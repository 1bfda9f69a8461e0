"""Multi-box dynamic AMR: tag clustering into K fine windows (port of
``ibamr_tpu/amr_multibox.py``).

A fixed pool of K fixed-shape windows over one periodic coarse level,
each advanced by the single-window machinery of
:class:`ibamr_tpu_torch.amr_dynamic.DynamicTwoLevelAdvDiff`. Clustering
runs on the host between chunks of steps, as the reference's does:
connected-component labelling of the tag field, a box per component
(largest first), pairwise separation of fixed-shape boxes that come too
close, and min-cost matching to the previous origins so that surviving
fine data is copied across the right overlap. The origins are read to the
host once per regrid.

Windows stay separated by at least ``GAP`` coarse cells: each window's
reflux lands on the coarse cells just outside it, which no other window
may cover (its restriction would overwrite the correction).
"""

from __future__ import annotations

from itertools import permutations
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.amr import box_slices
from ibamr_tpu_torch.amr_dynamic import (DynamicTwoLevelAdvDiff, copy_overlap,
                                         prolong_cc_conservative,
                                         restrict_into_coarse, tag_gradient)
from ibamr_tpu_torch.grid import StaggeredGrid

Origins = Tuple[Tuple[int, ...], ...]


# -- host-side clustering -----------------------------------------------------

def connected_components(tags: np.ndarray) -> List[np.ndarray]:
    """Face-connected components of a boolean tag array (host BFS; the
    periodic wrap by index modulo). One (n_cells, dim) index array per
    component, largest first."""
    tags = np.asarray(tags, dtype=bool)
    shape = tags.shape
    dim = tags.ndim
    seen = np.zeros(shape, dtype=bool)
    comps = []
    for start in zip(*np.nonzero(tags & ~seen)):
        if seen[start]:
            continue
        stack = [start]
        seen[start] = True
        cells = []
        while stack:
            c = stack.pop()
            cells.append(c)
            for d in range(dim):
                for s in (-1, 1):
                    nb = list(c)
                    nb[d] = (nb[d] + s) % shape[d]
                    nb = tuple(nb)
                    if tags[nb] and not seen[nb]:
                        seen[nb] = True
                        stack.append(nb)
        comps.append(np.asarray(cells))
    comps.sort(key=len, reverse=True)
    return comps


def _center_box(cells: np.ndarray, shape: Tuple[int, ...],
                box_shape: Tuple[int, ...], clearance: int) -> np.ndarray:
    """Fixed-shape box origin centering one component (circular mean per
    axis, clipped to the clearance)."""
    dim = len(shape)
    lo = np.zeros(dim, dtype=np.int64)
    for d in range(dim):
        n = shape[d]
        th = 2.0 * np.pi * cells[:, d] / n
        center = np.mod(np.arctan2(np.sin(th).sum(), np.cos(th).sum())
                        / (2.0 * np.pi) * n + 0.5, n)
        lo[d] = int(np.clip(round(center - box_shape[d] / 2.0),
                            clearance, n - box_shape[d] - clearance))
    return lo


GAP = 1   # the least coarse-cell gap between windows (touching boxes would
# let one window's restriction overwrite another's reflux cells)


def _separate(los: List[np.ndarray], box_shape, shape, clearance,
              max_rounds: int = 8) -> List[np.ndarray]:
    """Nudge too-close fixed-shape boxes apart: for each violating pair,
    shift the later (smaller-component) box along the axis that needs the
    smallest displacement, keeping >= GAP cells between boxes. Returns []
    when the boxes cannot be separated."""
    los = [lo.copy() for lo in los]
    for _ in range(max_rounds):
        moved = False
        for j in range(1, len(los)):
            for i in range(j):
                ov = [min(los[i][d] + box_shape[d], los[j][d] + box_shape[d])
                      - max(los[i][d], los[j][d])
                      for d in range(len(shape))]
                if all(o > -GAP for o in ov):
                    d = int(np.argmin(ov))
                    if los[j][d] >= los[i][d]:
                        cand = los[i][d] + box_shape[d] + GAP
                    else:
                        cand = los[i][d] - box_shape[d] - GAP
                    los[j][d] = int(np.clip(
                        cand, clearance, shape[d] - box_shape[d] - clearance))
                    moved = True
        if not moved:
            return los
    return []


def cluster_boxes(tags: np.ndarray, K: int, box_shape: Tuple[int, ...],
                  clearance: int = 2,
                  prev: Optional[np.ndarray] = None) -> np.ndarray:
    """K fixed-shape box origins for the tag field, pairwise separated by
    >= GAP cells (host side). The K largest components get a box each;
    with fewer components, the extra boxes shadow the largest one. With
    ``prev`` the boxes are matched to the previous origins (exact
    min-cost permutation for K <= 6, greedy nearest pairs beyond), so a
    window follows its feature. Returns (K, dim) int64 origins; falls back
    to ``prev`` when separation is impossible, and raises when it is
    impossible with no ``prev``."""
    shape = tags.shape
    comps = connected_components(tags)
    if not comps:
        if prev is not None:
            return np.asarray(prev, dtype=np.int64)
        mid = np.asarray([(s - b) // 2 for s, b in zip(shape, box_shape)],
                         dtype=np.int64)
        los = _separate([mid.copy() for _ in range(K)], box_shape, shape,
                        clearance)
        if not los:
            raise ValueError(
                f"cannot place {K} disjoint {box_shape} windows in a "
                f"{shape} domain with clearance {clearance}")
        return np.stack(los).astype(np.int64)

    los = [_center_box(c, shape, box_shape, clearance) for c in comps[:K]]
    while len(los) < K:
        los.append(los[0].copy())     # shadow the largest component
    sep = _separate(los, box_shape, shape, clearance)
    if not sep:
        if prev is not None:
            return np.asarray(prev, dtype=np.int64)
        raise ValueError(
            f"features too clustered for {K} disjoint {box_shape} "
            f"windows (domain {shape}, clearance {clearance}); use a "
            "larger box_shape or fewer windows")
    los = np.stack(sep)

    if prev is not None:
        prev = np.asarray(prev)
        if K <= 6:
            best, best_cost = None, None
            for perm in permutations(range(K)):
                cost = sum(np.abs(los[p] - prev[k]).sum()
                           for k, p in enumerate(perm))
                if best_cost is None or cost < best_cost:
                    best, best_cost = perm, cost
            order = best
        else:
            remaining = set(range(K))
            order = [None] * K
            for _ in range(K):
                bi = bj = bcost = None
                for k in range(K):
                    if order[k] is not None:
                        continue
                    for p in remaining:
                        cost = np.abs(los[p] - prev[k]).sum()
                        if bcost is None or cost < bcost:
                            bi, bj, bcost = k, p, cost
                order[bi] = bj
                remaining.discard(bj)
        los = np.stack([los[p] for p in order])
    return los.astype(np.int64)


# -- the K-window integrator --------------------------------------------------

class MultiBoxState(NamedTuple):
    Qc: torch.Tensor      # coarse level (periodic)
    Qf: torch.Tensor      # (K, *fine_shape) window pool
    lo: torch.Tensor      # (K, dim) int32 window origins


def _origins(lo) -> Origins:
    """The pool's origins as host ints (one device read for a tensor)."""
    if isinstance(lo, torch.Tensor):
        lo = lo.tolist()
    return tuple(tuple(int(v) for v in row) for row in lo)


class MultiBoxDynamicAdvDiff:
    """K-window moving-refinement advection-diffusion: the composite step
    advances every window at its origin; clustering runs on the host
    between chunks of steps (``advance_regridding``)."""

    def __init__(self, grid: StaggeredGrid, box_shape: Tuple[int, ...],
                 K: int, kappa: float = 0.0, scheme: str = "centered",
                 u_fn: Optional[Callable] = None,
                 tag_threshold: float = 0.05, ratio: int = 2,
                 clearance: int = 2, dtype=torch.float64, device="cuda"):
        self.K = int(K)
        # every per-window operation is the single-window integrator's
        self.win = DynamicTwoLevelAdvDiff(
            grid, box_shape, kappa=kappa, scheme=scheme, u_fn=u_fn,
            tag_threshold=tag_threshold, ratio=ratio, clearance=clearance,
            dtype=dtype, device=device)
        self.device = self.win.device
        self.grid = grid
        self.ratio = ratio

    def _lo_tensor(self, los) -> torch.Tensor:
        return torch.tensor(np.asarray(los), dtype=torch.int32,
                            device=self.device)

    # -- composite step -------------------------------------------------------
    def step_at(self, state: MultiBoxState, dt: float,
                los: Origins) -> MultiBoxState:
        """One composite step with the origins ``los`` given as host ints
        (equal to ``state.lo``)."""
        win = self.win
        Qc, Qf = state.Qc, state.Qf
        Fc, Qc_new = win._coarse_advance(Qc, dt)
        # every window reads the pristine coarse predictor before any
        # writes back (so the result does not depend on the window order)
        subs = [win._fine_substeps(Qc, Qc_new, Qf[k], los[k], dt)
                for k in range(self.K)]
        for k in range(self.K):
            Qf_k, acc_lo, acc_hi = subs[k]
            Qc_new = win._restrict_and_reflux(Qc_new, Qf_k, los[k], Fc,
                                              acc_lo, acc_hi, dt)
        return MultiBoxState(Qc=Qc_new, Qf=torch.stack([s[0] for s in subs]),
                             lo=state.lo)

    def step(self, state: MultiBoxState, dt: float) -> MultiBoxState:
        return self.step_at(state, dt, _origins(state.lo))

    def advance(self, state: MultiBoxState, dt: float,
                num_steps: int) -> MultiBoxState:
        """``num_steps`` composite steps with the windows in place (one
        host read of the origins)."""
        los = _origins(state.lo)
        for _ in range(num_steps):
            state = self.step_at(state, dt, los)
        return state

    # -- host-side regrid -----------------------------------------------------
    def regrid_state(self, state: MultiBoxState) -> MultiBoxState:
        """Re-cluster the tags and move the window pool: the coarse level
        synced under every old window, the new windows prolonged, and the
        surviving fine data copied from the matched old window."""
        win = self.win
        r = self.ratio
        Qc, Qf = state.Qc, state.Qf
        los = _origins(state.lo)
        for k in range(self.K):
            Qc = restrict_into_coarse(Qc, Qf[k], los[k], r)
        tags = tag_gradient(Qc, self.grid, win.tag_threshold).cpu().numpy()
        lo_new = cluster_boxes(tags, self.K, win.box_shape, win.clearance,
                               prev=np.asarray(los))
        new = _origins(lo_new)
        Qf_out = []
        for k in range(self.K):
            Qf_k = prolong_cc_conservative(Qc, new[k], win.box_shape, r)
            Qf_out.append(copy_overlap(Qf_k, Qf[k], new[k], los[k], r))
        return MultiBoxState(Qc=Qc, Qf=torch.stack(Qf_out),
                             lo=self._lo_tensor(lo_new))

    def advance_regridding(self, state: MultiBoxState, dt: float,
                           num_steps: int,
                           regrid_interval: int = 5) -> MultiBoxState:
        """A regrid before every chunk of ``regrid_interval`` steps."""
        done = 0
        while done < num_steps:
            state = self.regrid_state(state)
            n = min(regrid_interval, num_steps - done)
            state = self.advance(state, dt, n)
            done += n
        return state

    # -- set-up and diagnostics -----------------------------------------------
    def initialize(self, fn) -> MultiBoxState:
        """``fn(coords) -> tensor`` on the coarse level, the initial tags
        clustered, each window sampled exactly."""
        win = self.win
        kw = dict(dtype=win.dtype, device=self.device)
        Qc = torch.as_tensor(fn(self.grid.cell_centers(win.dtype,
                                                       self.device)), **kw)
        Qc = Qc.expand(self.grid.n).clone()
        tags = tag_gradient(Qc, self.grid, win.tag_threshold).cpu().numpy()
        lo = cluster_boxes(tags, self.K, win.box_shape, win.clearance)
        Qf = [torch.as_tensor(fn(win._fine_cell_coords(o)), **kw)
              .expand(win.fine_shape) for o in _origins(lo)]
        return MultiBoxState(Qc=Qc, Qf=torch.stack(Qf),
                             lo=self._lo_tensor(lo))

    def total(self, state: MultiBoxState) -> torch.Tensor:
        """Composite conserved integral (uncovered coarse + windows)."""
        win = self.win
        vol_c = self.grid.cell_volume
        vol_f = vol_c / (self.ratio ** self.grid.dim)
        covered = torch.zeros(self.grid.n, dtype=torch.bool,
                              device=state.Qc.device)
        acc = torch.zeros((), dtype=state.Qc.dtype, device=state.Qc.device)
        for k, o in enumerate(_origins(state.lo)):
            covered[box_slices(o, win.box_shape)] = True
            acc = acc + torch.sum(state.Qf[k]) * vol_f
        return acc + torch.sum(torch.where(
            covered, torch.zeros_like(state.Qc), state.Qc)) * vol_c
