"""L-level nested AMR hierarchy for advection-diffusion (port of
``ibamr_tpu/amr_multilevel.py``).

The hierarchy is a static list of levels, one fixed box per level, each
nested with clearance inside its parent. The composite step recurses
over the levels: level l takes 2^l substeps of one root step (ratio-2
subcycling), and at every coarse-fine interface the covered parent cells
take the restriction of the child while the uncovered neighbours are
refluxed with the time-averaged, transversely restricted child flux minus
the parent flux. The composite integral is then conserved to roundoff.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.amr import (FineBox, box_slices, fill_fine_ghosts,
                                 restrict_cc)
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid

Vel = Tuple[torch.Tensor, ...]


class LevelSpec(NamedTuple):
    """Static geometry of one level: its box in the parent level's index
    space (None for the root) and its own grid."""
    box: Optional[FineBox]
    grid: StaggeredGrid


def build_hierarchy(grid: StaggeredGrid,
                    boxes: Sequence[FineBox]) -> List[LevelSpec]:
    """Validate and build an L-level nested hierarchy: ``boxes[l]`` is
    level l+1's box inside level l. Each box keeps >= 2 cells of clearance
    inside its parent, so the quadratic CF interpolation stencils and the
    interface refluxing stay interior."""
    levels = [LevelSpec(box=None, grid=grid)]
    parent = grid
    for box in boxes:
        box.validate(parent)
        fine = box.fine_grid(parent)
        levels.append(LevelSpec(box=box, grid=fine))
        parent = fine
    return levels


def face_mesh(g: StaggeredGrid, d: int, complete: bool):
    """Host coordinate arrays of MAC component ``d``'s faces: the
    periodic lower-face layout, or the complete-face box layout (+1 along
    ``d``)."""
    shape = tuple(g.n[e] + (1 if (complete and e == d) else 0)
                  for e in range(g.dim))
    coords = []
    for e in range(g.dim):
        if e == d:
            c = g.x_lo[e] + np.arange(shape[e]) * g.dx[e]
        else:
            c = g.x_lo[e] + (np.arange(shape[e]) + 0.5) * g.dx[e]
        coords.append(c)
    return shape, np.meshgrid(*coords, indexing="ij")


class MultiLevelAdvDiff:
    """Composite L-level advance of dQ/dt + div(u Q) = kappa lap(Q) with
    a velocity frozen per level. Level 0 is periodic; levels 1..L-1 are
    nested ratio-2 boxes. ``vel_fn(mesh_tuple) -> tuple of components``
    (host numpy) is evaluated at every level's faces at build time."""

    GHOST = 1      # centered/upwind fluxes need one ghost layer

    def __init__(self, grid: StaggeredGrid, boxes: Sequence[FineBox],
                 kappa: float = 0.0, scheme: str = "centered",
                 vel_fn: Optional[Callable] = None,
                 dtype=torch.float64, device="cuda"):
        self.device = resolve_device(device)
        self.levels = build_hierarchy(grid, boxes)
        self.L = len(self.levels)
        self.kappa = float(kappa)
        if scheme not in ("centered", "upwind"):
            raise ValueError(f"unknown scheme {scheme!r}")
        self.scheme = scheme
        self.dtype = dtype

        # face velocities per level, component d on the faces along d:
        # the periodic layout at level 0, complete faces on the boxes
        self.u_faces: List[Optional[Vel]] = []
        for l, spec in enumerate(self.levels):
            if vel_fn is None:
                self.u_faces.append(None)
                continue
            comps = []
            for d in range(spec.grid.dim):
                _, mesh = face_mesh(spec.grid, d, complete=l > 0)
                comps.append(torch.as_tensor(
                    np.asarray(vel_fn(mesh)[d]), dtype=dtype,
                    device=self.device))
            self.u_faces.append(tuple(comps))

    def initialize(self, fn) -> Tuple[torch.Tensor, ...]:
        """``fn(cell_center_tensors) -> tensor`` on every level."""
        out = []
        for spec in self.levels:
            Q = torch.as_tensor(
                fn(spec.grid.cell_centers(self.dtype, self.device)),
                dtype=self.dtype, device=self.device)
            out.append(Q.expand(spec.grid.n).clone())
        return tuple(out)

    # -- flux machinery -------------------------------------------------------
    def _fluxes(self, l: int, Q: torch.Tensor,
                Qg: Optional[torch.Tensor]) -> Vel:
        """Face fluxes of u Q - kappa dQ/dx on level l: periodic rolls
        (lower faces) at level 0, the 1-ghost extension ``Qg`` (complete
        faces) on the boxes."""
        g = self.levels[l].grid
        dim = g.dim
        out = []
        for d in range(dim):
            h = g.dx[d]
            if l == 0:
                QL, QR = torch.roll(Q, 1, d), Q
            else:
                lo = [slice(1, 1 + g.n[e]) for e in range(dim)]
                hi = [slice(1, 1 + g.n[e]) for e in range(dim)]
                lo[d] = slice(0, g.n[d] + 1)
                hi[d] = slice(1, g.n[d] + 2)
                QL, QR = Qg[tuple(lo)], Qg[tuple(hi)]
            u = self.u_faces[l][d]
            if self.scheme == "upwind":
                adv = torch.where(u > 0, u * QL, u * QR)
            else:
                adv = u * 0.5 * (QL + QR)
            out.append(adv - self.kappa * (QR - QL) / h)
        return tuple(out)

    @staticmethod
    def _div(F: Vel, g: StaggeredGrid, complete: bool) -> torch.Tensor:
        acc = None
        for d, f in enumerate(F):
            if complete:
                lo = [slice(None)] * g.dim
                hi = [slice(None)] * g.dim
                lo[d] = slice(0, -1)
                hi[d] = slice(1, None)
                t = (f[tuple(hi)] - f[tuple(lo)]) / g.dx[d]
            else:
                t = (torch.roll(f, -1, d) - f) / g.dx[d]
            acc = t if acc is None else acc + t
        return acc

    @staticmethod
    def _bdry_slabs(F: Vel) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(lo, hi) boundary-face flux slabs per axis of a complete-face
        flux tuple."""
        out = []
        for d, f in enumerate(F):
            lo_sl = [slice(None)] * f.ndim
            hi_sl = [slice(None)] * f.ndim
            lo_sl[d] = slice(0, 1)
            hi_sl[d] = slice(f.shape[d] - 1, f.shape[d])
            out.append((f[tuple(lo_sl)], f[tuple(hi_sl)]))
        return out

    @staticmethod
    def _transverse_restrict(slab: torch.Tensor, d: int,
                             r: int) -> torch.Tensor:
        """Mean over r-blocks in every axis but d (``slab`` has extent 1
        along d)."""
        shape = []
        for a in range(slab.ndim):
            shape += [1] if a == d else [slab.shape[a] // r, r]
        arr = slab.reshape(shape)
        mean_axes, i = [], 0
        for a in range(slab.ndim):
            if a == d:
                i += 1
            else:
                mean_axes.append(i + 1)
                i += 2
        return arr.mean(dim=tuple(mean_axes))

    # -- recursive composite step ---------------------------------------------
    def _advance_level(self, l: int, Qs: List[torch.Tensor],
                       p_ghost_src: Optional[torch.Tensor], dt: float):
        """Advance level l (and, recursively, every finer level) by one
        step of its local ``dt``. ``p_ghost_src`` is the parent tensor,
        time-interpolated to this substep's start, for the CF ghosts.
        Returns the updated tensors and level l's boundary-face flux slabs
        (None at the root) for the parent's reflux."""
        spec = self.levels[l]
        g = spec.grid

        Q_old = Qs[l]
        if l == 0:
            F = self._fluxes(0, Q_old, None)
            Q_new = Q_old - dt * self._div(F, g, complete=False)
        else:
            Qg = fill_fine_ghosts(Q_old, p_ghost_src, spec.box,
                                  ghost=self.GHOST)
            F = self._fluxes(l, Q_old, Qg)
            Q_new = Q_old - dt * self._div(F, g, complete=True)

        Qs = list(Qs)
        Qs[l] = Q_new

        if l + 1 < self.L:
            box = self.levels[l + 1].box
            r = box.ratio
            acc = None
            for m in range(r):
                theta = m / r
                p_src = (1.0 - theta) * Q_old + theta * Q_new
                Qs, slabs = self._advance_level(l + 1, Qs, p_src, dt / r)
                acc = slabs if acc is None else [
                    (a0 + s0, a1 + s1)
                    for (a0, a1), (s0, s1) in zip(acc, slabs)]

            # restriction onto the covered region of level l
            Ql = Qs[l].clone()
            Ql[box_slices(box.lo, box.shape)] = restrict_cc(Qs[l + 1])

            # reflux level l's uncovered neighbours at the CF interface
            for d in range(g.dim):
                favg_lo = self._transverse_restrict(acc[d][0], d, r) / r
                favg_hi = self._transverse_restrict(acc[d][1], d, r) / r
                lo_face = [slice(box.lo[a], box.hi[a])
                           for a in range(g.dim)]
                hi_face = list(lo_face)
                lo_face[d] = slice(box.lo[d], box.lo[d] + 1)
                hi_face[d] = slice(box.hi[d], box.hi[d] + 1)
                # level 0's lower-face tensors index the interface faces
                # as the complete-face tensors of the boxes do
                fc_lo = F[d][tuple(lo_face)]
                fc_hi = F[d][tuple(hi_face)]
                nb_lo = list(lo_face)
                nb_lo[d] = slice(box.lo[d] - 1, box.lo[d])
                nb_hi = list(hi_face)
                nb_hi[d] = slice(box.hi[d], box.hi[d] + 1)
                Ql[tuple(nb_lo)] += (-dt / g.dx[d]) * (favg_lo - fc_lo)
                Ql[tuple(nb_hi)] += (dt / g.dx[d]) * (favg_hi - fc_hi)
            Qs[l] = Ql

        slabs = None if l == 0 else self._bdry_slabs(F)
        return Qs, slabs

    # -- public API -----------------------------------------------------------
    def step(self, Qs: Sequence[torch.Tensor],
             dt: float) -> Tuple[torch.Tensor, ...]:
        out, _ = self._advance_level(0, list(Qs), None, dt)
        return tuple(out)

    def total(self, Qs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Composite conserved integral: the uncovered cells of each level
        plus the whole finest level."""
        acc = torch.zeros((), dtype=self.dtype, device=self.device)
        for l, spec in enumerate(self.levels):
            g = spec.grid
            vol = float(np.prod(g.dx))
            Q = Qs[l]
            if l + 1 < self.L:
                box = self.levels[l + 1].box
                mask = torch.ones(g.n, dtype=torch.bool, device=Q.device)
                mask[box_slices(box.lo, box.shape)] = False
                acc = acc + vol * torch.sum(
                    torch.where(mask, Q, torch.zeros_like(Q)))
            else:
                acc = acc + vol * torch.sum(Q)
        return acc
