"""Instrument panels: flow meters and pressure gauges on marker loops, and
a control-volume hydrodynamic force (port of ``ibamr_tpu/instruments.py``).

Each meter is an ordered chain of markers riding on the structure; a
reading gives the volumetric flux through the surface the chain spans and
the mean pressure along it. Meters are static padded index tensors and the
readings are interpolation gathers plus reductions on the device, with no
host read. The spanning surface is the centroid fan of the loop (exact
for planar loops):
  3D: flux = sum_tri u(centroid_tri) . n_tri A_tri;
  2D: a meter is an open curve and flux = the integral of u . n ds across
      it (n the left normal of each segment).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import interaction

Vel = Tuple[torch.Tensor, ...]


class MeterSpecs(NamedTuple):
    """B meters, each a padded chain of marker indices: idx (B, L) int64
    (pad slots repeat the first node), valid (B, L) 0/1 (real nodes, for
    the pressure mean), seg (B, L) 0/1 (real segments k -> k+1, for the
    flux; a closed meter includes the segment back to its first node)."""
    idx: torch.Tensor
    valid: torch.Tensor
    seg: torch.Tensor


def make_meters(loops: Sequence[Sequence[int]], closed,
                dtype=torch.float32, device="cuda") -> MeterSpecs:
    """Padded meter specs from per-meter marker index lists. ``closed``
    (bool or one per meter): closed loops (3D spanning surfaces) take the
    closing segment; open chains (2D cross-section meters) must not (a
    closed 2D contour integral of u . n reads ~0 for a near
    divergence-free field)."""
    dev = resolve_device(device)
    B = len(loops)
    if isinstance(closed, bool):
        closed = [closed] * B
    L = max(len(l) for l in loops) + 1   # always >= 1 pad slot
    idx = np.zeros((B, L), dtype=np.int64)
    valid = np.zeros((B, L), dtype=np.float64)
    seg = np.zeros((B, L), dtype=np.float64)
    for b, loop in enumerate(loops):
        n = len(loop)
        idx[b, :n] = loop
        idx[b, n:] = loop[0]     # pad at the first node's position
        valid[b, :n] = 1.0
        seg[b, :n - 1] = 1.0
        if closed[b]:
            seg[b, n - 1] = 1.0      # the segment n-1 -> n lands on node 0
    return MeterSpecs(idx=torch.as_tensor(idx, device=dev),
                      valid=torch.as_tensor(valid, dtype=dtype, device=dev),
                      seg=torch.as_tensor(seg, dtype=dtype, device=dev))


class InstrumentPanel:
    """Flow-meter and pressure-gauge readings of marker loops."""

    def __init__(self, grid: StaggeredGrid, meters: MeterSpecs,
                 kernel="IB_4"):
        self.grid = grid
        self.meters = meters
        self.kernel = kernel

    def readings(self, u: Vel, p: torch.Tensor,
                 X: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{"flux": (B,), "mean_pressure": (B,)}: one interpolation gather
        per quantity, the reductions on the device."""
        grid = self.grid
        idx, valid, seg_valid = self.meters
        B, L = idx.shape
        Xl = X[idx]                                     # (B, L, dim)
        b = torch.roll(Xl, -1, dims=1)
        if grid.dim == 2:
            # the open-curve meter: segments between consecutive nodes
            mid = (0.5 * (Xl + b)).reshape(-1, 2)
            t = b - Xl
            # the (ds-weighted) left normal (t_y, -t_x)
            nrm = torch.stack([t[..., 1], -t[..., 0]], dim=-1).reshape(-1, 2)
            Um = interaction.interpolate_vel(u, grid, mid,
                                             kernel=self.kernel)
            flux = torch.sum((Um * nrm).sum(-1).reshape(B, L) * seg_valid,
                             dim=1)
        else:
            # the centroid-fan triangulation of each closed loop
            cnt = torch.clamp(torch.sum(valid, dim=1, keepdim=True), min=1.0)
            cent = torch.sum(Xl * valid[..., None], dim=1) / cnt   # (B, 3)
            tri_c = (Xl + b + cent[:, None, :]) / 3.0
            # the area-weighted normal of the triangle (cent, a, b)
            nrm = 0.5 * torch.linalg.cross(Xl - cent[:, None, :],
                                           b - cent[:, None, :], dim=-1)
            Um = interaction.interpolate_vel(u, grid, tri_c.reshape(-1, 3),
                                             kernel=self.kernel)
            flux = torch.sum((Um.reshape(B, L, 3) * nrm).sum(-1) * seg_valid,
                             dim=1)
        Pm = interaction.interpolate(p, grid, Xl.reshape(-1, grid.dim),
                                     centering="cell", kernel=self.kernel)
        cnt = torch.clamp(torch.sum(valid, dim=1), min=1.0)
        mean_p = torch.sum(Pm.reshape(B, L) * valid, dim=1) / cnt
        return {"flux": flux, "mean_pressure": mean_p}


class HydrodynamicForceEvaluator:
    """Control-volume drag and lift on an immersed body, from the momentum
    balance over an axis-aligned control volume:

      F_body = oint [-rho u (u.n) - p n + mu (grad u + grad u^T).n] dA
               - d/dt int_cv rho u dV

    ``surface_force`` evaluates the surface integral with second-order MAC
    quadrature (face-plane cell-center points, one-cell centered
    differences for the tractions); ``momentum`` gives the CV momentum so
    the caller can difference it across steps. The CV keeps one cell of
    clearance from the domain edge, on the periodic lower-face MAC layout
    of :mod:`ibamr_tpu_torch.integrators.ins`."""

    def __init__(self, grid: StaggeredGrid, lo: Sequence[int],
                 hi: Sequence[int], rho: float = 1.0, mu: float = 0.01):
        dim = grid.dim
        if not len(lo) == len(hi) == dim:
            raise ValueError("lo and hi need one entry per axis")
        for d in range(dim):
            if not 1 <= lo[d] < hi[d] <= grid.n[d] - 1:
                raise ValueError(
                    "CV needs one-cell clearance from the domain edge")
        self.grid = grid
        self.lo = tuple(int(v) for v in lo)
        self.hi = tuple(int(v) for v in hi)
        self.rho = float(rho)
        self.mu = float(mu)

    def _box(self, a: torch.Tensor) -> torch.Tensor:
        return a[tuple(slice(l, h) for l, h in zip(self.lo, self.hi))]

    def _face_plane(self, a: torch.Tensor, axis: int,
                    face: int) -> torch.Tensor:
        """``a`` at index ``face`` along ``axis`` over the CV
        cross-section; ``face`` wraps (the layout is periodic)."""
        sl = [slice(l, h) for l, h in zip(self.lo, self.hi)]
        sl[axis] = face % a.shape[axis]
        return a[tuple(sl)]

    def momentum(self, u: Vel) -> torch.Tensor:
        """(dim,) rho int_cv u dV (faces averaged to cell centers)."""
        dV = math.prod(self.grid.dx)
        return torch.stack([
            self.rho * torch.sum(self._box(0.5 * (c + torch.roll(c, -1, d))))
            * dV for d, c in enumerate(u)])

    def surface_force(self, u: Vel, p: torch.Tensor) -> torch.Tensor:
        """(dim,) surface integral of the momentum flux and traction."""
        dim = self.grid.dim
        dx = self.grid.dx
        rho, mu = self.rho, self.mu
        fp = self._face_plane
        F = [torch.zeros((), dtype=p.dtype, device=p.device)
             for _ in range(dim)]
        for a in range(dim):
            dA = math.prod(dx[e] for e in range(dim) if e != a)
            for side, f in ((-1.0, self.lo[a]), (1.0, self.hi[a])):
                # u_a lies on the face plane at cross-section centers
                ua = fp(u[a], a, f)
                pf = 0.5 * (fp(p, a, f - 1) + fp(p, a, f))
                dua_da = (fp(u[a], a, f + 1) - fp(u[a], a, f - 1)) \
                    / (2.0 * dx[a])
                F[a] = F[a] + side * dA * torch.sum(
                    -rho * ua * ua - pf + 2.0 * mu * dua_da)
                for d in range(dim):
                    if d == a:
                        continue
                    # u_d at the same face points: faces to centers along
                    # d, cells to the face plane along a
                    ud_cc = 0.5 * (u[d] + torch.roll(u[d], -1, d))
                    ud = 0.5 * (fp(ud_cc, a, f - 1) + fp(ud_cc, a, f))
                    dud_da = (fp(ud_cc, a, f) - fp(ud_cc, a, f - 1)) / dx[a]
                    # d u_a / d x_d at the face points (centered along the
                    # transverse axis of the face-plane slice)
                    ua_full = torch.select(u[a], a, f % u[a].shape[a])
                    dp = d - (1 if d > a else 0)
                    dua_dd_full = (torch.roll(ua_full, -1, dp)
                                   - torch.roll(ua_full, 1, dp)) \
                        / (2.0 * dx[d])
                    dua_dd = dua_dd_full[tuple(
                        slice(self.lo[e], self.hi[e])
                        for e in range(dim) if e != a)]
                    F[d] = F[d] + side * dA * torch.sum(
                        -rho * ud * ua + mu * (dud_da + dua_dd))
        return torch.stack(F)

    def body_force(self, u: Vel, p: torch.Tensor, mom_prev: torch.Tensor,
                   mom_new: torch.Tensor, dt: float) -> torch.Tensor:
        """F on the body: the surface integral minus the CV momentum rate
        (``mom_*`` from :meth:`momentum` at consecutive steps)."""
        return self.surface_force(u, p) - (mom_new - mom_prev) / dt
