"""Explicit Godunov advection: slope-limited MUSCL predictor with
corner-transport-upwind (CTU) transverse corrections (port of
``ibamr_tpu/ops/godunov.py``).

The PLM/CTU member of the reference's Godunov predictor family (2nd
order, monotone with the MC limiter), as whole-array rolls and
``torch.where`` upwind selects.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.parallel.spmd import Blocks, halo_stencil
from ibamr_tpu_torch.solvers import fft

Vel = Tuple[torch.Tensor, ...]


def mc_limited_slope(Q: torch.Tensor, axis: int,
                     wall: bool = False) -> torch.Tensor:
    """Monotonized-central limited undivided slope (van Leer MC).

    ``wall`` treats both ends of ``axis`` as domain walls: the
    cross-wall (periodic-wrap) differences are zeroed, the
    even-reflection ghost, which limits the boundary cells' slopes to 0."""
    dp = torch.roll(Q, -1, axis) - Q
    dm = Q - torch.roll(Q, 1, axis)
    if wall:
        is_lo, is_hi = stencils.wall_boundary_masks(Q.shape, axis, Q.device)
        dm = torch.where(is_lo, torch.zeros_like(dm), dm)
        dp = torch.where(is_hi, torch.zeros_like(dp), dp)
    dc = 0.5 * (dp + dm)
    s = torch.sign(dc)
    mag = torch.minimum(torch.abs(dc),
                        2.0 * torch.minimum(torch.abs(dp), torch.abs(dm)))
    return torch.where(dp * dm > 0.0, s * mag, torch.zeros_like(dc))


def _face_states(Q: torch.Tensor, u: torch.Tensor, d: int, dx: float,
                 dt: float, wall: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left/right predicted states at the lower d-faces (PLM in space +
    half-dt characteristic tracing along d)."""
    slope = mc_limited_slope(Q, d, wall=wall)
    nu = u * dt / dx
    zero = torch.zeros((), dtype=nu.dtype, device=nu.device)
    qL = torch.roll(Q, 1, d) + 0.5 * (1.0 - torch.maximum(nu, zero)) \
        * torch.roll(slope, 1, d)
    qR = Q - 0.5 * (1.0 + torch.minimum(nu, zero)) * slope
    return qL, qR


def _upwind_select(u: torch.Tensor, qL: torch.Tensor,
                   qR: torch.Tensor) -> torch.Tensor:
    """qL where u > 0, qR where u < 0, their mean where u == 0."""
    return torch.where(u > 0.0, qL,
                       torch.where(u < 0.0, qR, 0.5 * (qL + qR)))


def godunov_face_values(Q: torch.Tensor, u: Vel,
                        dx: Sequence[float], dt: float,
                        ctu: bool = True,
                        wall_axes: Optional[Sequence[bool]] = None) -> Vel:
    """Time-centered face values q^{n+1/2} at the lower faces of each
    axis; ``u`` is the advecting MAC velocity. With ``ctu``, transverse
    corner-transport-upwind corrections lift the stability limit to the
    full multidimensional CFL. ``wall_axes[d]`` marks axis d as
    wall-bounded under the pinned-face storage convention: the wall-face
    fluxes vanish, so only the boundary cells' slopes change."""
    dim = Q.ndim
    if wall_axes is None:
        wall_axes = (False,) * dim
    faces = []
    for d in range(dim):
        qL, qR = _face_states(Q, u[d], d, dx[d], dt, wall=wall_axes[d])
        if ctu:
            corr = torch.zeros_like(Q)
            for a in range(dim):
                if a == d:
                    continue
                # transverse donor-cell flux difference (Colella CTU)
                Fa = u[a] * torch.where(u[a] > 0.0, torch.roll(Q, 1, a), Q)
                corr = corr + (torch.roll(Fa, -1, a) - Fa) / dx[a]
            qL = qL - 0.5 * dt * torch.roll(corr, 1, d)
            qR = qR - 0.5 * dt * corr
        faces.append(_upwind_select(u[d], qL, qR))
    return tuple(faces)


def advect(Q: torch.Tensor, u: Vel, dx: Sequence[float], dt: float,
           ctu: bool = True,
           wall_axes: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """One conservative Godunov advection step Q - dt div(u q^{n+1/2})
    (flux form: exact mass conservation, in the walled box too). On
    Blocks, one halo stencil of radius 2 (the limited slopes of the
    neighbour cells and the CTU corrections), bitwise the whole grid's:
    the wall masks read global indices."""
    if isinstance(Q, Blocks):
        return halo_stencil(
            lambda qv: advect(qv[0], qv[1:], dx, dt, ctu=ctu,
                              wall_axes=wall_axes), 2)((Q, *u))
    qf = godunov_face_values(Q, u, dx, dt, ctu=ctu, wall_axes=wall_axes)
    out = Q
    for d in range(Q.ndim):
        F = u[d] * qf[d]
        out = out - dt * (torch.roll(F, -1, d) - F) / dx[d]
    return out


def advect_split(Q: torch.Tensor, u: Vel, dx: Sequence[float],
                 dt: float, parity: int = 0) -> torch.Tensor:
    """Strang dimensionally-split Godunov step: one 1D PLM sweep per axis
    (alternate ``parity`` between steps for 2nd order). Each sweep is
    TVD, so the split scheme is monotone for constant advection."""
    dim = Q.ndim
    order = range(dim) if parity % 2 == 0 else reversed(range(dim))
    for d in order:
        qL, qR = _face_states(Q, u[d], d, dx[d], dt)
        F = u[d] * _upwind_select(u[d], qL, qR)
        Q = Q - dt * (torch.roll(F, -1, d) - F) / dx[d]
    return Q


class AdvDiffPredictorCorrector:
    """Predictor-corrector advection-diffusion: the Godunov predictor
    gives the time-centered convective flux, diffusion is Crank-Nicolson
    by an FFT Helmholtz solve on the periodic grid:
      (1/dt - kappa/2 lap) Q^{n+1} =
          (1/dt + kappa/2 lap) Q^n - div(u q^{n+1/2})
    """

    def __init__(self, grid, kappa: float = 0.0, ctu: bool = True):
        self.grid = grid
        self.kappa = float(kappa)
        self.ctu = ctu

    def step(self, Q: torch.Tensor, u: Vel, dt: float) -> torch.Tensor:
        dx = self.grid.dx
        qf = godunov_face_values(Q, u, dx, dt, ctu=self.ctu)
        conv = torch.zeros_like(Q)
        for d in range(Q.ndim):
            F = u[d] * qf[d]
            conv = conv + (torch.roll(F, -1, d) - F) / dx[d]
        if self.kappa == 0.0:
            return Q - dt * conv
        rhs = Q / dt + 0.5 * self.kappa * stencils.laplacian(Q, dx) - conv
        return fft.solve_helmholtz_periodic(rhs, dx, alpha=1.0 / dt,
                                            beta=-0.5 * self.kappa)
