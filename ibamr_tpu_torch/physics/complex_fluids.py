"""Viscoelastic (complex) fluids: Oldroyd-B conformation-tensor transport
(port of ``ibamr_tpu/physics/complex_fluids.py``).

The polymeric phase is a symmetric conformation tensor C evolved by the
upper-convected derivative with linear relaxation,

    dC/dt + u . grad C = grad_u C + C grad_u^T + (1/lambda)(I - C),

and feeds back on the fluid through the polymer stress
tau = (mu_p / lambda)(C - I), whose divergence enters the INS step as a
body force. C is stored as its dim*(dim+1)/2 unique components in one
(..., nc) cell-centered tensor; transport is the Godunov advector per
component.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins_walls import pin_normal
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.ops.godunov import advect
from ibamr_tpu_torch.ops.stencils import central_grad

Vel = Tuple[torch.Tensor, ...]

_PAIRS = {2: ((0, 0), (0, 1), (1, 1)),
          3: ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))}


def n_components(dim: int) -> int:
    return dim * (dim + 1) // 2


def identity_conformation(grid: StaggeredGrid, dtype=torch.float32,
                          device="cuda") -> torch.Tensor:
    """Equilibrium conformation field C = I -> (*n, nc)."""
    dim = grid.dim
    C = torch.zeros(grid.n + (n_components(dim),), dtype=dtype,
                    device=resolve_device(device))
    for k, (i, j) in enumerate(_PAIRS[dim]):
        if i == j:
            C[..., k] = 1.0
    return C


def pack(Cfull: torch.Tensor) -> torch.Tensor:
    """(..., dim, dim) symmetric -> (..., nc) unique components."""
    dim = Cfull.shape[-1]
    return torch.stack([Cfull[..., i, j] for (i, j) in _PAIRS[dim]], dim=-1)


def unpack(C: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., nc) -> (..., dim, dim) symmetric."""
    out = torch.zeros(C.shape[:-1] + (dim, dim), dtype=C.dtype,
                      device=C.device)
    for k, (i, j) in enumerate(_PAIRS[dim]):
        out[..., i, j] = C[..., k]
        if i != j:
            out[..., j, i] = C[..., k]
    return out


def velocity_gradient_cc(u: Vel, dx: Sequence[float],
                         wall_axes=None) -> torch.Tensor:
    """Cell-centered grad_u[i, j] = du_i/dx_j from MAC velocity;
    ``wall_axes[j]`` uses one-sided differences at the boundary cells of
    axis j instead of the periodic wrap."""
    dim = len(u)
    if wall_axes is None:
        wall_axes = (False,) * dim
    cc = stencils.fc_to_cc(u)
    rows = []
    for i in range(dim):
        cols = [central_grad(cc[i], j, dx[j], wall_axes[j])
                for j in range(dim)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)          # (..., i, j)


def oldroyd_b_source(C: torch.Tensor, grad_u: torch.Tensor,
                     lam: float) -> torch.Tensor:
    """Stretching + relaxation RHS in packed components:
    grad_u C + C grad_u^T + (I - C)/lambda."""
    dim = grad_u.shape[-1]
    Cf = unpack(C, dim)
    GC = torch.einsum("...ik,...kj->...ij", grad_u, Cf)
    S = GC + torch.swapaxes(GC, -1, -2)
    S = S + (torch.eye(dim, dtype=C.dtype, device=C.device) - Cf) / lam
    return pack(S)


def polymer_stress(C: torch.Tensor, mu_p: float, lam: float,
                   dim: int) -> torch.Tensor:
    """tau = (mu_p / lambda)(C - I), packed."""
    eye = torch.eye(dim, dtype=C.dtype, device=C.device)
    I = pack(torch.broadcast_to(eye, C.shape[:-1] + (dim, dim)))
    return (mu_p / lam) * (C - I)


def stress_divergence_mac(tau: torch.Tensor, grid: StaggeredGrid,
                          wall_axes=None) -> Vel:
    """MAC body force f_d = sum_j d_j tau_dj from the packed cell-centered
    stress: backward difference to the face along d, centered difference
    shifted to the face across it; ``wall_axes``: one-sided transverse
    differences at the wall layers and pinned wall-normal faces."""
    dim = grid.dim
    dx = grid.dx
    if wall_axes is None:
        wall_axes = (False,) * dim
    tf = unpack(tau, dim)
    out = []
    for d in range(dim):
        acc = None
        for j in range(dim):
            t = tf[..., d, j]
            if j == d:
                g = (t - torch.roll(t, 1, d)) / dx[d]
            else:
                g = central_grad(t, j, dx[j], wall_axes[j])
                g = 0.5 * (g + torch.roll(g, 1, d))
            acc = g if acc is None else acc + g
        out.append(pin_normal(acc, d, wall_axes))
    return tuple(out)


class OldroydB:
    """Owns (mu_p, lambda), advances C and returns the polymer body force
    for the INS step."""

    def __init__(self, grid: StaggeredGrid, mu_p: float, lam: float,
                 wall_axes=None, dtype=torch.float32, device="cuda"):
        self.grid = grid
        self.mu_p = float(mu_p)
        self.lam = float(lam)
        self.wall_axes = (tuple(bool(w) for w in wall_axes)
                          if wall_axes is not None
                          else (False,) * grid.dim)
        self.dtype = dtype
        self.device = resolve_device(device)

    def initialize(self) -> torch.Tensor:
        return identity_conformation(self.grid, dtype=self.dtype,
                                     device=self.device)

    def step(self, C: torch.Tensor, u: Vel, dt: float) -> torch.Tensor:
        """Advect each packed component (Godunov), then apply the
        stretching/relaxation source (explicit Euler)."""
        dx = self.grid.dx
        wa = self.wall_axes
        Cadv = torch.stack([advect(C[..., k], u, dx, dt, wall_axes=wa)
                            for k in range(C.shape[-1])], dim=-1)
        gu = velocity_gradient_cc(u, dx, wall_axes=wa)
        return Cadv + dt * oldroyd_b_source(Cadv, gu, self.lam)

    def body_force(self, C: torch.Tensor) -> Vel:
        tau = polymer_stress(C, self.mu_p, self.lam, self.grid.dim)
        return stress_divergence_mac(tau, self.grid, wall_axes=self.wall_axes)
