"""IMP: the immersed material-point method (port of
``ibamr_tpu/integrators/imp.py``).

Structures are material points carrying a deformation gradient F and a
reference volume V0: the interpolated velocity moves the points, the
interpolated velocity gradient evolves F (dF/dt = (grad u) F), and the
first Piola-Kirchhoff stress of a hyperelastic law enters the fluid in
divergence form, f = -sum_p V0_p P(F_p) F_p^T grad(delta_h). Points are
fixed-capacity (N, ...) tensors with an active mask; the transfers are the
kernel-gradient scatter/gather of :mod:`ibamr_tpu_torch.ops.interaction`
(C^1 kernels only; B-splines by default).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator, INSState
from ibamr_tpu_torch.ops import interaction

Vel = Tuple[torch.Tensor, ...]


class NeoHookean(NamedTuple):
    """Compressible neo-Hookean: P(F) = mu (F - F^-T) + lam ln(J) F^-T."""
    mu: float
    lam: float

    def pk1(self, F: torch.Tensor) -> torch.Tensor:
        FinvT = torch.linalg.inv(F).transpose(-1, -2)
        J = torch.linalg.det(F)
        lnJ = torch.log(torch.clamp(J, min=1e-12))
        return self.mu * (F - FinvT) + self.lam * lnJ[..., None, None] * FinvT


class IMPState(NamedTuple):
    ins: INSState
    X: torch.Tensor        # (N, dim) point positions
    F: torch.Tensor        # (N, dim, dim) deformation gradients
    mask: torch.Tensor     # (N,) active-slot mask


class IMPMethod:
    """Material-point structure: volumes, constitutive law, kernel, and the
    grid <-> point transfers. ``V0`` goes to ``device``."""

    def __init__(self, V0, model: NeoHookean, kernel="BSPLINE_3",
                 device="cuda"):
        self.device = resolve_device(device)
        self.V0 = torch.as_tensor(V0, device=self.device)
        self.model = model
        self.kernel = kernel

    def interpolate_velocity(self, u: Vel, grid: StaggeredGrid,
                             X: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
        return interaction.interpolate_vel(u, grid, X, kernel=self.kernel,
                                           weights=mask)

    def velocity_gradient(self, u: Vel, grid: StaggeredGrid,
                          X: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
        return interaction.interpolate_gradient_vel(
            u, grid, X, kernel=self.kernel, weights=mask)

    def velocity_and_gradient(self, u: Vel, grid: StaggeredGrid,
                              X: torch.Tensor, mask: torch.Tensor):
        """(U, grad u) at the points from one stencil pass per component."""
        return interaction.interpolate_vel_and_gradient(
            u, grid, X, kernel=self.kernel, weights=mask)

    def spread_force(self, F_def: torch.Tensor, grid: StaggeredGrid,
                     X: torch.Tensor, mask: torch.Tensor) -> Vel:
        P = self.model.pk1(F_def)
        PFt = P @ F_def.transpose(-1, -2)
        return interaction.spread_stress(PFt, self.V0, grid, X,
                                         kernel=self.kernel, weights=mask)


class IMPExplicitIntegrator:
    """Explicit IMP coupling to the periodic staggered INS integrator: the
    midpoint pattern of ``IBExplicitIntegrator`` with the marker force
    replaced by the material-point stress divergence and the structure
    state extended with F."""

    def __init__(self, ins: INSStaggeredIntegrator, imp: IMPMethod,
                 scheme: str = "midpoint"):
        if scheme not in ("midpoint", "forward_euler"):
            raise ValueError(f"unknown IMP scheme {scheme!r}")
        self.ins = ins
        self.imp = imp
        self.scheme = scheme

    def initialize(self, X0, ins_state: Optional[INSState] = None,
                   mask=None) -> IMPState:
        kw = dict(dtype=self.ins.dtype, device=self.ins.device)
        X = torch.as_tensor(X0, **kw)
        N, dim = X.shape
        if ins_state is None:
            ins_state = self.ins.initialize()
        mask = torch.ones(N, **kw) if mask is None \
            else torch.as_tensor(mask, **kw)
        F = torch.eye(dim, **kw).expand(N, dim, dim).clone()
        return IMPState(ins=ins_state, X=X, F=F, mask=mask)

    def step(self, state: IMPState, dt: float) -> IMPState:
        grid = self.ins.grid
        imp = self.imp
        u_n = state.ins.u
        X_n, F_n = state.X, state.F
        eye = torch.eye(grid.dim, dtype=X_n.dtype, device=X_n.device)

        U_n, G_n = imp.velocity_and_gradient(u_n, grid, X_n, state.mask)
        if self.scheme == "midpoint":
            X_half = X_n + 0.5 * dt * U_n
            F_half = (eye + 0.5 * dt * G_n) @ F_n
        else:
            X_half, F_half = X_n, F_n

        f_eul = imp.spread_force(F_half, grid, X_half, state.mask)
        ins_new = self.ins.step(state.ins, dt, f=f_eul)

        if self.scheme == "midpoint":
            u_half = tuple(0.5 * (a + b) for a, b in zip(u_n, ins_new.u))
            U_half, G_half = imp.velocity_and_gradient(
                u_half, grid, X_half, state.mask)
            X_new = X_n + dt * U_half
            # the midpoint rule for dF/dt = G F: the half-step gradient
            # acts on the half-step state
            F_new = F_n + dt * G_half @ F_half
        else:
            X_new = X_n + dt * U_n
            F_new = (eye + dt * G_n) @ F_n
        return IMPState(ins=ins_new, X=X_new, F=F_new, mask=state.mask)

    def jacobians(self, state: IMPState) -> torch.Tensor:
        """det(F) per point (~1 for nearly incompressible motion)."""
        return torch.linalg.det(state.F)


def material_disc(grid: StaggeredGrid, center, radius: float,
                  points_per_cell: int = 2, dtype=torch.float64,
                  device="cuda"):
    """Uniformly seeded material points filling a disc/ball: positions
    (N, dim) and reference volumes (N,)."""
    h = min(grid.dx)
    spacing = h / points_per_cell
    axes = [np.arange(c - radius, c + radius + spacing / 2, spacing)
            for c in center]
    mesh = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([m.ravel() for m in mesh], axis=-1)
    keep = np.sum((pts - np.asarray(center)) ** 2, axis=-1) <= radius ** 2
    pts = pts[keep]
    dev = resolve_device(device)
    return (torch.as_tensor(pts, dtype=dtype, device=dev),
            torch.full((pts.shape[0],), spacing ** grid.dim, dtype=dtype,
                       device=dev))
