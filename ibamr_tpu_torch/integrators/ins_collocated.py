"""Collocated (cell-centered) INS integrator with an approximate
projection (port of ``ibamr_tpu/integrators/ins_collocated.py``).

All velocity components live at cell centers; the Poisson problem is
driven by the divergence of the face-averaged velocity and the
correction is the cell-centered central gradient, so the residual
cell-centered divergence is O(h^2) rather than roundoff. The periodic
solves are the spectral ones of ``solvers/fft.py``; walled axes go
through ``solvers/fastdiag.py`` (Dirichlet-at-face velocity, Neumann
pressure), with odd (velocity) or even (pressure) reflection ghosts in
every explicit stencil.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ibamr_tpu_torch.bc import (DIRICHLET, NEUMANN, DomainBC, SideBC,
                                dirichlet_axis, ghost_reflect_coeff,
                                neumann_axis, periodic_axis)
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins_walls import pin_normal
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.ops.stencils import axis_slice
from ibamr_tpu_torch.solvers import fft
from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver

Vel = Tuple[torch.Tensor, ...]


class CollocatedINSState(NamedTuple):
    u: Vel                 # dim cell-centered components
    p: torch.Tensor        # cell-centered pressure
    n_prev: Vel            # previous convective rate (AB2)
    t: torch.Tensor
    k: int                 # step counter (host)


class INSCollocatedIntegrator:
    """Cell-centered approximate-projection INS; ``wall_axes[d]`` puts
    no-slip walls on both sides of axis d."""

    def __init__(self, grid: StaggeredGrid, rho: float = 1.0,
                 mu: float = 0.01, convective_op_type: str = "centered",
                 wall_axes=None, dtype=torch.float32, device="cuda"):
        if convective_op_type not in ("centered", "upwind", "none"):
            raise ValueError(
                f"unknown convective_op_type {convective_op_type!r}")
        self.grid = grid
        self.rho = float(rho)
        self.mu = float(mu)
        self.convective_op_type = convective_op_type
        self.dtype = dtype
        self.device = resolve_device(device)
        self.wall_axes = (tuple(bool(w) for w in wall_axes)
                          if wall_axes is not None
                          else (False,) * grid.dim)
        self._vel_solver = None
        self._phi_solver = None
        if any(self.wall_axes):
            vel_bc = DomainBC(axes=tuple(
                dirichlet_axis() if w else periodic_axis()
                for w in self.wall_axes))
            phi_bc = DomainBC(axes=tuple(
                neumann_axis() if w else periodic_axis()
                for w in self.wall_axes))
            self._vel_solver = FastDiagSolver(grid, vel_bc,
                                              ("cc",) * grid.dim,
                                              device=self.device)
            self._phi_solver = FastDiagSolver(grid, phi_bc,
                                              ("cc",) * grid.dim,
                                              device=self.device)

    # -- wall-aware cell-centered stencils -----------------------------------
    def _ext(self, c: torch.Tensor, d: int, sign: float) -> torch.Tensor:
        """One ghost layer along axis d by homogeneous reflection (sign
        -1: velocity Dirichlet, +1: pressure Neumann), the coefficient
        from ``bc.ghost_reflect_coeff``."""
        kind = DIRICHLET if sign < 0 else NEUMANN
        r = ghost_reflect_coeff(SideBC(kind), self.grid.dx[d])
        n = c.shape[d]
        lo = r * axis_slice(c, d, 0, 1)
        hi = r * axis_slice(c, d, n - 1, n)
        return torch.cat([lo, c, hi], dim=d)

    def _d_central(self, c, d, sign):
        """Central first derivative along d, wall-aware when flagged."""
        dx = self.grid.dx[d]
        if not self.wall_axes[d]:
            return (torch.roll(c, -1, d) - torch.roll(c, 1, d)) / (2.0 * dx)
        e = self._ext(c, d, sign)
        n = c.shape[d]
        return (axis_slice(e, d, 2, n + 2)
                - axis_slice(e, d, 0, n)) / (2.0 * dx)

    def _d_upwind(self, c, d, a, sign):
        dx = self.grid.dx[d]
        if not self.wall_axes[d]:
            dm = (c - torch.roll(c, 1, d)) / dx
            dp = (torch.roll(c, -1, d) - c) / dx
        else:
            e = self._ext(c, d, sign)
            n = c.shape[d]
            dm = (c - axis_slice(e, d, 0, n)) / dx
            dp = (axis_slice(e, d, 2, n + 2) - c) / dx
        return torch.where(a > 0, dm, dp)

    def _lap(self, c, sign):
        g = self.grid
        acc = torch.zeros_like(c)
        for d in range(g.dim):
            dx = g.dx[d]
            if not self.wall_axes[d]:
                acc = acc + (torch.roll(c, -1, d) - 2.0 * c
                             + torch.roll(c, 1, d)) / dx ** 2
            else:
                e = self._ext(c, d, sign)
                n = c.shape[d]
                acc = acc + (axis_slice(e, d, 2, n + 2) - 2.0 * c
                             + axis_slice(e, d, 0, n)) / dx ** 2
        return acc

    # -- state ----------------------------------------------------------------
    def initialize(self, u0=None,
                   u0_arrays: Optional[Vel] = None) -> CollocatedINSState:
        """The initial state: ``u0_arrays``, or ``u0`` as per-component
        callables ``u0[d](coords, t)`` or one vector callable
        ``u0(coords, t) -> [array, ...]`` at the cell centers, t = 0."""
        g = self.grid
        kw = dict(dtype=self.dtype, device=self.device)
        if u0_arrays is not None:
            u = tuple(torch.as_tensor(c, **kw) for c in u0_arrays)
        elif u0 is not None:
            coords = g.cell_centers(self.dtype, self.device)
            vals = (u0(coords, 0.0) if callable(u0)
                    else [u0[d](coords, 0.0) for d in range(g.dim)])
            u = tuple(torch.broadcast_to(torch.as_tensor(vals[d], **kw),
                                         g.n).clone()
                      for d in range(g.dim))
        else:
            u = tuple(torch.zeros(g.n, **kw) for _ in range(g.dim))
        return CollocatedINSState(
            u=u, p=torch.zeros(g.n, **kw),
            n_prev=tuple(torch.zeros(g.n, **kw) for _ in range(g.dim)),
            t=torch.zeros((), **kw), k=0)

    # -- approximate projection ----------------------------------------------
    def _approx_project(self, u: Vel) -> Tuple[Vel, torch.Tensor]:
        """MAC divergence of the face-averaged velocity drives the
        Poisson solve; the cell-centered central gradient corrects."""
        g = self.grid
        dx = g.dx
        u_face = []
        for d in range(g.dim):
            uf = 0.5 * (u[d] + torch.roll(u[d], 1, d))
            if self.wall_axes[d]:
                uf = pin_normal(uf, d, self.wall_axes)
            u_face.append(uf)
        div = stencils.divergence(tuple(u_face), dx)
        if self._phi_solver is not None:
            phi = self._phi_solver.solve(div, alpha=0.0, beta=1.0,
                                         zero_nullspace=True)
        else:
            phi = fft.solve_poisson_periodic(div, dx)
        grad_cc = tuple(self._d_central(phi, d, +1.0) for d in range(g.dim))
        return tuple(c - gc for c, gc in zip(u, grad_cc)), phi

    # -- one step -------------------------------------------------------------
    def step(self, state: CollocatedINSState, dt: float,
             f: Optional[Vel] = None) -> CollocatedINSState:
        g = self.grid
        rho, mu = self.rho, self.mu
        dx = g.dx
        u, p = state.u, state.p
        k = int(state.k)
        walls = any(self.wall_axes)
        if self.convective_op_type == "none":
            n_star = tuple(torch.zeros_like(c) for c in u)
            n_curr = n_star
        else:
            out = []
            for d in range(g.dim):
                acc = torch.zeros_like(u[d])
                for a in range(g.dim):
                    if self.convective_op_type == "centered":
                        dd = self._d_central(u[d], a, -1.0)
                    else:
                        dd = self._d_upwind(u[d], a, u[a], -1.0)
                    acc = acc + u[a] * dd
                out.append(acc)
            n_curr = tuple(out)
            c1, c2 = (1.0, 0.0) if k == 0 else (1.5, -0.5)
            n_star = tuple(c1 * a + c2 * b
                           for a, b in zip(n_curr, state.n_prev))

        grad_p = tuple(self._d_central(p, d, +1.0) for d in range(g.dim))
        rhs = []
        for d in range(g.dim):
            lap = (self._lap(u[d], -1.0) if walls
                   else stencils.laplacian(u[d], dx))
            r = (rho / dt) * u[d] + 0.5 * mu * lap \
                - rho * n_star[d] - grad_p[d]
            if f is not None:
                r = r + f[d]
            rhs.append(r)
        if self._vel_solver is not None:
            u_star = tuple(self._vel_solver.solve(c, alpha=rho / dt,
                                                  beta=-0.5 * mu)
                           for c in rhs)
        else:
            u_star = tuple(fft.solve_helmholtz_periodic(
                c, dx, alpha=rho / dt, beta=-0.5 * mu) for c in rhs)

        u_new, phi0 = self._approx_project(u_star)
        phi = (rho / dt) * phi0
        p_new = p + phi - (0.5 * mu * dt / rho) * (
            self._lap(phi, +1.0) if walls else stencils.laplacian(phi, dx))
        return CollocatedINSState(u=u_new, p=p_new, n_prev=n_curr,
                                  t=state.t + dt, k=k + 1)

    # -- diagnostics ----------------------------------------------------------
    def kinetic_energy(self, state: CollocatedINSState) -> torch.Tensor:
        ke = sum(torch.sum(torch.square(c)) for c in state.u)
        return 0.5 * self.rho * ke * self.grid.cell_volume

    def max_divergence(self, state: CollocatedINSState) -> torch.Tensor:
        """Cell-centered central divergence (O(h^2), not roundoff)."""
        g = self.grid
        div = torch.zeros(g.n, dtype=state.u[0].dtype,
                          device=state.u[0].device)
        for d in range(g.dim):
            div = div + self._d_central(state.u[d], d, -1.0)
        return torch.max(torch.abs(div))


def advance_collocated(integ: INSCollocatedIntegrator,
                       state: CollocatedINSState, dt: float,
                       num_steps: int,
                       f: Optional[Vel] = None) -> CollocatedINSState:
    """``num_steps`` fixed-dt steps (a loop where the reference scans)."""
    for _ in range(num_steps):
        state = integ.step(state, dt, f)
    return state
