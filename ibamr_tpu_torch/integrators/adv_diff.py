"""Advection-diffusion integrator, semi-implicit and cell-centered (port of
``ibamr_tpu/integrators/adv_diff.py``).

Scalar transport dQ/dt + div(u Q) = kappa lap(Q) + src with AB2
extrapolated explicit convection and Crank-Nicolson diffusion, advected
by a MAC velocity (e.g. the INS integrator's). Several transported
quantities ride one state, each with its own diffusivity, source and
boundary conditions. The state is a NamedTuple of tensors; ``step`` is
eager PyTorch and reads nothing back to the host (the AB2 switch is a
``torch.where`` on the step counter ``k``, which stays on the device).
The Crank-Nicolson solve is spectral on the periodic grid, through the
overridable ``helmholtz_solve`` seam, and fast diagonalization for a
quantity with walls.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch import bc as bc_mod
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.ops.convection import advective_face_value
from ibamr_tpu_torch.solvers import fft
from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver

Vel = Tuple[torch.Tensor, ...]


class AdvDiffState(NamedTuple):
    """State of all transported quantities (one tensor per variable)."""
    Q: Tuple[torch.Tensor, ...]
    n_prev: Tuple[torch.Tensor, ...]   # previous convective rates (AB2)
    t: torch.Tensor
    k: torch.Tensor


class TransportedQuantity(NamedTuple):
    """Per-variable configuration. ``bc`` of None means fully periodic; a
    DomainBC with wall axes gets fast-diagonalization diffusion solves
    and ghost-lifted Crank-Nicolson boundary data (the advecting
    velocity must satisfy u.n = 0 at walls)."""
    name: str
    kappa: float = 0.0
    # source(coords, t, Q) -> tensor, or None
    source: Optional[Callable] = None
    convective_op_type: str = "upwind"   # "centered"|"upwind"|"cui"|"none"
    init: Optional[Callable] = None      # Q0(coords) -> tensor
    bc: Optional[object] = None          # bc.DomainBC or None
    # spatially-varying boundary data {(axis, side): tensor} overriding
    # the per-side constants
    bdry_data: Optional[dict] = None


def convective_flux_divergence(Q: torch.Tensor, u: Vel,
                               dx: Sequence[float],
                               scheme: str, bc=None,
                               bdry_data=None) -> torch.Tensor:
    """div(u Q) at cell centers from face fluxes; ``scheme`` picks the
    face value of Q (centered, upwind or CUI). With a walled ``bc`` the
    face states come from a BC-honoring ghost fill; the flux divergence
    keeps the roll form because the normal velocity vanishes on wall
    faces (pinned MAC layout)."""
    dim = Q.ndim
    need_ghosts = bc is not None and not bc.all_periodic
    if need_ghosts:
        g = 2
        Qg = bc_mod.fill_ghosts_cc(Q, bc, dx, bdry_data=bdry_data, width=g)
        interior = [slice(g, g + Q.shape[e]) for e in range(dim)]

        def at(d, s):
            sl = list(interior)
            sl[d] = slice(g + s, g + s + Q.shape[d])
            return Qg[tuple(sl)]
    else:
        def at(d, s):
            return torch.roll(Q, -s, d) if s else Q

    out = torch.zeros_like(Q)
    for d in range(dim):
        ud = u[d]
        if need_ghosts and not bc.axes[d].periodic:
            # pin the wall face (face 0 is both the boundary face and, by
            # the roll, the image of the opposite one) on a copy: the
            # caller's velocity is left as it is
            sl = [slice(None)] * dim
            sl[d] = slice(0, 1)
            ud = ud.clone()
            ud[tuple(sl)] = 0.0
        Qm = at(d, -1)                    # Q[i-1] at lower face i
        if scheme == "cui":
            qf = advective_face_value(Qm, Q, ud, scheme,
                                      Qmm=at(d, -2), Qpp=at(d, 1))
        else:
            qf = advective_face_value(Qm, Q, ud, scheme)
        flux = ud * qf
        out = out + (torch.roll(flux, -1, d) - flux) / dx[d]
    return out


class AdvDiffSemiImplicitIntegrator:
    """Semi-implicit advection-diffusion on the uniform level."""

    def __init__(self, grid: StaggeredGrid,
                 quantities: Sequence[TransportedQuantity],
                 dtype=torch.float32, device="cuda"):
        self.grid = grid
        self.quantities = tuple(quantities)
        self.dtype = dtype
        self.device = resolve_device(device)
        # solver seam: (rhs, dx, alpha, beta) -> solution
        self.helmholtz_solve = fft.solve_helmholtz_periodic
        self._wall_solvers = [
            FastDiagSolver(grid, q.bc, ("cc",) * grid.dim,
                           device=self.device)
            if q.bc is not None and not q.bc.all_periodic else None
            for q in self.quantities]

    def initialize(self, Q0: Optional[Sequence] = None) -> AdvDiffState:
        g = self.grid
        kw = dict(dtype=self.dtype, device=self.device)
        coords = g.cell_centers(self.dtype, self.device)
        Qs = []
        for i, q in enumerate(self.quantities):
            if Q0 is not None and Q0[i] is not None:
                arr = torch.as_tensor(Q0[i], **kw).expand(g.n).clone()
            elif q.init is not None:
                arr = torch.as_tensor(q.init(coords), **kw).expand(
                    g.n).clone()
            else:
                arr = torch.zeros(g.n, **kw)
            Qs.append(arr)
        zeros = tuple(torch.zeros(g.n, **kw) for _ in self.quantities)
        return AdvDiffState(Q=tuple(Qs), n_prev=zeros,
                            t=torch.zeros((), **kw),
                            k=torch.zeros((), dtype=torch.int32,
                                          device=self.device))

    def step(self, state: AdvDiffState, dt, u: Optional[Vel] = None,
             sources: Optional[Sequence] = None) -> AdvDiffState:
        """Advance one step. ``u`` is the MAC advection velocity (held
        fixed over the step); ``sources`` optionally overrides the
        per-variable sources with precomputed tensors (e.g. an IB-spread
        marker source)."""
        g = self.grid
        dx = g.dx
        coords = g.cell_centers(self.dtype, self.device)
        t_half = state.t + 0.5 * dt
        first = state.k == 0
        one = torch.ones((), dtype=self.dtype, device=self.device)
        c1 = torch.where(first, one, 1.5 * one)
        c2 = torch.where(first, 0.0 * one, -0.5 * one)

        newQ, newN = [], []
        for i, q in enumerate(self.quantities):
            Q = state.Q[i]
            if q.convective_op_type == "none" or u is None:
                n_curr = torch.zeros_like(Q)
                n_star = n_curr
            else:
                n_curr = convective_flux_divergence(
                    Q, u, dx, q.convective_op_type, bc=q.bc,
                    bdry_data=q.bdry_data)
                n_star = c1 * n_curr + c2 * state.n_prev[i]

            rhs = Q / dt - n_star
            wall_solver = self._wall_solvers[i]
            if q.kappa != 0.0:
                if wall_solver is not None:
                    # affine lifting: lap_bc(Q) = A Q + b, b = lap_bc(0);
                    # CN's RHS takes kappa/2 lap_bc(Q^n) + kappa/2 b
                    b_vec = bc_mod.laplacian_cc(
                        torch.zeros_like(Q), q.bc, dx,
                        bdry_data=q.bdry_data)
                    rhs = rhs + 0.5 * q.kappa * (
                        bc_mod.laplacian_cc(Q, q.bc, dx,
                                            bdry_data=q.bdry_data)
                        + b_vec)
                else:
                    rhs = rhs + 0.5 * q.kappa * stencils.laplacian(Q, dx)
            if sources is not None and sources[i] is not None:
                rhs = rhs + sources[i]
            elif q.source is not None:
                rhs = rhs + q.source(coords, t_half, Q)

            if q.kappa != 0.0:
                if wall_solver is not None:
                    Qn = wall_solver.solve(rhs, 1.0 / dt, -0.5 * q.kappa)
                else:
                    Qn = self.helmholtz_solve(rhs, dx, alpha=1.0 / dt,
                                              beta=-0.5 * q.kappa)
            else:
                Qn = dt * rhs
            newQ.append(Qn)
            newN.append(n_curr)

        return AdvDiffState(Q=tuple(newQ), n_prev=tuple(newN),
                            t=state.t + dt, k=state.k + 1)

    def total(self, state: AdvDiffState, i: int = 0) -> torch.Tensor:
        """Conserved integral of Q_i (periodic, conservative flux form)."""
        return torch.sum(state.Q[i]) * self.grid.cell_volume


def advance_adv_diff(integ: AdvDiffSemiImplicitIntegrator,
                     state: AdvDiffState, dt: float, num_steps: int,
                     u: Optional[Vel] = None) -> AdvDiffState:
    """Advance ``num_steps`` fixed-velocity steps."""
    for _ in range(num_steps):
        state = integ.step(state, dt, u=u)
    return state
