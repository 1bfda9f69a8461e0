"""Incompressible Navier-Stokes on the staggered grid (port of
``ibamr_tpu/integrators/ins.py``).

Per step (pressure-increment projection, AB2 convection, CN diffusion):
  1. N* = 3/2 N(u^n) - 1/2 N(u^{n-1})          (forward Euler on step 0)
  2. rhs = (rho/dt) u^n + (mu/2) lap u^n - rho N* - grad p^{n-1/2} + f
  3. u^{n+1}, p_inc from the fused spectral substep: Helmholtz solve,
     exact Leray projection and pressure increment in one batched
     rfftn/irfftn pair (``solvers/spectral_plan.py``)
  4. p^{n+1/2} = p^{n-1/2} + p_inc

On the fully periodic path steps 3 and 4 are the fused spectral substep
(``spectral_dtype`` picks its transform precision: None, bf16 operands,
or the f64 twin plan). With no-slip walls (``wall_axes``, optionally
moving: ``wall_tangential``) or with a divergence source ``q``, they are
the separate Helmholtz solve, the exact projection and the pressure
update, through the fast-diagonalization seams of
``integrators/ins_walls.py`` or the periodic FFT solves. PPM and CUI
convection, and any convection with walls, take the ghost-padded
``convective_rate_bc``. The initial velocity comes from callables
evaluated at each component's own face centers, or from raw MAC arrays,
as in the reference.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.ops.convection import (convective_rate,
                                            convective_rate_bc)
from ibamr_tpu_torch.solvers import fft, spectral_plan
from ibamr_tpu_torch.utils.cuda_graph import Graphed
from ibamr_tpu_torch.utils.tree import tree_map

Vel = Tuple[torch.Tensor, ...]


class INSState(NamedTuple):
    """INS state, shaped like the reference's pytree."""
    u: Vel                  # MAC velocity components
    p: torch.Tensor         # cell-centered pressure (at t^{n-1/2})
    n_prev: Vel             # N(u^{n-1}) for AB2 extrapolation
    t: torch.Tensor         # 0-dim time
    k: torch.Tensor         # 0-dim int32 step counter (AB2 bootstrap)


class INSStaggeredIntegrator:
    """Projection-method INS integrator on a uniform MAC grid.
    ``convective_op_type`` in {"centered", "upwind", "ppm", "cui", "none"}
    (case-insensitive). ``wall_axes`` puts homogeneous no-slip walls on
    both sides of the marked axes; ``wall_tangential[(d, e, side)]`` is
    component d's tangential velocity on the side (0 = lo, 1 = hi) wall
    of axis e (a moving lid). ``spectral_dtype`` ("bf16", "f64" or None)
    is honored by the fully periodic fused path only."""

    def __init__(self, grid: StaggeredGrid, rho: float = 1.0,
                 mu: float = 0.01, convective_op_type: str = "centered",
                 dtype=torch.float32,
                 wall_axes: Optional[Tuple[bool, ...]] = None,
                 wall_tangential=None, spectral_dtype=None, device="cuda"):
        op = convective_op_type.lower()
        if op not in ("centered", "upwind", "ppm", "cui", "none"):
            raise ValueError(f"unknown convective_op_type {op!r}")
        self.grid = grid
        self.rho = float(rho)
        self.mu = float(mu)
        self.convective_op_type = op
        self.dtype = dtype
        self.device = resolve_device(device)
        self._step_graphs: dict = {}
        self.wall_axes = (tuple(bool(w) for w in wall_axes)
                          if wall_axes is not None else (False,) * grid.dim)
        if len(self.wall_axes) != grid.dim:
            raise ValueError(
                f"wall_axes has {len(self.wall_axes)} entries for a "
                f"{grid.dim}D grid")
        self.spectral_dtype = spectral_plan.canonical_spectral_dtype(
            spectral_dtype)
        if self.spectral_dtype is not None and any(self.wall_axes):
            raise ValueError(
                "spectral_dtype requires the fully-periodic fused "
                f"spectral path; wall_axes={self.wall_axes}")
        self.wall_tangential = dict(wall_tangential or {})
        for key in self.wall_tangential:
            ok = (isinstance(key, tuple) and len(key) == 3
                  and 0 <= key[0] < grid.dim and 0 <= key[1] < grid.dim
                  and key[0] != key[1] and key[2] in (0, 1)
                  and self.wall_axes[key[1]])
            if not ok:
                raise ValueError(
                    f"wall_tangential key {key!r} must be (component d, "
                    f"wall axis e != d, side in {{0, 1}}) with "
                    f"wall_axes[e] set; wall_axes={self.wall_axes}")
        # solver and stencil seams: fast diagonalization with walls, FFT
        # without; the sharded step swaps them for the pencil solves and
        # the halo stencils of parallel/mesh.py
        self.fused_stokes = None
        self.divergence = stencils.divergence
        self.wall_ops = None
        if any(self.wall_axes):
            from ibamr_tpu_torch.integrators import ins_walls

            ops = ins_walls.WallOps(grid, self.wall_axes,
                                    tangential=self.wall_tangential,
                                    device=self.device)
            self.wall_ops = ops
            self.helmholtz_vel_solve = ops.helmholtz_vel
            self.project = ops.project
            self.laplacian_vel = ops.laplacian_vel
            self.pressure_gradient = ops.pressure_gradient
            self.laplacian_cc = ops.laplacian_cc
        else:
            self.helmholtz_vel_solve = fft.solve_helmholtz_periodic_vel
            self.project = fft.project_divergence_free
            self.laplacian_vel = stencils.laplacian_vel
            self.pressure_gradient = stencils.gradient
            self.laplacian_cc = stencils.laplacian
            self.fused_stokes = fft.helmholtz_project_periodic
        # walls or PPM/CUI take the ghost-padded convection; periodic
        # centered/upwind keep the roll form
        if op == "none":
            self._convective = None
        elif any(self.wall_axes) or op in ("ppm", "cui"):
            self._convective = partial(
                convective_rate_bc, scheme=op, wall_axes=self.wall_axes,
                wall_tangential=self.wall_tangential)
        else:
            self._convective = partial(convective_rate, scheme=op)

    def initialize(self, u0=None, u0_arrays: Optional[Vel] = None
                   ) -> INSState:
        """The initial state: the fluid at rest, or the velocity ``u0``,
        either a sequence of per-component callables ``u0[d](coords, t)``
        or one vector callable ``u0(coords, t) -> [array, ...]`` (what
        ``utils.gridfunctions.function_from_db`` returns, called once per
        component), each component evaluated at its own face centers; or
        the raw MAC arrays ``u0_arrays``."""
        g, kw = self.grid, dict(dtype=self.dtype, device=self.device)
        if u0_arrays is not None:
            u = tuple(torch.as_tensor(c, **kw) for c in u0_arrays)
        elif u0 is not None:
            def eval_comp(d):
                coords = g.face_centers(d, self.dtype, self.device)
                val = u0(coords, 0.0)[d] if callable(u0) \
                    else u0[d](coords, 0.0)
                return torch.broadcast_to(torch.as_tensor(val, **kw),
                                          g.n).clone()

            u = tuple(eval_comp(d) for d in range(g.dim))
        else:
            u = tuple(torch.zeros(g.n, **kw) for _ in range(g.dim))
        return INSState(u=u,
                        p=torch.zeros(g.n, **kw),
                        n_prev=tuple(torch.zeros(g.n, **kw)
                                     for _ in range(g.dim)),
                        t=torch.zeros((), **kw),
                        k=torch.zeros((), dtype=torch.int32,
                                      device=self.device))

    def step(self, state: INSState, dt: float, f: Optional[Vel] = None,
             q: Optional[torch.Tensor] = None) -> INSState:
        """Advance one timestep with an optional MAC body force ``f`` held
        fixed over the step and an optional cell-centered divergence
        source ``q`` (``div u^{n+1} = q``)."""
        g = self.grid
        rho, mu, dx = self.rho, self.mu, g.dx
        u, p = state.u, state.p

        if self._convective is None:
            n_curr = n_star = tuple(torch.zeros_like(c) for c in u)
        else:
            n_curr = self._convective(u, dx)
            first = state.k == 0
            c1 = torch.where(first, 1.0, 1.5).to(self.dtype)
            c2 = torch.where(first, 0.0, -0.5).to(self.dtype)
            n_star = tuple(c1 * a + c2 * b
                           for a, b in zip(n_curr, state.n_prev))

        lap_u = self.laplacian_vel(u, dx)
        gp = self.pressure_gradient(p, dx)
        rhs = []
        for d in range(g.dim):
            r = (rho / dt) * u[d] + 0.5 * mu * lap_u[d] \
                - rho * n_star[d] - gp[d]
            if f is not None:
                r = r + f[d]
            rhs.append(r)
        # the fused path holds only while the seams are the stock
        # periodic FFT ones
        use_fused = (
            self.fused_stokes is not None and q is None
            and self.helmholtz_vel_solve is fft.solve_helmholtz_periodic_vel
            and self.project is fft.project_divergence_free)
        if use_fused:
            extra = ({"spectral_dtype": self.spectral_dtype}
                     if self.spectral_dtype is not None else {})
            u_new, p_inc = self.fused_stokes(
                tuple(rhs), dx, alpha=rho / dt, beta=-0.5 * mu,
                pinc_coeffs=(rho / dt, -0.5 * mu), **extra)
            p_new = p + p_inc
        else:
            u_star = self.helmholtz_vel_solve(tuple(rhs), dx,
                                              alpha=rho / dt, beta=-0.5 * mu)
            u_new, phi0 = self.project(u_star, dx, q=q)
            phi = (rho / dt) * phi0
            p_new = p + phi \
                - (0.5 * mu * dt / rho) * self.laplacian_cc(phi, dx)
        return INSState(u=u_new, p=p_new, n_prev=n_curr,
                        t=state.t + dt, k=state.k + 1)

    def cfl_dt(self, state: INSState, cfl: float = 0.5) -> float:
        """Largest stable dt by the advective CFL condition (a host
        read; the analog of the reference's global-min dt reduction).
        This and the two diagnostics below take block-resident state
        through the blocks' reductions (``parallel/spmd.py``)."""
        umax = max(float(torch.max(torch.abs(c))) for c in state.u)
        if umax == 0.0:
            return math.inf
        return cfl * min(self.grid.dx) / umax

    def kinetic_energy(self, state: INSState) -> torch.Tensor:
        ke = sum(torch.sum(torch.square(c)) for c in state.u)
        return 0.5 * self.rho * ke * self.grid.cell_volume

    def max_divergence(self, state: INSState) -> torch.Tensor:
        return torch.max(torch.abs(self.divergence(state.u, self.grid.dx)))


def advance(integrator: INSStaggeredIntegrator, state: INSState, dt: float,
            num_steps: int, f: Optional[Vel] = None,
            q: Optional[torch.Tensor] = None) -> INSState:
    """Advance ``num_steps`` fixed-dt steps (a loop where the reference
    scans). On the card, with no body force or source, the step is
    captured once per dt as a CUDA graph and replayed (a walled 2D step is
    ~650 kernels of ~1 µs; the result is bitwise the eager loop of
    ``integrator.step``)."""
    if (state.u[0].device.type != "cuda" or f is not None or q is not None
            or num_steps < 2):
        for _ in range(num_steps):
            state = integrator.step(state, dt, f, q=q)
        return state
    graph = integrator._step_graphs.get(float(dt))
    if graph is None:
        graph = Graphed(lambda s: integrator.step(s, dt), state)
        integrator._step_graphs[float(dt)] = graph
    for _ in range(num_steps):
        state = graph(state)
    return tree_map(torch.clone, state)
