"""Incompressible Navier-Stokes on the periodic staggered grid (port of
the periodic branch of ``ibamr_tpu/integrators/ins.py``).

Per step (pressure-increment projection, AB2 convection, CN diffusion):
  1. N* = 3/2 N(u^n) - 1/2 N(u^{n-1})          (forward Euler on step 0)
  2. rhs = (rho/dt) u^n + (mu/2) lap u^n - rho N* - grad p^{n-1/2} + f
  3. u^{n+1}, p_inc from the fused spectral substep: Helmholtz solve,
     exact Leray projection and pressure increment in one batched
     rfftn/irfftn pair (``solvers/spectral_plan.py``)
  4. p^{n+1/2} = p^{n-1/2} + p_inc

Only the fully periodic path with centered/upwind (or no) convection is
ported; walls, PPM/CUI convection, divergence sources and the Krylov
solvers are not ported yet and raise. The initial velocity comes from
callables evaluated at each component's own face centers, or from raw
MAC arrays, as in the reference.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.ops.convection import convective_rate
from ibamr_tpu_torch.solvers import fft

Vel = Tuple[torch.Tensor, ...]


class INSState(NamedTuple):
    """INS state, shaped like the reference's pytree."""
    u: Vel                  # MAC velocity components
    p: torch.Tensor         # cell-centered pressure (at t^{n-1/2})
    n_prev: Vel             # N(u^{n-1}) for AB2 extrapolation
    t: torch.Tensor         # 0-dim time
    k: torch.Tensor         # 0-dim int32 step counter (AB2 bootstrap)


class INSStaggeredIntegrator:
    """Projection-method INS integrator on a periodic uniform MAC grid.
    ``convective_op_type`` in {"centered", "upwind", "none"}."""

    def __init__(self, grid: StaggeredGrid, rho: float = 1.0,
                 mu: float = 0.01, convective_op_type: str = "centered",
                 dtype=torch.float32, device="cuda"):
        op = convective_op_type.lower()
        if op in ("ppm", "cui"):
            raise NotImplementedError(
                f"convective_op_type {op!r} is not ported yet")
        if op not in ("centered", "upwind", "none"):
            raise ValueError(f"unknown convective_op_type {op!r}")
        self.grid = grid
        self.rho = float(rho)
        self.mu = float(mu)
        self.convective_op_type = op
        self.dtype = dtype
        self.device = resolve_device(device)
        self._convective = (None if op == "none"
                            else partial(convective_rate, scheme=op))

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

    def step(self, state: INSState, dt: float,
             f: Optional[Vel] = None) -> INSState:
        """Advance one timestep with an optional MAC body force ``f``
        held fixed over the step."""
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

        lap_u = stencils.laplacian_vel(u, dx)
        gp = stencils.gradient(p, dx)
        rhs = []
        for d in range(g.dim):
            r = (rho / dt) * u[d] + 0.5 * mu * lap_u[d] \
                - rho * n_star[d] - gp[d]
            if f is not None:
                r = r + f[d]
            rhs.append(r)
        u_new, p_inc = fft.helmholtz_project_periodic(
            tuple(rhs), dx, alpha=rho / dt, beta=-0.5 * mu,
            pinc_coeffs=(rho / dt, -0.5 * mu))
        return INSState(u=u_new, p=p + p_inc, n_prev=n_curr,
                        t=state.t + dt, k=state.k + 1)

    def cfl_dt(self, state: INSState, cfl: float = 0.5) -> float:
        """Largest stable dt by the advective CFL condition (a host
        read; the analog of the reference's global-min dt reduction)."""
        umax = max(float(torch.max(torch.abs(c))) for c in state.u)
        if umax == 0.0:
            return math.inf
        return cfl * min(self.grid.dx) / umax

    def kinetic_energy(self, state: INSState) -> torch.Tensor:
        ke = sum(torch.sum(torch.square(c)) for c in state.u)
        return 0.5 * self.rho * ke * self.grid.cell_volume

    def max_divergence(self, state: INSState) -> torch.Tensor:
        return torch.max(torch.abs(stencils.divergence(state.u,
                                                       self.grid.dx)))
