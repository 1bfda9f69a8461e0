"""IB coupling on inflow/outflow (open-boundary) boxes: flow past an
immersed structure (port of ``ibamr_tpu/integrators/ib_open.py``).

The open solver stores velocities face-complete (+1 on each component's
own non-periodic axis); the transfers use the periodic lower-face layout.
The structure keeps delta-support clearance from every boundary, which
makes the conversion exact: interpolation reads the lower faces, and
spreading appends a zero upper boundary face. In 2D the transfers run on
the scatter oracle. ``advance_ib_open`` is a loop where the reference
scans.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins_open import (INSOpenIntegrator,
                                                  OpenINSState)
from ibamr_tpu_torch.ops.stencils import (mac_complete_from_periodic,
                                          mac_periodic_from_complete)

Vel = Tuple[torch.Tensor, ...]


class IBOpenState(NamedTuple):
    fluid: OpenINSState
    X: torch.Tensor
    U: torch.Tensor
    mask: torch.Tensor
    # the net Lagrangian force spread during the last step (at X_half,
    # U_n, t + dt/2); zeros before the first step
    F_net: torch.Tensor


class IBOpenIntegrator:
    """Explicit midpoint IB coupling over the open-boundary INS step.
    ``ib`` is a marker IB method (``integrators.ib.IBMethod``); ``x_lo``
    places the solver's index box in space (default: the origin)."""

    def __init__(self, ins: INSOpenIntegrator, ib,
                 x_lo: Optional[Sequence[float]] = None):
        self.ins = ins
        self.ib = ib
        dim = len(ins.n)
        x_lo = tuple(float(v) for v in (x_lo or (0.0,) * dim))
        x_up = tuple(x_lo[d] + ins.n[d] * ins.dx[d] for d in range(dim))
        self.grid = StaggeredGrid(n=tuple(ins.n), x_lo=x_lo, x_up=x_up)

    def _to_lower(self, u: Vel) -> Vel:
        """Face-complete to the periodic lower-face layout."""
        return mac_periodic_from_complete(u, self.grid.n)

    def _to_complete(self, f: Vel) -> Vel:
        """The periodic lower-face layout to face-complete."""
        return mac_complete_from_periodic(f)

    def initialize(self, X0, fluid: Optional[OpenINSState] = None,
                   mask=None) -> IBOpenState:
        """Markers at ``X0`` (cast to the fluid's dtype) in ``fluid``
        (default: at rest)."""
        if fluid is None:
            fluid = self.ins.initialize()
        kw = dict(dtype=self.ins.solver.dtype, device=self.ins.solver.device)
        X = torch.as_tensor(X0, **kw)
        mask = (torch.ones(X.shape[0], **kw) if mask is None
                else torch.as_tensor(mask, **kw))
        return IBOpenState(fluid=fluid, X=X, U=torch.zeros_like(X),
                           mask=mask, F_net=torch.zeros(X.shape[1], **kw))

    def step(self, state: IBOpenState, dt=None) -> IBOpenState:
        """One midpoint step; ``dt`` None is the construction dt."""
        dt_arg = dt
        if dt is None:
            dt = self.ins.dt
        grid, ib, fluid = self.grid, self.ib, state.fluid
        X_n = state.X
        u_low = self._to_lower(fluid.u)
        U_n = ib.interpolate_velocity(u_low, grid, X_n, state.mask)
        X_half = X_n + 0.5 * dt * U_n
        F = ib.compute_force(X_half, U_n, fluid.t + 0.5 * dt)
        ctx = ib.prepare(X_half, state.mask)
        f_per = ib.spread_force(F, grid, X_half, state.mask, ctx=ctx)
        fluid_new = self.ins.step(fluid, dt=dt_arg,
                                  f=self._to_complete(f_per))
        u_mid = tuple(0.5 * (a + b) for a, b in
                      zip(u_low, self._to_lower(fluid_new.u)))
        U_half = ib.interpolate_velocity(u_mid, grid, X_half, state.mask,
                                         ctx=ctx)
        return IBOpenState(fluid=fluid_new, X=X_n + dt * U_half, U=U_half,
                           mask=state.mask,
                           F_net=torch.sum(F * state.mask[:, None], dim=0))

    def body_force_on_fluid(self, state: IBOpenState) -> torch.Tensor:
        """The net structural force applied to the fluid during the last
        step (the negative of the hydrodynamic force on the body)."""
        return state.F_net

    def cfl_dt(self, state: IBOpenState, cfl: float = 0.5) -> float:
        return self.ins.cfl_dt(state.fluid, cfl)


def advance_ib_open(integ: IBOpenIntegrator, state: IBOpenState,
                    num_steps: int) -> IBOpenState:
    """``num_steps`` steps at the construction dt."""
    for _ in range(num_steps):
        state = integ.step(state)
    return state
