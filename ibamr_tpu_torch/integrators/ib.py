"""Immersed-boundary coupling, explicit schemes (port of
``ibamr_tpu/integrators/ib.py``). One midpoint timestep:

  U^n       = J(X^n) u^n                       (interpolate)
  X^{n+1/2} = X^n + dt/2 U^n
  F^{n+1/2} = Force(X^{n+1/2}, U^n)
  f         = S(X^{n+1/2}) F^{n+1/2}           (spread)
  u^{n+1}   = INS step with body force f
  U^{n+1/2} = J(X^{n+1/2}) (u^n + u^{n+1})/2
  X^{n+1}   = X^n + dt U^{n+1/2}

The step is eager PyTorch; ``advance_ib`` is a plain loop of steps
where the reference scans. With the packed transfer engine it reads two
host values per step: the overflow flags of the pack and the hit of the
half-step refresh. An engine without a refresh (the tile engine) buckets
twice per step instead and reads the overflow flags of each bucketing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins import INSState, INSStaggeredIntegrator
from ibamr_tpu_torch.ops import forces as force_mod
from ibamr_tpu_torch.ops import interaction

Vel = Tuple[torch.Tensor, ...]


class IBState(NamedTuple):
    """Coupled fluid + structure state."""
    ins: INSState
    X: torch.Tensor       # (N, dim) marker positions
    U: torch.Tensor       # (N, dim) marker velocities
    mask: torch.Tensor    # (N,) 0/1 active-slot mask


class IBMethod:
    """Marker-IB structure: force specs, delta kernel and an optional
    transfer engine (None = the scatter/gather oracle)."""

    def __init__(self, specs: force_mod.ForceSpecs, kernel="IB_4",
                 fast=None):
        self.specs = specs
        self.kernel = kernel
        self.fast = fast
        self.engine_name = None

    def compute_force(self, X: torch.Tensor, U: torch.Tensor,
                      t) -> torch.Tensor:
        return force_mod.compute_lagrangian_force(X, U, self.specs)

    def prepare(self, X: torch.Tensor, mask: torch.Tensor):
        """Per-position transfer context (marker buckets), shared by all
        spread/interp calls at the same X within a step."""
        if self.fast is None:
            return None
        return self.fast.buckets(X, mask)

    def refresh(self, ctx, X: torch.Tensor, mask: torch.Tensor):
        """Slot-preserving context refresh at a drifted position; returns
        ``(ctx, hit)``, or ``(None, None)`` when the engine has no refresh
        path and the caller must re-prepare."""
        if ctx is None or self.fast is None:
            return None, None
        r = getattr(self.fast, "refresh", None)
        if r is None:
            return None, None
        return r(ctx, X, weights=mask)

    def _check_grid(self, grid: StaggeredGrid) -> None:
        eg = self.fast.grid
        if (eg.n, eg.x_lo, eg.x_up) != (grid.n, grid.x_lo, grid.x_up):
            raise ValueError(f"fast engine grid {eg} != call grid {grid}; "
                             "rebuild the engine for this grid")

    def interpolate_velocity(self, u: Vel, grid: StaggeredGrid,
                             X: torch.Tensor, mask: torch.Tensor,
                             ctx=None) -> torch.Tensor:
        if self.fast is not None:
            self._check_grid(grid)
            return self.fast.interpolate_vel(u, X, weights=mask, b=ctx)
        return interaction.interpolate_vel(u, grid, X, kernel=self.kernel,
                                           weights=mask)

    def spread_force(self, F: torch.Tensor, grid: StaggeredGrid,
                     X: torch.Tensor, mask: torch.Tensor,
                     ctx=None) -> Vel:
        if self.fast is not None:
            self._check_grid(grid)
            return self.fast.spread_vel(F, X, weights=mask, b=ctx)
        return interaction.spread_vel(F, grid, X, kernel=self.kernel,
                                      weights=mask)


class IBExplicitIntegrator:
    """Explicit IB coupling of an INS integrator and an IBMethod."""

    def __init__(self, ins: INSStaggeredIntegrator, ib: IBMethod,
                 scheme: str = "midpoint"):
        if scheme not in ("midpoint", "forward_euler"):
            raise ValueError(f"unknown IB time stepping scheme {scheme!r}")
        self.ins = ins
        self.ib = ib
        self.scheme = scheme

    def initialize(self, X0, ins_state: Optional[INSState] = None,
                   mask=None) -> IBState:
        """Markers at ``X0`` in the fluid state ``ins_state`` (default: at
        rest), with the active-slot ``mask`` (default: every marker)."""
        kw = dict(dtype=self.ins.dtype, device=self.ins.device)
        X = torch.as_tensor(X0, **kw)
        if ins_state is None:
            ins_state = self.ins.initialize()
        if mask is None:
            mask = torch.ones(X.shape[0], **kw)
        return IBState(ins=ins_state, X=X, U=torch.zeros_like(X),
                       mask=torch.as_tensor(mask, **kw))

    def step(self, state: IBState, dt: float) -> IBState:
        return self.step_with_stats(state, dt)[0]

    def step_with_stats(self, state: IBState, dt: float):
        """``step`` plus ``{"refresh_hit": bool or None}``: True when the
        half-step context came from the slot-preserving refresh, False
        when the drift bound forced a full re-pack, None when the engine
        has no refresh (the half-step context is bucketed anew)."""
        grid = self.ins.grid
        ib = self.ib
        u_n, X_n = state.ins.u, state.X

        ctx_n = ib.prepare(X_n, state.mask)
        U_n = ib.interpolate_velocity(u_n, grid, X_n, state.mask, ctx=ctx_n)
        refresh_hit = None
        if self.scheme == "midpoint":
            X_half = X_n + 0.5 * dt * U_n
            ctx_h, refresh_hit = ib.refresh(ctx_n, X_half, state.mask)
            if ctx_h is None:
                ctx_h = ib.prepare(X_half, state.mask)
        else:
            X_half, ctx_h = X_n, ctx_n

        t_half = state.ins.t + 0.5 * dt
        F_half = ib.compute_force(X_half, U_n, t_half)
        f_eul = ib.spread_force(F_half, grid, X_half, state.mask, ctx=ctx_h)

        ins_new = self.ins.step(state.ins, dt, f=f_eul)

        if self.scheme == "midpoint":
            u_half = tuple(0.5 * (a + b) for a, b in zip(u_n, ins_new.u))
            U_out = ib.interpolate_velocity(u_half, grid, X_half,
                                            state.mask, ctx=ctx_h)
            X_new = X_n + dt * U_out
        else:
            U_out = U_n
            X_new = X_n + dt * U_n
        return (IBState(ins=ins_new, X=X_new, U=U_out, mask=state.mask),
                {"refresh_hit": refresh_hit})

    def total_marker_force(self, state: IBState) -> torch.Tensor:
        """The sum of the active markers' Lagrangian forces -> (dim,)."""
        F = self.ib.compute_force(state.X, state.U, state.ins.t)
        return torch.sum(F * state.mask[:, None], dim=0)


def advance_ib(integrator: IBExplicitIntegrator, state: IBState, dt: float,
               num_steps: int) -> IBState:
    """Advance ``num_steps`` fixed-dt steps."""
    for _ in range(num_steps):
        state = integrator.step(state, dt)
    return state


def polygon_area(X: torch.Tensor) -> torch.Tensor:
    """Shoelace area of a closed 2D marker loop (the membrane's volume-
    conservation diagnostic) -> 0-dim tensor."""
    x, y = X[:, 0], X[:, 1]
    xn, yn = torch.roll(x, -1), torch.roll(y, -1)
    return 0.5 * torch.abs(torch.sum(x * yn - xn * y))
