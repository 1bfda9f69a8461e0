"""Penalty IB: massive immersed boundaries (port of
``ibamr_tpu/integrators/penalty_ib.py``; Kim and Peskin's penalty
formulation).

Each massive marker i carries a shadow mass point Y_i of mass m_i
tethered to the IB marker X_i by a stiff penalty spring K. The IB markers
move with the fluid as usual; the mass points obey Newton's law with
gravity, and the spring carries inertia and weight to the fluid:

  F_fluid,i = K (Y_i - X_i)              (added to the elastic force)
  m_i dV_i/dt = -K (Y_i - X_i) + m_i g   (symplectic Euler in the step)
  dY_i/dt = V_i
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ibamr_tpu_torch.integrators.ib import (IBExplicitIntegrator, IBMethod,
                                            IBState)
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator, INSState

Vel = Tuple[torch.Tensor, ...]


class PenaltyIBState(NamedTuple):
    ib: IBState            # fluid and IB markers
    Y: torch.Tensor        # (N, dim) mass-point positions
    V: torch.Tensor        # (N, dim) mass-point velocities


class PenaltyIBIntegrator:
    """``IBExplicitIntegrator`` plus massive shadow points. ``mass`` (N,)
    marker masses (0: massless, no spring), ``stiffness`` the penalty
    spring constant K, ``gravity`` (dim,) g; they go to the INS
    integrator's device."""

    def __init__(self, ins: INSStaggeredIntegrator, ib: IBMethod,
                 mass, stiffness: float, gravity=None,
                 scheme: str = "midpoint"):
        self.inner = IBExplicitIntegrator(ins, ib, scheme=scheme)
        self.ins = ins
        self.ib = ib
        kw = dict(dtype=ins.dtype, device=ins.device)
        self.mass = torch.as_tensor(mass, **kw)
        self.K = float(stiffness)
        if gravity is None:
            gravity = (0.0,) * ins.grid.dim
        self.gravity = torch.as_tensor(gravity, **kw)

    def initialize(self, X0, ins_state: Optional[INSState] = None,
                   mask=None) -> PenaltyIBState:
        ib_state = self.inner.initialize(X0, ins_state=ins_state, mask=mask)
        return PenaltyIBState(ib=ib_state, Y=ib_state.X,
                              V=torch.zeros_like(ib_state.X))

    def step(self, state: PenaltyIBState, dt: float) -> PenaltyIBState:
        ib_state, Y, V = state
        massive = (self.mass > 0.0).to(Y.dtype)[:, None]

        # the penalty spring force on the fluid markers, added to the
        # elastic force through the force_fn seam
        base_force = self.ib.compute_force

        def force_with_penalty(X, U, t):
            return base_force(X, U, t) + self.K * massive * (Y - X)

        ib_penalized = IBMethod(self.ib.specs, kernel=self.ib.kernel,
                                force_fn=force_with_penalty,
                                fast=self.ib.fast)
        stepper = IBExplicitIntegrator(self.ins, ib_penalized,
                                       scheme=self.inner.scheme)
        ib_new = stepper.step(ib_state, dt)

        # symplectic-Euler mass-point update (reaction and gravity);
        # massless slots get zero acceleration through the where
        pos = self.mass[:, None] > 0.0
        safe_mass = torch.where(self.mass > 0.0, self.mass,
                                torch.ones_like(self.mass))[:, None]
        acc = torch.where(pos, -self.K * (Y - ib_new.X) / safe_mass
                          + self.gravity, torch.zeros_like(Y))
        V_new = massive * (V + dt * acc)
        Y_new = Y + dt * V_new * massive
        return PenaltyIBState(ib=ib_new, Y=Y_new, V=V_new)


def advance_penalty_ib(integ: PenaltyIBIntegrator, state: PenaltyIBState,
                       dt: float, num_steps: int) -> PenaltyIBState:
    for _ in range(num_steps):
        state = integ.step(state, dt)
    return state
