"""Generalized IB: rods with director frames and torque coupling (port of
``ibamr_tpu/integrators/gib.py``).

Each Lagrangian node carries an orthonormal director triad; the rod model
gives torques as well as forces, the fluid turns the frames with half its
vorticity, and the torques enter the fluid as the couple force density
f_N = 1/2 curl(N delta(x - X)). One midpoint step:

  U^n = J u^n,  w^n = 1/2 J curl(u^n);
  X, D at n+1/2 by half-step translation and rotation;
  (F, N) = the rod force and torque at the half step (autograd);
  f = S F + 1/2 curl(S N);  the fluid step with f;
  the corrector with the midpoint velocities.

3D only. The transfers are the scatter oracle (``ops.interaction``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator, INSState
from ibamr_tpu_torch.ops import interaction, stencils
from ibamr_tpu_torch.ops.rods import (RodSpecs, rod_energy, rod_force_torque,
                                      rotate_frames)

Vel = Tuple[torch.Tensor, ...]


class GIBState(NamedTuple):
    ins: INSState
    X: torch.Tensor       # (N, 3) node positions
    D: torch.Tensor       # (N, 3, 3) director triads (rows = directors)


def _dcc(f, axis, h):
    return (torch.roll(f, -1, axis) - torch.roll(f, 1, axis)) / (2.0 * h)


def _cc_to_face(f, d):
    """A cell-centered tensor shifted to face centering along axis d."""
    return 0.5 * (f + torch.roll(f, 1, d))


def couple_force_mac(n_cc: Vel, grid: StaggeredGrid) -> Vel:
    """The MAC force of the torque couple 1/2 curl(n) of a cell-centered
    torque density n."""
    dx = grid.dx
    curl = (
        _dcc(n_cc[2], 1, dx[1]) - _dcc(n_cc[1], 2, dx[2]),
        _dcc(n_cc[0], 2, dx[2]) - _dcc(n_cc[2], 0, dx[0]),
        _dcc(n_cc[1], 0, dx[0]) - _dcc(n_cc[0], 1, dx[1]),
    )
    return tuple(0.5 * _cc_to_face(curl[d], d) for d in range(3))


class GeneralizedIBMethod:
    """Rod-structure coupling integrator on a periodic 3D INS integrator
    (``specs`` from ``ops.rods.make_rods`` on the integrator's device)."""

    def __init__(self, ins: INSStaggeredIntegrator, specs: RodSpecs,
                 kernel="IB_4"):
        if ins.grid.dim != 3:
            raise ValueError("generalized IB requires a 3D grid")
        self.ins = ins
        self.specs = specs
        self.kernel = kernel

    def _marker_velocities(self, u: Vel, X: torch.Tensor):
        grid = self.ins.grid
        U = interaction.interpolate_vel(u, grid, X, kernel=self.kernel)
        w_cc = stencils.curl_3d_cc(u, grid.dx)
        w = torch.stack([interaction.interpolate(w_cc[d], grid, X,
                                                 centering="cell",
                                                 kernel=self.kernel)
                         for d in range(3)], dim=-1)
        return U, 0.5 * w

    def _spread_force_torque(self, F: torch.Tensor, N: torch.Tensor,
                             X: torch.Tensor) -> Vel:
        grid = self.ins.grid
        f = interaction.spread_vel(F, grid, X, kernel=self.kernel)
        n_cc = tuple(interaction.spread(N[:, d], grid, X, centering="cell",
                                        kernel=self.kernel)
                     for d in range(3))
        return tuple(a + b for a, b in zip(f, couple_force_mac(n_cc, grid)))

    def step(self, state: GIBState, dt: float) -> GIBState:
        u_n = state.ins.u
        X_n, D_n = state.X, state.D

        U_n, w_n = self._marker_velocities(u_n, X_n)
        X_half = X_n + 0.5 * dt * U_n
        D_half = rotate_frames(D_n, 0.5 * dt * w_n)

        F, N = rod_force_torque(X_half, D_half, self.specs)
        f = self._spread_force_torque(F, N, X_half)
        ins_new = self.ins.step(state.ins, dt, f=f)

        u_mid = tuple(0.5 * (a + b) for a, b in zip(u_n, ins_new.u))
        U_half, w_half = self._marker_velocities(u_mid, X_half)
        return GIBState(ins=ins_new, X=X_n + dt * U_half,
                        D=rotate_frames(D_n, dt * w_half))

    def initialize(self, X0, D0,
                   ins_state: Optional[INSState] = None) -> GIBState:
        kw = dict(dtype=self.ins.dtype, device=self.ins.device)
        if ins_state is None:
            ins_state = self.ins.initialize()
        return GIBState(ins=ins_state, X=torch.as_tensor(X0, **kw),
                        D=torch.as_tensor(D0, **kw))

    def energy(self, state: GIBState) -> torch.Tensor:
        return rod_energy(state.X, state.D, self.specs)


def advance_gib(method: GeneralizedIBMethod, state: GIBState, dt: float,
                num_steps: int) -> GIBState:
    for _ in range(num_steps):
        state = method.step(state, dt)
    return state
