"""Eel2d gait optimization: the swim distance differentiated through the
solver (port of ``ibamr_tpu/design/eel_gait.py``).

An anguilliform swimmer as a ConstraintIB body (momentum-projection
coupling): the gait is a prescribed deformational velocity, a traveling
wave of lateral motion whose amplitude grows toward the tail, and the
body's rigid motion is left free, so any net displacement is
hydrodynamic thrust recovered by the momentum projection. The design
parameters (amplitude, frequency, wavenumber) reach every step:
``ConstraintIBMethod`` is built inside the objective, so the gait closure
carries them into every spread, interp and transform of the rollout, a
Python loop over ``checkpointed_step(method.step, remat)``.

Objective: the swim displacement ``mean_x(X_T) - mean_x(X_0)``. The wave
travels head to tail (+x), so thrust drives the body toward -x:
minimizing the objective means swimming farther.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.cib import RigidBodies
from ibamr_tpu_torch.integrators.constraint_ib import ConstraintIBMethod
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
from ibamr_tpu_torch.utils.hierarchy_driver import checkpointed_step


def build_eel(ns: int = 33, L: float = 0.5, center=(0.55, 0.5),
              dtype=torch.float32, device="cuda"
              ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """Straight horizontal filament of ``ns`` markers, head at
    ``center[0] - L/2`` and tail at ``+L/2``. Returns ``(X0, s, L)`` with
    ``s`` the head-to-tail arclength coordinate."""
    dev = resolve_device(device)
    s = torch.linspace(0.0, L, ns, dtype=dtype, device=dev)
    X0 = torch.stack([center[0] - L / 2 + s,
                      torch.full((ns,), center[1], dtype=dtype,
                                 device=dev)], dim=1)
    return X0, s, float(L)


def build_eel_gait_problem(n: int = 32, ns: int = 33, num_steps: int = 20,
                           dt: float = 2e-3, mu: float = 0.01,
                           L: float = 0.5, dtype=torch.float32,
                           remat: Optional[str] = "full", device="cuda"
                           ) -> Tuple[Callable, dict]:
    """``(objective, params0)`` for a :class:`~ibamr_tpu_torch.design.
    loop.DesignLoop`: ``objective(params)`` rolls the swimmer
    ``num_steps`` forward under the gait ``params`` and returns the
    signed swim displacement; ``remat`` checkpoints each step, so the
    reverse pass keeps one state per step."""
    dev = resolve_device(device)
    grid = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    ins = INSStaggeredIntegrator(grid, rho=1.0, mu=mu, dtype=dtype,
                                 device=dev)
    X0, s, L = build_eel(ns=ns, L=L, dtype=dtype, device=dev)
    bodies = RigidBodies(body_id=torch.zeros(ns, dtype=torch.int64,
                                             device=dev), n_bodies=1)

    def objective(params):
        A0, omega, k = params["A0"], params["omega"], params["k"]

        def gait(t, X):
            # the lateral velocity of y(s, t) = A0 (s/L) sin(k s - omega t)
            # (the method projects out its rigid part)
            uy = -(A0 * s / L) * omega * torch.cos(k * s - omega * t)
            return torch.stack([torch.zeros_like(uy), uy], dim=1)

        # built inside the objective: the gait closure carries the design
        # parameters into the physics of every step
        method = ConstraintIBMethod(ins, bodies, deformation_fn=gait)
        st = method.initialize(X0)
        com0 = torch.mean(st.X[:, 0])
        step = method.step if remat is None \
            else checkpointed_step(method.step, remat)
        for _ in range(num_steps):
            st = step(st, dt)
        return torch.mean(st.X[:, 0]) - com0

    params0 = {"A0": torch.tensor(0.08, dtype=dtype, device=dev),
               "omega": torch.tensor(8.0, dtype=dtype, device=dev),
               "k": torch.tensor(2.0 * math.pi / L, dtype=dtype,
                                 device=dev)}
    return objective, params0
