"""IBFE cantilever stiffness and shape optimization: match a target tip
deflection by differentiating through the FE coupling (port of
``ibamr_tpu/design/cantilever.py``).

A neo-Hookean QUAD4 beam is anchored along its left edge (a stiff tether
to its reference positions) and loaded by a distributed transverse body
force; after a short rollout the tip sags by an amount set by the
stiffness and the thickness. The design parameters, ``log_mu`` (log
shear modulus: Adam steps are multiplicative and positivity is free) and
``log_thick`` (log thickness scale of the undeformed section), reach the
physics through ``neo_hookean`` and the initial geometry: ``IBFEMethod``
is built inside the objective, so the nodal force (itself an autograd
gradient of the strain energy, ``fe.fem.energy_grads``) carries their
derivatives, and the transfers carry the rest.

Objective: ``(tip_deflection - target)^2``, a calibration problem: the
stiffness and section that give a prescribed compliance.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.fe.fem import neo_hookean
from ibamr_tpu_torch.fe.mesh import rect_quad_mesh
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ib import IBExplicitIntegrator
from ibamr_tpu_torch.integrators.ibfe import IBFEMethod
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
from ibamr_tpu_torch.utils.hierarchy_driver import checkpointed_step


def build_cantilever_problem(n: int = 32, nx: int = 8, ny: int = 2,
                             num_steps: int = 10, dt: float = 2e-3,
                             mu: float = 0.05, load: float = -4.0,
                             k_anchor: float = 2e3,
                             target_tip: float = -0.02,
                             dtype=torch.float32,
                             remat: Optional[str] = "full", device="cuda"
                             ) -> Tuple[Callable, dict]:
    """``(objective, params0)`` for a :class:`~ibamr_tpu_torch.design.
    loop.DesignLoop`. The beam spans x in [0.3, 0.7] at mid-channel; its
    left edge is anchored, every other node carries the transverse
    ``load`` per unit mass; ``objective(params)`` returns the squared
    mismatch between the rolled-out mean tip deflection and
    ``target_tip``."""
    dev = resolve_device(device)
    grid = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    ins = INSStaggeredIntegrator(grid, rho=1.0, mu=mu, dtype=dtype,
                                 device=dev)
    mesh = rect_quad_mesh(nx, ny, x_lo=(0.30, 0.46), x_up=(0.70, 0.54))
    nodes = mesh.nodes
    base = nodes[:, 0] <= nodes[:, 0].min() + 1e-12
    tip = nodes[:, 0] >= nodes[:, 0].max() - 1e-12
    y_mid = float(0.5 * (nodes[:, 1].min() + nodes[:, 1].max()))
    kw = dict(dtype=dtype, device=dev)
    base_w = torch.as_tensor(base.astype(np.float64), **kw)[:, None]
    free_w = 1.0 - base_w
    tip_idx = torch.as_tensor(np.nonzero(tip)[0], device=dev)
    X_ref = torch.as_tensor(nodes, **kw)

    def objective(params):
        mu_s = torch.exp(params["log_mu"])
        lam_s = 4.0 * mu_s                     # fixed compressibility ratio
        thick = torch.exp(params["log_thick"])
        # the shape parameter scales the undeformed section about the
        # beam axis (the anchor tether targets the same scaled reference)
        X0 = torch.stack([X_ref[:, 0],
                          y_mid + thick * (X_ref[:, 1] - y_mid)], dim=1)

        def body_force(x, t):
            tether = -k_anchor * (x - X0) * base_w
            pull = torch.stack([torch.zeros_like(x[:, 0]),
                                torch.full_like(x[:, 0], load)], dim=1)
            return tether + pull * free_w

        # built inside the objective: mu_s and lam_s live in the
        # neo-Hookean closure, so the weak-form force carries them
        fe = IBFEMethod(mesh, neo_hookean(mu_s, lam_s),
                        body_force=body_force, dtype=dtype, device=dev)
        integ = IBExplicitIntegrator(ins, fe)
        st = integ.initialize(X0)
        step = integ.step if remat is None \
            else checkpointed_step(integ.step, remat)
        for _ in range(num_steps):
            st = step(st, dt)
        defl = torch.mean(st.X[tip_idx, 1]) - y_mid
        return (defl - target_tip) ** 2

    params0 = {"log_mu": torch.tensor(0.0, **kw),
               "log_thick": torch.tensor(0.0, **kw)}
    return objective, params0
