"""2D immersed elastic FE disc, the IBFE/explicit/ex0-equivalent
configuration (port of ``ibamr_tpu/models/fe_disc2d.py``): a soft
neo-Hookean TRI3 disc in a periodic incompressible fluid, coupled with
regularized deltas through the scatter oracle. Pre-stretched by the
area-preserving map diag(s, 1/s) and released, it oscillates and relaxes
back toward the round reference shape while incompressibility holds its
area.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ibamr_tpu_torch.fe import disc_mesh, neo_hookean
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ib import IBExplicitIntegrator, IBState
from ibamr_tpu_torch.integrators.ibfe import IBFEMethod
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator


def build_fe_disc_example(
        n_cells: int = 64,
        n_rings: int = 6,
        radius: float = 0.2,
        stretch: float = 1.0,
        mu_s: float = 1.0,
        lam_s: float = 4.0,
        rho: float = 1.0,
        mu: float = 0.05,
        kernel: str = "IB_4",
        coupling: str = "unified",
        convective_op_type: str = "centered",
        dtype=torch.float32,
        device="cuda",
        input_db=None) -> Tuple[IBExplicitIntegrator, IBState]:
    """Assemble the IBFE-ex0-equivalent simulation on ``device`` (the GPU
    unless ``device="cpu"``); the sections of ``input_db``, where given,
    override the keyword defaults as the reference reads them.
    ``stretch`` != 1 applies diag(stretch, 1/stretch) about the center."""
    n = (n_cells, n_cells)
    x_lo, x_up = (0.0, 0.0), (1.0, 1.0)
    if input_db is not None:
        geo = input_db.get_database_with_default("CartesianGeometry")
        n = tuple(int(v) for v in geo.get_int_array("n_cells", list(n)))
        x_lo = tuple(float(v) for v in geo.get_array("x_lo", list(x_lo)))
        x_up = tuple(float(v) for v in geo.get_array("x_up", list(x_up)))
        ins_db = input_db.get_database_with_default(
            "INSStaggeredHierarchyIntegrator")
        rho = ins_db.get_float("rho", rho)
        mu = ins_db.get_float("mu", mu)
        convective_op_type = ins_db.get_string("convective_op_type",
                                               convective_op_type)
        fe_db = input_db.get_database_with_default("IBFEMethod")
        kernel = fe_db.get_string("delta_fcn", kernel)
        coupling = fe_db.get_string("coupling", coupling)
        disc = input_db.get_database_with_default("Disc")
        n_rings = disc.get_int("n_rings", n_rings)
        radius = disc.get_float("radius", radius)
        stretch = disc.get_float("stretch", stretch)
        mu_s = disc.get_float("shear_modulus", mu_s)
        lam_s = disc.get_float("bulk_modulus", lam_s)

    grid = StaggeredGrid(n=n, x_lo=x_lo, x_up=x_up)
    ins = INSStaggeredIntegrator(grid, rho=rho, mu=mu,
                                 convective_op_type=convective_op_type,
                                 dtype=dtype, device=device)
    center = tuple(0.5 * (lo + hi) for lo, hi in zip(x_lo, x_up))
    mesh = disc_mesh(radius=radius, center=center, n_rings=n_rings)
    fe = IBFEMethod(mesh, neo_hookean(mu_s, lam_s), kernel=kernel,
                    coupling=coupling, dtype=dtype, device=ins.device)
    integ = IBExplicitIntegrator(ins, fe, scheme="midpoint")

    X0 = mesh.nodes.copy()
    if stretch != 1.0:
        c = np.asarray(center)
        A = np.diag([stretch, 1.0 / stretch])
        X0 = (X0 - c) @ A.T + c
    return integ, integ.initialize(X0)
