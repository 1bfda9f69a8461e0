"""2D periodic elastic membrane, the ex0-equivalent (port of
``ibamr_tpu/models/membrane2d.py``).

A closed fiber loop of markers with springs between neighbours (and
optional beams) in a periodic box of incompressible fluid on one uniform
level, with the delta the input names (IB_4 by default). Its transfers
are the scatter/gather oracle: the reference has no 2D Pallas program, so
this path runs no hand kernel.

``build_membrane_example`` takes keyword parameters or an
``InputDatabase`` with the reference's sections (``CartesianGeometry``,
``INSStaggeredHierarchyIntegrator``, ``IBMethod``, ``Membrane``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ib import (IBExplicitIntegrator, IBMethod,
                                            IBState)
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
from ibamr_tpu_torch.io.structures import StructureData


def make_circle_membrane(num_markers: int, radius: float,
                         center: Tuple[float, float],
                         stiffness: float,
                         rest_length_factor: float = 1.0,
                         aspect: float = 1.0,
                         bend_rigidity: float = 0.0) -> StructureData:
    """Closed marker loop with nearest-neighbour springs (and beams when
    ``bend_rigidity`` > 0). ``aspect`` != 1 makes an ellipse, which
    relaxes toward a circle at constant area; ``rest_length_factor`` < 1
    makes the loop taut everywhere."""
    theta = 2.0 * math.pi * np.arange(num_markers) / num_markers
    verts = np.stack([center[0] + radius * aspect * np.cos(theta),
                      center[1] + (radius / aspect) * np.sin(theta)], axis=1)
    ds = 2.0 * math.pi * radius / num_markers
    idx0 = np.arange(num_markers)
    idx1 = (idx0 + 1) % num_markers
    springs = np.stack([
        idx0, idx1,
        np.full(num_markers, stiffness),
        np.full(num_markers, ds * rest_length_factor)], axis=1)
    data = StructureData(name="membrane2d", vertices=verts, springs=springs)
    if bend_rigidity > 0.0:
        prev = (idx0 - 1) % num_markers
        data.beams = np.stack([
            prev, idx0, idx1,
            np.full(num_markers, bend_rigidity)], axis=1)
    return data


def build_membrane_example(
        n_cells: int = 64,
        num_markers: int = 128,
        radius: float = 0.25,
        aspect: float = 1.0,
        stiffness: float = 1.0,
        rest_length_factor: float = 0.5,
        rho: float = 1.0,
        mu: float = 0.05,
        kernel: str = "IB_4",
        convective_op_type: str = "centered",
        dtype=torch.float32,
        device="cuda",
        input_db=None) -> Tuple[IBExplicitIntegrator, IBState]:
    """Assemble the ex0-equivalent simulation on ``device`` (the GPU
    unless ``device="cpu"``). The sections of ``input_db``, where given,
    override the keyword defaults as the reference reads them."""
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
        ib_db = input_db.get_database_with_default("IBMethod")
        kernel = ib_db.get_string("delta_fcn", kernel)
        mem = input_db.get_database_with_default("Membrane")
        num_markers = mem.get_int("num_markers", num_markers)
        radius = mem.get_float("radius", radius)
        aspect = mem.get_float("aspect", aspect)
        stiffness = mem.get_float("stiffness", stiffness)
        rest_length_factor = mem.get_float("rest_length_factor",
                                           rest_length_factor)

    grid = StaggeredGrid(n=n, x_lo=x_lo, x_up=x_up)
    ins = INSStaggeredIntegrator(grid, rho=rho, mu=mu,
                                 convective_op_type=convective_op_type,
                                 dtype=dtype, device=device)
    center = tuple(0.5 * (lo + hi) for lo, hi in zip(x_lo, x_up))
    structure = make_circle_membrane(
        num_markers, radius, center=center, stiffness=stiffness,
        rest_length_factor=rest_length_factor, aspect=aspect)
    ib = IBMethod(structure.force_specs(dtype=dtype, device=ins.device),
                  kernel=kernel)
    integ = IBExplicitIntegrator(ins, ib, scheme="midpoint")
    return integ, integ.initialize(structure.vertices)
