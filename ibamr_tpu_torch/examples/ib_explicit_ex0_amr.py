"""ex0 with adaptive refinement: a 2D elastic membrane advected by a
background stream and tracked by a marker-tagged refined window on a
two-level composite hierarchy, on the GPU (port of
``examples/IB/explicit/ex0_amr/main.py``).

Run:  python -m ibamr_tpu_torch.examples.ib_explicit_ex0_amr [INPUT]

The input file is the reference's (``examples/IB/explicit/ex0_amr/
input2d`` by default), run as it is, in f32 with the projection tolerance
3e-6 as the reference runs it. The fine box is fitted to the markers with
``GriddingAlgorithm.tag_buffer`` cells of padding; the run advances in
chunks of ``regrid_interval`` steps with a marker-tagged regrid between
them, under the timer ``IB::advanceHierarchy``. After each chunk one
JSONL record of ``step, t, area_drift, window_lo, max_div, x_center`` to
``Main.log_file``; at every ``viz_dump_interval`` the markers to
``<viz_dirname>/markers.<step>.csv`` and the hierarchy's cell-centered
velocity to ``<viz_dirname>/amr_<step>.vtm``. Paths in the input file are
relative to the working directory.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.amr import box_mac_to_cc
from ibamr_tpu_torch.amr_ins import (TwoLevelIBINS,
                                     advance_two_level_ib_regridding,
                                     box_from_markers)
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ib import IBMethod, polygon_area
from ibamr_tpu_torch.io.vtk import VizWriter
from ibamr_tpu_torch.models.membrane2d import make_circle_membrane
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples", "IB",
    "explicit", "ex0_amr", "input2d")


def _host(tree):
    return tuple(c.cpu().numpy() for c in tree)


def add_stream(state, u0: float):
    """The uniform (div-free) background stream ``u0`` along x added to
    both levels: it survives the composite projection."""
    fluid = state.fluid
    return state._replace(fluid=fluid._replace(
        uc=(fluid.uc[0] + u0,) + fluid.uc[1:],
        uf=(fluid.uf[0] + u0,) + fluid.uf[1:]))


def build(db: InputDatabase, device="cuda"):
    """The two-level IB integrator and its initial state on ``device``,
    in f32."""
    device = resolve_device(device)
    grid_db = db.get_database_with_default("GriddingAlgorithm")
    mem_db = db.get_database("Membrane")
    geo = db.get_database("CartesianGeometry")
    grid = StaggeredGrid(
        n=tuple(int(v) for v in geo.get_int_array("n_cells")),
        x_lo=tuple(float(v) for v in geo.get_array("x_lo")),
        x_up=tuple(float(v) for v in geo.get_array("x_up")))
    struct = make_circle_membrane(
        mem_db.get_int("num_markers"), mem_db.get_float("radius"),
        tuple(float(v) for v in mem_db.get_array("center")),
        stiffness=mem_db.get_float("stiffness"),
        rest_length_factor=mem_db.get_float("rest_length_factor", 1.0),
        aspect=mem_db.get_float("aspect", 1.0))
    integ = amr_integrator(db, grid, struct,
                           grid_db.get_int("tag_buffer", 4), device)
    return integ, add_stream(integ.initialize(torch.as_tensor(
        struct.vertices, dtype=torch.float32, device=integ.device)),
        db.get_database_with_default("Stream").get_float("u0", 0.0))


def amr_integrator(db, grid, struct, pad, device):
    """The f32 TwoLevelIBINS of an AMR driver: the box fitted to the
    structure's f32 positions (as the reference fits it) with ``pad``
    cells, the density and viscosity of the input, and the reference's
    f32 projection tolerance 3e-6 (above f32 roundoff, so FGMRES stops on
    the tolerance, not the restart cap)."""
    ins_db = db.get_database("INSStaggeredHierarchyIntegrator")
    ib = IBMethod(struct.force_specs(dtype=torch.float32, device=device),
                  kernel=db.get_database_with_default("IBMethod")
                  .get_string("delta_fcn", "IB_4"))
    box = box_from_markers(grid, struct.vertices.astype(np.float32),
                           pad=pad)
    return TwoLevelIBINS(grid, box, ib, rho=ins_db.get_float("rho", 1.0),
                         mu=ins_db.get_float("mu"), proj_tol=3e-6,
                         device=device)


def warn_dt(integ, state, dt: float) -> None:
    lim = float(integ.core.stable_dt(state.fluid))
    if dt > lim:
        print(f"WARNING: dt={dt:g} exceeds the explicit-predictor "
              f"stability advisory {lim:g} (finest-level viscous/CFL "
              "limit); expect blow-up")


def run(db: InputDatabase, device="cuda"):
    """Build from ``db`` on ``device`` and run to ``num_steps``; returns
    the final ``(integ, state)`` (the integrator of the last window)."""
    main_db = db.get_database("Main")
    ins_db = db.get_database("INSStaggeredHierarchyIntegrator")
    grid_db = db.get_database_with_default("GriddingAlgorithm")
    integ, state = build(db, device)
    grid = integ.grid

    dt = ins_db.get_float("dt")
    warn_dt(integ, state, dt)
    num_steps = ins_db.get_int("num_steps")
    regrid_int = grid_db.get_int("regrid_interval", 20)
    viz_int = main_db.get_int("viz_dump_interval", 0)
    viz_dir = main_db.get_string("viz_dirname", "viz_ex0_amr")
    os.makedirs(viz_dir, exist_ok=True)
    metrics = MetricsLogger(main_db.get_string("log_file", "") or None)
    viz = VizWriter(viz_dir, grid)
    tm = TimerManager.instance()

    a0 = float(polygon_area(state.X))
    last_viz = [0]

    def on_chunk(ci, cs, done):
        metrics.log({
            "step": done,
            "t": float(cs.fluid.t),
            "area_drift": float(polygon_area(cs.X)) / a0 - 1.0,
            "window_lo": list(ci.box.lo),
            "max_div": float(ci.core.max_divergence(cs.fluid)),
            "x_center": float(torch.mean(cs.X[:, 0])),
        })
        if viz_int and done // viz_int > last_viz[0]:
            last_viz[0] = done // viz_int
            with tm.scope("Main::viz"):
                np.savetxt(os.path.join(viz_dir, f"markers.{done:06d}.csv"),
                           cs.X.cpu().numpy(), delimiter=",")
                fg = ci.box.fine_grid(grid)
                viz.dump_hierarchy(done, float(cs.fluid.t), [grid, fg], [
                    {"u": _host(stencils.fc_to_cc(cs.fluid.uc))},
                    {"u": _host(box_mac_to_cc(cs.fluid.uf))}])

    with tm.scope("IB::advanceHierarchy", block_on=state.X):
        integ, state = advance_two_level_ib_regridding(
            integ, state, dt, num_steps, regrid_interval=regrid_int,
            on_chunk=on_chunk)
    metrics.close()
    print(tm.report())
    return integ, state


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
