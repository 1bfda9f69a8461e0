"""ex4 with adaptive refinement: the 3D elastic shell in a background
stream, tracked by a marker-tagged refined window on the composite
two-level hierarchy, on the GPU (port of
``examples/IB/explicit/ex4_amr/main.py``).

Run:  python -m ibamr_tpu_torch.examples.ib_explicit_ex4_amr [INPUT]

The input file is the reference's (``examples/IB/explicit/ex4_amr/
input3d`` by default), run as it is, in f32 with the projection tolerance
3e-6 as the reference runs it. The transfers are the scatter oracle (the
input names no transfer engine), so the path launches no hand kernel.
The run loop is ex0_amr's: chunks of ``regrid_interval`` steps with a
marker-tagged regrid between them under ``IB::advanceHierarchy``, one
JSONL record per chunk of ``step, t, volume_drift, window_lo, max_div,
x_center``, and at every ``viz_dump_interval`` the hierarchy's velocity
(binary ``.vtm``) and the markers (``.vtp``) to ``Main.viz_dirname``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.amr import box_mac_to_cc
from ibamr_tpu_torch.amr_ins import advance_two_level_ib_regridding
from ibamr_tpu_torch.examples.ib_explicit_ex0_amr import (add_stream,
                                                          amr_integrator,
                                                          warn_dt)
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.io.vtk import VizWriter
from ibamr_tpu_torch.models.shell3d import make_spherical_shell, shell_volume
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples", "IB",
    "explicit", "ex4_amr", "input3d")


def build(db: InputDatabase, device="cuda"):
    """The two-level IB integrator, its initial state on ``device`` (f32)
    and the shell's center."""
    device = resolve_device(device)
    grid_db = db.get_database_with_default("GriddingAlgorithm")
    sh = db.get_database("Shell")
    geo = db.get_database("CartesianGeometry")
    grid = StaggeredGrid(
        n=tuple(int(v) for v in geo.get_int_array("n_cells")),
        x_lo=tuple(float(v) for v in geo.get_array("x_lo")),
        x_up=tuple(float(v) for v in geo.get_array("x_up")))
    center = tuple(float(v) for v in sh.get_array("center"))
    struct = make_spherical_shell(
        sh.get_int("n_lat"), sh.get_int("n_lon"), sh.get_float("radius"),
        center=center, stiffness=sh.get_float("stiffness"),
        rest_length_factor=sh.get_float("rest_length_factor", 1.0),
        aspect=sh.get_float("aspect", 1.0))
    integ = amr_integrator(db, grid, struct,
                           grid_db.get_int("tag_buffer", 3), device)
    state = add_stream(integ.initialize(torch.as_tensor(
        struct.vertices, dtype=torch.float32, device=integ.device)),
        db.get_database_with_default("Stream").get_float("u0", 0.0))
    return integ, state, center


def run(db: InputDatabase, device="cuda"):
    """Build from ``db`` on ``device`` and run to ``num_steps``; returns
    the final ``(integ, state)`` (the integrator of the last window)."""
    main_db = db.get_database("Main")
    ins_db = db.get_database("INSStaggeredHierarchyIntegrator")
    grid_db = db.get_database_with_default("GriddingAlgorithm")
    integ, state, center = build(db, device)
    grid = integ.grid

    dt = ins_db.get_float("dt")
    warn_dt(integ, state, dt)
    num_steps = ins_db.get_int("num_steps")
    regrid_int = grid_db.get_int("regrid_interval", 10)
    viz_int = main_db.get_int("viz_dump_interval", 0)
    viz_dir = main_db.get_string("viz_dirname", "viz_ex4_amr")
    metrics = MetricsLogger(main_db.get_string("log_file", "") or None)
    viz = VizWriter(viz_dir, grid)
    tm = TimerManager.instance()

    v0 = float(shell_volume(state.X, center))
    last_viz = [0]

    def on_chunk(ci, cs, done):
        Xh = cs.X.cpu().numpy()
        metrics.log({
            "step": done,
            "t": float(cs.fluid.t),
            "volume_drift": float(shell_volume(
                cs.X, tuple(np.mean(Xh, axis=0)))) / v0 - 1.0,
            "window_lo": list(ci.box.lo),
            "max_div": float(ci.core.max_divergence(cs.fluid)),
            "x_center": float(torch.mean(cs.X[:, 0])),
        })
        if viz_int and done // viz_int > last_viz[0]:
            last_viz[0] = done // viz_int
            with tm.scope("Main::viz"):
                fg = ci.box.fine_grid(grid)
                viz.dump_hierarchy(
                    done, float(cs.fluid.t), [grid, fg],
                    [{"u": tuple(c.cpu().numpy() for c in
                                 stencils.fc_to_cc(cs.fluid.uc))},
                     {"u": tuple(c.cpu().numpy() for c in
                                 box_mac_to_cc(cs.fluid.uf))}],
                    fmt="binary")
                viz.dump(done, float(cs.fluid.t), markers=Xh)

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
