"""Lid-driven cavity driver: the wall-bounded Navier-Stokes validation on
the GPU (port of ``examples/navier_stokes/cavity2d/main.py``).

Run:  python -m ibamr_tpu_torch.examples.navier_stokes_cavity2d [INPUT]

The input file is the reference's (``examples/navier_stokes/cavity2d/
input2d`` by default), run as it is: no-slip walls on all four sides, the
lid (the hi wall of axis 1) moving at ``U_lid``, f32. Chunks of
``Main.log_interval`` steps run under the timer ``advance``; after each,
one JSONL record ``step, t, u_center_min, max_div`` goes to
``Main.log_jsonl`` and, every ``viz_dump_interval`` steps, the pressure to
``<viz_dirname>/cavity_<step>.vti``. The last record holds the final
``u(x = 0.5, y)`` centerline for the Ghia comparison. Paths in the input
file are relative to the working directory.
"""

from __future__ import annotations

import os
import sys

import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator, advance
from ibamr_tpu_torch.io.vtk import write_vti
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples",
    "navier_stokes", "cavity2d", "input2d")


def build(db: InputDatabase, device="cuda", dtype=torch.float32):
    """The cavity's integrator and its initial state (fluid at rest)."""
    geo = db.get_database("CartesianGeometry")
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    grid = StaggeredGrid(n=tuple(geo.get_int_array("n")),
                         x_lo=tuple(geo.get_float_array("x_lo")),
                         x_up=tuple(geo.get_float_array("x_up")))
    integ = INSStaggeredIntegrator(
        grid, rho=idb.get_float("rho", 1.0), mu=idb.get_float("mu"),
        convective_op_type=idb.get_string("convective_op_type", "ppm"),
        dtype=dtype, wall_axes=(True, True),
        # component 0's tangential velocity on the hi wall of axis 1
        wall_tangential={(0, 1, 1): idb.get_float("U_lid", 1.0)},
        device=device)
    return integ, integ.initialize()


def centerline(state, n):
    """u(x = 0.5, y): the column of u_0 at i = n_0 / 2, on the host."""
    return state.u[0][n[0] // 2, :].detach().cpu().numpy()


def run(db: InputDatabase, device="cuda"):
    """Run the cavity of ``db`` to ``num_steps`` on ``device`` in f32;
    returns the final state."""
    main_db = db.get_database("Main")
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    integ, st = build(db, device)
    n = integ.grid.n
    viz_dir = main_db.get_string("viz_dirname", "viz_cavity2d")
    os.makedirs(viz_dir, exist_ok=True)
    dt = idb.get_float("dt")
    num_steps = idb.get_int("num_steps")
    viz_int = main_db.get_int("viz_dump_interval", 0)
    chunk = main_db.get_int("log_interval", viz_int if viz_int else num_steps)
    timers = TimerManager.instance()
    with MetricsLogger(main_db.get_string(
            "log_jsonl", "cavity2d_metrics.jsonl")) as metrics:
        k = 0
        while k < num_steps:
            m = min(chunk, num_steps - k)
            with timers.scope("advance", block_on=st.u[0]):
                st = advance(integ, st, dt, m)
            k += m
            uc = centerline(st, n)
            max_div = float(integ.max_divergence(st))
            metrics.log({"step": k, "t": float(st.t),
                         "u_center_min": float(uc.min()),
                         "max_div": max_div})
            print(f"step {k}: primary-vortex u_min {uc.min():.5f} "
                  f"(Ghia Re=100: -0.21090), max div {max_div:.1e}")
            if viz_int and k % viz_int == 0:
                write_vti(os.path.join(viz_dir, f"cavity_{k:05d}.vti"),
                          integ.grid, {"p": st.p.detach().cpu().numpy()})
        metrics.log({"step": k, "centerline_u":
                     [float(v) for v in centerline(st, n)]})
    print(timers.report())
    return st


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
