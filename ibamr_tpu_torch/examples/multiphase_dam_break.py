"""Dam-break driver: a water column collapsing in a closed tank under
gravity at density ratio 1000 (port of ``examples/multiphase/dam_break/
main.py``; Martin & Moyce 1952 for the surge-front scaling).

Run:  python -m ibamr_tpu_torch.examples.multiphase_dam_break [INPUT]
          [--restart]

The input file is the reference's (``examples/multiphase/dam_break/
input2d`` by default), run as it is, in f32 on the GPU: walls on both
axes, the variable-density projection, the level set with its
reinitialization. Chunks of ``Main.log_interval`` steps (at most
``restart_interval``) run under the timer ``advance``; after each, one
JSONL record ``step, t, front, volume_drift, max_div`` goes to
``Main.log_jsonl`` (the surge front is the rightmost floor cell of the
heavy phase). With ``restart_interval`` a checkpoint lands in
``restart_dirname`` whenever the run crosses an interval boundary;
``--restart`` resumes from the newest one there. Paths in the input file
are relative to the working directory.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins_vc import (INSVCStaggeredIntegrator,
                                                advance_vc)
from ibamr_tpu_torch.io.vtk import write_vti
from ibamr_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples",
    "multiphase", "dam_break", "input2d")


def surge_front(phi: torch.Tensor, grid: StaggeredGrid) -> float:
    """Rightmost x where the heavy phase (phi > 0) touches the floor row:
    the Martin & Moyce front position."""
    floor = phi[:, 0].detach().cpu().numpy()
    wet = np.nonzero(floor > 0)[0]
    if wet.size == 0:
        return 0.0
    return float((wet.max() + 0.5) * grid.dx[0])


def build(db: InputDatabase, device="cuda", dtype=torch.float32):
    """The tank's integrator and its initial state: a column of width
    ``column_width`` and height ``column_height`` against the left wall."""
    geo = db.get_database("CartesianGeometry")
    vc = db.get_database("INSVCStaggeredHierarchyIntegrator")
    n = tuple(geo.get_int_array("n"))
    grid = StaggeredGrid(n=n, x_lo=tuple(geo.get_float_array("x_lo")),
                         x_up=tuple(geo.get_float_array("x_up")))
    integ = INSVCStaggeredIntegrator(
        grid, rho0=vc.get_float("rho0"), rho1=vc.get_float("rho1"),
        mu0=vc.get_float("mu0"), mu1=vc.get_float("mu1"),
        sigma=vc.get_float("sigma", 0.0),
        gravity=(0.0, vc.get_float("gravity_y", 0.0)),
        wall_axes=(True, True),
        cg_tol=vc.get_float("cg_tol", 1.0e-5), dtype=dtype, device=device)
    a = vc.get_float("column_width")
    h0 = vc.get_float("column_height")
    x = (np.arange(n[0]) + 0.5) * grid.dx[0]
    y = (np.arange(n[1]) + 0.5) * grid.dx[1]
    X, Y = np.meshgrid(x, y, indexing="ij")
    phi0 = np.minimum(a - X, h0 - Y).astype(np.float32)
    return integ, integ.initialize(phi0)


def run(db: InputDatabase, device="cuda", restart=None):
    """Run the tank of ``db`` to ``num_steps`` on ``device`` in f32; with
    ``restart`` true, resume from the newest checkpoint in
    ``Main.restart_dirname``. Returns the integrator and final state."""
    main_db = db.get_database("Main")
    vc = db.get_database("INSVCStaggeredHierarchyIntegrator")
    integ, st = build(db, device)
    grid = integ.grid
    # the drift reference comes from the fresh t = 0 state, before any
    # restore
    vol0 = float(integ.heavy_phase_volume(st))
    restart_dir = main_db.get_string("restart_dirname", "restart_dam")
    restart_int = main_db.get_int("restart_interval", 0)
    k = 0
    if restart:
        st, k, _ = restore_checkpoint(restart_dir, template=st)
        st = st._replace(k=int(st.k))
        print(f"restarted from {restart_dir} at step {k}")
    viz_dir = main_db.get_string("viz_dirname", "viz_dam_break")
    os.makedirs(viz_dir, exist_ok=True)
    dt = vc.get_float("dt")
    num_steps = vc.get_int("num_steps")
    viz_int = main_db.get_int("viz_dump_interval", 0)
    chunk = main_db.get_int("log_interval", viz_int if viz_int else
                            num_steps)
    if restart_int:
        chunk = min(chunk, restart_int)
    last_ckpt_epoch = k // restart_int if restart_int else 0
    timers = TimerManager.instance()
    with MetricsLogger(main_db.get_string(
            "log_jsonl", "dam_break_metrics.jsonl")) as metrics:
        while k < num_steps:
            m = min(chunk, num_steps - k)
            with timers.scope("advance", block_on=st.u[0]):
                st = advance_vc(integ, st, dt, m)
            k += m
            vol = float(integ.heavy_phase_volume(st))
            front = surge_front(st.phi, grid)
            div = float(integ.max_divergence(st))
            metrics.log({"step": k, "t": float(st.t), "front": front,
                         "volume_drift": abs(vol - vol0) / vol0,
                         "max_div": div})
            print(f"step {k}: front {front:.3f}, volume drift "
                  f"{abs(vol - vol0) / vol0:.2e}, max div {div:.1e}")
            if viz_int and k % viz_int == 0:
                write_vti(os.path.join(viz_dir, f"dam_{k:05d}.vti"), grid,
                          {"phi": st.phi.detach().cpu().numpy(),
                           "p": st.p.detach().cpu().numpy()})
            if restart_int and k // restart_int > last_ckpt_epoch:
                # epoch-crossing rule: a dump lands whenever the run
                # passes a restart_interval boundary
                last_ckpt_epoch = k // restart_int
                save_checkpoint(restart_dir, st, step=k)
    print(timers.report())
    return integ, st


def main(argv):
    restart = "--restart" in argv
    argv = [a for a in argv if a != "--restart"]
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda", restart=restart)


if __name__ == "__main__":
    main(sys.argv)
