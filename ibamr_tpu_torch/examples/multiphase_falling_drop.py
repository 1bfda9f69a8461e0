"""Falling-drop driver: a heavy drop (density ratio 1000) falling under
gravity with CSF surface tension (port of ``examples/multiphase/
falling_drop/main.py``).

Run:  python -m ibamr_tpu_torch.examples.multiphase_falling_drop [INPUT]

The input file is the reference's (``examples/multiphase/falling_drop/
input2d`` by default; ``input2d.walled`` closes the box with
``wall_axes = 1, 1``), run as it is, in f32 on the GPU. Chunks of
``viz_dump_interval`` steps run under the timer ``advance``; after each,
one JSONL record ``step, t, volume_drift, max_div`` goes to
``Main.log_jsonl`` and phi and p to ``<viz_dirname>/drop_<step>.vti``.
Paths in the input file are relative to the working directory.
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
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples",
    "multiphase", "falling_drop", "input2d")


def build(db: InputDatabase, device="cuda", dtype=torch.float32):
    """The drop's integrator and its initial state (fluid at rest)."""
    geo = db.get_database("CartesianGeometry")
    vc = db.get_database("INSVCStaggeredHierarchyIntegrator")
    n = tuple(geo.get_int_array("n"))
    grid = StaggeredGrid(n=n, x_lo=tuple(geo.get_float_array("x_lo")),
                         x_up=tuple(geo.get_float_array("x_up")))
    # wall_axes = 1, 1: no-slip walls on both sides of the flagged axes
    wall_axes = tuple(bool(v) for v in
                      vc.get_int_array("wall_axes", [0] * len(n)))
    integ = INSVCStaggeredIntegrator(
        grid, rho0=vc.get_float("rho0"), rho1=vc.get_float("rho1"),
        mu0=vc.get_float("mu0"), mu1=vc.get_float("mu1"),
        sigma=vc.get_float("sigma", 0.0),
        gravity=(0.0, vc.get_float("gravity_y", 0.0)),
        wall_axes=wall_axes if any(wall_axes) else None,
        cg_tol=vc.get_float("cg_tol", 1.0e-5), dtype=dtype, device=device)
    cx, cy = vc.get_float_array("drop_center")
    r0 = vc.get_float("drop_radius")
    x = (np.arange(n[0]) + 0.5) * grid.dx[0]
    y = (np.arange(n[1]) + 0.5) * grid.dx[1]
    X, Y = np.meshgrid(x, y, indexing="ij")
    phi0 = (r0 - np.sqrt((X - cx) ** 2 + (Y - cy) ** 2)).astype(np.float32)
    return integ, integ.initialize(phi0)


def run(db: InputDatabase, device="cuda"):
    """Run the drop of ``db`` to ``num_steps`` on ``device`` in f32;
    returns the integrator and final state."""
    main_db = db.get_database("Main")
    vc = db.get_database("INSVCStaggeredHierarchyIntegrator")
    integ, st = build(db, device)
    grid = integ.grid
    vol0 = float(integ.heavy_phase_volume(st))
    viz_dir = main_db.get_string("viz_dirname", "viz_falling_drop")
    os.makedirs(viz_dir, exist_ok=True)
    dt = vc.get_float("dt")
    num_steps = vc.get_int("num_steps")
    viz_int = main_db.get_int("viz_dump_interval", 0)
    chunk = viz_int if viz_int else num_steps
    timers = TimerManager.instance()
    with MetricsLogger(main_db.get_string(
            "log_jsonl", "falling_drop_metrics.jsonl")) as metrics:
        k = 0
        while k < num_steps:
            m = min(chunk, num_steps - k)
            with timers.scope("advance", block_on=st.u[0]):
                st = advance_vc(integ, st, dt, m)
            k += m
            vol = float(integ.heavy_phase_volume(st))
            div = float(integ.max_divergence(st))
            metrics.log({"step": k, "t": float(st.t),
                         "volume_drift": abs(vol - vol0) / vol0,
                         "max_div": div})
            print(f"step {k}: volume drift {abs(vol - vol0) / vol0:.2e}, "
                  f"max div {div:.1e}")
            if viz_int:
                write_vti(os.path.join(viz_dir, f"drop_{k:05d}.vti"), grid,
                          {"phi": st.phi.detach().cpu().numpy(),
                           "p": st.p.detach().cpu().numpy()})
    print(timers.report())
    return integ, st


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
