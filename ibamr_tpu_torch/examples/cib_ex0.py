"""CIB ex0-equivalent driver: a rigid disc sedimenting in periodic Stokes
flow through the constraint/mobility formulation, on the GPU (port of
``examples/CIB/ex0/main.py``).

Run:  python -m ibamr_tpu_torch.examples.cib_ex0 [INPUT]

The input file is the reference's (``examples/CIB/ex0/input2d`` by
default), run as it is, in f32 (the reference builds the disc at f64 and
runs in JAX's 32-bit mode): each quasi-static step solves the body
resistance column by column (one CG on the FFT mobility per rigid mode)
and moves the markers by forward Euler, under the timer ``CIB::step``.
Every step one JSONL record ``step, t, cg_converged, cg_iters, centroid,
U`` goes to ``Main.log_file``, and every ``Main.viz_dump_interval`` steps
the markers to ``<viz_dirname>/markers_<step>.npy``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators import cib
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples", "CIB",
    "ex0", "input2d")


def build(db: InputDatabase, device="cuda", dtype=torch.float32):
    """The CIB method, the disc's markers, its bodies and the external
    force/torque."""
    geom = db.get_database("CartesianGeometry")
    cib_db = db.get_database("CIBMethod")
    body_db = db.get_database("Body")
    grid = StaggeredGrid(n=tuple(geom.get_int_array("n_cells")),
                         x_lo=tuple(geom.get_float_array("x_lo")),
                         x_up=tuple(geom.get_float_array("x_up")))
    nm = body_db.get_int("num_markers")
    X = cib.make_disc(tuple(body_db.get_float_array("center")),
                      body_db.get_float("radius"), nm, dtype=dtype,
                      device=device)
    bodies = cib.RigidBodies(
        body_id=torch.zeros(nm, dtype=torch.int64, device=X.device),
        n_bodies=1)
    method = cib.CIBMethod(
        grid, bodies, mu=cib_db.get_float("mu", 1.0),
        kernel=cib_db.get_string("delta_fcn", "IB_4"),
        cg_tol=cib_db.get_float("cg_tol", 1e-9),
        cg_maxiter=cib_db.get_int("cg_maxiter", 400), device=X.device)
    F = body_db.get_float_array("force")
    tau = body_db.get_float("torque", 0.0)
    FT = torch.tensor([[F[0], F[1], tau]], dtype=dtype, device=X.device)
    return method, X, bodies, FT


def run(db: InputDatabase, device="cuda"):
    """Run the disc of ``db`` for ``num_steps`` on ``device`` (f32 as the
    reference's 32-bit mode; its CG stops at ``cg_maxiter`` either way,
    at the f32 floor in f32); returns the final marker positions."""
    main_db = db.get_database("Main")
    ts = db.get_database("TimeStepping")
    method, X, bodies, FT = build(db, device)
    dt = ts.get_float("dt")
    num_steps = ts.get_int("num_steps")
    viz_dir = main_db.get_string("viz_dirname", "viz_cib")
    os.makedirs(viz_dir, exist_ok=True)
    timers = TimerManager.instance()
    dump = main_db.get_int("viz_dump_interval", 0)
    with MetricsLogger(main_db.get_string("log_file", "") or None) \
            as metrics:
        for k in range(num_steps):
            with timers.scope("CIB::step", block_on=X):
                X, U, info = method.step(X, FT, dt)
            cent = cib.body_centroids(X, bodies)
            metrics.log({"step": k + 1, "t": (k + 1) * dt,
                         "cg_converged": bool(info.converged),
                         "cg_iters": int(info.max_iters),
                         "centroid": cent[0].tolist(),
                         "U": U[0].tolist()})
            if dump and (k + 1) % dump == 0:
                np.save(os.path.join(viz_dir, f"markers_{k + 1:05d}.npy"),
                        X.detach().cpu().numpy())
    print(timers.report())
    print(f"final centroid: {cib.body_centroids(X, bodies)[0].cpu().numpy()}")
    return X


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
