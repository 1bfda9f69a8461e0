"""Oscillating-cylinder CIB driver: a rigid disc driven with prescribed
``U(t) = V0 cos(2 pi t / T)`` through the constraint (prescribed-
kinematics) solve, on the GPU (port of
``examples/CIB/oscillating_cylinder/main.py``).

Run:  python -m ibamr_tpu_torch.examples.cib_oscillating_cylinder [INPUT]

The input file is the reference's (``examples/CIB/oscillating_cylinder/
input2d`` by default), run as it is: quasi-static Stokes, the disc at
its phase offset each step, one CG on the mobility of the domain the
input names (``CIBMethod.domain``, "walled": every CG iteration nests a
saddle FGMRES of the no-slip box). The precision is f64, as the
reference runs under JAX's x64 mode; at f32 the walled solve's
tolerance of 1e-10 is out of reach and the constraint solve does not
converge (ROADMAP C). Each step runs under the timer
``constraint_solve``; one JSONL record ``step, t, u, fx, fy, torque,
R_eff, converged`` per step goes to ``Main.log_jsonl``.
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
    "oscillating_cylinder", "input2d")


def build(db: InputDatabase, device="cuda"):
    """The CIB method and the disc's markers at rest, in f64."""
    dtype = torch.float64
    geom = db.get_database("CartesianGeometry")
    cdb = db.get_database("CIBMethod")
    body = db.get_database("Body")
    grid = StaggeredGrid(n=tuple(geom.get_int_array("n_cells")),
                         x_lo=tuple(geom.get_float_array("x_lo")),
                         x_up=tuple(geom.get_float_array("x_up")))
    cx, cy = body.get_float_array("center")
    m = body.get_int("n_markers")
    X = cib.make_disc((cx, cy), body.get_float("radius"), m, dtype=dtype,
                      device=device)
    bodies = cib.RigidBodies(
        body_id=torch.zeros(m, dtype=torch.int64, device=X.device),
        n_bodies=1)
    method = cib.CIBMethod(
        grid, bodies, mu=cdb.get_float("mu"),
        cg_tol=cdb.get_float("cg_tol", 1e-8),
        cg_maxiter=cdb.get_int("cg_maxiter", 300),
        domain=cdb.get_string("domain", "periodic"), dtype=dtype,
        device=X.device)
    return method, X


def phase(db: InputDatabase, k: int):
    """Step ``k``'s midpoint time, prescribed velocity and x offset."""
    osc = db.get_database("Oscillation")
    V0, T = osc.get_float("V0"), osc.get_float("period")
    dt = T / osc.get_int("steps_per_period")
    t = (k + 0.5) * dt
    return (t, V0 * np.cos(2.0 * np.pi * t / T),
            V0 * T / (2.0 * np.pi) * np.sin(2.0 * np.pi * t / T))


def run(db: InputDatabase, device="cuda"):
    """Run the oscillation of ``db`` on ``device``; returns the last
    step's constraint forces and net force/torque."""
    main_db = db.get_database("Main")
    osc = db.get_database("Oscillation")
    method, X = build(db, device)
    nsteps = osc.get_int("num_periods") * osc.get_int("steps_per_period")
    timers = TimerManager.instance()
    with MetricsLogger(main_db.get_string(
            "log_jsonl", "oscillating_cylinder_metrics.jsonl")) as metrics:
        for k in range(nsteps):
            t, u, xoff = phase(db, k)
            Xk = X + torch.tensor([xoff, 0.0], dtype=X.dtype,
                                  device=X.device)
            U = torch.tensor([[u, 0.0, 0.0]], dtype=X.dtype,
                             device=X.device)
            with timers.scope("constraint_solve", block_on=X):
                lam, FT, info = method.solve_constraint(Xk, U)
            fx, fy, tq = (float(v) for v in FT[0].cpu())
            R_eff = fx / u if abs(u) > 1e-12 else float("nan")
            metrics.log({"step": k + 1, "t": t, "u": float(u), "fx": fx,
                         "fy": fy, "torque": tq, "R_eff": R_eff,
                         "converged": bool(info.converged)})
            print(f"step {k + 1}: t={t:.3f} u={u:+.3f} Fx={fx:+.4f} "
                  f"R_eff={R_eff:.3f}")
    print(timers.report())
    return lam, FT


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
