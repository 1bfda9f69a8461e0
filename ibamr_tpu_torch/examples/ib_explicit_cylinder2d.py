"""Flow past a cylinder: a target-point IB cylinder in an inflow/outflow
channel, on the GPU (port of ``examples/IB/explicit/cylinder2d/main.py``).

Run:  python -m ibamr_tpu_torch.examples.ib_explicit_cylinder2d [INPUT]

The input file is the reference's (``examples/IB/explicit/cylinder2d/
input2d`` by default), run as it is, in f32: the channel's coupled
saddle solve with the stabilized PPM convection, the cylinder's markers
held at their anchors by the target force ``-kappa (X - X0) - eta U``,
and the transfers on the scatter oracle. Chunks of
``Main.viz_dump_interval`` steps run under the timer ``advance``; after
each, one JSONL record ``step, t, drag, lift, cd`` goes to
``Main.log_jsonl``, and the fields ``u, v, p`` and the markers to
``<viz_dirname>`` (``eul_<step>.vti``, ``lag_<step>.vtp`` and their
``.pvd`` collections).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.integrators.ib import IBMethod
from ibamr_tpu_torch.integrators.ib_open import (IBOpenIntegrator,
                                                 advance_ib_open)
from ibamr_tpu_torch.integrators.ins_open import INSOpenIntegrator
from ibamr_tpu_torch.io.vtk import VizWriter
from ibamr_tpu_torch.ops.forces import ForceSpecs
from ibamr_tpu_torch.solvers.stokes import channel_bc
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples", "IB",
    "explicit", "cylinder2d", "input2d")


def build(db: InputDatabase, device="cuda", dtype=torch.float32):
    """The coupled integrator and its initial state: the fluid at rest,
    the markers on the cylinder's circle."""
    geo = db.get_database("CartesianGeometry")
    idb = db.get_database("INSOpenIntegrator")
    cyl = db.get_database("Cylinder")
    n = tuple(geo.get_int_array("n"))
    x_lo = tuple(geo.get_float_array("x_lo"))
    x_up = tuple(geo.get_float_array("x_up"))
    dx = tuple((u - l) / m for u, l, m in zip(x_up, x_lo, n))
    ins = INSOpenIntegrator(
        n, dx, channel_bc(2), mu=idb.get_float("mu"),
        dt=idb.get_float("dt"), rho=idb.get_float("rho", 1.0),
        bdry={(0, 0, 0): idb.get_float("U0")}, tol=idb.get_float("tol", 1e-7),
        convective_op_type=idb.get_string("convective_op_type",
                                          "stabilized_ppm"),
        dtype=dtype, device=device)
    cx, cy = cyl.get_float_array("center")
    D = cyl.get_float("diameter")
    m = cyl.get_int("n_markers")
    th = 2.0 * np.pi * np.arange(m) / m
    X0 = torch.as_tensor(np.stack([cx + 0.5 * D * np.cos(th),
                                   cy + 0.5 * D * np.sin(th)], axis=1),
                         dtype=dtype, device=ins.solver.device)
    kappa = cyl.get_float("kappa")
    eta = cyl.get_float("eta")
    ib = IBMethod(ForceSpecs(), kernel="IB_4",
                  force_fn=lambda X, U, t: -kappa * (X - X0) - eta * U)
    integ = IBOpenIntegrator(ins, ib, x_lo=x_lo)
    return integ, integ.initialize(X0)


def run(db: InputDatabase, device="cuda"):
    """Run the cylinder of ``db`` to ``num_steps`` on ``device`` in f32;
    returns the final state."""
    main_db = db.get_database("Main")
    idb = db.get_database("INSOpenIntegrator")
    integ, st = build(db, device)
    U0 = idb.get_float("U0")
    D = db.get_database("Cylinder").get_float("diameter")
    viz_dir = main_db.get_string("viz_dirname", "viz_cylinder2d")
    os.makedirs(viz_dir, exist_ok=True)
    writer = VizWriter(viz_dir, integ.grid)
    timers = TimerManager.instance()
    num_steps = idb.get_int("num_steps")
    viz_int = main_db.get_int("viz_dump_interval", 0)
    chunk = viz_int if viz_int else num_steps

    def host(x):
        return x.detach().cpu().numpy()

    with MetricsLogger(main_db.get_string(
            "log_jsonl", "cylinder2d_metrics.jsonl")) as metrics:
        k = 0
        while k < num_steps:
            mstep = min(chunk, num_steps - k)
            with timers.scope("advance", block_on=st.X):
                st = advance_ib_open(integ, st, mstep)
            k += mstep
            F = host(integ.body_force_on_fluid(st))
            drag, lift = -float(F[0]), -float(F[1])
            cd = drag / (0.5 * integ.ins.rho * U0 ** 2 * D)
            t = float(st.fluid.t)
            metrics.log({"step": k, "t": t, "drag": drag, "lift": lift,
                         "cd": cd})
            print(f"step {k}: t={t:.3f} cd={cd:.3f} lift={lift:+.4f}")
            if viz_int:
                u_low = integ._to_lower(st.fluid.u)
                writer.dump(k, t, cell_fields={"u": host(u_low[0]),
                                               "v": host(u_low[1]),
                                               "p": host(st.fluid.p)},
                            markers=host(st.X))
    return st


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
