"""IBFE cantilever-beam driver: a hyperelastic FE beam clamped near the
channel floor, bending in an inflow, on the GPU (port of
``examples/IBFE/explicit/beam2d/main.py``).

Run:  python -m ibamr_tpu_torch.examples.ibfe_explicit_beam2d [INPUT]

The input file is the reference's (``examples/IBFE/explicit/beam2d/
input2d`` by default), run as it is, in f32: a QUAD4 neo-Hookean beam on
the open-boundary IB coupling (inflow, walls, traction-free outflow; the
coupled FGMRES saddle solve), the base row held by the stiff penalty
``-k_anchor (X - X0)``, the transfers on the scatter oracle. The beam
keeps delta-support clearance from the floor (``Beam.base_y`` >= 3 dx),
the layout bridge's contract. Chunks of ``Main.log_interval`` steps run
under the timer ``advance``; after each, one JSONL record ``step,
tip_deflection, tip_y, elastic_energy`` goes to ``Main.log_jsonl``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.fe.fem import neo_hookean
from ibamr_tpu_torch.fe.mesh import rect_quad_mesh
from ibamr_tpu_torch.integrators.ib_open import (IBOpenIntegrator,
                                                 advance_ib_open)
from ibamr_tpu_torch.integrators.ibfe import IBFEMethod
from ibamr_tpu_torch.integrators.ins_open import INSOpenIntegrator
from ibamr_tpu_torch.solvers.stokes import channel_bc
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples",
    "IBFE", "explicit", "beam2d", "input2d")


def build(db: InputDatabase, device="cuda", dtype=torch.float32):
    """The coupled integrator, its initial state and the index of the tip
    node (the top node nearest the beam's axis)."""
    geo = db.get_database("CartesianGeometry")
    idb = db.get_database("INSOpenIntegrator")
    bm = db.get_database("Beam")
    n = tuple(geo.get_int_array("n"))
    x_lo = tuple(geo.get_float_array("x_lo"))
    x_up = tuple(geo.get_float_array("x_up"))
    dx = tuple((u - l) / m for u, l, m in zip(x_up, x_lo, n))
    ins = INSOpenIntegrator(n, dx, channel_bc(2), mu=idb.get_float("mu"),
                            dt=idb.get_float("dt"),
                            rho=idb.get_float("rho", 1.0),
                            bdry={(0, 0, 0): idb.get_float("U0")},
                            tol=idb.get_float("tol", 1.0e-6), dtype=dtype,
                            device=device)
    w = bm.get_float("width")
    H = bm.get_float("height")
    bx = bm.get_float("base_x")
    by = bm.get_float("base_y", 0.1)
    if by < 3.0 * dx[1]:
        raise ValueError(
            f"Beam.base_y = {by} is within the IB_4 delta support of "
            f"the floor (need >= {3.0 * dx[1]:.4f}); raise base_y or "
            "refine the grid")
    mesh = rect_quad_mesh(bm.get_int("nx_elems", 2),
                          bm.get_int("ny_elems", 12),
                          x_lo=(bx - w / 2, by), x_up=(bx + w / 2, by + H))
    dev = ins.solver.device
    X0 = torch.as_tensor(mesh.nodes, dtype=dtype, device=dev)
    base = torch.as_tensor(mesh.nodes[:, 1] <= by + 1e-9, dtype=dtype,
                           device=dev)
    k_anchor = bm.get_float("k_anchor")

    def tether(x, t):
        return -k_anchor * (x - X0) * base[:, None]

    fe = IBFEMethod(mesh, neo_hookean(bm.get_float("shear_modulus"),
                                      bm.get_float("bulk_modulus")),
                    kernel="IB_4", body_force=tether, dtype=dtype,
                    device=dev)
    integ = IBOpenIntegrator(ins, fe, x_lo=x_lo)
    tip = int(np.argmax(mesh.nodes[:, 1]
                        + 1e-6 * np.abs(mesh.nodes[:, 0] - bx)))
    return integ, integ.initialize(X0), tip


def run(db: InputDatabase, device="cuda"):
    """Run the beam of ``db`` to ``num_steps`` on ``device`` (f32, as the
    reference's driver); returns the final state."""
    main_db = db.get_database("Main")
    integ, st, tip = build(db, device)
    X0 = st.X
    fe = integ.ib
    timers = TimerManager.instance()
    num_steps = db.get_database("INSOpenIntegrator").get_int("num_steps")
    chunk = main_db.get_int("log_interval", 50)
    with MetricsLogger(main_db.get_string("log_jsonl",
                                          "beam2d_metrics.jsonl")) as metrics:
        k = 0
        while k < num_steps:
            m = min(chunk, num_steps - k)
            with timers.scope("advance", block_on=st.X):
                st = advance_ib_open(integ, st, m)
            k += m
            defl = float(st.X[tip, 0] - X0[tip, 0])
            E = float(fe.energy(st.X))
            metrics.log({"step": k, "tip_deflection": defl,
                         "tip_y": float(st.X[tip, 1]),
                         "elastic_energy": E})
            print(f"step {k}: tip deflection {defl:+.4f}, energy {E:.4g}")
    print(timers.report())
    return st


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
