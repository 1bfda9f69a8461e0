"""Flapping-filament driver: a near-inextensible elastic fiber (springs
and beams) anchored at its leading end in a uniform stream, on the GPU
(port of ``examples/IB/explicit/filament2d/main.py``).

Run:  python -m ibamr_tpu_torch.examples.ib_explicit_filament2d [INPUT]

The input file is the reference's (``examples/IB/explicit/filament2d/
input2d`` by default), run as it is, in f32: the marker chain with
stretching springs, bending beams and a target point at the anchor, on
the open-boundary IB coupling (stabilized PPM, the coupled FGMRES saddle
solve), the transfers on the scatter oracle. Chunks of 50 steps (fewer
when ``Main.viz_dump_interval`` is smaller) run under the timer
``advance``; after each, one JSONL record ``step, t, tail_x, tail_y,
drag, lift`` goes to ``Main.log_jsonl``, and every viz interval the
fields ``u, v, p`` and the markers to ``<viz_dirname>``.
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
from ibamr_tpu_torch.ops.forces import (make_beams, make_force_specs,
                                        make_springs, make_targets)
from ibamr_tpu_torch.solvers.stokes import channel_bc
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples", "IB",
    "explicit", "filament2d", "input2d")


def build_filament(fil, dtype=torch.float32, device="cuda"):
    """Marker chain + stretching springs + bending beams + the
    leading-end anchor (the .vertex/.spring/.beam/.target menu of the
    reference's structure files, assembled in code)."""
    ax, ay = fil.get_float_array("anchor")
    L = fil.get_float("length")
    m = fil.get_int("n_markers")
    inc = fil.get_float("incline", 0.0)
    s = np.linspace(0.0, L, m)
    X0 = np.stack([ax + s * np.cos(inc), ay + s * np.sin(inc)], axis=1)
    ds = L / (m - 1)
    kw = dict(dtype=dtype, device=device)
    springs = make_springs(np.arange(m - 1), np.arange(1, m),
                           np.full(m - 1, fil.get_float("k_stretch")),
                           np.full(m - 1, ds), **kw)
    beams = make_beams(np.arange(m - 2), np.arange(1, m - 1),
                       np.arange(2, m),
                       np.full(m - 2, fil.get_float("k_bend")), dim=2, **kw)
    targets = make_targets(np.array([0]),
                           np.array([fil.get_float("k_anchor")]),
                           X0[:1], **kw)
    specs = make_force_specs(springs, beams, targets, num_markers=m)
    return torch.as_tensor(X0, **kw), specs


def build(db: InputDatabase, device="cuda", dtype=torch.float32):
    """The coupled integrator and its initial state: the fluid at rest,
    the filament on its inclined line."""
    geo = db.get_database("CartesianGeometry")
    idb = db.get_database("INSOpenIntegrator")
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
    X0, specs = build_filament(db.get_database("Filament"), dtype=dtype,
                               device=ins.solver.device)
    integ = IBOpenIntegrator(ins, IBMethod(specs, kernel="IB_4"), x_lo=x_lo)
    return integ, integ.initialize(X0)


def run(db: InputDatabase, device="cuda"):
    """Run the filament of ``db`` to ``num_steps`` on ``device`` (f32, as
    the reference's driver); returns the final state."""
    main_db = db.get_database("Main")
    integ, st = build(db, device)
    viz_dir = main_db.get_string("viz_dirname", "viz_filament2d")
    os.makedirs(viz_dir, exist_ok=True)
    writer = VizWriter(viz_dir, integ.grid)
    timers = TimerManager.instance()
    num_steps = db.get_database("INSOpenIntegrator").get_int("num_steps")
    viz_int = main_db.get_int("viz_dump_interval", 0)
    chunk = min(50, viz_int) if viz_int else 50

    def host(x):
        return x.detach().cpu().numpy()

    with MetricsLogger(main_db.get_string(
            "log_jsonl", "filament2d_metrics.jsonl")) as metrics:
        k = 0
        while k < num_steps:
            mstep = min(chunk, num_steps - k)
            with timers.scope("advance", block_on=st.X):
                st = advance_ib_open(integ, st, mstep)
            k += mstep
            tail = host(st.X[-1])
            F = host(integ.body_force_on_fluid(st))
            t = float(st.fluid.t)
            metrics.log({"step": k, "t": t, "tail_x": float(tail[0]),
                         "tail_y": float(tail[1]), "drag": -float(F[0]),
                         "lift": -float(F[1])})
            print(f"step {k}: t={t:.3f} tail_y={float(tail[1]):+.4f}")
            if viz_int and k % viz_int == 0:
                u_low = integ._to_lower(st.fluid.u)
                writer.dump(k, t, cell_fields={"u": host(u_low[0]),
                                               "v": host(u_low[1]),
                                               "p": host(st.fluid.p)},
                            markers=host(st.X))
    print(timers.report())
    return st


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
