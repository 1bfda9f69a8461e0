"""IBFE ex0-equivalent driver: a stretched hyperelastic FE disc relaxing
in periodic incompressible flow, on the GPU (port of
``examples/IBFE/explicit/ex0/main.py``).

Run:  python -m ibamr_tpu_torch.examples.ibfe_explicit_ex0 [INPUT]

The input file is the reference's (``examples/IBFE/explicit/ex0/input2d``
by default), run as it is, in f32, with the transfers on the scatter
oracle. Each step runs under the timer ``IBFE::step``; after step 1 and
every 10th, one JSONL record ``step, t, elastic_energy, area,
area_drift`` goes to ``Main.log_file``, and every
``Main.viz_dump_interval`` steps the nodes to
``<viz_dirname>/nodes_<step>.npy``. Paths are relative to the working
directory.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.models.fe_disc2d import build_fe_disc_example
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples",
    "IBFE", "explicit", "ex0", "input2d")


def run(db: InputDatabase, device="cuda"):
    """Run the disc of ``db`` to ``num_steps`` on ``device`` in f32;
    returns the final state."""
    main_db = db.get_database("Main")
    ts = db.get_database("TimeStepping")
    integ, state = build_fe_disc_example(input_db=db, dtype=torch.float32,
                                         device=device)
    fe = integ.ib
    dt = ts.get_float("dt")
    num_steps = ts.get_int("num_steps")
    viz_dir = main_db.get_string("viz_dirname", "viz_ibfe")
    os.makedirs(viz_dir, exist_ok=True)
    timers = TimerManager.instance()
    dump = main_db.get_int("viz_dump_interval", 0)
    A0 = float(fe.current_volume(state.X))
    with MetricsLogger(main_db.get_string("log_file", "") or None) \
            as metrics:
        for k in range(num_steps):
            with timers.scope("IBFE::step", block_on=state.X):
                state = integ.step(state, dt)
            if (k + 1) % 10 == 0 or k == 0:
                A = float(fe.current_volume(state.X))
                metrics.log({"step": k + 1, "t": (k + 1) * dt,
                             "elastic_energy": float(fe.energy(state.X)),
                             "area": A, "area_drift": (A - A0) / A0})
            if dump and (k + 1) % dump == 0:
                np.save(os.path.join(viz_dir, f"nodes_{k + 1:05d}.npy"),
                        state.X.detach().cpu().numpy())
    print(timers.report())
    print(f"final elastic energy: {float(fe.energy(state.X)):.6g}, "
          f"area drift: {(float(fe.current_volume(state.X)) - A0) / A0:.3e}")
    return state


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
