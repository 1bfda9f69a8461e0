"""ex0-equivalent driver: a 2D periodic elastic membrane in incompressible
flow, on the GPU (port of ``examples/IB/explicit/ex0/main.py``).

Run:  python -m ibamr_tpu_torch.examples.ib_explicit_ex0 [INPUT [RESTART_DIR STEP]]

The input file is the reference's (``examples/IB/explicit/ex0/input2d``
by default), run as it is. The run loop is the reference's: chunks of
``Main.viz_dump_interval`` steps (50 when it is 0) under the timer
``IB::advanceHierarchy``; after each chunk one JSONL record of ``step, t,
area, ke, max_div, cfl_dt`` to ``Main.log_file``, the marker positions to
``<viz_dirname>/markers.<step>.csv`` when the viz interval is set, and a
checkpoint to ``restart_dirname`` every ``restart_interval`` steps. Paths
in the input file are relative to the working directory.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.integrators.ib import advance_ib, polygon_area
from ibamr_tpu_torch.models.membrane2d import build_membrane_example
from ibamr_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples", "IB",
    "explicit", "ex0", "input2d")


def run(db: InputDatabase, device="cuda", restart=None):
    """Build the membrane from ``db`` on ``device`` in f32, restore
    ``restart = (restart_dir, step)`` if given, and run to ``num_steps``.
    Returns the final state."""
    main_db = db.get_database("Main")
    ins_db = db.get_database("INSStaggeredHierarchyIntegrator")

    integ, state = build_membrane_example(input_db=db, dtype=torch.float32,
                                          device=device)
    start_step = 0
    if restart is not None:
        state, start_step, _ = restore_checkpoint(restart[0], state,
                                                  step=int(restart[1]))
        print(f"restarted from {restart[0]} at step {start_step}")

    dt = ins_db.get_float("dt")
    num_steps = ins_db.get_int("num_steps")
    viz_int = main_db.get_int("viz_dump_interval", 0)
    rst_int = main_db.get_int("restart_interval", 0)
    viz_dir = main_db.get_string("viz_dirname", "viz_ex0")
    rst_dir = main_db.get_string("restart_dirname", "restart_ex0")
    os.makedirs(viz_dir, exist_ok=True)

    tm = TimerManager.instance()
    with MetricsLogger(main_db.get_string("log_file"), echo=True) as metrics:
        step = start_step
        while step < num_steps:
            chunk = min(viz_int or 50, num_steps - step)
            with tm.scope("IB::advanceHierarchy", block_on=state.X):
                state = advance_ib(integ, state, dt, chunk)
            step += chunk
            metrics.log({
                "step": step,
                "t": state.ins.t,
                "area": polygon_area(state.X),
                "ke": integ.ins.kinetic_energy(state.ins),
                "max_div": integ.ins.max_divergence(state.ins),
                "cfl_dt": integ.ins.cfl_dt(state.ins),
            })
            if viz_int:
                np.savetxt(os.path.join(viz_dir, f"markers.{step:06d}.csv"),
                           state.X.detach().cpu().numpy(), delimiter=",")
            if rst_int and step % rst_int == 0:
                save_checkpoint(rst_dir, state, step)
    print(tm.report())
    return state


def main(argv):
    if len(argv) not in (1, 2, 4):
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    restart = (argv[2], int(argv[3])) if len(argv) == 4 else None
    return run(db, device="cuda", restart=restart)


if __name__ == "__main__":
    main(sys.argv)
