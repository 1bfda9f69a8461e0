"""ex4-equivalent driver: a 3D elastic shell in incompressible flow, on
the GPU (port of ``examples/IB/explicit/ex4/main.py``).

Run:  python -m ibamr_tpu_torch.examples.ib_explicit_ex4 INPUT [RESTART_DIR STEP]

The input file is the reference's (``examples/IB/explicit/ex4/input3d``,
``input3d.northstar``), run as it is: an absent or ``"auto"``
``IBMethod.transfer_engine`` resolves as in the reference
(``models/engine_resolver.py``: ``scatter`` for ``input3d``, ``packed``
for ``input3d.northstar``), and a ported engine may be named instead, for
example ``IBMethod { transfer_engine = "pallas_packed" }``. The run loop is :class:`HierarchyDriver`; per chunk it
logs ``step, t, volume, ke, max_div, cfl_dt`` to ``Main.log_file``
(JSONL), writes the marker positions to ``<viz_dirname>/markers.<step>.csv``
at the viz cadence and a checkpoint to ``restart_dirname`` at the restart
cadence.

As in the reference, the Eulerian grid shards over every visible GPU
when more than one is visible (``parallel.make_mesh()``, then
``place_state`` and ``make_sharded_ib_step``: every grid array in
per-shard blocks on the shards' own devices, the co-partitioned marker
transfers, the pencil-FFT solves); with one GPU it runs unsharded.
``run(..., mesh=...)`` shards over an explicit mesh instead (8 shards
on one card, or on the CPU).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.models.shell3d import build_shell_example, shell_volume
from ibamr_tpu_torch.parallel.mesh import (make_mesh, make_sharded_ib_step,
                                           place_state)
from ibamr_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
from ibamr_tpu_torch.utils.hierarchy_driver import HierarchyDriver, RunConfig
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager


def run(db: InputDatabase, device="cuda", restart=None, mesh=None):
    """Build the shell from ``db`` on ``device`` in f32, restore ``restart
    = (restart_dir, step)`` if given, and run to ``num_steps``. ``mesh``
    (``parallel.make_mesh``) shards the run over it; with none, a run on
    the GPU shards over every visible GPU when there are several. Returns
    the final state (block-resident when sharded)."""
    main_db = db.get_database("Main")
    ins_db = db.get_database("INSStaggeredHierarchyIntegrator")

    integ, state = build_shell_example(input_db=db, dtype=torch.float32,
                                       device=device)
    if (mesh is None and torch.device(device).type == "cuda"
            and torch.cuda.device_count() > 1):
        mesh = make_mesh(device=device)
    step_fn = None
    if mesh is not None:
        state = place_state(state, integ.ins.grid, mesh)
        step_fn = make_sharded_ib_step(integ, mesh)
        # its integrator carries the halo stencils the metrics read
        integ = step_fn.integ
        print(f"sharding over mesh {dict(mesh.shape)}")
    start_step = 0
    if restart is not None:
        state, start_step, _ = restore_checkpoint(restart[0], state,
                                                  step=int(restart[1]))
        print(f"restarted from {restart[0]} at step {start_step}")

    viz_dir = main_db.get_string("viz_dirname", "viz_ex4")
    rst_dir = main_db.get_string("restart_dirname", "restart_ex4")
    os.makedirs(viz_dir, exist_ok=True)
    geo = db.get_database_with_default("CartesianGeometry")
    x_lo = geo.get_array("x_lo", [0.0, 0.0, 0.0])
    x_up = geo.get_array("x_up", [1.0, 1.0, 1.0])
    center = tuple(0.5 * (lo + hi) for lo, hi in zip(x_lo, x_up))

    viz_int = main_db.get_int("viz_dump_interval", 0)
    cfg = RunConfig(
        dt=ins_db.get_float("dt"),
        num_steps=ins_db.get_int("num_steps"),
        viz_dump_interval=viz_int,
        restart_interval=main_db.get_int("restart_interval", 0),
        health_interval=min(20, viz_int) if viz_int else 20)

    tm = TimerManager.instance()
    with MetricsLogger(main_db.get_string("log_file"), echo=True) as log:

        def metrics_fn(s, step):
            rec = {
                "step": step,
                "t": s.ins.t,
                "volume": shell_volume(s.X, center),
                "ke": integ.ins.kinetic_energy(s.ins),
                "max_div": integ.ins.max_divergence(s.ins),
                "cfl_dt": integ.ins.cfl_dt(s.ins),
            }
            log.log(rec)
            return rec

        def viz_fn(s, step):
            np.savetxt(os.path.join(viz_dir, f"markers.{step:06d}.csv"),
                       s.X.detach().cpu().numpy(), delimiter=",")

        driver = HierarchyDriver(
            integ, cfg, step_fn=step_fn, metrics_fn=metrics_fn,
            viz_fn=viz_fn,
            checkpoint_fn=lambda s, k: save_checkpoint(rst_dir, s, k),
            timer=tm, timer_name="IB::advanceHierarchy")
        state = driver.run(state, start_step=start_step)
    print(tm.report())
    return state


def main(argv):
    if len(argv) not in (2, 4):
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1])
    restart = (argv[2], int(argv[3])) if len(argv) == 4 else None
    from ibamr_tpu_torch.utils.backend_guard import auto_backend

    return run(db, device=auto_backend("cuda"), restart=restart)


if __name__ == "__main__":
    main(sys.argv)
