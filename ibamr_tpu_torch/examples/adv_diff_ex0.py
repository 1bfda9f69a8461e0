"""IB + advection-diffusion driver: a passive scalar released at the
immersed membrane's markers and advected by the flow the membrane drives,
on the GPU (port of ``examples/adv_diff/ex0/main.py``).

Run:  python -m ibamr_tpu_torch.examples.adv_diff_ex0 [INPUT]

The input file is the reference's (``examples/adv_diff/ex0/input2d`` by
default), run as it is, in f32 as the reference runs it. One coupled step
is an IB step of the ex0 membrane, then one semi-implicit step of the
scalar ``C`` advected by the new velocity, with a source of
``source_strength`` per marker spread at cell centers. The run loop is
the reference's: chunks of ``Main.viz_dump_interval`` steps (25 when it
is 0) under the timer ``IBAdvDiff::advanceHierarchy``; after each chunk
one JSONL record of ``step, t, area, scalar_total, scalar_max, max_div``
to ``Main.log_file``, and the scalar to ``<viz_dirname>/scalar.<step>
.npy`` when the viz interval is set. Paths in the input file are relative
to the working directory.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.integrators.adv_diff import (
    AdvDiffSemiImplicitIntegrator, TransportedQuantity)
from ibamr_tpu_torch.integrators.ib import polygon_area
from ibamr_tpu_torch.models.membrane2d import build_membrane_example
from ibamr_tpu_torch.ops import interaction
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples",
    "adv_diff", "ex0", "input2d")


class IBAdvDiff:
    """The coupled step: the IB integrator ``integ``, then the scalar of
    ``adv`` advected by the new velocity with the marker source."""

    def __init__(self, integ, adv: AdvDiffSemiImplicitIntegrator,
                 strength: float):
        self.integ = integ
        self.adv = adv
        self.strength = float(strength)

    def step(self, ib_state, ad_state, dt):
        ib_new = self.integ.step(ib_state, dt)
        ad_new = self.adv.step(ad_state, dt, u=ib_new.ins.u,
                               sources=[self.source(ib_new)])
        return ib_new, ad_new

    def source(self, ib_state):
        """The markers' scalar source spread to the cell centers."""
        X = ib_state.X
        src_markers = torch.full((X.shape[0],), self.strength,
                                 dtype=X.dtype, device=X.device)
        return interaction.spread(src_markers, self.integ.ins.grid, X,
                                  centering="cell",
                                  kernel=self.integ.ib.kernel,
                                  weights=ib_state.mask)


def build(db: InputDatabase, device="cuda"):
    """The coupled integrator and its initial ``(ib_state, ad_state)``,
    f32 on ``device``."""
    ad_db = db.get_database_with_default(
        "AdvDiffSemiImplicitHierarchyIntegrator")
    integ, state = build_membrane_example(input_db=db, dtype=torch.float32,
                                          device=device)
    adv = AdvDiffSemiImplicitIntegrator(
        integ.ins.grid,
        [TransportedQuantity(
            "C", kappa=ad_db.get_float("kappa", 1e-3),
            convective_op_type=ad_db.get_string("convective_op_type",
                                                "upwind"))],
        dtype=torch.float32, device=integ.ins.device)
    coupled = IBAdvDiff(integ, adv, ad_db.get_float("source_strength", 1.0))
    return coupled, state, adv.initialize()


def run(db: InputDatabase, device="cuda"):
    """Build from ``db`` on ``device`` and run to ``num_steps``; returns
    the final ``(ib_state, ad_state)``."""
    main_db = db.get_database("Main")
    ins_db = db.get_database("INSStaggeredHierarchyIntegrator")
    coupled, state, ad_state = build(db, device)
    integ, adv = coupled.integ, coupled.adv

    dt = ins_db.get_float("dt")
    num_steps = ins_db.get_int("num_steps")
    viz_int = main_db.get_int("viz_dump_interval", 0)
    viz_dir = main_db.get_string("viz_dirname", "viz_adv_diff")
    os.makedirs(viz_dir, exist_ok=True)

    tm = TimerManager.instance()
    with MetricsLogger(main_db.get_string("log_file"), echo=True) as metrics:
        step = 0
        while step < num_steps:
            chunk = min(viz_int or 25, num_steps - step)
            with tm.scope("IBAdvDiff::advanceHierarchy",
                          block_on=ad_state.Q):
                for _ in range(chunk):
                    state, ad_state = coupled.step(state, ad_state, dt)
            step += chunk
            metrics.log({
                "step": step,
                "t": state.ins.t,
                "area": polygon_area(state.X),
                "scalar_total": adv.total(ad_state),
                "scalar_max": torch.max(ad_state.Q[0]),
                "max_div": integ.ins.max_divergence(state.ins),
            })
            if viz_int:
                np.save(os.path.join(viz_dir, f"scalar.{step:06d}.npy"),
                        ad_state.Q[0].cpu().numpy())
    print(tm.report())
    return state, ad_state


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    from ibamr_tpu_torch.utils.backend_guard import auto_backend

    return run(db, device=auto_backend("cuda"))


if __name__ == "__main__":
    main(sys.argv)
