"""Channel-flow driver: parabolic inflow, developed Poiseuille flow and a
traction-free outflow, on the GPU (port of
``examples/navier_stokes/channel2d/main.py``).

Run:  python -m ibamr_tpu_torch.examples.navier_stokes_channel2d [INPUT]

The input file is the reference's (``examples/navier_stokes/channel2d/
input2d`` by default), run as it is, in f32 (what the reference's
example computes in JAX's default 32-bit mode; hence the file's
``solver_tol = 1.0e-5``). Each step is one coupled FGMRES + multigrid
saddle solve under the timer ``step``. Every ``viz_dump_interval`` steps
the cell-centered ``u, v, p`` go to ``<viz_dirname>/u_<step>.vti`` and one
JSONL record ``step, t, outflow_flux, max_div`` to ``Main.log_jsonl``. At
the end the driver prints the developed profile's error against
Poiseuille at x = 3/4 of the channel.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins_open import INSOpenIntegrator
from ibamr_tpu_torch.io.vtk import write_vti
from ibamr_tpu_torch.solvers.stokes import channel_bc
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples",
    "navier_stokes", "channel2d", "input2d")


def _grid(db: InputDatabase) -> StaggeredGrid:
    geo = db.get_database("CartesianGeometry")
    return StaggeredGrid(n=tuple(geo.get_int_array("n")),
                         x_lo=tuple(geo.get_float_array("x_lo")),
                         x_up=tuple(geo.get_float_array("x_up")))


def poiseuille(db: InputDatabase) -> np.ndarray:
    """The parabolic inflow profile ``4 U y (H - y) / H^2`` at the cell
    centers across the channel (f64, on the host)."""
    grid = _grid(db)
    H = grid.x_up[1] - grid.x_lo[1]
    y = (np.arange(grid.n[1]) + 0.5) * (H / grid.n[1])
    U = db.get_database("INSOpenIntegrator").get_float("U_max", 1.0)
    return 4.0 * U * y * (H - y) / H ** 2


def build(db: InputDatabase, device="cuda", dtype=torch.float32):
    """The channel's grid, integrator and initial state (at rest)."""
    ins_db = db.get_database("INSOpenIntegrator")
    grid = _grid(db)
    profile = torch.as_tensor(poiseuille(db), dtype=dtype)
    integ = INSOpenIntegrator(
        grid.n, grid.dx, channel_bc(2), mu=ins_db.get_float("mu"),
        dt=ins_db.get_float("dt"), rho=ins_db.get_float("rho", 1.0),
        bdry={(0, 0, 0): profile[None, :], (1, 0, 0): 0.0},
        tol=ins_db.get_float("solver_tol", 1e-8), dtype=dtype, device=device)
    return grid, integ, integ.initialize()


def profile_error(db: InputDatabase, state) -> float:
    """max |u(x = 3/4 L, y) - Poiseuille(y)|, as the driver prints it."""
    n = _grid(db).n
    un = state.u[0].detach().cpu().numpy()
    return float(np.max(np.abs(un[3 * n[0] // 4, :] - poiseuille(db))))


def outflow_flux(state, dy: float) -> float:
    """The volume flux through the outflow face, ``sum_j u[-1, j] dy``."""
    return float(state.u[0].detach().cpu().numpy().sum(axis=1)[-1] * dy)


def run(db: InputDatabase, device="cuda"):
    """Run the channel of ``db`` to ``num_steps`` on ``device`` in f32;
    returns the final state."""
    main_db = db.get_database("Main")
    ins_db = db.get_database("INSOpenIntegrator")
    grid, integ, state = build(db, device)
    dy = grid.dx[1]
    viz_dir = main_db.get_string("viz_dirname", "viz_channel2d")
    os.makedirs(viz_dir, exist_ok=True)
    timers = TimerManager.instance()
    num_steps = ins_db.get_int("num_steps")
    viz_int = main_db.get_int("viz_dump_interval", 0)
    with MetricsLogger(main_db.get_string(
            "log_jsonl", "channel2d_metrics.jsonl")) as metrics:
        for k in range(num_steps):
            with timers.scope("step"):
                state = integ.step(state)
            if viz_int and (k + 1) % viz_int == 0:
                u_cc = [c.detach().cpu().numpy()
                        for c in integ._to_cells(state.u)]
                write_vti(os.path.join(viz_dir, f"u_{k + 1:05d}.vti"), grid,
                          {"u": u_cc[0], "v": u_cc[1],
                           "p": state.p.detach().cpu().numpy()})
                flux = outflow_flux(state, dy)
                metrics.log({"step": k + 1, "t": float(state.t),
                             "outflow_flux": flux,
                             "max_div": float(integ.max_divergence(state))})
                print(f"step {k + 1}: outflow flux {flux:.5f}")
    print(timers.report())
    print(f"developed-profile error vs Poiseuille: "
          f"{profile_error(db, state):.2e}")
    return state


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
