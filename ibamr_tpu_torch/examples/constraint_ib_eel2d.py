"""Undulatory-swimmer driver: a slender body self-propelling by a
prescribed traveling-wave gait under the ConstraintIB momentum
projection, on the GPU (port of ``examples/ConstraintIB/eel2d/
main.py``).

Run:  python -m ibamr_tpu_torch.examples.constraint_ib_eel2d [INPUT]

The input file is the reference's (``examples/ConstraintIB/eel2d/
input2d`` by default), run as it is, in f32: the body's lateral
deformation velocity is a backward-traveling wave with a tail-growing
envelope, its rigid part projected out, and the free translation comes
from momentum conservation alone; the swimmer moves against the wave.
Chunks of ``Main.log_interval`` steps run under the timer ``advance``;
after each, one JSONL record ``step, t, com_x, com_y, swim_dx, U_body``
goes to ``Main.log_jsonl``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.cib import RigidBodies
from ibamr_tpu_torch.integrators.constraint_ib import (ConstraintIBMethod,
                                                       advance_constraint_ib)
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
from ibamr_tpu_torch.utils.input_db import InputDatabase, parse_input_file
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.timers import TimerManager

DEFAULT_INPUT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "examples",
    "ConstraintIB", "eel2d", "input2d")


def build_eel(eel, dx, dtype=torch.float32, device="cuda"):
    """Slender marker body: length L, thickness h, spacing ~dx/2; returns
    the markers, their arclength coordinates and L."""
    L = eel.get_float("length")
    h = eel.get_float("thickness")
    cx, cy = eel.get_float_array("center")
    sp = dx / 2.0
    ns = max(2, int(round(L / sp)) + 1)
    nt = max(2, int(round(h / sp)) + 1)
    s = np.linspace(0.0, L, ns)
    t = np.linspace(-h / 2, h / 2, nt)
    S, T = np.meshgrid(s, t, indexing="ij")
    X0 = np.stack([cx - L / 2 + S.ravel(), cy + T.ravel()], axis=1)
    kw = dict(dtype=dtype, device=device)
    return (torch.as_tensor(X0, **kw), torch.as_tensor(S.ravel(), **kw), L)


def make_gait(eel, s, L):
    """Backward-traveling-wave lateral velocity with the linear envelope
    A(s) = A0 s / L (head quiet, tail driving)."""
    A0 = eel.get_float("amplitude")
    lam = eel.get_float("wavelength")
    omega = 2.0 * np.pi * eel.get_float("frequency")
    k = 2.0 * np.pi / lam

    def deformation_fn(t, X):
        phase = k * s - omega * t
        uy = -(A0 * s / L) * omega * torch.cos(phase)
        return torch.stack([torch.zeros_like(uy), uy], dim=1)

    return deformation_fn


def build(db: InputDatabase, device="cuda"):
    """The ConstraintIB method and its initial state."""
    geo = db.get_database("CartesianGeometry")
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    eel = db.get_database("Eel")
    grid = StaggeredGrid(n=tuple(geo.get_int_array("n")),
                         x_lo=tuple(geo.get_float_array("x_lo")),
                         x_up=tuple(geo.get_float_array("x_up")))
    ins = INSStaggeredIntegrator(grid, rho=idb.get_float("rho", 1.0),
                                 mu=idb.get_float("mu"), device=device)
    X0, s, L = build_eel(eel, grid.dx[0], dtype=ins.dtype,
                         device=ins.device)
    bodies = RigidBodies(body_id=torch.zeros(X0.shape[0], dtype=torch.int64,
                                             device=ins.device), n_bodies=1)
    method = ConstraintIBMethod(ins, bodies,
                                deformation_fn=make_gait(eel, s, L))
    return method, method.initialize(X0)


def run(db: InputDatabase, device="cuda"):
    """Run the swimmer of ``db`` to ``num_steps`` on ``device`` in f32;
    returns the final state."""
    main_db = db.get_database("Main")
    idb = db.get_database("INSStaggeredHierarchyIntegrator")
    method, st = build(db, device)
    timers = TimerManager.instance()
    dt = idb.get_float("dt")
    num_steps = idb.get_int("num_steps")
    chunk = main_db.get_int("log_interval", 50)
    com0 = float(torch.mean(st.X[:, 0]))
    with MetricsLogger(main_db.get_string("log_jsonl",
                                          "eel2d_metrics.jsonl")) as metrics:
        k = 0
        while k < num_steps:
            m = min(chunk, num_steps - k)
            with timers.scope("advance", block_on=st.X):
                st = advance_constraint_ib(method, st, dt, m)
            k += m
            com = [float(v) for v in torch.mean(st.X, dim=0).cpu()]
            U_body = [float(v) for v in st.U_body[0].cpu()]
            metrics.log({"step": k, "t": float(st.ins.t),
                         "com_x": com[0], "com_y": com[1],
                         "swim_dx": com[0] - com0, "U_body": U_body})
            print(f"step {k}: COM x {com[0]:.4f} (swim dx "
                  f"{com[0] - com0:+.4f}), U_body "
                  f"{[round(v, 4) for v in U_body]}")
    print(timers.report())
    return st


def main(argv):
    if len(argv) > 2:
        raise SystemExit(__doc__.split("\n\n")[1])
    db = parse_input_file(argv[1] if len(argv) > 1 else DEFAULT_INPUT)
    return run(db, device="cuda")


if __name__ == "__main__":
    main(sys.argv)
