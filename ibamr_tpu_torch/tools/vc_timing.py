"""Timing of the two-phase step on the committed inputs.

    python ibamr_tpu_torch/tools/vc_timing.py [--steps 10] [--warm 2]
        [--sharded] [--thresholds 16,4,1000000] [--gpus N]
        [--device cuda|cpu]

Builds the committed dam break (``examples/multiphase/dam_break/input2d``,
128x96, walls, rho 1 / 1000, mg-preconditioned CG, f32) with the port's
example driver and times its unsharded step (the projection graphed on
the card): ``warm`` steps, then ``steps`` timed steps, host clock with a
device synchronization around each step. With ``--sharded`` it also
times the block-resident step of the dam break and of the committed
falling drop (``examples/multiphase/falling_drop/input2d``, 64^2) on
(4, 2) shards of the device (with ``--gpus N``, one shard on each of
the first N GPUs instead), once for each value of
``solvers.multigrid.MIN_BLOCK`` in ``--thresholds`` (every level whose
blocks would be thinner runs whole on the first shard; 1000000 gathers
every level below the finest), each from the same initial state:
ms/step, CG iterations a step and the shapes gathered in one step.

Run it as a script, with ``PYTHONPATH`` naming the checkout whose
``ibamr_tpu_torch`` to time (the first line names the package it
imported): one machine can then time two checkouts in turn. The last
line is a JSON object of every figure.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _sync(dev):
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _timed(step, integ, s, dt, warm, steps, dev):
    """(state, ms/step over the timed steps, CG iterations a step)."""
    for _ in range(warm):
        s = step(s, dt)
    ms, its = [], []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        s = step(s, dt)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        its.append(integ.last_solve_stats["iters"])
    return s, sum(ms) / len(ms), its


def _build(root, rel, module, dev):
    import importlib

    from ibamr_tpu_torch.utils.input_db import parse_input_file

    db = parse_input_file(os.path.join(root, rel))
    dt = db.get_database("INSVCStaggeredHierarchyIntegrator").get_float("dt")
    mod = importlib.import_module(f"ibamr_tpu_torch.examples.{module}")
    integ, st = mod.build(db, dev)
    return integ, st, dt


CASES = (("dam break", "examples/multiphase/dam_break/input2d",
          "multiphase_dam_break"),
         ("falling drop", "examples/multiphase/falling_drop/input2d",
          "multiphase_falling_drop"))


def run(steps: int = 10, warm: int = 2, sharded: bool = False,
        thresholds=(16, 4, 1000000), device="cuda", gpus: int = 0) -> dict:
    import ibamr_tpu_torch
    from ibamr_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(ibamr_tpu_torch.__file__)))
    out = {"package": os.path.dirname(ibamr_tpu_torch.__file__),
           "device": _smi() if dev.type == "cuda" else "cpu"}
    print(f"[vc_timing] package {out['package']} on {out['device']}")
    name, rel, module = CASES[0]
    integ, st, dt = _build(root, rel, module, dev)
    _, ms, its = _timed(integ.step, integ, st, dt, warm, steps, dev)
    out["dam_break_unsharded_ms"] = ms
    out["dam_break_unsharded_cg"] = its
    print(f"[vc_timing] {name} {rel} unsharded: {ms:.3f} ms/step over "
          f"{steps} steps after {warm}; CG iterations {its}")
    if sharded:
        out.update(_sharded(root, thresholds, warm, steps, dev, gpus))
    return out


def _sharded(root, thresholds, warm, steps, dev, gpus) -> dict:
    from ibamr_tpu_torch.parallel import spmd
    from ibamr_tpu_torch.parallel.mesh import (make_mesh, make_sharded_step,
                                               place_state)
    from ibamr_tpu_torch.solvers import multigrid

    mesh = make_mesh(devices=[f"cuda:{i}" for i in range(gpus)] if gpus
                     else [dev] * 8)
    out = {"mesh": [str(d) for d in mesh.devices.flat]}
    default = multigrid.MIN_BLOCK
    try:
        for name, rel, module in CASES:
            integ, st, dt = _build(root, rel, module, dev)
            for mb in thresholds:
                multigrid.MIN_BLOCK = int(mb)
                sstep = make_sharded_step(integ, mesh)
                s0 = place_state(st, integ.grid, mesh)
                s, ms, its = _timed(sstep, sstep.integ, s0, dt, warm,
                                    steps, dev)
                seen = []

                def rec(kind, whole):
                    seen.append((kind, tuple(whole.shape)))

                spmd.GRID_LISTENERS.append(rec)
                try:
                    sstep(s, dt)
                finally:
                    spmd.GRID_LISTENERS.remove(rec)
                key = f"{name.replace(' ', '_')}_min_block_{mb}"
                out[key + "_ms"] = ms
                out[key + "_cg"] = its
                out[key + "_layouts"] = sorted(set(seen))
                print(f"[vc_timing] {name} on {dict(mesh.shape)} shards, "
                      f"MIN_BLOCK {mb}: {ms:.3f} ms/step over {steps} "
                      f"steps after {warm}; CG iterations {its}; one "
                      f"step's gathers and scatters "
                      f"{sorted(set(seen))} x{len(seen)}")
    finally:
        multigrid.MIN_BLOCK = default
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--thresholds", default="16,4,1000000")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gpus", type=int, default=0)
    a = ap.parse_args(argv)
    res = run(a.steps, a.warm, a.sharded,
              tuple(int(v) for v in a.thresholds.split(",")), a.device,
              a.gpus)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
