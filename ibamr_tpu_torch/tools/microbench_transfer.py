"""Microbenchmark: the spread and interp cost split at one size (port of
``tools/microbench_transfer.py``).

    python -m ibamr_tpu_torch.tools.microbench_transfer [--n 256]
        [--reps 10] [--n-lat N] [--no-pallas] [--json] [--device cuda|cpu]

On the ellipsoidal shell (316 x 316 markers at ``n >= 256``, else 180 x
180; radius 0.25, aspect 1.2) in an ``n^3`` box: the ``mxu`` engine's
pieces one at a time (the bucketing, the weights and the contraction of
one component, the overlap-add and the tile extraction), then the spread
and interp of a MAC velocity (three components) through each engine of
the registry on one layout: ``mxu``, ``packed`` (with its slot-preserving
refresh against a full re-pack), ``packed3``, their bf16 twins, and,
unless ``--no-pallas``, the hand-kernel engines ``pallas_packed`` and
``hybrid_bf16``. Every engine is sized as ``construct_transfer_engine``
sizes it. The packed layouts need ``n >= 16`` (a tile of 8 plus the
footprint), so a smaller ``n`` runs at 16 (``transfer_n``). Each time is
the mean of ``reps`` calls after one warm-up call, between device
synchronizations.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ibamr_tpu_torch.tools.microbench_grad import timeit


def run(n: int = 256, reps: int = 10, pallas: bool = True, device="cuda",
        n_lat=None, quiet: bool = False) -> dict:
    """Time every piece; returns the flat metrics dict. ``n_lat`` (the
    shell's rings and meridians) defaults as the module docstring says."""
    from ibamr_tpu_torch.device import resolve_device
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.models.shell3d import (construct_transfer_engine,
                                                make_spherical_shell)
    from ibamr_tpu_torch.ops.interaction_fast import (_extract_tiles,
                                                      _overlap_add,
                                                      _tile_weights,
                                                      contract_compressed)

    dev = resolve_device(device)
    nt = max(n, 16)
    grid = StaggeredGrid(n=(nt,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    nl = n_lat or (316 if n >= 256 else 180)
    shell = make_spherical_shell(nl, nl, 0.25, (0.5, 0.5, 0.5), 1.0,
                                 aspect=1.2)
    X = torch.as_tensor(shell.vertices, dtype=torch.float32, device=dev)
    N = X.shape[0]
    F = torch.ones((N, 3), dtype=torch.float32, device=dev)
    u = tuple(torch.zeros(grid.n, dtype=torch.float32, device=dev)
              for _ in range(3))
    r = reps
    out = {"n": n, "transfer_n": nt, "markers": N, "device": dev.type,
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}

    def engine(name):
        return construct_transfer_engine(name, grid, shell.vertices, "IB_4",
                                         device=dev)

    # -- the mxu engine, piece by piece (component 0) ----------------------
    eng = engine("mxu")
    geom = eng.geom
    b = eng.buckets(X)
    B = b.wb.shape[0]
    out["mxu_cap"] = geom.cap
    out["mxu_slot_util"] = N / (B * geom.cap)
    out["mxu_overflow"] = int(torch.sum(b.w_overflow > 0))
    tid = torch.arange(B, device=dev)
    out["mxu_bucket_ms"] = timeit(lambda: eng.buckets(X), r, dev)
    out["weights_1ch_ms"] = timeit(
        lambda: _tile_weights(geom, grid, b, tid, 0, "IB_4"), r, dev)
    A, W = _tile_weights(geom, grid, b, tid, 0, "IB_4")
    out["einsum_1ch_ms"] = timeit(
        lambda: contract_compressed("qpm,qzm->qpz", A, W), r, dev)
    T = contract_compressed("qpm,qzm->qpz", A, W)
    out["einsum_1ch_operand_bytes"] = (A.numel() * A.element_size()
                                       + W.numel() * W.element_size()
                                       + T.numel() * T.element_size())
    out["overlap_1ch_ms"] = timeit(lambda: _overlap_add(geom, grid, T), r,
                                   dev)
    f = _overlap_add(geom, grid, T)
    out["extract_1ch_ms"] = timeit(lambda: _extract_tiles(geom, grid, f), r,
                                   dev)
    del A, W, T, f

    # -- spread and interp of a MAC velocity through each engine ----------
    names = ["mxu", "mxu_bf16", "packed", "packed_bf16", "packed3",
             "packed3_bf16"] + (["pallas_packed", "hybrid_bf16"]
                                if pallas else [])
    layouts = {}
    for name in names:
        e = eng if name == "mxu" else engine(name)
        # the bf16 and hybrid twins share their f32 twin's layout
        base = {"mxu_bf16": "mxu", "packed_bf16": "packed",
                "packed3_bf16": "packed3", "hybrid_bf16": "packed"}.get(name)
        if base is None:
            layouts[name] = e.buckets(X)
            if name != "mxu":
                out[f"{name}_bucket_ms"] = timeit(lambda: e.buckets(X), r,
                                                  dev)
        lb = layouts[base or name]
        out[f"{name}_spread3_ms"] = timeit(
            lambda: e.spread_vel(F, X, b=lb), r, dev)
        out[f"{name}_interp3_ms"] = timeit(
            lambda: e.interpolate_vel(u, X, b=lb), r, dev)
        if name == "packed":
            # a half-step-sized drift re-gathers into the pack-time layout
            dxm = float(min(grid.dx))
            Xh = X + torch.tensor([[0.3 * dxm, -0.2 * dxm, 0.15 * dxm]],
                                  dtype=X.dtype, device=dev)
            out["packed_refresh_hit"] = bool(e.refresh(lb, Xh)[1])
            out["packed_refresh_ms"] = timeit(lambda: e.refresh(lb, Xh), r,
                                              dev)
            out["packed_chunks"] = int(lb.wb.shape[0])
            out["packed_slot_util"] = N / lb.wb.numel()

    if not quiet:
        print(f"n={nt} N={N} device={out['device_kind']}")
        for k, v in out.items():
            if k.endswith("_ms"):
                print(f"{k:24s}{v:10.3f} ms")
        print(f"packed refresh hit: {out['packed_refresh_hit']}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--n-lat", type=int, default=None,
                    help="the shell's rings and meridians (default 316 "
                         "at n >= 256, else 180)")
    ap.add_argument("--no-pallas", action="store_true",
                    help="skip the hand-kernel engines")
    ap.add_argument("--json", action="store_true",
                    help="print the metrics as one JSON line after the "
                         "table")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(n=args.n, reps=args.reps, pallas=not args.no_pallas,
              device=args.device, n_lat=args.n_lat)
    if args.json:
        print(json.dumps({k: (v if not isinstance(v, float)
                              or math.isfinite(v) else None)
                          for k, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
