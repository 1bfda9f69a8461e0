#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ibamr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, as a check
    python3 chip_smoke.py --phases kernels     # build + kernel checks only

Phases, in order; any failure raises and the exit code is non-zero:

1. build   -- compile the four CUDA kernels from ``ibamr_tpu_torch/csrc``.
2. kernels -- at the flagship shapes (a real pack and a real per-tile
   bucketing of the 316x316 shell on the 256^3 grid) each kernel against
   its plain PyTorch version on the card, two kernel runs bitwise equal,
   and the times of the kernel, the plain version and one ``torch.bmm``
   yardstick beside the kernel's bound; every kernel writes or reads the
   grid itself, and the overlap-add and tile extraction they fold in are
   timed alone beside them; the packed spread also on a hot tile of
   40,000 markers.
3. parity  -- 3 midpoint steps of the 32^3 shell (16x16) on the GPU (the
   kernels) and on the CPU (the plain versions) from the same state, on
   the ``pallas_packed``, ``pallas``, ``hybrid_bf16``, ``hybrid_packed``
   and ``packed`` engines, each launching its own kernels and no other; a
   buffered and an exceeded overflow through each kernel engine against
   the CPU scatter oracle.
4. path    -- the flagship step, ``build_shell_example(n_cells=256,
   n_lat=316, n_lon=316, use_fast_interaction="pallas_packed")``, warmed
   up and timed; the kernel launch counts of exactly this run, and no
   tile extraction or overlap-add in it.
5. hybrid  -- the flagship on ``hybrid_bf16`` and ``hybrid_packed`` (the
   ``packed_spread`` kernel, the interp in torch ops), warmed up and timed
   beside the path phase's ``pallas_packed``: the launches of exactly
   each run (``packed_spread`` alone), the refresh hits, and one step
   taken twice from the same state, bitwise equal.
6. driver  -- the ex4 driver, ``ibamr_tpu_torch.examples.ib_explicit_ex4
   .run``, on the committed ``input3d.northstar`` (256^3, 316x316 shell)
   with ``IBMethod.transfer_engine = "pallas"``: steps/s, the metrics log,
   the kernel launches of exactly this run, the checkpoint it wrote
   restored bitwise, and a restart from its mid-run checkpoint.
7. auto    -- the ex4 driver on the committed ``input3d.northstar`` and
   ``input3d`` as they are (no ``transfer_engine``; only the output
   directories and a short run overridden): the engine each resolves
   (``packed`` and ``scatter`` by the default rule), checked against the
   resolver, and its steps/s.
8. ex0     -- the ex0 driver, ``ibamr_tpu_torch.examples.ib_explicit_ex0
   .run``, on the committed ``examples/IB/explicit/ex0/input2d`` as it is
   (64^2, 128 markers, 400 steps; the 2D path runs no hand kernel) in a
   temporary working directory: finite metrics, the area conserved to
   the reference's bound with the eccentricity falling, a restart from
   the step-200 checkpoint bitwise equal to the straight run, the first
   20 steps on the GPU against the CPU, and the steps/s of the restarted
   (warm) leg.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
raises before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and f32
# FLOP/s outside the tensor cores (the kernels use f32 FMA, no TF32).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# f32 operations per live marker slot of one transfer: 12 IB_4 weights
# of ~16 operations each, 16 products wx*wy, and a multiply-add at each
# of the 64 taps of the 4x4x4 support
OPS_PER_MARKER = 12 * 16 + 16 + 2 * 64
TOL_KERNEL = 1e-5        # max|kernel - plain| <= TOL_KERNEL * max|plain|
TOL_PARITY_X = 1e-6      # GPU vs CPU step, relative to max|X|
TOL_PARITY_U = 1e-4      # GPU vs CPU step, relative to max|u|
FLAGSHIP = dict(n_cells=256, n_lat=316, n_lon=316)
DT_FLAGSHIP = 5e-5       # bench.py's flagship timestep
WARMUP, STEPS = 3, 20    # flagship steps before and inside the timing
DRIVER_INPUT = "examples/IB/explicit/ex4/input3d.northstar"
DRIVER_STEPS = 20        # driver phase: steps, viz every 10, restart every 10
AUTO_INPUTS = ("examples/IB/explicit/ex4/input3d.northstar",
               "examples/IB/explicit/ex4/input3d")
AUTO_STEPS, AUTO_TIMED = 4, 5   # auto leg: driver steps, then timed steps
HOT_TILE_MARKERS = 40000  # the packed spread's hot-tile case
HYBRID_ENGINES = ("hybrid_bf16", "hybrid_packed")
EX0_INPUT = "examples/IB/explicit/ex0/input2d"
EX0_RESTART = 200        # ex0: the checkpoint step restarted from
EX0_PARITY_STEPS = 20    # ex0: steps of the GPU-vs-CPU check
EX0_AREA_DRIFT = 0.02    # |area - area0| / area0: tests/test_ib_membrane.py
DEVICE = "cuda"
# the TPU kernel each CUDA kernel replaces, and its source
KERNELS = {
    "packed_spread": ("ibamr_tpu_torch/csrc/packed_spread.cu",
                      "ibamr_tpu/ops/pallas_interaction.py:250"),
    "packed_interp": ("ibamr_tpu_torch/csrc/packed_interp.cu",
                      "ibamr_tpu/ops/pallas_interaction.py:314"),
    "tile_spread": ("ibamr_tpu_torch/csrc/tile_spread.cu",
                    "ibamr_tpu/ops/pallas_interaction.py:94"),
    "tile_interp": ("ibamr_tpu_torch/csrc/tile_interp.cu",
                    "ibamr_tpu/ops/pallas_interaction.py:195"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Device time of one call, from CUDA events over ``reps`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> None:
    from ibamr_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    kernel_build.load_all()
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s "
        f"(nvcc: {kernel_build.build_report.get('seconds', 0.0):.2f} s, "
        f"built {kernel_build.build_report.get('built', [])})")
    for name, info in kernel_build.build_report.get("ptxas", {}).items():
        for line in info.splitlines():
            log(f"[build] {name}: {line.strip()}")


def _check_kernel(name: str, kernel, plain, library, nbytes: int,
                  ops: float, live=None, note: str = "") -> dict:
    """One kernel against its plain version on the same inputs: max
    abs error (on live slots where ``live`` is given: the engine weights
    the rest by 0), run-to-run bitwise equality, and the times of the
    kernel (its device time from the profiler, and CUDA events around
    back-to-back wrapper calls, which the host's launch rate can set for a
    short kernel), the plain version and the ``torch.bmm`` yardstick
    beside the bound of ``nbytes`` moved and ``ops`` operations."""
    err, scale, bitwise = _compare(kernel, plain, live)
    ms = _device_ms(kernel, 20)[0]
    calls_ms = time_ms(kernel, 50)
    plain_ms = time_ms(plain, 5)
    library_ms = time_ms(library, 10)
    bms, by = bound(nbytes, ops)
    log(f"[kernels] {name}: max|kernel-plain|"
        f"{' on live slots' if live is not None else ''}={err:.3e} "
        f"(tol {TOL_KERNEL:g}*max|plain| = {TOL_KERNEL * scale:.3e}) "
        f"bitwise run-to-run={bitwise} kernel_ms(profiler device)={ms:.4f} "
        f"(events over back-to-back calls {calls_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms(bmm, {note})="
        f"{library_ms:.4f} bound_ms={bms:.4f} ({by}, {nbytes} B)")
    if not (err <= TOL_KERNEL * scale and bitwise):
        raise AssertionError(f"{name} disagrees with its plain version or "
                             "is not run-to-run bitwise")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


def _compare(kernel, plain, live=None):
    """Max |kernel - plain| (on live slots where ``live`` is given), max
    |plain| and whether two kernel runs are bitwise equal."""
    k1, k2, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    diff, mag = (k1 - ref).abs(), ref.abs()
    if live is not None:
        diff, mag = diff * live, mag * live
    return float(diff.max()), float(mag.max()), bool(torch.equal(k1, k2))


def _touched_tiles(wx, wy, wz, live, tid, B, P, nz) -> torch.Tensor:
    """(B, P, nz) count of live slots whose support covers each tile
    entry (t, p, z)."""
    lw = live[:, None, :].to(wz.dtype)
    touched = torch.einsum("qam,qbm,qzm->qabz", (wx != 0) * lw,
                           (wy != 0).to(wz.dtype), (wz != 0).to(wz.dtype))
    per_tile = torch.zeros((B, P, nz), dtype=wz.dtype, device=wz.device)
    return per_tile.index_add_(0, tid.to(torch.int64),
                               touched.reshape(tid.shape[0], P, nz))


def phase_kernels() -> dict:
    """Each kernel against its plain version at the flagship shapes."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.models.shell3d import (construct_transfer_engine,
                                                make_spherical_shell)
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops.interaction import _centering_offsets
    from ibamr_tpu_torch.ops.interaction_fast import (_extract_tiles,
                                                      _overlap_add,
                                                      bucketed_channel)

    dev = torch.device(DEVICE)
    n = FLAGSHIP["n_cells"]
    grid = StaggeredGrid(n=(n,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    shell = make_spherical_shell(FLAGSHIP["n_lat"], FLAGSHIP["n_lon"], 0.25,
                                 (0.5, 0.5, 0.5), 1.0, 0.75, 1.2)
    X = torch.tensor(shell.vertices, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(0)
    offs = _centering_offsets(grid, 0)
    F = torch.randn(X.shape[0], generator=gen).to(dev)
    f = torch.randn(grid.n, generator=gen).to(dev)
    rows = {}

    # -- packed kernels, on a real pack ----------------------------------
    eng = construct_transfer_engine("pallas_packed", grid, shell.vertices,
                                    "IB_4", device=dev)
    b = eng.buckets(X)
    geom = eng.geom
    Q, c = b.wb.shape
    live = b.wb != 0
    n_live = int(live.sum())
    B = math.prod(geom.nblk)
    P = geom.width[0] * geom.width[1]
    per_tile = torch.bincount(b.tile_of_chunk[live.any(1)].long(),
                              minlength=B)
    log(f"[kernels] flagship pack: N={X.shape[0]} Q={Q} c={c} B={B} P={P} "
        f"nz={n} live slots={n_live} occupied tiles="
        f"{int((per_tile > 0).sum())} max chunks per tile="
        f"{int(per_tile.max())} overflow={b.any_overflow}")
    coef = (bucketed_channel(b, F) * b.wb / grid.cell_volume).contiguous()
    T_in = _extract_tiles(geom, grid, f).contiguous()
    tid, Xb = b.tile_of_chunk, b.Xb
    wx, wy, wz = ci.tile_weights(geom, grid, offs, tid, Xb)
    A = (wx[:, :, None, :] * wy[:, None, :, :]).reshape(Q, P, c)
    Wzc = (wz * coef[:, None, :]).transpose(1, 2).contiguous()
    # the spread stores the grid once and reads tid, every coef and the X
    # of the live slots (coef != 0) only
    rows["packed_spread"] = _check_kernel(
        "packed_spread",
        lambda: ci.packed_spread(geom, grid, offs, tid, Xb, coef),
        lambda: ci.packed_spread_plain(geom, grid, offs, tid, Xb, coef),
        lambda: torch.bmm(A, Wzc),
        4 * (tid.numel() + coef.numel() + 3 * n_live + f.numel()),
        n_live * OPS_PER_MARKER, note="product only")
    del A, Wzc
    # what the two spread kernels fold in, alone at the flagship shapes:
    # the overlap-add of (B, P, nz) partials
    T_part = torch.randn((B, P, n), generator=gen).to(dev)
    fold_ms = time_ms(lambda: _overlap_add(geom, grid, T_part), 10)
    log(f"[kernels] folded into packed_spread and tile_spread, timed alone: "
        f"_overlap_add of ({B}, {P}, {n}) partials {fold_ms:.4f} ms")
    del T_part
    check_hot_tile(grid, offs)
    extract_ms = time_ms(lambda: _extract_tiles(geom, grid, f), 10)
    log(f"[kernels] folded into packed_interp, timed alone: _extract_tiles "
        f"of a {n}^3 field into ({B}, {P}, {n}) tiles {extract_ms:.4f} ms")
    # an interp reads the grid entries under the live supports once, the
    # X of every slot (it evaluates them all), tid, and writes (Q, c)
    touched = _touched_tiles(wx, wy, wz, live, tid, B, P, n)
    n_touched = int((_overlap_add(geom, grid, touched) != 0).sum())
    del touched
    Tq = T_in[tid.to(torch.int64)].contiguous()
    rows["packed_interp"] = _check_kernel(
        "packed_interp",
        lambda: ci.packed_interp(geom, grid, offs, tid, Xb, f),
        lambda: ci.packed_interp_plain(geom, grid, offs, tid, Xb, f),
        lambda: torch.bmm(Tq, wz),
        4 * (tid.numel() + Xb.numel() + n_touched + Q * c),
        n_live * OPS_PER_MARKER,
        note=f"z-contraction only; {n_touched} grid entries touched")
    del Tq, wx, wy, wz

    # -- tile kernels, on the pallas engine's real per-tile bucketing ------
    eng = construct_transfer_engine("pallas", grid, shell.vertices, "IB_4",
                                    device=dev)
    b = eng.buckets(X)
    geom = eng.geom
    cap = geom.cap
    live = b.wb != 0
    n_live = int(live.sum())
    n_over = int((b.slot_of_marker >= B * cap).sum())
    log(f"[kernels] flagship per-tile bucketing: N={X.shape[0]} B={B} "
        f"cap={cap} P={P} nz={n} live slots={n_live} (slot utilization "
        f"{n_live / (B * cap):.3f}) occupied tiles="
        f"{int(live.any(1).sum())} hottest tile "
        f"{int(live.sum(1).max())} overflow markers={n_over} "
        f"(buffer {b.o_idx.numel()}, exceeded={b.exceeded})")
    if B != 1024 or cap != 1024:
        raise AssertionError(f"expected B = cap = 1024, got {B}, {cap}")
    coef = (bucketed_channel(b, F) * b.wb / grid.cell_volume).contiguous()
    Xb, counts = b.Xb, b.counts
    tid = torch.arange(B, dtype=torch.int32, device=dev)
    wx, wy, wz = ci.tile_weights(geom, grid, offs, tid, Xb)
    A = (wx[:, :, None, :] * wy[:, None, :, :]).reshape(B, P, cap)
    Wzc = (wz * coef[:, None, :]).transpose(1, 2).contiguous()
    # the kernel stores the grid once and reads the X and coef of the
    # filled slots (here all live) and the counts
    rows["tile_spread"] = _check_kernel(
        "tile_spread",
        lambda: ci.tile_spread(geom, grid, offs, Xb, coef, counts),
        lambda: ci.tile_spread_plain(geom, grid, offs, Xb, coef, counts),
        lambda: torch.bmm(A, Wzc),
        4 * (f.numel() + 4 * n_live + B),
        n_live * OPS_PER_MARKER, note="product only")
    del A, Wzc
    # what the two kernels fold in, timed alone above (both layouts have
    # the same B tiles)
    log(f"[kernels] folded into the tile kernels, timed alone: "
        f"_overlap_add of ({B}, {P}, {n}) partials {fold_ms:.4f} ms, "
        f"_extract_tiles of a {n}^3 field {extract_ms:.4f} ms")
    # an interp reads the grid entries under the live supports once
    touched = _touched_tiles(wx, wy, wz, live, tid, B, P, n)
    n_touched = int((_overlap_add(geom, grid, touched) != 0).sum())
    del touched
    rows["tile_interp"] = _check_kernel(
        "tile_interp",
        lambda: ci.tile_interp(geom, grid, offs, Xb, f, counts),
        lambda: ci.tile_interp_plain(geom, grid, offs, Xb, f, counts),
        lambda: torch.bmm(T_in, wz),
        4 * (3 * n_live + n_touched + B * cap + B),
        n_live * OPS_PER_MARKER, live=live,
        note=f"z-contraction only; {n_touched} grid entries touched")
    return rows


def check_hot_tile(grid, offs) -> None:
    """The packed spread on a pack whose one hot tile holds
    HOT_TILE_MARKERS markers (313 chunks of 128): the columns around it
    hold more 32-slot chunks than the kernel's chunk table and more than
    2^15 live slots, so they walk every chunk per slab and narrow their
    fixed point. Kernel against plain, bitwise run to run."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops.interaction_fast import bucketed_channel
    from ibamr_tpu_torch.ops.interaction_packed import suggest_chunks

    rng = np.random.default_rng(2)
    N = HOT_TILE_MARKERS
    lo, hi = 10.0 / grid.n[0], 16.0 / grid.n[0]   # stencil origins 8..14
    X = np.stack([rng.uniform(lo, hi, N), rng.uniform(lo, hi, N),
                  rng.uniform(0, 1, N)], axis=1).astype(np.float32)
    Q = suggest_chunks(grid, X, tile=8, chunk=128, slack=1.3)
    eng = ci.PackedKernelInteraction(grid, chunk=128, nchunks=Q,
                                     device=DEVICE)
    b = eng.buckets(torch.tensor(X, device=DEVICE))
    live = (b.wb != 0).any(1)
    tiles = b.tile_of_chunk[live].unique()
    F = torch.tensor(rng.standard_normal(N), dtype=torch.float32,
                     device=DEVICE)
    coef = (bucketed_channel(b, F) * b.wb / grid.cell_volume).contiguous()
    err, scale, bitwise = _compare(
        lambda: ci.packed_spread(eng.geom, grid, offs, b.tile_of_chunk,
                                 b.Xb, coef),
        lambda: ci.packed_spread_plain(eng.geom, grid, offs,
                                       b.tile_of_chunk, b.Xb, coef))
    log(f"[kernels] packed_spread hot tile: {N} markers in tiles "
        f"{tiles.tolist()}, {int(live.sum())} live chunks of Q={Q}, "
        f"overflow={b.any_overflow}: max|kernel-plain|={err:.3e} (tol "
        f"{TOL_KERNEL:g}*max|plain| = {TOL_KERNEL * scale:.3e}) bitwise "
        f"run-to-run={bitwise}")
    if tiles.numel() != 1 or int(live.sum()) * 4 <= 1024 or b.any_overflow:
        raise AssertionError("the hot-tile case is not one tile of more "
                             "chunks than the kernel's table")
    if not (err <= TOL_KERNEL * scale and bitwise):
        raise AssertionError("packed_spread disagrees with its plain "
                             "version on the hot tile or is not "
                             "run-to-run bitwise")


def _to(s, dev):
    """An IBState's tensors on ``dev``."""
    from ibamr_tpu_torch.integrators.ib import IBState
    from ibamr_tpu_torch.integrators.ins import INSState

    return IBState(ins=INSState(*(tuple(x.to(dev) for x in v)
                                  if isinstance(v, tuple) else v.to(dev)
                                  for v in s.ins)),
                   X=s.X.to(dev), U=s.U.to(dev), mask=s.mask.to(dev))


# the kernels each engine launches (the packed engine is the reference's
# XLA engine in torch ops: none; the hybrid engines interpolate with it)
ENGINE_KERNELS = {"pallas_packed": ("packed_spread", "packed_interp"),
                  "pallas": ("tile_spread", "tile_interp"),
                  "hybrid_bf16": ("packed_spread",),
                  "hybrid_packed": ("packed_spread",),
                  "packed": ()}


def phase_parity() -> None:
    """3 midpoint steps of the 32^3 shell: GPU (kernels) vs CPU (plain),
    on each engine, then the overflow fallbacks on the card."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci

    for engine, kernels in ENGINE_KERNELS.items():
        kw = dict(n_cells=32, n_lat=16, n_lon=16,
                  use_fast_interaction=engine, dtype=torch.float32)
        gpu, _ = build_shell_example(device=DEVICE, **kw)
        cpu, cs = build_shell_example(device="cpu", **kw)
        gs = _to(cs, DEVICE)
        before = dict(ci.LAUNCHES)
        for _ in range(3):
            gs, _ = gpu.step_with_stats(gs, 1e-3)
            cs, _ = cpu.step_with_stats(cs, 1e-3)
        torch.cuda.synchronize()
        ran = {k: ci.LAUNCHES[k] - before[k] for k in before}
        gX, cX = gs.X.cpu(), cs.X
        ex = float((gX - cX).abs().max() / cX.abs().max())
        eu = max(float((a.cpu() - b).abs().max() / b.abs().max())
                 for a, b in zip(gs.ins.u, cs.ins.u))
        finite = all(bool(torch.isfinite(t).all())
                     for t in (gs.X, *gs.ins.u, gs.ins.p))
        log(f"[parity] {engine}: 32^3 shell 16x16, 3 midpoint steps "
            f"dt=1e-3, f32: max|X_gpu-X_cpu|/max|X|={ex:.3e} (tol "
            f"{TOL_PARITY_X:g}) max_d |u_gpu-u_cpu|/max|u|={eu:.3e} (tol "
            f"{TOL_PARITY_U:g}) finite={finite} kernel launches={ran}")
        if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U and finite):
            raise AssertionError(f"GPU and CPU steps disagree on {engine}")
        if ran != {k: (ran[k] if k in kernels else 0) for k in ran} \
                or not all(ran[k] for k in kernels):
            raise AssertionError(f"the GPU step on {engine} did not launch "
                                 f"its kernels {kernels} alone")
    check_overflow()


def check_overflow() -> None:
    """Markers beyond the layout's capacity take the scatter fallback on
    the GPU (deterministic accumulation): for each engine a buffered and
    an exceeded overflow, each twice (bitwise equal) and against the CPU
    scatter oracle."""
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.ops import interaction
    from ibamr_tpu_torch.ops.cuda_interaction import (PackedKernelInteraction,
                                                      TileKernelInteraction)

    grid = StaggeredGrid(n=(32,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.uniform(0, 1, (1500, 3)), dtype=torch.float32)
    F = torch.tensor(rng.standard_normal((1500, 3)), dtype=torch.float32)
    u = tuple(torch.tensor(rng.standard_normal(grid.n), dtype=torch.float32)
              for _ in range(3))
    f_ref = interaction.spread_vel(F, grid, X)
    U_ref = interaction.interpolate_vel(u, grid, X)
    Xd, Fd, ud = X.to(DEVICE), F.to(DEVICE), tuple(c.to(DEVICE) for c in u)
    engines = {
        "pallas_packed": lambda ocap: PackedKernelInteraction(
            grid, chunk=128, nchunks=4, overflow_cap=ocap, device=DEVICE),
        "pallas": lambda ocap: TileKernelInteraction(
            grid, cap=32, overflow_cap=ocap, device=DEVICE)}
    for engine, make in engines.items():
        for ocap in (None, 64):
            eng = make(ocap)
            b = eng.buckets(Xd)
            f1, f2 = (eng.spread_vel(Fd, Xd, b=b) for _ in range(2))
            U1, U2 = (eng.interpolate_vel(ud, Xd, b=b) for _ in range(2))
            bitwise = (all(torch.equal(p, q) for p, q in zip(f1, f2))
                       and torch.equal(U1, U2))
            ef = max(float((a.cpu() - r).abs().max() / r.abs().max())
                     for a, r in zip(f1, f_ref))
            eU = float((U1.cpu() - U_ref).abs().max() / U_ref.abs().max())
            log(f"[parity] {engine} overflow (cap {b.o_idx.numel()}, "
                f"exceeded={b.exceeded}): spread vs CPU oracle {ef:.3e}, "
                f"interp {eU:.3e} (tol {TOL_KERNEL:g}), bitwise "
                f"run-to-run={bitwise}")
            if not (b.any_overflow and b.exceeded == (ocap is not None)):
                raise AssertionError("the overflow case did not overflow")
            if not (bitwise and ef <= TOL_KERNEL and eU <= TOL_KERNEL):
                raise AssertionError("the GPU overflow fallback is wrong "
                                     "or not run-to-run deterministic")


def phase_path(warmup: int, steps: int):
    """The flagship step on the packed-kernel engine; returns the launch
    counts of exactly this run, ms per step, the integrator and the state
    it reached."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops import interaction_fast

    t0 = time.perf_counter()
    integ, state = build_shell_example(use_fast_interaction="pallas_packed",
                                       dtype=torch.float32, device=DEVICE,
                                       **FLAGSHIP)
    torch.cuda.synchronize()
    log(f"[path] built flagship in {time.perf_counter() - t0:.2f} s: "
        f"grid {integ.ins.grid.n}, {state.X.shape[0]} markers, "
        f"engine {integ.ib.engine_name}, Q={integ.ib.fast.nchunks}")
    X0 = state.X.clone()
    # the packed kernels write and read the grid themselves: count any
    # tile extraction or overlap-add
    folds = {"_extract_tiles": [], "_overlap_add": []}
    real = {name: getattr(interaction_fast, name) for name in folds}

    def counted(name):
        def fn(*args, **kwargs):
            folds[name].append(1)
            return real[name](*args, **kwargs)
        return fn

    for mod in (ci, interaction_fast):
        for name in folds:
            setattr(mod, name, counted(name))
    ci.reset_launch_counts()
    hits = []
    try:
        for _ in range(warmup):
            state, st = integ.step_with_stats(state, DT_FLAGSHIP)
            hits.append(st["refresh_hit"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, st = integ.step_with_stats(state, DT_FLAGSHIP)
            hits.append(st["refresh_hit"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod in (ci, interaction_fast):
            for name in folds:
                setattr(mod, name, real[name])
    launches = dict(ci.LAUNCHES)
    total = warmup + steps
    div = float(integ.ins.max_divergence(state.ins))
    umax = max(float(c.abs().max()) for c in state.ins.u)
    rel_div = div * integ.ins.grid.dx[0] / max(umax, 1e-30)
    disp = float((state.X - X0).abs().max())
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.X, *state.ins.u, state.ins.p))
    log(f"[path] {torch.cuda.get_device_name(0)}: {steps} timed steps "
        f"after {warmup} warm-up: {steps / wall:.3f} steps/s, "
        f"{1e3 * wall / steps:.3f} ms/step (host clock, synchronized)")
    log(f"[path] refresh hits {sum(bool(h) for h in hits)}/{len(hits)}; "
        f"max|div u|={div:.3e} (max|u|={umax:.3e}, "
        f"max|div u|*dx/max|u|={rel_div:.3e}); "
        f"max|X-X0|={disp:.3e}; finite={finite}")
    log(f"[path] kernel launches in {total} steps: {launches} "
        f"(per step: packed_spread 3 = one per velocity component, "
        f"packed_interp 6 = two interps x 3 components); tile extractions "
        f"{len(folds['_extract_tiles'])}, overlap-adds "
        f"{len(folds['_overlap_add'])}")
    if not finite:
        raise AssertionError("flagship state is not finite")
    if rel_div > 1e-4:
        raise AssertionError("flagship velocity is not divergence-free")
    if launches != {**dict.fromkeys(KERNELS, 0), "packed_spread": 3 * total,
                    "packed_interp": 6 * total}:
        raise AssertionError(f"unexpected kernel launch counts {launches}")
    if folds["_extract_tiles"] or folds["_overlap_add"]:
        raise AssertionError("the pallas_packed step extracted or folded "
                             "tiles")
    return launches, 1e3 * wall / steps, integ, state


def _finite_div(integ, state):
    """Whether the state is finite, and max|div u| * dx / max|u|."""
    div = float(integ.ins.max_divergence(state.ins))
    umax = max(float(c.abs().max()) for c in state.ins.u)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.X, *state.ins.u, state.ins.p))
    return finite, div * integ.ins.grid.dx[0] / max(umax, 1e-30)


def phase_hybrid(path_ms: float, breakdown: bool = False) -> dict:
    """The flagship on each hybrid engine: WARMUP steps, then STEPS timed;
    the launches of exactly those steps (``packed_spread``, 3 per step,
    and no other kernel), the refresh hits, then one step taken twice
    from the state reached, bitwise equal. Returns the summed launches."""
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.utils.tree import flatten_with_path

    total = dict.fromkeys(KERNELS, 0)
    for engine in HYBRID_ENGINES:
        t0 = time.perf_counter()
        integ, state = build_shell_example(use_fast_interaction=engine,
                                           dtype=torch.float32,
                                           device=DEVICE, **FLAGSHIP)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ci.reset_launch_counts()
        hits = []
        for _ in range(WARMUP):
            state, st = integ.step_with_stats(state, DT_FLAGSHIP)
            hits.append(st["refresh_hit"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, st = integ.step_with_stats(state, DT_FLAGSHIP)
            hits.append(st["refresh_hit"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ci.LAUNCHES)
        one, two = (integ.step(state, DT_FLAGSHIP) for _ in range(2))
        bitwise = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(one), flatten_with_path(two)))
        finite, rel_div = _finite_div(integ, state)
        ms = 1e3 * wall / STEPS
        log(f"[hybrid] {engine} on {torch.cuda.get_device_name(0)}: built "
            f"in {build_s:.2f} s (Q={integ.ib.fast.nchunks}, interp "
            f"compute dtype {integ.ib.fast.compute_dtype}); {STEPS} timed "
            f"steps after {WARMUP} warm-up: {1e3 / ms:.3f} steps/s, "
            f"{ms:.3f} ms/step (host clock, synchronized) vs pallas_packed "
            f"{1e3 / path_ms:.3f} steps/s (path phase, same call)")
        log(f"[hybrid] {engine}: refresh hits {sum(bool(h) for h in hits)}/"
            f"{len(hits)}; kernel launches in {WARMUP + STEPS} steps "
            f"{launches} (per step: packed_spread 3, no interp kernel); one "
            f"step twice from the same state bitwise={bitwise}; finite="
            f"{finite}, max|div u|*dx/max|u|={rel_div:.3e}")
        want = {**dict.fromkeys(KERNELS, 0),
                "packed_spread": 3 * (WARMUP + STEPS)}
        if launches != want:
            raise AssertionError(f"{engine}: unexpected kernel launch "
                                 f"counts {launches}")
        if not (finite and bitwise and rel_div <= 1e-4):
            raise AssertionError(f"{engine}: state not finite, not "
                                 "divergence-free or not run-to-run bitwise")
        total = {k: total[k] + launches[k] for k in total}
        if breakdown:
            phase_breakdown(integ, state, ms, engine)
        del integ, state, one, two
    return total


def _ecc(X: torch.Tensor) -> float:
    """Largest over smallest distance of the markers from their mean."""
    r = torch.linalg.norm(X - X.mean(0), dim=1)
    return float(r.max() / r.min())


def phase_ex0(breakdown: bool = False) -> dict:
    """The ex0 driver on the committed input2d as it is, on the card, in a
    temporary working directory; returns the kernel launches of the run
    (none: the 2D path runs no hand kernel). With ``breakdown``, the
    profile of the step at the state the run reached."""
    from ibamr_tpu_torch.examples import ib_explicit_ex0
    from ibamr_tpu_torch.integrators.ib import advance_ib, polygon_area
    from ibamr_tpu_torch.models.membrane2d import build_membrane_example
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager
    from ibamr_tpu_torch.utils.tree import flatten_with_path

    db = parse_input_file(os.path.join(ROOT, EX0_INPUT))
    ins_db = db.get_database("INSStaggeredHierarchyIntegrator")
    main = db.get_database("Main")
    steps, dt = ins_db.get_int("num_steps"), ins_db.get_float("dt")
    _, s0 = build_membrane_example(input_db=db, device=DEVICE)
    area0, ecc0 = float(polygon_area(s0.X)), _ecc(s0.X)
    timer = TimerManager.instance()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            timer.reset()
            ci.reset_launch_counts()
            t0 = time.perf_counter()
            state = ib_explicit_ex0.run(db, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ci.LAUNCHES)
            run_s = timer.get("IB::advanceHierarchy").total
            with open(main.get_string("log_file")) as fh:
                records = [json.loads(ln) for ln in fh]
            rst = main.get_string("restart_dirname")
            ckpts = sorted(os.listdir(rst))
            viz = [f for f in os.listdir(main.get_string("viz_dirname"))
                   if f.endswith(".csv")]
            timer.reset()
            again = ib_explicit_ex0.run(db, device=DEVICE,
                                        restart=(rst, EX0_RESTART))
            torch.cuda.synchronize()
            warm_s = timer.get("IB::advanceHierarchy").total
        finally:
            os.chdir(cwd)
    restart_bitwise = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_path(again), flatten_with_path(state)))
    finite = all(isinstance(v, (int, float)) and math.isfinite(v)
                 for r in records for v in r.values())
    area1, ecc1 = records[-1]["area"], _ecc(state.X)
    drift = abs(area1 - area0) / area0
    # the first steps on the card against the CPU, from the same build
    gi, gs = build_membrane_example(input_db=db, device=DEVICE)
    ci_, cs = build_membrane_example(input_db=db, device="cpu")
    gs = advance_ib(gi, gs, dt, EX0_PARITY_STEPS)
    cs = advance_ib(ci_, cs, dt, EX0_PARITY_STEPS)
    ex = float((gs.X.cpu() - cs.X).abs().max() / cs.X.abs().max())
    eu = max(float((a.cpu() - b).abs().max() / b.abs().max())
             for a, b in zip(gs.ins.u, cs.ins.u))
    warm = steps - EX0_RESTART
    log(f"[ex0] {EX0_INPUT} on {torch.cuda.get_device_name(0)}: grid "
        f"{s0.ins.u[0].shape}, {s0.X.shape[0]} markers, {steps} steps of "
        f"dt={dt:g}, f32: {steps / run_s:.3f} steps/s over the run (first "
        f"chunk's set-up included), restarted leg of {warm} steps "
        f"{warm / warm_s:.3f} steps/s, {1e3 * warm_s / warm:.3f} ms/step "
        f"(warm chunks: host clock around each chunk and its synchronize); "
        f"whole run {wall:.2f} s with build, metrics, viz and checkpoints")
    for r in records:
        log(f"[ex0] metrics {json.dumps(r)}")
    log(f"[ex0] area {area0:.9g} -> {area1:.9g}: |drift|/area0={drift:.3e} "
        f"(bound {EX0_AREA_DRIFT}); eccentricity max r/min r {ecc0:.6f} -> "
        f"{ecc1:.6f}; marker CSVs {len(viz)}, restart files {ckpts}; restart "
        f"from step {EX0_RESTART} bitwise={restart_bitwise}; kernel "
        f"launches {launches}")
    log(f"[ex0] first {EX0_PARITY_STEPS} steps GPU vs CPU: "
        f"max|X_gpu-X_cpu|/max|X|={ex:.3e} (tol {TOL_PARITY_X:g}) max_d "
        f"|u_gpu-u_cpu|/max|u|={eu:.3e} (tol {TOL_PARITY_U:g})")
    if not (finite and len(records) * main.get_int("viz_dump_interval")
            == steps and int(state.ins.k) == steps):
        raise AssertionError("ex0: metrics not finite or the run incomplete")
    if not (drift < EX0_AREA_DRIFT and ecc1 < ecc0):
        raise AssertionError("ex0: area not conserved or the ellipse did "
                             "not relax")
    if not restart_bitwise:
        raise AssertionError("ex0: the restarted run does not reach the "
                             "straight run's state bitwise")
    if not (ex <= TOL_PARITY_X and eu <= TOL_PARITY_U):
        raise AssertionError("ex0: GPU and CPU steps disagree")
    if any(launches.values()):
        raise AssertionError(f"ex0: unexpected kernel launches {launches}")
    if breakdown:
        phase_breakdown(gi, state, 1e3 * warm_s / warm, "ex0", dt)
    return launches


def _device_ms(fn, reps: int):
    """Device busy time of one call: the profiler's sum of kernel (self
    device) time over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    return (sum(map(_self_device_us, rows)) / reps / 1e3,
            sum(e.count for e in rows) / reps, prof)


def _self_device_us(e) -> float:
    """Self device time of a profiler row that is a device kernel (the
    rows of host ops repeat their kernels' time and are not counted)."""
    if not str(getattr(e, "device_type", "")).endswith("CUDA"):
        return 0.0
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_driver(steps: int):
    """The ex4 driver on the committed north-star input, on the ``pallas``
    engine; returns the kernel launch counts of exactly the driven run,
    ms per step of the warm restarted leg, the input database it ran and
    the state it reached."""
    from ibamr_tpu_torch.examples import ib_explicit_ex4
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops import stencils
    from ibamr_tpu_torch.utils.checkpoint import restore_checkpoint
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager
    from ibamr_tpu_torch.utils.tree import flatten_with_path

    db = parse_input_file(os.path.join(ROOT, DRIVER_INPUT))
    with tempfile.TemporaryDirectory() as tmp:
        main = db.get_database("Main")
        for key, val in (("log_file", os.path.join(tmp, "metrics.jsonl")),
                         ("viz_dirname", os.path.join(tmp, "viz")),
                         ("restart_dirname", os.path.join(tmp, "restart")),
                         ("viz_dump_interval", steps // 2),
                         ("restart_interval", steps // 2)):
            main.put(key, val)
        db.get_database("INSStaggeredHierarchyIntegrator").put("num_steps",
                                                               steps)
        db.get_database("IBMethod").put("transfer_engine", "pallas")
        geo = db.get_database("CartesianGeometry")
        shell = db.get_database("Shell")
        log(f"[driver] {DRIVER_INPUT}: grid {geo.get_int_array('n_cells')}, "
            f"shell {shell.get_int('n_lat')}x{shell.get_int('n_lon')}, "
            f"engine pallas, {steps} steps, viz and restart every "
            f"{steps // 2}")
        timer = TimerManager.instance()
        timer.reset()
        ci.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ib_explicit_ex4.run(db, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ci.LAUNCHES)
        adv = timer.get("IB::advanceHierarchy")
        run_s, chunks = adv.total, adv.count
        with open(main.get_string("log_file")) as fh:
            lines = fh.read().splitlines()
        for ln in lines:
            log(f"[driver] metrics {ln}")
        viz = sorted(os.listdir(main.get_string("viz_dirname")))
        rst = main.get_string("restart_dirname")
        ckpts = sorted(os.listdir(rst))
        saved, k, _ = restore_checkpoint(rst, state, step=steps)
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(saved), flatten_with_path(state)))
        # a restart from the mid-run checkpoint reaches the same state
        again = ib_explicit_ex4.run(db, device=DEVICE,
                                    restart=(rst, steps // 2))
        torch.cuda.synchronize()
        err_X = float((again.X - state.X).abs().max() / state.X.abs().max())
        restart_bitwise = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_path(again), flatten_with_path(state)))
        # the restarted leg runs on a warm process (the first chunk of the
        # run pays the phase's one-time CUDA/cuFFT set-up)
        step_ms = 1e3 * (adv.total - run_s) / (steps - steps // 2)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (state.X, *state.ins.u, state.ins.p))
    dx = tuple((hi - lo) / n for lo, hi, n in zip(
        geo.get_float_array("x_lo"), geo.get_float_array("x_up"),
        geo.get_int_array("n_cells")))
    umax = max(float(c.abs().max()) for c in state.ins.u)
    div = float(stencils.divergence(state.ins.u, dx).abs().max())
    rel_div = div * dx[0] / max(umax, 1e-30)
    log(f"[driver] {torch.cuda.get_device_name(0)}: run of {steps} steps in "
        f"{chunks} chunks: {steps / run_s:.3f} steps/s, "
        f"{1e3 * run_s / steps:.3f} ms/step with the first chunk's set-up; "
        f"restarted leg of {steps - steps // 2} steps: "
        f"{1e3 / step_ms:.3f} steps/s, {step_ms:.3f} ms/step (host clock "
        f"around each chunk and its synchronizing finite check); whole "
        f"run {wall:.2f} s with build, metrics, viz and checkpoints")
    log(f"[driver] metrics lines {len(lines)}, viz files {viz}, restart "
        f"files {ckpts}; checkpoint of step {k} restored bitwise={same}; "
        f"restart from step {steps // 2}: max|X-X_run|/max|X|={err_X:.3e} "
        f"bitwise={restart_bitwise}")
    log(f"[driver] final state finite={finite}, max|div u|*dx/max|u|="
        f"{rel_div:.3e} (max|u|={umax:.3e}); kernel launches {launches} "
        f"(per step: tile_spread 3, tile_interp 6)")
    if not finite:
        raise AssertionError("driver state is not finite")
    if rel_div > 1e-4:
        raise AssertionError("driver velocity is not divergence-free")
    if launches != {**dict.fromkeys(KERNELS, 0), "tile_spread": 3 * steps,
                    "tile_interp": 6 * steps}:
        raise AssertionError(f"unexpected kernel launch counts {launches}")
    if len(lines) != chunks or not same:
        raise AssertionError("the driver's metrics log or checkpoint is "
                             "wrong")
    if not restart_bitwise:
        raise AssertionError("the restarted run does not reach the state "
                             "of the uninterrupted run bitwise")
    return launches, step_ms, db, state


def phase_auto(path_ms: float, breakdown: bool = False):
    """The ex4 driver on each committed input as it is (no
    ``transfer_engine``): the engine it resolves, checked against the
    resolver, the launches of exactly that run (none: the resolved
    engines run no hand kernel), its steps/s, then AUTO_TIMED steps of
    the built integrator timed alone beside the path phase's
    ``pallas_packed``; with ``breakdown``, the profile of the flagship's
    ``packed`` step."""
    from ibamr_tpu_torch.examples import ib_explicit_ex4
    from ibamr_tpu_torch.models.engine_resolver import resolve_engine
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops.delta import get_kernel
    from ibamr_tpu_torch.utils.input_db import parse_input_file
    from ibamr_tpu_torch.utils.timers import TimerManager

    real_build = ib_explicit_ex4.build_shell_example
    for path in AUTO_INPUTS:
        db = parse_input_file(os.path.join(ROOT, path))
        if "transfer_engine" in db.get_database("IBMethod").keys():
            raise AssertionError(f"{path} names a transfer engine")
        geo = db.get_database("CartesianGeometry")
        shell = db.get_database("Shell")
        n = tuple(geo.get_int_array("n_cells"))
        markers = shell.get_int("n_lat") * shell.get_int("n_lon")
        want = resolve_engine(
            n, markers,
            get_kernel(db.get_database("IBMethod").get_string("delta_fcn"))[0],
            spectral_dtype=db.get_database(
                "INSStaggeredHierarchyIntegrator").get_string(
                    "spectral_dtype", "f32"),
            platform="cuda")
        built = []

        def spy(*args, **kwargs):
            built.append(real_build(*args, **kwargs))
            return built[-1]

        with tempfile.TemporaryDirectory() as tmp:
            main = db.get_database("Main")
            for key, val in (("log_file", os.path.join(tmp, "metrics.jsonl")),
                             ("viz_dirname", os.path.join(tmp, "viz")),
                             ("restart_dirname", os.path.join(tmp, "rst"))):
                main.put(key, val)
            db.get_database("INSStaggeredHierarchyIntegrator").put(
                "num_steps", AUTO_STEPS)
            timer = TimerManager.instance()
            timer.reset()
            ib_explicit_ex4.build_shell_example = spy
            ci.reset_launch_counts()
            try:
                state = ib_explicit_ex4.run(db, device=DEVICE)
                torch.cuda.synchronize()
            finally:
                ib_explicit_ex4.build_shell_example = real_build
            launches = dict(ci.LAUNCHES)
            adv = timer.get("IB::advanceHierarchy")
        integ = built[0][0]
        run_sps = AUTO_STEPS / adv.total
        dt = db.get_database("INSStaggeredHierarchyIntegrator").get_float(
            "dt")
        st = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AUTO_TIMED):
            st = integ.step(st, dt)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / AUTO_TIMED
        finite = all(bool(torch.isfinite(t).all())
                     for t in (st.X, *st.ins.u, st.ins.p))
        log(f"[auto] {path} (grid {n}, {markers} markers, no "
            f"transfer_engine): resolved {integ.ib.engine_name!r} "
            f"(resolve_engine on cuda: {want!r}); {AUTO_STEPS} driver steps "
            f"{run_sps:.3f} steps/s (first chunk's set-up included), then "
            f"{AUTO_TIMED} steps alone {1e3 / step_ms:.3f} steps/s, "
            f"{step_ms:.3f} ms/step; kernel launches {launches}; "
            f"finite={finite}")
        if want == "packed":
            log(f"[auto] shoot-out datum on "
                f"{torch.cuda.get_device_name(0)}: packed "
                f"{1e3 / step_ms:.3f} steps/s vs pallas_packed "
                f"{1e3 / path_ms:.3f} steps/s (path phase) at the flagship")
        if integ.ib.engine_name != want or int(state.ins.k) != AUTO_STEPS:
            raise AssertionError(f"{path} resolved {integ.ib.engine_name!r}"
                                 f", not {want!r}, or did not run")
        if any(launches.values()) or not finite:
            raise AssertionError(f"{path}: unexpected kernel launches "
                                 f"{launches} or a state that is not finite")
        if breakdown and want == "packed":
            phase_breakdown(integ, st, step_ms, "packed")


def phase_breakdown(integ, state, step_ms: float, label: str,
                    dt: float = DT_FLAGSHIP) -> None:
    """Where a step's time goes: each stage of ``step_with_stats`` alone
    on the state a timed phase reached (host clock around a synchronize,
    and the profiler's device busy time), then the top kernels of whole
    steps and the device's idle share. An engine without a refresh
    buckets twice per step; the scatter oracle (no engine) buckets not at
    all."""
    ib, grid, s = integ.ib, integ.ins.grid, state
    ctx = ib.prepare(s.X, s.mask)
    U = ib.interpolate_velocity(s.ins.u, grid, s.X, s.mask, ctx=ctx)
    Xh = s.X + 0.5 * dt * U
    refresh = hasattr(ib.fast, "refresh")
    ctx_h = ib.refresh(ctx, Xh, s.mask)[0] if refresh else \
        ib.prepare(Xh, s.mask)
    F = ib.compute_force(Xh, U, s.ins.t)
    f = ib.spread_force(F, grid, Xh, s.mask, ctx=ctx_h)
    stages = [("pack", 1, lambda: ib.prepare(s.X, s.mask)),
              ("refresh", 1, lambda: ib.refresh(ctx, Xh, s.mask))] \
        if refresh else [("bucket", 2, lambda: ib.prepare(s.X, s.mask))] \
        if ib.fast is not None else []
    stages += [
        ("interp", 2, lambda: ib.interpolate_velocity(
            s.ins.u, grid, s.X, s.mask, ctx=ctx)),
        ("force", 1, lambda: ib.compute_force(Xh, U, s.ins.t)),
        ("spread", 1, lambda: ib.spread_force(F, grid, Xh, s.mask,
                                              ctx=ctx_h)),
        ("fluid", 1, lambda: integ.ins.step(s.ins, dt, f=f)),
    ]
    for name, per_step, fn in stages:
        host = _host_ms(fn, 10)
        dev, kernels, _ = _device_ms(fn, 3)
        log(f"[breakdown] {label} {name:8s} x{per_step}/step: host "
            f"{host:.3f} ms, "
            f"device busy {dev:.3f} ms in {kernels:.0f} kernels per call")

    def steps3():
        st = s
        for _ in range(3):
            st, _ = integ.step_with_stats(st, dt)

    dev, kernels, prof = _device_ms(steps3, 1)
    dev, kernels = dev / 3, kernels / 3
    log(f"[breakdown] {label} whole step: device busy {dev:.3f} ms in "
        f"{kernels:.0f} kernels, of {step_ms:.3f} ms/step (timed phase): "
        f"idle share {1 - dev / step_ms:.3f}")
    rows = sorted(prof.key_averages(), key=_self_device_us, reverse=True)
    for e in rows[:15]:
        us = _self_device_us(e)
        if us <= 0:
            break
        log(f"[breakdown] {label} kernel {e.key[:70]:70s} calls/step "
            f"{e.count / 3:6.1f} device {us / 3e3:.3f} ms/step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,parity,path,hybrid,driver,auto,ex0",
                    help="comma-separated subset of kernels,parity,path,"
                    "hybrid,driver,auto,ex0 (add 'breakdown' for a profile "
                    "of the step of each of path, hybrid, driver, the "
                    "flagship's auto leg and ex0 that runs; hybrid reads "
                    "the path phase's time)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(f"[device] {smi.stdout.strip()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase_build()
    rows = phase_kernels() if "kernels" in phases else {}
    if "parity" in phases:
        phase_parity()
    launches = dict.fromkeys(KERNELS, 0)
    path_ms = float("nan")
    if "path" in phases:
        ran, path_ms, integ, state = phase_path(WARMUP, STEPS)
        launches = {k: launches[k] + ran[k] for k in launches}
        if "breakdown" in phases:
            phase_breakdown(integ, state, path_ms, "pallas_packed")
        del integ, state
    if "hybrid" in phases:
        ran = phase_hybrid(path_ms, "breakdown" in phases)
        launches = {k: launches[k] + ran[k] for k in launches}
    if "driver" in phases:
        ran, step_ms, db, state = phase_driver(DRIVER_STEPS)
        launches = {k: launches[k] + ran[k] for k in launches}
        if "breakdown" in phases:
            from ibamr_tpu_torch.models.shell3d import build_shell_example

            # built as ib_explicit_ex4.run builds it, from the same database
            integ, _ = build_shell_example(input_db=db, dtype=torch.float32,
                                           device=DEVICE)
            phase_breakdown(integ, state, step_ms, "pallas")
    if "auto" in phases:
        phase_auto(path_ms, "breakdown" in phases)
    if "ex0" in phases:
        ran = phase_ex0("breakdown" in phases)
        launches = {k: launches[k] + ran[k] for k in launches}

    table = [dict(name=k, route="cuda", source=KERNELS[k][0],
                  replaces=KERNELS[k][1], launches=launches[k], **v)
             for k, v in rows.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
