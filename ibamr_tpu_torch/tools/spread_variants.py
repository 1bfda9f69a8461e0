"""Variants and per-block probes of the shared column spread
(``csrc/spread_column.cuh``) at the flagship layouts, on one GPU.

    python3 ibamr_tpu_torch/tools/spread_variants.py

Each variant is the committed source with one text substitution, built
with ``nvcc`` into ``csrc/build/variants/<name>/`` and bound with
``ctypes``. For every variant: the packed and tile spreads of the three
velocity components, bitwise against the committed form (the variants
change no arithmetic), and their profiler device time per component, in
turns forwards and backwards. Then ``clock64`` probes of the packed
spread: cycles per block and, of those, the first pass's, for the
committed form and for variants that drop the shared atomics (racy, for
timing only) or the int64 conversion. A substitution that no longer
matches the source raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
CSRC = os.path.join(ROOT, "ibamr_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "variants")

# -- variants of spread_column.cuh --------------------------------------------

ATOMICS = """            atomicAdd(acc_lo + i, (unsigned)(q & low_mask));
            atomicAdd(acc_hi + i, (int)(q >> low));"""
CONVERT = """            const long long q = __float2ll_rn(__fmul_rn(term, scale));"""
WALK = """    walk(bit, [&](int j, float4 v, bool filled) {"""
SLAB_END = """      __syncwarp();  // the records are rewritten for the next chunk
    });
    __syncthreads();"""
PASS1_END = """  __syncthreads();
  const int n_ent = col.n_ent;"""


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"substitution no longer matches: {old[:60]!r}")
    return src.replace(old, new)


def merge_runs(h: str) -> str:
    """Sum a lane's consecutive terms of one cell in a register and add
    them with one pair of atomics when the cell changes."""
    h = _sub(h, ATOMICS, """            if (i == pend_i[h]) {
              pend_q[h] += q;
            } else {
              flush(h);
              pend_i[h] = i;
              pend_q[h] = q;
            }""")
    h = _sub(h, WALK, """    int pend_i[2] = {-1, -1};
    long long pend_q[2] = {0, 0};
    auto flush = [&](int h) {
      if (pend_i[h] >= 0) {
        atomicAdd(acc_lo + pend_i[h], (unsigned)(pend_q[h] & low_mask));
        atomicAdd(acc_hi + pend_i[h], (int)(pend_q[h] >> low));
      }
    };
""" + WALK)
    return _sub(h, SLAB_END, """      __syncwarp();  // the records are rewritten for the next chunk
    });
    flush(0);
    flush(1);
    __syncthreads();""")


def group8(h: str) -> str:
    return _sub(h, "constexpr int kGroup = 4;", "constexpr int kGroup = 8;")


def no_atomics(h: str) -> str:
    """Plain adds for the atomics: racy, wrong sums, timing only."""
    return _sub(h, ATOMICS, """            acc_lo[i] += (unsigned)(q & low_mask);
            acc_hi[i] += (int)(q >> low);""")


def no_convert(h: str) -> str:
    """The term's bits for its fixed-point value: wrong sums, timing only."""
    return _sub(no_atomics(h), CONVERT,
                "            const long long q = (long long)__float_as_int(term);")


def probed(h: str) -> str:
    """Record the clock at the end of the first pass."""
    h = _sub(h, PASS1_END, """  __syncthreads();
  if (threadIdx.x == 0) g_pass1[blockIdx.x] = clock64();
  const int n_ent = col.n_ent;""")
    return _sub(h, "namespace {\n",
                "namespace {\n__device__ long long g_pass1[65536];\n")


# per-block cycles of the packed kernel and of its first pass
PROBE = [
    ("""__global__ void __launch_bounds__(kThreads)
packed_spread_kernel(""", """__device__ long long g_clk[65536];
__global__ void __launch_bounds__(kThreads)
packed_spread_kernel("""),
    ("""  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < kNeighbours) {""", """  const long long t_clk = clock64();
  if (threadIdx.x == 0) g_pass1[blockIdx.x] = t_clk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < kNeighbours) {"""),
    ("""  spread_column(col, Xb, coef, out, table, g, smem);
}""", """  spread_column(col, Xb, coef, out, table, g, smem);
  __syncthreads();
  if (threadIdx.x == 0) {
    g_clk[blockIdx.x] = clock64() - t_clk;
    g_pass1[blockIdx.x] -= t_clk;
  }
}"""),
    ("""extern "C" int packed_spread_limits(""", """extern "C" int packed_spread_probe(long long* clk, long long* pass1,
                                   int n) {
  cudaMemcpyFromSymbol(clk, g_clk, n * sizeof(long long));
  return (int)cudaMemcpyFromSymbol(pass1, g_pass1, n * sizeof(long long));
}
extern "C" int packed_spread_limits("""),
]


def build(name: str, header: str, probe: bool = False) -> dict:
    """Build both spread kernels on ``header``; returns their libraries."""
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops import kernel_build

    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in ("delta_ib4.cuh", "packed_spread.cu", "tile_spread.cu"):
        with open(os.path.join(CSRC, f)) as fh:
            src = fh.read()
        if probe and f == "packed_spread.cu":
            for old, new in PROBE:
                src = _sub(src, old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(src)
    with open(os.path.join(d, "spread_column.cuh"), "w") as fh:
        fh.write(header)
    procs = {}
    for k in ("packed_spread", "tile_spread"):
        so = os.path.join(d, f"lib{k}.so")
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", so,
               os.path.join(d, f"{k}.cu")]
        procs[k] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    libs = {}
    for k, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(log)
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"[{name}] {k}: {regs}", flush=True)
        lib = ctypes.CDLL(so)
        fn = getattr(lib, f"{k}_launch")
        fn.argtypes = ci._ARGTYPES[k]
        fn.restype = ctypes.c_int
        libs[k] = (lib, fn)
    return libs


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.models.shell3d import (construct_transfer_engine,
                                                make_spherical_shell)
    from ibamr_tpu_torch.ops import cuda_interaction as ci
    from ibamr_tpu_torch.ops.interaction import _centering_offsets
    from ibamr_tpu_torch.ops.interaction_fast import bucketed_channel

    if not torch.cuda.is_available():
        raise SystemExit("spread_variants: no CUDA device is available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    f = chip_smoke.FLAGSHIP
    n = f["n_cells"]
    grid = StaggeredGrid(n=(n,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    shell = make_spherical_shell(f["n_lat"], f["n_lon"], 0.25,
                                 (0.5, 0.5, 0.5), 1.0, 0.75, 1.2)
    X = torch.tensor(shell.vertices, dtype=torch.float32, device=dev)
    F = torch.randn(X.shape[0],
                    generator=torch.Generator().manual_seed(0)).to(dev)
    pe = construct_transfer_engine("pallas_packed", grid, shell.vertices,
                                   "IB_4", device=dev)
    te = construct_transfer_engine("pallas", grid, shell.vertices, "IB_4",
                                   device=dev)
    pb, tb = pe.buckets(X), te.buckets(X)
    pc = (bucketed_channel(pb, F) * pb.wb / grid.cell_volume).contiguous()
    tc = (bucketed_channel(tb, F) * tb.wb / grid.cell_volume).contiguous()
    (Q, c), (B, cap) = pb.wb.shape, tb.wb.shape
    stream = torch.cuda.current_stream().cuda_stream

    def spreads(libs):
        def packed(d):
            out = torch.empty(grid.n, device=dev)
            err = libs["packed_spread"][1](
                pb.tile_of_chunk.data_ptr(), pb.Xb.data_ptr(), pc.data_ptr(),
                out.data_ptr(), Q, c,
                ci._tile_geom(pe.geom, grid, _centering_offsets(grid, d)),
                stream)
            if err:
                raise RuntimeError(f"packed_spread: CUDA error {err}")
            return out

        def tile(d):
            out = torch.empty(grid.n, device=dev)
            err = libs["tile_spread"][1](
                tb.Xb.data_ptr(), tc.data_ptr(), tb.counts.data_ptr(),
                out.data_ptr(), B, cap,
                ci._tile_geom(te.geom, grid, _centering_offsets(grid, d)),
                stream)
            if err:
                raise RuntimeError(f"tile_spread: CUDA error {err}")
            return out
        return {"packed_spread": packed, "tile_spread": tile}

    with open(os.path.join(CSRC, "spread_column.cuh")) as fh:
        committed = fh.read()
    variants = {"committed": committed, "merge_runs": merge_runs(committed),
                "group8": group8(committed),
                "merge_runs+group8": merge_runs(group8(committed))}
    fns = {name: spreads(build(name, h)) for name, h in variants.items()}
    ref, times = {}, {name: {k: [] for k in fns[name]} for name in fns}
    for name in list(fns) + list(reversed(list(fns))):
        for kind, fn in fns[name].items():
            for d in range(3):
                out = fn(d)
                torch.cuda.synchronize()
                same = torch.equal(out, ref.setdefault((kind, d), out))
                if not same:
                    raise AssertionError(f"{name}: {kind} of component {d} "
                                         "is not the committed form's")
            ms = chip_smoke._device_ms(
                lambda: [fn(d) for d in range(3)], 10)[0] / 3
            times[name][kind].append(ms)
    for name, t in times.items():
        print(f"[variant] {name}: bitwise equal to committed; ms per "
              f"component (profiler, forwards then backwards) "
              f"packed_spread {t['packed_spread']} tile_spread "
              f"{t['tile_spread']}", flush=True)

    for name, h in (("probe_committed", committed),
                    ("probe_no_atomics", no_atomics(committed)),
                    ("probe_no_atomics_no_convert", no_convert(committed))):
        libs = build(name, probed(h), probe=True)
        read = libs["packed_spread"][0].packed_spread_probe
        read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        spreads(libs)["packed_spread"](0)
        torch.cuda.synchronize()
        clk = np.zeros(B, dtype=np.int64)
        pass1 = np.zeros(B, dtype=np.int64)
        if read(clk.ctypes.data, pass1.ctypes.data, B):
            raise RuntimeError("reading the probe failed")
        print(f"[{name}] component 0: cycles per block max {clk.max()} "
              f"median {int(np.median(clk))}, sum over 264 block slots "
              f"{clk.sum() / 264:.0f}", flush=True)
        for b in np.argsort(clk)[::-1][:6]:
            print(f"[{name}]   tile ({b // 32}, {b % 32}): {clk[b]} cycles, "
                  f"first pass {pass1[b]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
