// Interpolation straight from the grid for Hopper (sm_90a): the pallas
// engine's tile extraction and tile interp in one kernel over filled
// slots only.
//
// Replaces _interp_kernel_3d (ibamr_tpu/ops/pallas_interaction.py:195,
// pallas_call at :235) together with the prologue that copies each
// tile's footprint out of the grid, _extract_tiles
// (ibamr_tpu/ops/interaction_fast.py:345, called at
// pallas_interaction.py:580).
// The layout is the unpacked per-tile one: B tiles of `cap` slots, row t
// holding tile t's markers in its first counts[t] slots. For each slot
// (t, m) with m < counts[t]:
//
//   out[t, m] = sum_a wx[a,m] sum_b wy[b,m] sum_z wz[z,m]
//               f[wrap(x0(t)-1+a), wrap(y0(t)-1+b), z]
//
// over the footprint offsets (a, b) of tile t, with the IB_4 weights of
// delta_ib4.cuh, the function the spread kernels evaluate; out[t, m] = 0
// exactly for m >= counts[t].
//
// Bound. At the flagship (256^3 grid, B = 1,024 tiles of cap 1,024, 95,148
// filled slots) an interp must read the grid entries under the filled
// slots' supports (at most 495,751, 2.0 MB), their X (1.1 MB) and the
// counts, and write the (B, cap) output (4.2 MB): ~7.3 MB, 0.0022 ms at
// 3.35 TB/s; its ~3e7 operations bound nothing. The reference's form
// first copies the 67 MB grid into a 177 MB (B, 169, nz) tile block.
//
// Design. A block owns 64 slots of one tile row. Blocks past the row's
// filled prefix write their zeros and leave; 91% of the flagship's slots
// are never evaluated. In a live block each half-warp takes one slot at a
// time: its lanes 0..11 take the 4 nonzero weights of each axis
// (ib4_weights: from the fraction of the grid coordinate, one square
// root; every weight outside |t| < 2 is exactly 0) and the wrapped grid
// index of each tap, and lane (sx, sy) of the 16 then reads the 4 z taps
// of grid column (x_sx, y_sy), a run of 4 consecutive floats, so each
// group of 4 lanes reads one z run. The sum runs in the reference's
// nesting (z, then y, then x) as fixed butterfly reductions over the
// half-warp: no atomics, bitwise reproducible.
//
// Tensor cores do not pay here: the TPU's matrix unit takes a dense
// (169, nz) x (nz, cap) product per tile, ~676x the 64 multiply-adds a
// marker needs; the compact form is a gather bound by bytes, with no
// product left to feed a matrix unit, and its f32 sums must stay exact
// to f32 rounding, which TF32 is not.

#include <cstdint>

#include "delta_ib4.cuh"

namespace {

constexpr int kThreads = 256;   // 16 half-warps, one slot each at a time
constexpr int kSlots = 64;      // slots per block
constexpr int kMaxWidth = 16;   // footprint widths W0, W1 <= kMaxWidth
constexpr int kMinNz = 5;       // 4 distinct z stencil planes

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}
// i mod n for i in [-n, 2n), without a division
__device__ __forceinline__ int wrap1(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__global__ void __launch_bounds__(kThreads)
tile_interp_kernel(const float* __restrict__ Xb,
                   const float* __restrict__ f,
                   const int* __restrict__ counts, float* __restrict__ out,
                   int cap, TileGeom g) {
  const int t = blockIdx.x;
  const int base = blockIdx.y * kSlots;
  const int filled = min(max(counts[t], 0), cap);
  float* row_out = out + (size_t)t * cap;
  if (base >= filled) {  // no filled slot in this block
    for (int m = base + threadIdx.x; m < min(base + kSlots, cap);
         m += kThreads)
      row_out[m] = 0.0f;
    return;
  }

  const unsigned all = 0xffffffffu;
  const int j = threadIdx.x & 15;     // lane within the half-warp
  const int half = threadIdx.x >> 4;  // half-warp of the block
  // lanes 0..11 take weight k of axis d; lane j reads column (sx, sy)
  const int d = min(j >> 2, 2), k = j & 3;
  const int sx = j >> 2, sy = j & 3;
  // per-axis footprint origin o, width W and extent n of this lane's
  // weight: a blocked axis of tile t, or the periodic z axis as one
  // footprint of origin 1 (so that o - 1 + a is the wrapped plane)
  const int o = d == 0 ? (t / g.nb1) * g.t0
                       : (d == 1 ? (t % g.nb1) * g.t1 : 1);
  const int W = d == 0 ? g.W0 : (d == 1 ? g.W1 : g.nz);
  const int n = d == 0 ? g.n0 : (d == 1 ? g.n1 : g.nz);
  const float lo = d == 0 ? g.lo0 : (d == 1 ? g.lo1 : g.lo2);
  const float dx = d == 0 ? g.dx0 : (d == 1 ? g.dx1 : g.dx2);
  const float off = d == 0 ? g.off0 : (d == 1 ? g.off1 : g.off2);

  for (int r = 0; r < kSlots / 16; ++r) {
    const int m = base + half + 16 * r;
    const bool live = m < filled;
    float w = 0.0f;
    int idx = 0;
    if (live && j < 12) {
      const float xi =
          grid_coord(Xb[3 * ((size_t)t * cap + m) + d], lo, dx, off);
      const int a = wrap((int)floorf(xi) + k - o, n);
      float w4[4];
      ib4_weights(xi, w4);
      idx = wrap1(o - 1 + a, n);
      if (a < W)
        w = k == 0 ? w4[0] : (k == 1 ? w4[1] : (k == 2 ? w4[2] : w4[3]));
    }
    const int gx = __shfl_sync(all, idx, sx, 16);
    const int gy = __shfl_sync(all, idx, 4 + sy, 16);
    const float* col = f + ((size_t)gx * g.n1 + gy) * g.nz;
    float sz = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float wz = __shfl_sync(all, w, 8 + q, 16);
      const int gz = __shfl_sync(all, idx, 8 + q, 16);
      if (live) sz = fmaf(col[gz], wz, sz);
    }
    const float wx = __shfl_sync(all, w, sx, 16);
    const float wy = __shfl_sync(all, w, 4 + sy, 16);
    float v = __fmul_rn(wy, sz);
    v = __fadd_rn(v, __shfl_xor_sync(all, v, 1, 16));
    v = __fadd_rn(v, __shfl_xor_sync(all, v, 2, 16));
    v = __fmul_rn(wx, v);
    v = __fadd_rn(v, __shfl_xor_sync(all, v, 4, 16));
    v = __fadd_rn(v, __shfl_xor_sync(all, v, 8, 16));
    if (j == 0 && m < cap) row_out[m] = live ? v : 0.0f;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int tile_interp_launch(const float* Xb, const float* f,
                                  const int* counts, float* out, int B,
                                  int cap, TileGeom g, void* stream) {
  if (B == 0 || cap == 0) return 0;
  const dim3 grid(B, (cap + kSlots - 1) / kSlots);
  tile_interp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Xb, f, counts, out, cap, g);
  return (int)cudaGetLastError();
}

extern "C" int tile_interp_limits(int* max_cap, int* max_width,
                                  int* min_nz) {
  *max_cap = 65535 * kSlots;   // grid.y = ceil(cap / kSlots)
  *max_width = kMaxWidth;
  *min_nz = kMinNz;
  return 0;
}
