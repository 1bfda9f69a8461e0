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
// over the footprint offsets (a, b) of tile t, with the weights of
// delta.cuh (any of the ten named deltas, support S = 2..6, one kernel
// instantiation per S), the function the spread kernels evaluate;
// out[t, m] = 0 exactly for m >= counts[t].
//
// Bound. At the flagship (256^3 grid, B = 1,024 tiles of cap 1,024, 95,148
// filled slots) an interp must read the grid entries under the filled
// slots' supports (at most 495,751, 2.0 MB, at IB_4), their X (1.1 MB)
// and the counts, and write the (B, cap) output (4.2 MB): ~7.3 MB, 0.0022
// ms at 3.35 TB/s; its ~3e7 operations bound nothing. The reference's form
// first copies the 67 MB grid into a 177 MB (B, 169, nz) tile block.
//
// Design. A block owns 64 slots of one tile row. Blocks past the row's
// filled prefix write their zeros and leave; 91% of the flagship's slots
// are never evaluated. In a live block a group of lanes takes one slot at
// a time: a half-warp for S <= 4, a warp for S = 5, 6. Lane j < 3S of the
// group takes weight j % S of axis j / S (tap_weight; at IB_4 from the
// fraction of the grid coordinate, one square root; every weight outside
// |t| < S/2 is exactly 0) and the wrapped grid index of that tap. The
// group's lanes form a grid of 4 (y) by 4 or 8 (x): lane (sx, sy) reads
// the S z taps of grid column (x_sx, y_sy) and, for S > 4, of column
// (x_sx, y_{sy+4}) as well, a run of S consecutive floats each; lanes past
// the support read nothing and add exact zeros. The sum runs in the
// reference's nesting (z, then y, then x) as fixed butterfly reductions
// over the group: no atomics, bitwise reproducible. At S = 4 this is the
// half-warp form of PR 4: 12 weight lanes, 16 columns.
//
// Tensor cores do not pay here: the TPU's matrix unit takes a dense
// (W0 W1, nz) x (nz, cap) product per tile, ~676x the 64 multiply-adds
// a marker needs at IB_4; the compact form is a gather bound by bytes, with no
// product left to feed a matrix unit, and its f32 sums must stay exact
// to f32 rounding, which TF32 is not.

#include <cstdint>

#include "delta.cuh"

namespace {

constexpr int kThreads = 256;   // groups of 16 or 32 lanes, a slot each
constexpr int kSlots = 64;      // slots per block
constexpr int kMaxWidth = 16;   // footprint widths W0, W1 <= kMaxWidth

template <int S, bool IB4>
__global__ void __launch_bounds__(kThreads)
tile_interp_kernel(const float* __restrict__ Xb,
                   const float* __restrict__ f,
                   const int* __restrict__ counts, float* __restrict__ out,
                   int cap, TileGeom g) {
  constexpr int kLanes = S <= 4 ? 16 : 32;  // lanes of a slot's group
  constexpr int kGroups = kThreads / kLanes;
  constexpr int kYR = (S + 3) / 4;          // y columns per lane
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
  const int j = threadIdx.x % kLanes;   // lane within the group
  const int grp = threadIdx.x / kLanes; // group of the block
  // lanes 0..3S-1 take weight k of axis d; lane j reads the columns
  // (sx, sy0 + 4 r), r < kYR
  const int d = min(j / S, 2), k = j % S;
  const int sx = j >> 2, sy0 = j & 3;
  const bool x_in = sx < S;
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

  for (int r = 0; r < kSlots / kGroups; ++r) {
    const int m = base + grp + kGroups * r;
    const bool live = m < filled;
    float w = 0.0f;
    int idx = 0;
    if (live && j < 3 * S) {
      const float xi =
          grid_coord(Xb[3 * ((size_t)t * cap + m) + d], lo, dx, off);
      const int a = wrap(first_tap<S>(xi) + 1 + k - o, n);
      idx = wrap1(o - 1 + a, n);
      if (a < W) {
        if constexpr (IB4) {
          float w4[4];
          ib4_weights(xi, w4);
          w = k == 0 ? w4[0] : (k == 1 ? w4[1] : (k == 2 ? w4[2] : w4[3]));
        } else {
          w = tap_weight<S>(xi, o - 1 + a, n, g);
        }
      }
    }
    const int gx = __shfl_sync(all, idx, x_in ? sx : 0, kLanes);
    float v = 0.0f;
#pragma unroll
    for (int yr = 0; yr < kYR; ++yr) {
      const int sy = sy0 + 4 * yr;
      const bool in = live && x_in && sy < S;
      const int gy = __shfl_sync(all, idx, S + (sy < S ? sy : 0), kLanes);
      const float* col = f + ((size_t)gx * g.n1 + gy) * g.nz;
      float sz = 0.0f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        // the z taps' weights and planes as each load needs them, which
        // keeps them out of registers
        const float wz = __shfl_sync(all, w, 2 * S + q, kLanes);
        const int gz = __shfl_sync(all, idx, 2 * S + q, kLanes);
        if (in) sz = fmaf(col[gz], wz, sz);
      }
      const float wy = __shfl_sync(all, w, S + (sy < S ? sy : 0), kLanes);
      const float term = __fmul_rn(sy < S ? wy : 0.0f, sz);
      v = yr == 0 ? term : __fadd_rn(v, term);
    }
    float wx = __shfl_sync(all, w, x_in ? sx : 0, kLanes);
    if (!x_in) wx = 0.0f;
    v = __fadd_rn(v, __shfl_xor_sync(all, v, 1, kLanes));
    v = __fadd_rn(v, __shfl_xor_sync(all, v, 2, kLanes));
    v = __fmul_rn(wx, v);
#pragma unroll
    for (int h = 4; h < kLanes; h <<= 1)
      v = __fadd_rn(v, __shfl_xor_sync(all, v, h, kLanes));
    if (j == 0 && m < cap) row_out[m] = live ? v : 0.0f;
  }
}

}  // namespace

// Launches on `stream` the instantiation for S = g.support (IB_4's own
// at IB_4); returns
// cudaGetLastError() of the launch.
extern "C" int tile_interp_launch(const float* Xb, const float* f,
                                  const int* counts, float* out, int B,
                                  int cap, TileGeom g, void* stream) {
  return with_support(g, [&](auto s, auto ib4) {
    if (B == 0 || cap == 0) return 0;
    const dim3 grid(B, (cap + kSlots - 1) / kSlots);
    tile_interp_kernel<decltype(s)::value, decltype(ib4)::value>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(Xb, f, counts, out,
                                                      cap, g);
    return (int)cudaGetLastError();
  });
}

// The limits of the instantiation for support S; nonzero for an S that
// has none.
extern "C" int tile_interp_limits(int S, int* max_cap, int* max_width,
                                  int* min_z) {
  if (S < 2 || S > 6) return (int)cudaErrorInvalidValue;
  *max_cap = 65535 * kSlots;   // grid.y = ceil(cap / kSlots)
  *max_width = kMaxWidth;
  *min_z = S + 1;              // S distinct z stencil planes
  return 0;
}
