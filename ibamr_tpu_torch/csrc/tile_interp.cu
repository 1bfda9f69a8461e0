// Per-tile interpolation for Hopper (sm_90a).
//
// Replaces _interp_kernel_3d (ibamr_tpu/ops/pallas_interaction.py). The
// layout is the unpacked per-tile one (B tiles of `cap` slots, slot row t
// holding tile t's markers). For every slot (t, m):
//
//   out[t, m] = sum_a wx[a,m] sum_b wy[b,m] sum_z T[t, a*W1 + b, z] wz[z,m]
//
// where T (B, W0*W1, nz) holds each tile's footprint of the field
// (_extract_tiles) and the weights are the IB_4 weights of delta_ib4.cuh,
// the same function the spread kernels evaluate. Empty slots hold X = 0
// and come out finite; the engine multiplies them by their weight 0.
//
// Design: compact support, one thread per (tile, slot). The TPU kernel
// forms the dense (P, nz) x (nz, cap) product because that shape suits
// the MXU; every weight outside |t| < 2 is exactly 0, so the same sum
// needs only each marker's 4 x 4 x 4 nonzero taps. A thread evaluates
// the 13 x- and 13 y-weights of the footprint and the weights of the 5 z
// planes around its marker (the 4 planes within the support and one more
// against rounding; z planes further out have weight exactly 0), and
// skips zero weights. The sum runs in the reference's nesting (z
// innermost, then b, then a).
//
// Bound. Each live marker reads 64 floats of T, scattered over its tile's
// footprint, plus its position, and writes one float: the kernel is bound
// by those bytes (a gather), not by its ~200 flops per marker. Threads of
// empty slots evaluate their weights and read little of T.

#include <cstdint>

#include "delta_ib4.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 16;   // footprint widths W0, W1 <= kMaxWidth
constexpr int kZTaps = 5;       // z planes visited per marker (nz >= 5)

__global__ void __launch_bounds__(kThreads)
tile_interp_kernel(const float* __restrict__ Xb,
                   const float* __restrict__ T,
                   float* __restrict__ out, int B, int cap, TileGeom g) {
  const size_t s = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= (size_t)B * cap) return;
  const int t = (int)(s / cap);
  const float x0 = (float)((t / g.nb1) * g.t0 - 1);
  const float y0 = (float)((t % g.nb1) * g.t1 - 1);
  const float xi = grid_coord(Xb[3 * s + 0], g.lo0, g.dx0, g.off0);
  const float yi = grid_coord(Xb[3 * s + 1], g.lo1, g.dx1, g.off1);
  const float zi = grid_coord(Xb[3 * s + 2], g.lo2, g.dx2, g.off2);

  float wy[kMaxWidth];
#pragma unroll
  for (int b = 0; b < kMaxWidth; ++b)
    wy[b] = (b < g.W1) ? delta_weight(yi, y0 + (float)b, (float)g.n1)
                       : 0.0f;

  // z planes floor(zi)-2 .. floor(zi)+2, wrapped onto [0, nz)
  float wz[kZTaps];
  int kz[kZTaps];
  const int zf = (int)floorf(zi);
#pragma unroll
  for (int k = 0; k < kZTaps; ++k) {
    int z = (zf - 2 + k) % g.nz;
    z += (z < 0) ? g.nz : 0;
    kz[k] = z;
    wz[k] = delta_weight(zi, (float)z, (float)g.nz);
  }

  const float* Tt = T + (size_t)t * g.W0 * g.W1 * g.nz;
  float acc = 0.0f;
  for (int a = 0; a < g.W0; ++a) {
    const float wa = delta_weight(xi, x0 + (float)a, (float)g.n0);
    if (wa == 0.0f) continue;
    float inner = 0.0f;
#pragma unroll
    for (int b = 0; b < kMaxWidth; ++b) {
      if (wy[b] == 0.0f) continue;
      const float* row = Tt + (size_t)(a * g.W1 + b) * g.nz;
      float sz = 0.0f;
#pragma unroll
      for (int k = 0; k < kZTaps; ++k)
        if (wz[k] != 0.0f) sz = fmaf(row[kz[k]], wz[k], sz);
      inner = fmaf(wy[b], sz, inner);
    }
    acc = fmaf(wa, inner, acc);
  }
  out[s] = acc;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int tile_interp_launch(const float* Xb, const float* T,
                                  float* out, int B, int cap, TileGeom g,
                                  void* stream) {
  const long long slots = (long long)B * cap;
  const unsigned blocks = (unsigned)((slots + kThreads - 1) / kThreads);
  if (blocks == 0) return 0;
  tile_interp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Xb, T, out, B, cap, g);
  return (int)cudaGetLastError();
}

extern "C" int tile_interp_limits(int* max_cap, int* max_width,
                                  int* min_nz) {
  *max_cap = 1 << 30;   // one thread per slot: any cap
  *max_width = kMaxWidth;
  *min_nz = kZTaps;
  return 0;
}
