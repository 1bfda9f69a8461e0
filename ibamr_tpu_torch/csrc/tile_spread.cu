// Per-tile spread for Hopper (sm_90a).
//
// Replaces _spread_kernel_3d (ibamr_tpu/ops/pallas_interaction.py). The
// layout is the unpacked per-tile one (interaction_fast.bucket_markers):
// B tiles of `cap` slots, slot row t holding tile t's markers. For every
// tile t and footprint offset p = a*W1 + b, z in [0, nz):
//
//   out[t, p, z] = sum over slots m of row t:
//                  wx[a,m] * wy[b,m] * wz[z,m] * coef[t,m]
//
// with IB_4 weights from delta_ib4.cuh. A tile whose coefs are all zero
// (an empty tile: its slots hold X = 0 and weight 0) comes out exactly 0.
//
// Design. On the TPU one program per tile builds the whole (P, nz) block
// in VMEM with dense products over all cap slots. Here one block owns one
// (tile, 16-plane z-slab) output block and walks the tile's cap slots in
// groups of 128, one slot per thread, so any cap is allowed (the packed
// kernel's chunk is at most 128). Compact support: every weight outside
// |t| < 2 is exactly 0, so a marker adds to only its 4 x 4 x 4 stencil
// points that fall inside the footprint and the slab, 64 additions at
// most. Each warp takes a fixed quarter of every slot group and adds its
// live markers in slot order into its own shared-memory copy of the
// block, one marker at a time with its 64 taps spread over the lanes (the
// taps of one marker are distinct points, so lanes never collide); the
// four copies are summed in a fixed order at the end. No atomics: the
// result is bitwise reproducible run to run.
//
// Bound. The output (B, P, nz) f32 must be written in full (177 MB at the
// flagship's B = 1024, P = 169, nz = 256), against 4.2 MB of coefs at
// cap = 1024, the X of the live slots only (1.1 MB for 95,148 markers)
// and ~3e7 useful operations: the kernel is bound by the bytes of its
// store. Every slab block of a tile reads the tile's cap
// coefs again (16 times per tile; the repeats come from L2), and the
// blocks of empty tiles read zeros and store zeros.

#include <cstdint>

#include "delta_ib4.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // slots per group
constexpr int kSlab = 16;              // z planes per block
constexpr int kMaxWidth = 16;          // footprint widths W0, W1 <= kMaxWidth
constexpr int kMinNz = 5;              // 4 distinct z stencil planes
// per-marker record in shared memory: 4 x, 4 y, 4 z weights (the z
// weights carry coef), then their footprint x/y offsets and slab z
// offsets as ints; stride 25 keeps the lanes' record writes conflict-free
constexpr int kRec = 25;

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kThreads)
tile_spread_kernel(const float* __restrict__ Xb,
                   const float* __restrict__ coef,
                   float* __restrict__ out, int cap, TileGeom g) {
  extern __shared__ float smem[];

  const int t = blockIdx.x;
  const int z0 = blockIdx.y * kSlab;
  const int P = g.W0 * g.W1;
  const int n_acc = P * kSlab;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float* acc_all = smem;                                  // kWarps copies
  float* acc = acc_all + warp * n_acc;
  float* rec = acc_all + kWarps * n_acc + warp * 32 * kRec;
  for (int e = threadIdx.x; e < kWarps * n_acc; e += kThreads)
    acc_all[e] = 0.0f;
  __syncthreads();

  const int x0 = (t / g.nb1) * g.t0;
  const int y0 = (t % g.nb1) * g.t1;
  const float x0m1 = (float)(x0 - 1);
  const float y0m1 = (float)(y0 - 1);
  const size_t row = (size_t)t * cap;

  for (int m0 = 0; m0 < cap; m0 += kThreads) {
    const int m = m0 + warp * 32 + lane;   // this lane's slot of the group
    bool live = false;
    if (m < cap) {
      const size_t s = row + m;
      const float cm = coef[s];
      if (cm != 0.0f) {
        float* r = rec + lane * kRec;
        int* ri = reinterpret_cast<int*>(r);
        const float zi = grid_coord(Xb[3 * s + 2], g.lo2, g.dx2, g.off2);
        const int zf = (int)floorf(zi);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int z = wrap(zf - 1 + k, g.nz);
          const float w = (z >= z0 && z < z0 + kSlab)
              ? delta_weight(zi, (float)z, (float)g.nz) * cm : 0.0f;
          r[8 + k] = w;
          ri[20 + k] = z - z0;
          live |= (w != 0.0f);
        }
        if (live) {
          const float xi = grid_coord(Xb[3 * s + 0], g.lo0, g.dx0, g.off0);
          const float yi = grid_coord(Xb[3 * s + 1], g.lo1, g.dx1, g.off1);
          const int xf = (int)floorf(xi);
          const int yf = (int)floorf(yi);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            // footprint offsets of the stencil points floor-1 .. floor+2
            const int a = wrap(xf + k - x0, g.n0);
            const int b = wrap(yf + k - y0, g.n1);
            r[k] = a < g.W0
                ? delta_weight(xi, x0m1 + (float)a, (float)g.n0) : 0.0f;
            r[4 + k] = b < g.W1
                ? delta_weight(yi, y0m1 + (float)b, (float)g.n1) : 0.0f;
            ri[12 + k] = a;
            ri[16 + k] = b;
          }
        }
      }
    }
    unsigned todo = __ballot_sync(0xffffffffu, live);
    __syncwarp();
    while (todo) {   // this warp's live markers, in slot order
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const float* r = rec + j * kRec;
      const int* ri = reinterpret_cast<const int*>(r);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tap = lane + 32 * h;
        const int sx = tap >> 4, sy = (tap >> 2) & 3, sz = tap & 3;
        const float w = __fmul_rn(__fmul_rn(r[sx], r[4 + sy]), r[8 + sz]);
        if (w != 0.0f) {
          float* dst = acc + (ri[12 + sx] * g.W1 + ri[16 + sy]) * kSlab
                       + ri[20 + sz];
          *dst = __fadd_rn(*dst, w);
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  float* tile_out = out + (size_t)t * P * g.nz;
  for (int e = threadIdx.x; e < n_acc; e += kThreads) {
    float v = acc_all[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = __fadd_rn(v, acc_all[w * n_acc + e]);
    if (z0 + e % kSlab < g.nz)
      tile_out[(size_t)(e / kSlab) * g.nz + z0 + e % kSlab] = v;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch. The
// accumulators (kWarps x W0*W1 x kSlab floats, 43 KB at W = 13) and the
// marker records (12.8 KB) pass the 48 KB default of dynamic shared
// memory, so the kernel's limit is raised first.
extern "C" int tile_spread_launch(const float* Xb, const float* coef,
                                  float* out, int B, int cap, TileGeom g,
                                  void* stream) {
  const int smem = (int)sizeof(float) *
                   (kWarps * g.W0 * g.W1 * kSlab + kWarps * 32 * kRec);
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_spread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if (B == 0) return 0;
  const dim3 grid(B, (g.nz + kSlab - 1) / kSlab);
  tile_spread_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      Xb, coef, out, cap, g);
  return (int)cudaGetLastError();
}

extern "C" int tile_spread_limits(int* max_cap, int* max_width,
                                  int* min_nz) {
  *max_cap = 1 << 30;   // slot groups loop: any cap
  *max_width = kMaxWidth;
  *min_nz = kMinNz;
  return 0;
}
