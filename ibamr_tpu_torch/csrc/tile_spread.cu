// Grid-owner spread for Hopper (sm_90a): the pallas engine's tile spread
// and its overlap-add in one kernel that writes the periodic grid itself.
//
// Replaces _spread_kernel_3d (ibamr_tpu/ops/pallas_interaction.py:94,
// pallas_call at :127) together with the epilogue that folds its
// (B, W0*W1, nz) tile partials onto the grid, _overlap_add
// (ibamr_tpu/ops/interaction_fast.py:297, called at
// pallas_interaction.py:185).
// The layout is the unpacked per-tile one (interaction_fast.bucket_markers):
// B tiles of `cap` slots, row t holding tile t's markers in its first
// counts[t] slots. For the grid component g (n0, n1, nz) f32:
//
//   g[x, y, z] = sum over tiles t, slots m < counts[t], footprint offsets
//                (a, b) of t with x0(t)-1+a = x and y0(t)-1+b = y (mod n):
//                wx[a,m] * wy[b,m] * wz[z,m] * coef[t,m]
//
// with the IB_4 weights (delta_ib4.cuh) of the marker's 4 x 4 x 4 compact
// support: every weight outside |t| < 2 is exactly 0.
//
// Bound. At the flagship (256^3 grid, B = 1,024 tiles of cap 1,024, 95,148
// filled slots) the kernel must store the grid once (67.1 MB f32) and read
// the X and coef of the filled slots (1.5 MB) and the counts (4 KB): 68.6
// MB, 0.0205 ms at 3.35 TB/s. Its ~3e7 operations bound nothing. The
// reference's form stores a (B, 169, nz) tile block instead (177 MB, 2.6x
// the grid, 792 of its 1,024 tiles zero) and the overlap-add reads it back.
//
// Design. A block owns the column of one tile's t0 x t1 core cells over
// all nz planes and writes it once, in z-contiguous rows, 32 planes (a
// slab) at a time. A tile's footprint spans cells x0-1 .. x0+t0+3, so the
// core receives markers of the tiles t-1, t, t+1 on each blocked axis
// only; the block walks the distinct tiles among those 3 x 3 (at nblk = 2
// the two neighbours on an axis are one tile), and only their filled
// prefix of slots: 91% of the flagship's slots are never read. Each of
// 16 warps streams its share of 32-slot chunks through a cp.async ring,
// 2 chunks ahead, with no block barrier between chunks (the columns
// around the shell's poles set the kernel's time, and 16 warps a column
// measured 0.13 ms at the flagship against 0.19 ms with 8). A first pass
// marks, for each chunk, the slabs its markers reach inside the core; the
// second pass takes the slabs one by one and walks only the chunks that
// reach them, so a marker is read a few times, not once per slab and
// neighbour (8 x 9), and a slab no chunk reaches is stored as zeros.
//
// Determinism without serial adds. The shell's poles put thousands of
// markers of the tiles at cap and their neighbours on a few cells; adding
// them in a fixed order in f32 serialises them. Instead each column scales its
// contributions by 2^s, s fixed by its largest |coef|, and adds them in
// fixed point with native 32-bit shared-memory atomics (a high and a low
// part per cell, both exact): integer addition is associative, so the
// warps add their markers concurrently and the grid is bitwise
// reproducible run to run. A warp adds one marker at a time, its 64 taps
// over the lanes, so the 32 addresses of one atomic are distinct cells in
// distinct banks. Each term is the f32 product the reference forms,
// rounded to 2^-s (~2^-35 of the largest coef); each cell is rounded to
// f32 once, from the exact sum.
//
// Tensor cores do not pay here: each marker adds a rank-1 4 x 4 x 4 block,
// and the dense product over the footprint that the TPU's matrix unit
// takes was 9.2x slower than compact support on this card (the first
// design of packed_spread.cu); the operands are f32 and the sum must stay
// exact to f32 rounding, which TF32 is not.

#include <cstdint>

#include "delta_ib4.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlab = 32;              // z planes stored at a time
constexpr int kDepth = 3;              // 32-slot chunks in flight per warp
constexpr int kMaxWidth = 16;          // footprint widths W0, W1 <= kMaxWidth
constexpr int kMinNz = 5;              // 4 distinct z stencil planes
constexpr int kNeighbours = 9;         // the 3 x 3 tiles around a column
constexpr int kMaxChunks = 512;        // 32-slot chunks around a column
// Fixed point: no cell of a column sums more than 9 * 1,792 < 2^14 terms
// of magnitude <= max|coef| < 2^e, scaled by 2^(35 - e) below 2^35; each
// term splits into a signed high part (t >> 18, below 2^17) and an
// 18-bit low part, whose sums both fit 32 bits.
constexpr int kTermBits = 35;
constexpr int kLowBits = 18;
// per-marker record: 4 x, 4 y, 4 z weights (the z weights carry coef),
// then the box offsets of the 4 x, 4 y and 4 z taps as bytes (kOutside
// for a tap outside the box or of weight 0); the odd stride keeps the
// lanes' record writes conflict-free
constexpr int kRec = 15;
constexpr unsigned kOutside = 0xffu;

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}
// i mod n for i in [-n, 2n), without a division
__device__ __forceinline__ int wrap1(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// Row strides of the slab accumulators, laid out [x][y][z]: z stride 1,
// y stride kSlab + 4 (= 4 mod 32), x stride = 16 mod 32, so the 32 taps
// (2 x, 4 y, 4 z) of one marker that a warp adds at once fall in 32
// distinct banks.
__host__ __device__ constexpr int y_stride() { return kSlab + 4; }
__host__ __device__ constexpr int x_stride(int t1) {
  return t1 * y_stride() + (16 - (t1 * y_stride()) % 32 + 32) % 32;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
}

// The core offsets l[k] in [0, tc) of the stencil points floor(xi)-1+k of
// a marker of the tile with origin cell o on a blocked axis of n cells,
// for the core [c0, c0 + tc); -1 for a point outside the core or outside
// the tile's footprint of W cells from o - 1.
struct Taps {
  int l[4];
  __device__ bool any() const { return (l[0] & l[1] & l[2] & l[3]) >= 0; }
};
__device__ __forceinline__ Taps core_taps(float xi, int o, int W, int n,
                                          int c0, int tc) {
  Taps t;
  const int base = wrap((int)floorf(xi) - o, n);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = wrap1(base + k, n);  // footprint offset
    const int l = wrap1(o - 1 + a, n) - c0;
    t.l[k] = (a < W && l >= 0 && l < tc) ? l : -1;
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
tile_spread_kernel(const float* __restrict__ Xb,
                   const float* __restrict__ coef,
                   const int* __restrict__ counts, float* __restrict__ out,
                   int cap, TileGeom g) {
  extern __shared__ float smem[];
  __shared__ int s_tile[kNeighbours];
  __shared__ int s_count[kNeighbours];      // 0 for a repeated neighbour
  __shared__ int s_first[kNeighbours + 1];  // first chunk of each
  __shared__ int s_listed;
  __shared__ unsigned s_max_coef;           // bits of max |coef| >= 0

  const int nb0 = g.n0 / g.t0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int xs = x_stride(g.t1), ys = y_stride();
  const int n_acc = g.t0 * xs;
  const int n_slabs = (g.nz + kSlab - 1) / kSlab;

  // one slab of the column in fixed point: low and high parts
  unsigned* acc_lo = reinterpret_cast<unsigned*>(smem);
  int* acc_hi = reinterpret_cast<int*>(acc_lo + n_acc);
  float* rec = reinterpret_cast<float*>(acc_hi + n_acc);  // per thread
  float* ring = rec + kThreads * kRec;                     // per warp
  unsigned* s_mask =
      reinterpret_cast<unsigned*>(ring + kWarps * kDepth * 128);
  int* s_list = reinterpret_cast<int*>(s_mask + kMaxChunks);
  float* my_rec = rec + threadIdx.x * kRec;
  unsigned* my_rec_u = reinterpret_cast<unsigned*>(my_rec);
  float* my_ring = ring + warp * kDepth * 128;
  const int sx_lo = lane >> 4, sy = (lane >> 2) & 3, sz = lane & 3;

  const int cx = blockIdx.x / g.nb1, cy = blockIdx.x % g.nb1;
  const int X0 = cx * g.t0, Y0 = cy * g.t1;
  if (threadIdx.x < kNeighbours) {
    const int dx = threadIdx.x / 3 - 1, dy = threadIdx.x % 3 - 1;
    const int t = wrap1(cx + dx, nb0) * g.nb1 + wrap1(cy + dy, g.nb1);
    // at nblk = 2 the neighbours -1 and +1 on an axis are one tile
    const bool repeat = (nb0 == 2 && dx == 1) || (g.nb1 == 2 && dy == 1);
    s_tile[threadIdx.x] = t;
    s_count[threadIdx.x] = repeat ? 0 : min(max(counts[t], 0), cap);
  }
  if (threadIdx.x == 0) s_max_coef = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int c = 0;
    for (int j = 0; j < kNeighbours; ++j) {
      s_first[j] = c;
      c += (s_count[j] + 31) / 32;
    }
    s_first[kNeighbours] = c;
  }
  __syncthreads();
  const int n_chunks = s_first[kNeighbours];

  // store slab s of the column, each warp whole z rows (lane = plane):
  // the fixed-point sums scaled back by `unit`, or zeros
  auto store_slab = [&](int s, bool summed, float unit) {
    const int z0 = s * kSlab;
    if (lane >= min(kSlab, g.nz - z0)) return;
    for (int row = warp; row < g.t0 * g.t1; row += kWarps) {
      const int xl = row / g.t1, yl = row - xl * g.t1;
      float v = 0.0f;
      if (summed) {
        const int i = xl * xs + yl * ys + lane;
        const long long sum =
            (long long)acc_hi[i] * (1ll << kLowBits) + acc_lo[i];
        v = __fmul_rn(__ll2float_rn(sum), unit);
      }
      out[((size_t)(X0 + xl) * g.n1 + (Y0 + yl)) * g.nz + z0 + lane] = v;
    }
  };
  if (n_chunks == 0) {  // no filled slot around this column
    for (int s = 0; s < n_slabs; ++s) store_slab(s, false, 0.0f);
    return;
  }

  // Stream this warp's share of `total` chunks, chunk(i) for i = warp,
  // warp + kWarps, ..., through the ring: each lane stages its own slot's
  // x, y, z and coef with cp.async, kDepth - 1 chunks ahead, and `body`
  // gets (chunk, neighbour, staged values, slot filled with coef != 0).
  auto walk = [&](int total, auto chunk, auto body) {
    auto issue = [&](int q) {
      const int i = warp + q * kWarps;
      if (i < total) {
        const int c = chunk(i);
        int j = 0;
        while (c >= s_first[j + 1]) ++j;
        const int m = (c - s_first[j]) * 32 + lane;
        if (m < s_count[j]) {
          const size_t sl = (size_t)s_tile[j] * cap + m;
          float* dst = my_ring + ((q % kDepth) * 32 + lane) * 4;
          cp_async4(dst, Xb + 3 * sl);
          cp_async4(dst + 1, Xb + 3 * sl + 1);
          cp_async4(dst + 2, Xb + 3 * sl + 2);
          cp_async4(dst + 3, coef + sl);
        }
      }
      cp_async_commit();
    };
    for (int q = 0; q < kDepth - 1; ++q) issue(q);
    for (int q = 0; warp + q * kWarps < total; ++q) {
      issue(q + kDepth - 1);
      cp_async_wait_ring();  // chunk q has landed
      const int c = chunk(warp + q * kWarps);
      int j = 0;
      while (c >= s_first[j + 1]) ++j;
      const int m = (c - s_first[j]) * 32 + lane;
      const float4 v = *reinterpret_cast<const float4*>(
          my_ring + ((q % kDepth) * 32 + lane) * 4);
      body(c, j, v, m < s_count[j] && v.w != 0.0f);
    }
  };
  // a marker's grid coordinates and taps inside the core (blocked axes)
  auto core_xy = [&](int j, float4 v, float& xi, float& yi, Taps& tx,
                     Taps& ty) {
    const int t = s_tile[j];
    xi = grid_coord(v.x, g.lo0, g.dx0, g.off0);
    yi = grid_coord(v.y, g.lo1, g.dx1, g.off1);
    tx = core_taps(xi, (t / g.nb1) * g.t0, g.W0, g.n0, X0, g.t0);
    ty = core_taps(yi, (t % g.nb1) * g.t1, g.W1, g.n1, Y0, g.t1);
    return tx.any() && ty.any();
  };

  // pass 1: for each chunk, the slabs (bit min(s, 31)) that its markers'
  // taps reach inside the core; the largest |coef| that reaches it
  walk(n_chunks, [](int i) { return i; },
       [&](int c, int j, float4 v, bool filled) {
         unsigned bits = 0, mag = 0;
         float xi, yi;
         Taps tx, ty;
         if (filled && core_xy(j, v, xi, yi, tx, ty)) {
           const int zf = wrap(
               (int)floorf(grid_coord(v.z, g.lo2, g.dx2, g.off2)), g.nz);
#pragma unroll
           for (int k = 0; k < 4; ++k)
             bits |= 1u << min(wrap1(zf - 1 + k, g.nz) / kSlab, 31);
           mag = __float_as_uint(fabsf(v.w));
         }
         bits = __reduce_or_sync(0xffffffffu, bits);
         mag = __reduce_max_sync(0xffffffffu, mag);
         if (lane == 0) {
           s_mask[c] = bits;
           atomicMax(&s_max_coef, mag);
         }
       });
  __syncthreads();
  // terms scaled by 2^shift (a power of two: exact) stay below 2^kTermBits
  int e;
  frexpf(__uint_as_float(s_max_coef), &e);  // max|coef| < 2^e
  const int shift = max(-126, min(kTermBits - e, 126));
  const float scale = __int_as_float((127 + shift) << 23);  // 2^shift
  const float unit = __int_as_float((127 - shift) << 23);   // 2^-shift

  // pass 2: slab by slab, the chunks that reach it
  for (int s = 0; s < n_slabs; ++s) {
    const int z0 = s * kSlab;
    if (warp == 0) {
      int listed = 0;
      for (int c0 = 0; c0 < n_chunks; c0 += 32) {
        const int c = c0 + lane;
        const bool hit = c < n_chunks && ((s_mask[c] >> min(s, 31)) & 1u);
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (hit) s_list[listed + __popc(ballot & ((1u << lane) - 1))] = c;
        listed += __popc(ballot);
      }
      if (lane == 0) s_listed = listed;
    }
    __syncthreads();
    const int listed = s_listed;
    if (listed == 0) {  // no marker reaches this slab of the column
      store_slab(s, false, 0.0f);
      __syncthreads();  // s_listed is rewritten for the next slab
      continue;
    }
    for (int i = threadIdx.x; i < n_acc; i += kThreads) {
      acc_lo[i] = 0;
      acc_hi[i] = 0;
    }
    __syncthreads();

    walk(listed, [&](int i) { return s_list[i]; },
         [&](int c, int j, float4 v, bool filled) {
           // each lane records its marker's taps inside the box ...
           float xi, yi;
           Taps tx, ty;
           bool live = false;
           if (filled && core_xy(j, v, xi, yi, tx, ty)) {
             const float zi = grid_coord(v.z, g.lo2, g.dx2, g.off2);
             const int zf = wrap((int)floorf(zi), g.nz);
             float wx[4], wy[4], wz[4];
             ib4_weights(xi, wx);
             ib4_weights(yi, wy);
             ib4_weights(zi, wz);
             unsigned xo = 0, yo = 0, zo = 0;
#pragma unroll
             for (int k = 0; k < 4; ++k) {
               const int zl = wrap1(zf - 1 + k, g.nz) - z0;
               const bool in_z = zl >= 0 && zl < kSlab && wz[k] != 0.0f;
               my_rec[k] = wx[k];
               my_rec[4 + k] = wy[k];
               my_rec[8 + k] = __fmul_rn(wz[k], v.w);
               xo |= (tx.l[k] >= 0 && wx[k] != 0.0f ? (unsigned)tx.l[k]
                                                     : kOutside) << (8 * k);
               yo |= (ty.l[k] >= 0 && wy[k] != 0.0f ? (unsigned)ty.l[k]
                                                     : kOutside) << (8 * k);
               zo |= (in_z ? (unsigned)zl : kOutside) << (8 * k);
             }
             my_rec_u[12] = xo;
             my_rec_u[13] = yo;
             my_rec_u[14] = zo;
             live = xo != 0xffffffffu && yo != 0xffffffffu &&
                    zo != 0xffffffffu;
           }
           // ... and the warp adds them one marker at a time, its 64 taps
           // (distinct cells) over the lanes; integer adds commute, so no
           // ordering between markers is needed
           unsigned todo = __ballot_sync(0xffffffffu, live);
           __syncwarp();
           while (todo) {
             const int src = __ffs(todo) - 1;
             todo &= todo - 1;
             const float* r = rec + (warp * 32 + src) * kRec;
             const unsigned* ru = reinterpret_cast<const unsigned*>(r);
             const unsigned yo = (ru[13] >> (8 * sy)) & 0xffu;
             const unsigned zo = (ru[14] >> (8 * sz)) & 0xffu;
#pragma unroll
             for (int h = 0; h < 2; ++h) {
               const int sx = 2 * h + sx_lo;
               const unsigned xo = (ru[12] >> (8 * sx)) & 0xffu;
               if (xo != kOutside && yo != kOutside && zo != kOutside) {
                 const float term =
                     __fmul_rn(__fmul_rn(r[sx], r[4 + sy]), r[8 + sz]);
                 const long long q = __float2ll_rn(__fmul_rn(term, scale));
                 const int i = xo * xs + yo * ys + zo;
                 // q = hi * 2^kLowBits + lo, hi = floor(q / 2^kLowBits)
                 atomicAdd(acc_lo + i,
                           (unsigned)(q & ((1ll << kLowBits) - 1)));
                 atomicAdd(acc_hi + i, (int)(q >> kLowBits));
               }
             }
           }
           __syncwarp();  // the records are rewritten for the next chunk
         });
    __syncthreads();
    store_slab(s, true, unit);
    __syncthreads();  // acc and s_list are rewritten for the next slab
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch. The
// shared memory (one slab of the column in fixed point, 19 KB at tile 8;
// 30 KB of records; a 24 KB staging ring; 4 KB of chunk masks and lists:
// two blocks fit an SM) passes the 48 KB default of dynamic shared memory,
// so the kernel's limit is raised first.
extern "C" int tile_spread_launch(const float* Xb, const float* coef,
                                  const int* counts, float* out, int B,
                                  int cap, TileGeom g, void* stream) {
  const int smem =
      (int)sizeof(int) * 2 * g.t0 * x_stride(g.t1) +
      (int)sizeof(float) * (kThreads * kRec + kWarps * kDepth * 128) +
      (int)(sizeof(unsigned) + sizeof(int)) * kMaxChunks;
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_spread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  if (B == 0) return 0;
  tile_spread_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      Xb, coef, counts, out, cap, g);
  return (int)cudaGetLastError();
}

extern "C" int tile_spread_limits(int* max_cap, int* max_width,
                                  int* min_nz) {
  // the chunks of 9 tiles fit the chunk tables
  *max_cap = kMaxChunks / kNeighbours * 32;
  *max_width = kMaxWidth;
  *min_nz = kMinNz;
  return 0;
}
