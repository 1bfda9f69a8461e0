// Grid-owner spread for Hopper (sm_90a), shared by the two spread kernels:
// tile_spread.cu (the per-tile layout of the pallas engine) and
// packed_spread.cu (the packed chunk layout of the pallas_packed engine).
// Each block writes the core column of one tile of the periodic grid
// component g (n0, n1, nz) f32:
//
//   g[x, y, z] = sum over the slots m of the tiles t around the column,
//                footprint offsets (a, b) of t with x0(t)-1+a = x and
//                y0(t)-1+b = y (mod n):  wx[a,m] * wy[b,m] * wz[z,m] * coef[m]
//
// with the weights (delta.cuh) of one of the ten named deltas over the
// marker's S x S x S compact support (S = 2..6, a template parameter; the
// delta among those of support S is g.delta): every weight outside
// |t| < S/2 is exactly 0. The caller names the
// slots: for each of the 9 tiles around the column, one contiguous range of
// slots of Xb (slot, 3) and coef (slot); a slot with coef 0 adds nothing
// and is not read further.
//
// Design. A block owns the column of one tile's t0 x t1 core cells over
// all nz planes and writes it once, in z-contiguous rows, 32 planes (a
// slab) at a time. A tile's footprint spans cells x0-1 .. x0+t0+S-1, and
// a tile is at least S + 1 cells wide (make_geometry), so the core
// receives markers of the tiles t-1, t, t+1 on each blocked axis only;
// the caller lists the distinct tiles among those 3 x 3 (at nblk = 2
// the two neighbours on an axis are one tile). Their slot ranges are cut
// into 32-slot chunks. A first pass screens every chunk: each warp reads
// the coef of 4 chunks at once, then the X of their live slots only, and
// enters into a table each chunk whose markers reach the core, with a
// mask of the 32-plane slabs they reach; chunks of empty slots (the
// packed layout's unallocated chunks, pinned to the last tile) cost one
// coalesced read. The second pass takes the slabs one by one; each of 16
// warps walks its share of the table, takes the chunks that reach the
// slab and streams them through a cp.async ring 2 chunks ahead, so a
// marker is read a few times, not once per slab and neighbour (8 x 9),
// and a slab no chunk reaches is stored as zeros. A column whose chunks
// overflow the table (kTable: a hot tile of tens of thousands of markers)
// walks all its chunks for every slab instead: slower, and the same sums.
//
// Determinism without serial adds. A column's markers (thousands around
// the shell's poles) land on a few cells; adding them in a fixed order in
// f32 serialises them. Instead each column scales its contributions by
// 2^s and adds them in fixed point with native 32-bit shared-memory
// atomics (a high and a low part per cell, both exact): integer addition
// is associative, so the warps add their markers concurrently and the grid
// is bitwise reproducible run to run. s comes from the column's largest
// |coef| < 2^e and its count N of live slots that reach the core, which
// bounds the terms of any cell: the low part keeps min(18, 32 -
// ceil(log2 N)) bits, so N of them sum below 2^32, and a term keeps
// 35 - cut bits below 2^e up to N = 2^15, past which each doubling of N
// gives up 2 more. The bound: a term is wx wy (wz coef) with each weight
// at most max phi, so |term| < 2^e (max phi)^3, and its scaled value
// |term| 2^(35 - cut - e) stays below 2^32 when (2 max phi)^3 <= 2^cut,
// that is cut = ceil(3 log2(2 max phi)); the high parts (each below
// 2^(32 - low)) of N terms then sum below 2^30. The host passes cut with
// the delta (ops/delta.py::CUDA_DELTAS): 0 for IB_4 and COSINE (max phi =
// 1/2) and IB_6 (0.4465, its table's largest entry); 1 for BSPLINE_5
// (115/192) and BSPLINE_6 (11/20); 2 for IB_3 and BSPLINE_4 (2/3) and
// BSPLINE_3 (3/4); 3 for PIECEWISE_LINEAR and BSPLINE_2 (1). Without the
// cut a hat's term at a pole would reach 2^35 and its high part overflow.
// A warp adds one marker at a time, its S^3 taps in rounds of 32 over the
// lanes, so the 32 addresses of one atomic are distinct cells (at S = 4
// in distinct banks). Each term is the f32 product the reference forms,
// rounded to 2^-s; each cell is rounded to f32 once, from the exact sum.
//
// Tensor cores do not pay here: each marker adds a rank-1 S x S x S block,
// and the dense product over the footprint that the TPU's matrix unit
// takes was 9.2x slower than compact support on this card (the first
// design of packed_spread.cu); the operands are f32 and the sum must stay
// exact to f32 rounding, which TF32 is not.
#pragma once

#include <cstdint>

#include "delta.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlab = 32;              // z planes stored at a time
constexpr int kDepth = 3;              // 32-slot chunks in flight per warp
constexpr int kGroup = 4;              // chunks a warp screens at once
constexpr int kMaxWidth = 16;          // footprint widths W0, W1 <= kMaxWidth
// S + 1 planes at least, so that a marker's S z taps are distinct planes
__host__ __device__ constexpr int min_nz(int S) { return S + 1; }
constexpr int kNeighbours = 9;         // the 3 x 3 tiles around a column
constexpr int kTable = 1024;           // 32-slot chunks a column tables
// slots around a column a launch may have (Q * c for the packed layout,
// 9 * cap for the per-tile one): up to 2^20 live slots, a column keeps 25
// bits of each term, less the delta's cut (below)
constexpr int kMaxSlots = 1 << 20;
constexpr int kTermBits = 35;          // a term's bits below 2^e, cut 0
constexpr int kLowBits = 18;           // the low part's bits, N <= 2^14
// per-marker record at support S: S x, S y, S z weights (the z weights
// carry coef), then the box offsets of the S x, S y and S z taps as
// bytes, ceil(S / 4) words per axis (kOutside for a tap outside the box or
// of weight 0); the odd stride keeps the lanes' record writes
// conflict-free: 9, 13, 15, 21 and 25 words at S = 2..6
__host__ __device__ constexpr int offset_words(int S) { return (S + 3) / 4; }
__host__ __device__ constexpr int record_words(int S) {
  return (3 * S + 3 * offset_words(S)) | 1;
}
constexpr unsigned kOutside = 0xffu;
constexpr unsigned kFull = 0xffffffffu;

// The slots around one column and the column's running totals, in shared
// memory. The caller fills tile, base and len for the 9 neighbours.
struct Column {
  int tile[kNeighbours];       // tile id of neighbour j
  int base[kNeighbours];       // its first slot
  int len[kNeighbours];        // its slots; 0 for a repeated neighbour
  int first[kNeighbours + 1];  // its first 32-slot chunk in the column
  int n_ent;                   // chunks that reach the core
  unsigned slabs;              // the slabs (bit min(s, 31)) they reach
  unsigned max_coef;           // bits of max |coef| >= 0 reaching the core
  unsigned n_live;             // live slots reaching the core
};

// Tile j (0..8, dx = j / 3 - 1, dy = j % 3 - 1) around the column of tile
// (cx, cy); `repeat` for the second of two equal neighbours at nblk = 2.
__device__ __forceinline__ int neighbour_tile(int j, int cx, int cy,
                                              int nb0, int nb1,
                                              bool& repeat) {
  const int dx = j / 3 - 1, dy = j % 3 - 1;
  repeat = (nb0 == 2 && dx == 1) || (nb1 == 2 && dy == 1);
  return wrap1(cx + dx, nb0) * nb1 + wrap1(cy + dy, nb1);
}

// Row strides of the slab accumulators, laid out [x][y][z]: z stride 1,
// y stride kSlab + 4 (= 4 mod 32), x stride = 16 mod 32, so at S = 4 the
// 32 taps (2 x, 4 y, 4 z) of one marker that a warp adds at once fall in
// 32 distinct banks (other supports may share a bank: time, not bits).
__host__ __device__ constexpr int y_stride() { return kSlab + 4; }
__host__ __device__ constexpr int x_stride(int t1) {
  return t1 * y_stride() + (16 - (t1 * y_stride()) % 32 + 32) % 32;
}

// Dynamic shared memory of a launch at support S whose column table holds
// `table` chunks: one slab in fixed point, the records, the ring, the
// table. At tile 8 and a table of 1,024 chunks: 81.0 KB at S = 4 and
// 101.0 KB at S = 6 (records 30 -> 50 KB): two blocks fit an SM's 227 KB.
__host__ __device__ constexpr int column_smem(int S, int t0, int t1,
                                              int table) {
  return (int)sizeof(int) * 2 * t0 * x_stride(t1) +
         (int)sizeof(float) *
             (kThreads * record_words(S) + kWarps * kDepth * 128) +
         (int)(sizeof(int) + sizeof(unsigned)) * table;
}
// The table of a launch whose columns have at most `chunks` chunks.
__host__ __device__ constexpr int column_table(int chunks) {
  return chunks < kTable ? chunks : kTable;
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

// The core offsets l[k] in [0, tc) of the stencil points first_tap<S>(xi)
// + k of a marker of the tile with origin cell o on a blocked axis of n
// cells, for the core [c0, c0 + tc); -1 for a point outside the core or
// outside the tile's footprint of W cells from o - 1.
template <int S>
struct Taps {
  int l[S];
  __device__ bool any() const {  // some l[k] >= 0: the AND keeps the sign
    int a = l[0];
#pragma unroll
    for (int k = 1; k < S; ++k) a &= l[k];
    return a >= 0;
  }
};
template <int S>
__device__ __forceinline__ Taps<S> core_taps(float xi, int o, int W, int n,
                                             int c0, int tc) {
  Taps<S> t;
  const int base = wrap(first_tap<S>(xi) + 1 - o, n);  // offset of tap 0
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int a = wrap1(base + k, n);  // footprint offset
    const int l = wrap1(o - 1 + a, n) - c0;
    t.l[k] = (a < W && l >= 0 && l < tc) ? l : -1;
  }
  return t;
}

// The neighbour whose range holds chunk i of the column.
__device__ __forceinline__ int neighbour_of(const Column& col, int i) {
  int j = 0;
  while (i >= col.first[j + 1]) ++j;
  return j;
}

// Spread the slots of `col` onto the core column of tile blockIdx.x (tile
// (cx, cy) = (blockIdx.x / nb1, blockIdx.x % nb1)) at support S =
// g.support. All threads of the block call it after the caller has filled
// col.tile, col.base and col.len and synchronised. `table` =
// column_table(the most chunks of a column). IB4: IB_4's instantiation.
template <int S, bool IB4>
__device__ __forceinline__ void spread_column(Column& col,
                                              const float* __restrict__ Xb,
                                              const float* __restrict__ coef,
                                              float* __restrict__ out,
                                              int table, const TileGeom& g,
                                              float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int xs = x_stride(g.t1), ys = y_stride();
  const int n_acc = g.t0 * xs;
  const int n_slabs = (g.nz + kSlab - 1) / kSlab;

  // one slab of the column in fixed point: low and high parts
  unsigned* acc_lo = reinterpret_cast<unsigned*>(smem);
  int* acc_hi = reinterpret_cast<int*>(acc_lo + n_acc);
  float* rec = reinterpret_cast<float*>(acc_hi + n_acc);  // per thread
  constexpr int kRec = record_words(S);
  constexpr int kOff = 3 * S;                 // the offset words' start
  constexpr int kNW = offset_words(S);
  float* ring = rec + kThreads * kRec;                     // per warp
  int* s_ent = reinterpret_cast<int*>(ring + kWarps * kDepth * 128);
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_ent + table);
  float* my_rec = rec + threadIdx.x * kRec;
  unsigned* my_rec_u = reinterpret_cast<unsigned*>(my_rec);
  float* my_ring = ring + warp * kDepth * 128;

  const int cx = blockIdx.x / g.nb1, cy = blockIdx.x % g.nb1;
  const int X0 = cx * g.t0, Y0 = cy * g.t1;
  if (threadIdx.x == 0) {
    int c = 0;
    for (int j = 0; j < kNeighbours; ++j) {
      col.first[j] = c;
      c += (col.len[j] + 31) / 32;
    }
    col.first[kNeighbours] = c;
    col.n_ent = 0;
    col.slabs = 0;
    col.max_coef = 0;
    col.n_live = 0;
  }
  __syncthreads();
  const int n_chunks = col.first[kNeighbours];

  // a marker's grid coordinates and taps inside the core (blocked axes)
  // and the origins (ox, oy) of its tile
  auto core_xy = [&](int j, float x, float y, float& xi, float& yi,
                     Taps<S>& tx, Taps<S>& ty, int& ox, int& oy) {
    const int t = col.tile[j];
    ox = (t / g.nb1) * g.t0;
    oy = (t % g.nb1) * g.t1;
    xi = grid_coord(x, g.lo0, g.dx0, g.off0);
    yi = grid_coord(y, g.lo1, g.dx1, g.off1);
    tx = core_taps<S>(xi, ox, g.W0, g.n0, X0, g.t0);
    ty = core_taps<S>(yi, oy, g.W1, g.n1, Y0, g.t1);
    return tx.any() && ty.any();
  };

  // pass 1: screen the chunks, kGroup at a time per warp (coef first, then
  // the X of the live slots, each group's loads independent); table the
  // ones that reach the core with the slabs (bit min(s, 31)) they reach
  for (int i0 = warp; i0 < n_chunks; i0 += kWarps * kGroup) {
    float cf[kGroup], vx[kGroup], vy[kGroup], vz[kGroup];
    int jn[kGroup], sl[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int i = i0 + k * kWarps;
      cf[k] = 0.0f;
      jn[k] = 0;
      sl[k] = 0;
      if (i < n_chunks) {
        const int j = neighbour_of(col, i);
        const int m = (i - col.first[j]) * 32 + lane;
        jn[k] = j;
        if (m < col.len[j]) {
          sl[k] = col.base[j] + m;
          cf[k] = coef[sl[k]];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      vx[k] = vy[k] = vz[k] = 0.0f;
      if (cf[k] != 0.0f) {
        const float* x = Xb + 3 * (size_t)sl[k];
        vx[k] = x[0];
        vy[k] = x[1];
        vz[k] = x[2];
      }
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int i = i0 + k * kWarps;
      if (i >= n_chunks) break;  // uniform over the warp
      unsigned bits = 0, mag = 0;
      float xi, yi;
      Taps<S> tx, ty;
      int ox, oy;
      const bool live = cf[k] != 0.0f &&
                        core_xy(jn[k], vx[k], vy[k], xi, yi, tx, ty, ox, oy);
      if (live) {
        const int zf = wrap(
            first_tap<S>(grid_coord(vz[k], g.lo2, g.dx2, g.off2)), g.nz);
#pragma unroll
        for (int q = 0; q < S; ++q)
          bits |= 1u << min(wrap1(zf + q, g.nz) / kSlab, 31);
        mag = __float_as_uint(fabsf(cf[k]));
      }
      const unsigned n_in = __popc(__ballot_sync(kFull, live));
      bits = __reduce_or_sync(kFull, bits);
      mag = __reduce_max_sync(kFull, mag);
      if (lane == 0 && bits != 0) {
        const int e = atomicAdd(&col.n_ent, 1);
        if (e < table) {  // past it, pass 2 walks every chunk
          s_ent[e] = i;
          s_mask[e] = bits;
        }
        atomicOr(&col.slabs, bits);
        atomicMax(&col.max_coef, mag);
        atomicAdd(&col.n_live, n_in);
      }
    }
  }
  __syncthreads();
  const int n_ent = col.n_ent;
  const bool tabled = n_ent <= table;  // else walk every chunk per slab

  // store slab s of the column, each warp whole z rows (lane = plane):
  // the fixed-point sums scaled back by `unit`, or zeros
  auto store_slab = [&](int s, bool summed, float unit, int low) {
    const int z0 = s * kSlab;
    if (lane >= min(kSlab, g.nz - z0)) return;
    for (int row = warp; row < g.t0 * g.t1; row += kWarps) {
      const int xl = row / g.t1, yl = row - xl * g.t1;
      float v = 0.0f;
      if (summed) {
        const int i = xl * xs + yl * ys + lane;
        const long long sum =
            (long long)acc_hi[i] * (1ll << low) + acc_lo[i];
        v = __fmul_rn(__ll2float_rn(sum), unit);
      }
      out[((size_t)(X0 + xl) * g.n1 + (Y0 + yl)) * g.nz + z0 + lane] = v;
    }
  };
  if (n_ent == 0) {  // no live slot reaches this column
    for (int s = 0; s < n_slabs; ++s) store_slab(s, false, 0.0f, 0);
    return;
  }

  // the scale: N = n_live bounds the terms of any cell (see the top; the
  // launchers keep N <= kMaxSlots)
  const unsigned n_live = max(col.n_live, 1u);
  const int lg = n_live > 1 ? 32 - __clz(n_live - 1) : 0;  // ceil(log2 N)
  const int low = min(kLowBits, 32 - lg);
  int e;
  frexpf(__uint_as_float(col.max_coef), &e);  // max|coef| < 2^e
  const int shift =
      max(-126, min(kTermBits - g.cut - e - max(0, 2 * lg - 30), 126));
  const float scale = __int_as_float((127 + shift) << 23);  // 2^shift
  const float unit = __int_as_float((127 - shift) << 23);   // 2^-shift
  const long long low_mask = (1ll << low) - 1;

  // Walk this warp's share of the chunks that reach slab bit `bit`: the
  // table entries e = warp, warp + kWarps, ... with that bit (every chunk
  // of the column when the table overflowed), each lane staging its own
  // slot's x, y, z and coef with cp.async, 2 chunks ahead, and `body` gets
  // (neighbour, staged values, slot live with coef != 0).
  static_assert(kDepth == 3, "the walk keeps 2 chunks in flight");
  auto walk = [&](int bit, auto body) {
    const int total = tabled ? n_ent : n_chunks;
    int cur = warp;
    auto next = [&]() {  // the next chunk to walk, or -1
      while (cur < total) {
        const int p = cur;
        cur += kWarps;
        if (!tabled) return p;
        if ((s_mask[p] >> bit) & 1u) return s_ent[p];
      }
      return -1;
    };
    auto issue = [&](int c, int stage) {
      if (c >= 0) {
        const int j = neighbour_of(col, c);
        const int m = (c - col.first[j]) * 32 + lane;
        if (m < col.len[j]) {
          const size_t sl = (size_t)col.base[j] + m;
          float* dst = my_ring + (stage * 32 + lane) * 4;
          cp_async4(dst, Xb + 3 * sl);
          cp_async4(dst + 1, Xb + 3 * sl + 1);
          cp_async4(dst + 2, Xb + 3 * sl + 2);
          cp_async4(dst + 3, coef + sl);
        }
      }
      cp_async_commit();
    };
    int c0 = next();
    issue(c0, 0);
    int c1 = next();
    issue(c1, 1);
    for (int q = 0; c0 >= 0; ++q) {
      const int c2 = next();
      issue(c2, (q + 2) % kDepth);
      cp_async_wait_ring();  // chunk c0 has landed
      const int j = neighbour_of(col, c0);
      const int m = (c0 - col.first[j]) * 32 + lane;
      const float4 v = *reinterpret_cast<const float4*>(
          my_ring + ((q % kDepth) * 32 + lane) * 4);
      body(j, v, m < col.len[j] && v.w != 0.0f);
      c0 = c1;
      c1 = c2;
    }
  };

  // pass 2: slab by slab, the chunks that reach it
  for (int s = 0; s < n_slabs; ++s) {
    const int z0 = s * kSlab;
    const int bit = min(s, 31);
    if (!((col.slabs >> bit) & 1u)) {  // no marker reaches this slab
      store_slab(s, false, 0.0f, 0);
      continue;
    }
    for (int i = threadIdx.x; i < n_acc; i += kThreads) {
      acc_lo[i] = 0;
      acc_hi[i] = 0;
    }
    __syncthreads();

    walk(bit, [&](int j, float4 v, bool filled) {
      // each lane records its marker's taps inside the box ...
      float xi, yi;
      Taps<S> tx, ty;
      int ox, oy;
      bool live = false;
      if (filled && core_xy(j, v.x, v.y, xi, yi, tx, ty, ox, oy)) {
        const float zi = grid_coord(v.z, g.lo2, g.dx2, g.off2);
        const int zf = wrap(first_tap<S>(zi), g.nz);
        float wx[S], wy[S], wz[S];
        footprint_weights<S, IB4>(xi, ox, g.n0, g, wx);
        footprint_weights<S, IB4>(yi, oy, g.n1, g, wy);
        footprint_weights<S, IB4>(zi, 1, g.nz, g, wz);
        unsigned xo[kNW], yo[kNW], zo[kNW];
#pragma unroll
        for (int w = 0; w < kNW; ++w) xo[w] = yo[w] = zo[w] = 0;
        bool in_x = false, in_y = false, in_z = false;
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const int zl = wrap1(zf + k, g.nz) - z0;
          const bool ix = tx.l[k] >= 0 && wx[k] != 0.0f;
          const bool iy = ty.l[k] >= 0 && wy[k] != 0.0f;
          const bool iz = zl >= 0 && zl < kSlab && wz[k] != 0.0f;
          const int sh = 8 * (k & 3);
          my_rec[k] = wx[k];
          my_rec[S + k] = wy[k];
          my_rec[2 * S + k] = __fmul_rn(wz[k], v.w);
          xo[k >> 2] |= (ix ? (unsigned)tx.l[k] : kOutside) << sh;
          yo[k >> 2] |= (iy ? (unsigned)ty.l[k] : kOutside) << sh;
          zo[k >> 2] |= (iz ? (unsigned)zl : kOutside) << sh;
          in_x |= ix;
          in_y |= iy;
          in_z |= iz;
        }
#pragma unroll
        for (int w = 0; w < kNW; ++w) {
          my_rec_u[kOff + w] = xo[w];
          my_rec_u[kOff + kNW + w] = yo[w];
          my_rec_u[kOff + 2 * kNW + w] = zo[w];
        }
        live = in_x && in_y && in_z;
      }
      // ... and the warp adds them one marker at a time, its S^3 taps
      // (distinct cells) in rounds of 32 over the lanes, tap i = 32 rd +
      // lane being (i / S^2, i / S % S, i % S); integer adds commute, so
      // no ordering between markers is needed
      unsigned todo = __ballot_sync(kFull, live);
      __syncwarp();
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const float* r = rec + (warp * 32 + src) * kRec;
        const unsigned* ru = reinterpret_cast<const unsigned*>(r) + kOff;
        auto byte = [](unsigned word, int k) {
          return (word >> (8 * (k & 3))) & 0xffu;
        };
        // the box offsets and the y weight of taps (., sy, sz)
        auto yz = [&](int sy, int sz, unsigned& yo, unsigned& zo,
                      float& wy) {
          yo = byte(ru[kNW + (sy >> 2)], sy);
          zo = byte(ru[2 * kNW + (sz >> 2)], sz);
          wy = r[S + sy];
        };
        auto add = [&](int sx, int sz, unsigned yo, unsigned zo, float wy) {
          const unsigned xo = byte(ru[sx >> 2], sx);
          if (xo != kOutside && yo != kOutside && zo != kOutside) {
            const float term =
                __fmul_rn(__fmul_rn(r[sx], wy), r[2 * S + sz]);
            const long long q = __float2ll_rn(__fmul_rn(term, scale));
            const int i = xo * xs + yo * ys + zo;
            // q = hi * 2^low + lo, hi = floor(q / 2^low)
            atomicAdd(acc_lo + i, (unsigned)(q & low_mask));
            atomicAdd(acc_hi + i, (int)(q >> low));
          }
        };
        constexpr int kTaps = S * S * S;
        if constexpr (32 % (S * S) == 0) {
          // every round gives the lane the same (sy, sz): read them once
          const int sy = (lane / S) % S, sz = lane % S;
          unsigned yo, zo;
          float wy;
          yz(sy, sz, yo, zo, wy);
#pragma unroll
          for (int rd = 0; rd < (kTaps + 31) / 32; ++rd) {
            const int i = 32 * rd + lane;
            if (i < kTaps) add(i / (S * S), sz, yo, zo, wy);
          }
        } else {
#pragma unroll
          for (int rd = 0; rd < (kTaps + 31) / 32; ++rd) {
            const int i = 32 * rd + lane;
            if (i < kTaps) {
              const int sy = (i / S) % S, sz = i % S;
              unsigned yo, zo;
              float wy;
              yz(sy, sz, yo, zo, wy);
              add(i / (S * S), sz, yo, zo, wy);
            }
          }
        }
      }
      __syncwarp();  // the records are rewritten for the next chunk
    });
    __syncthreads();
    store_slab(s, true, unit, low);
    __syncthreads();  // acc is rewritten for the next slab
  }
}

}  // namespace
