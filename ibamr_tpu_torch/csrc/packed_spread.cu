// Grid-owner packed spread for Hopper (sm_90a): the pallas_packed engine's
// packed spread, its visited-tile mask and its overlap-add in one kernel
// that writes the periodic grid itself.
//
// Replaces _packed_spread_kernel_3d (ibamr_tpu/ops/pallas_interaction.py:250,
// pallas_call at :304) together with what PallasPackedInteraction.spread
// (:423-444) does with its (B, W0*W1, nz) tile partials: the visited-tile
// mask (_visited_mask, :415) and the fold onto the grid, _overlap_add
// (ibamr_tpu/ops/interaction_fast.py:297).
// The layout is the packed one (interaction_packed.pack_markers): Q chunks
// of c slots, chunk q holding markers of the tile tid[q], tid
// nondecreasing, so a tile's chunks are one contiguous range of slots; a
// tile's markers fill a prefix of its range, and the chunks past the last
// allocated one are pinned to the last tile with coef 0 and X 0. The grid
// component g (n0, n1, nz) f32 sums, over every slot, the marker's
// weights (any of the ten named deltas, support S = 2..6, one kernel
// instantiation per S) times its coef (spread_column.cuh, which holds the
// design: a
// block per tile's core column, the distinct 3 x 3 neighbour tiles walked
// once, fixed-point sums in shared memory, each slab stored once; a column
// no live slot reaches is stored as zeros, which is the reference's mask).
//
// Bound. At the flagship (256^3 grid, Q = 1,146 chunks of 128, 99,856 live
// slots) the kernel must store the grid once (67.1 MB f32), read the coef
// of every slot (0.59 MB), the X of the live ones (1.20 MB) and tid (4.6
// KB): 68.9 MB, 0.0206 ms at 3.35 TB/s. Its ~3e7 operations bound nothing.
// The reference's form stores a (B, 169, nz) tile block (177 MB) and the
// overlap-add reads it back.
//
// Finding a tile's chunks. Each of 9 warps finds one neighbour's range
// [q0, q1) of tid by two 33-way warp searches (lanes probe 32 split points
// at once, ballot, narrow): 3 dependent reads of tid each at the flagship,
// no per-tile table in the layout. Unlike the per-tile layout, the packed
// one caps no tile: a pole tile keeps every marker, in as many chunks as it
// needs, so a column may hold tens of thousands of slots (spread_column.cuh
// scales its fixed point by the column's live count, and walks a column
// that overflows its chunk table chunk by chunk).

#include "spread_column.cuh"

namespace {

// The first q in [0, Q) with tid[q] >= key (Q if none) for nondecreasing
// tid; all 32 lanes call it and get the answer.
__device__ int warp_lower_bound(const int* __restrict__ tid, int Q, int key,
                                int lane) {
  int lo = 0, hi = Q;  // the answer lies in [lo, hi]
  while (hi > lo) {
    const int len = hi - lo;
    // 32 probes in [lo, hi): every candidate, or 32 evenly spaced ones
    const int pos = len <= 32
                        ? lo + lane
                        : lo + (int)((long long)(lane + 1) * len / 33);
    const bool below = pos < hi && tid[pos] < key;
    const int n = __popc(__ballot_sync(kFull, below));  // a prefix of lanes
    if (len <= 32) return lo + n;
    const int p_lo = __shfl_sync(kFull, pos, max(n - 1, 0));
    const int p_hi = __shfl_sync(kFull, pos, min(n, 31));
    if (n > 0) lo = p_lo + 1;
    if (n < 32) hi = p_hi;
  }
  return lo;
}

template <int S, bool IB4>
__global__ void __launch_bounds__(kThreads)
packed_spread_kernel(const int* __restrict__ tid,
                     const float* __restrict__ Xb,
                     const float* __restrict__ coef,
                     float* __restrict__ out, int Q, int c, int table,
                     TileGeom g) {
  extern __shared__ float smem[];
  __shared__ Column col;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < kNeighbours) {
    bool repeat;
    const int t = neighbour_tile(warp, blockIdx.x / g.nb1,
                                 blockIdx.x % g.nb1, g.n0 / g.t0, g.nb1,
                                 repeat);
    const int q0 = warp_lower_bound(tid, Q, t, lane);
    const int q1 = warp_lower_bound(tid, Q, t + 1, lane);
    if (lane == 0) {
      col.tile[warp] = t;
      col.base[warp] = q0 * c;
      col.len[warp] = repeat ? 0 : (q1 - q0) * c;
    }
  }
  __syncthreads();
  spread_column<S, IB4>(col, Xb, coef, out, table, g, smem);
}

// Launches on `stream` the instantiation for S = g.support (IB_4's own
// at IB_4); returns
// cudaGetLastError() of the launch. The shared memory (one slab of the
// column in fixed point, 19 KB at tile 8; the records, 30 KB at S = 4 and
// 50 KB at S = 6; a 24 KB staging ring; an 8 KB chunk table: two blocks
// fit an SM) passes the 48 KB default of dynamic shared memory, so each
// instantiation's limit is raised first.
template <int S, bool IB4>
int launch(const int* tid, const float* Xb, const float* coef, float* out,
           int Q, int c, const TileGeom& g, cudaStream_t stream) {
  const int table = column_table(Q * ((c + 31) / 32));
  const int smem = column_smem(S, g.t0, g.t1, table);
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_spread_kernel<S, IB4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int B = (g.n0 / g.t0) * g.nb1;
  packed_spread_kernel<S, IB4><<<B, kThreads, smem, stream>>>(
      tid, Xb, coef, out, Q, c, table, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int packed_spread_launch(const int* tid, const float* Xb,
                                    const float* coef, float* out, int Q,
                                    int c, TileGeom g, void* stream) {
  return with_support(g, [&](auto s, auto ib4) {
    return launch<decltype(s)::value, decltype(ib4)::value>(
        tid, Xb, coef, out, Q, c, g, (cudaStream_t)stream);
  });
}

// The limits of the instantiation for support S; nonzero for an S that
// has none.
extern "C" int packed_spread_limits(int S, int* max_slots, int* max_width,
                                    int* min_z) {
  if (S < 2 || S > 6) return (int)cudaErrorInvalidValue;
  // every slot of the layout may lie around one column
  *max_slots = kMaxSlots;
  *max_width = kMaxWidth;
  *min_z = min_nz(S);
  return 0;
}
