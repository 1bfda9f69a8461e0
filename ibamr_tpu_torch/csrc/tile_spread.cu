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
// counts[t] slots. The grid component g (n0, n1, nz) f32 sums, over the
// filled slots of every tile, the marker's IB_4 weights times its coef
// (spread_column.cuh, which holds the design: a block per tile's core
// column, the distinct 3 x 3 neighbour tiles walked once, fixed-point sums
// in shared memory, each slab stored once).
//
// Bound. At the flagship (256^3 grid, B = 1,024 tiles of cap 1,024, 95,148
// filled slots) the kernel must store the grid once (67.1 MB f32) and read
// the X and coef of the filled slots (1.5 MB) and the counts (4 KB): 68.6
// MB, 0.0205 ms at 3.35 TB/s. Its ~3e7 operations bound nothing. The
// reference's form stores a (B, 169, nz) tile block instead (177 MB, 2.6x
// the grid, 792 of its 1,024 tiles zero) and the overlap-add reads it back.
//
// Here each neighbour tile's slots are the filled prefix of its row: 91% of
// the flagship's slots are never read.

#include "spread_column.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
tile_spread_kernel(const float* __restrict__ Xb,
                   const float* __restrict__ coef,
                   const int* __restrict__ counts, float* __restrict__ out,
                   int cap, int table, TileGeom g) {
  extern __shared__ float smem[];
  __shared__ Column col;
  if (threadIdx.x < kNeighbours) {
    const int j = threadIdx.x;
    bool repeat;
    const int t = neighbour_tile(j, blockIdx.x / g.nb1, blockIdx.x % g.nb1,
                                 g.n0 / g.t0, g.nb1, repeat);
    col.tile[j] = t;
    col.base[j] = t * cap;
    col.len[j] = repeat ? 0 : min(max(counts[t], 0), cap);
  }
  __syncthreads();
  spread_column(col, Xb, coef, out, table, g, smem);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch. The
// shared memory (one slab of the column in fixed point, 19 KB at tile 8;
// 30 KB of records; a 24 KB staging ring; a 2.3 KB chunk table at cap
// 1,024: two blocks fit an SM) passes the 48 KB default of dynamic shared
// memory, so the kernel's limit is raised first.
extern "C" int tile_spread_launch(const float* Xb, const float* coef,
                                  const int* counts, float* out, int B,
                                  int cap, TileGeom g, void* stream) {
  const int table = column_table(kNeighbours * ((cap + 31) / 32));
  const int smem = column_smem(g.t0, g.t1, table);
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
      Xb, coef, counts, out, cap, table, g);
  return (int)cudaGetLastError();
}

extern "C" int tile_spread_limits(int* max_cap, int* max_width,
                                  int* min_nz) {
  // the slots of 9 tiles around a column
  *max_cap = kMaxSlots / kNeighbours;
  *max_width = kMaxWidth;
  *min_nz = kMinNz;
  return 0;
}
