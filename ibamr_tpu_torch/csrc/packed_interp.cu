// Packed-chunk interpolation straight from the grid for Hopper (sm_90a):
// the pallas_packed engine's tile extraction and packed interp in one
// kernel.
//
// Replaces _packed_interp_kernel_3d (ibamr_tpu/ops/pallas_interaction.py:314,
// pallas_call at :359) together with the prologue that copies each
// tile's footprint out of the grid, _extract_tiles
// (ibamr_tpu/ops/interaction_fast.py:345, called at
// pallas_interaction.py:462). The layout is the occupancy-packed one: Q
// chunks of c slots, chunk q holding markers of tile t = tile_of_chunk[q].
// For every slot (q, m), m < c:
//
//   out[q, m] = sum_a wx[a,m] sum_b wy[b,m] sum_z wz[z,m]
//               f[wrap(x0(t)-1+a), wrap(y0(t)-1+b), z]
//
// over the footprint offsets a < W0, b < W1 of tile t (x0(t) =
// (t / nb1) * t0, y0(t) = (t % nb1) * t1), with the weights of delta.cuh
// (any of the ten named deltas, support S = 2..6, one kernel instantiation
// per S), the function the spread kernels evaluate. Only taps
// inside the footprint count, as in the reference: an empty slot (X = 0)
// of a tile whose footprint misses the origin gets a partial sum, which
// the engine then weights by wb = 0. Every slot is evaluated, so the
// kernel and its plain version agree on all Q * c slots.
//
// Bound. At the flagship (256^3 grid, Q = 1,146 chunks of 128, 99,856
// live slots) an interp must read the 320,572 grid entries under the
// live slots' supports (1.3 MB), the X of all Q * c slots (1.8 MB) and
// tile_of_chunk, and write the (Q, c) output (0.6 MB): 3.6 MB, 0.0011 ms
// at 3.35 TB/s; its ~3e7 operations bound nothing. The reference's form
// first copies the 67 MB grid into a 177 MB (B, 169, nz) tile block and
// then reads it back.
//
// Design. One thread per slot over the compact support: it takes the S
// weights of each axis (footprint_weights; at IB_4 from the fraction of the
// grid coordinate, one square root; every weight outside |t| < S/2 is
// exactly 0), zeroes the x and y taps that fall outside its tile's
// footprint, and reads the S x S grid columns of its support, S z taps
// each: S^3 independent loads in flight per thread (216 at S = 6).
// Slots of a chunk are neighbours on the structure and the chunks of one
// tile are consecutive in q, so neighbouring threads gather from the same
// few lines of L1 and L2 (a tile's footprint over all z is 173 KB at
// 256^3 and IB_4); the whole pack
// runs in about one wave. The sum runs in the reference's nesting (z,
// then y, then x) as fixed FMA chains: no atomics, bitwise reproducible.
// At the flagship pack on an H100 80GB HBM3 (700 W), chip_smoke.py's
// kernels phase read 0.0139 ms of device time for this form, 0.0311 ms
// for a half-warp per slot (tile_interp's form: 4 loads per lane and
// butterfly sums) and 0.0172 ms with each column's 4 taps read as two
// aligned 16-byte loads.
//
// Tensor cores do not pay here: the TPU's matrix unit takes a dense
// (W0 W1, nz) x (nz, c) product per chunk, ~676x the 64 multiply-adds a
// marker needs at IB_4; the compact form is a gather bound by bytes, with no
// product left to feed a matrix unit, and its f32 sums must stay exact
// to f32 rounding, which TF32 is not.

#include <cstdint>

#include "delta.cuh"

namespace {

constexpr int kThreads = 128;   // one slot per thread
constexpr int kMaxWidth = 16;   // footprint widths W0, W1 <= kMaxWidth

template <int S, bool IB4>
__global__ void __launch_bounds__(kThreads)
packed_interp_kernel(const int* __restrict__ tid,
                     const float* __restrict__ Xb,
                     const float* __restrict__ f, float* __restrict__ out,
                     int Q, int c, TileGeom g) {
  const size_t s = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (s >= (size_t)Q * c) return;
  const int t = tid[s / c];
  // footprint origins of tile t: offset a of the footprint is the grid
  // point o - 1 + a
  const int ox = (t / g.nb1) * g.t0, oy = (t % g.nb1) * g.t1;
  const float xi = grid_coord(Xb[3 * s + 0], g.lo0, g.dx0, g.off0);
  const float yi = grid_coord(Xb[3 * s + 1], g.lo1, g.dx1, g.off1);
  const float zi = grid_coord(Xb[3 * s + 2], g.lo2, g.dx2, g.off2);
  // tap k of an axis is the grid point first_tap<S>(xi) + k
  float wx[S], wy[S], wz[S];
  footprint_weights<S, IB4>(xi, ox, g.n0, g, wx);
  footprint_weights<S, IB4>(yi, oy, g.n1, g, wy);
  footprint_weights<S, IB4>(zi, 1, g.nz, g, wz);
  const int fx = first_tap<S>(xi), fy = first_tap<S>(yi),
            fz = first_tap<S>(zi);
  int gx[S], gy[S], gz[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int ax = wrap(fx + 1 + k - ox, g.n0);   // footprint offsets
    const int ay = wrap(fy + 1 + k - oy, g.n1);
    gx[k] = wrap(ox - 1 + ax, g.n0);
    gy[k] = wrap(oy - 1 + ay, g.n1);
    gz[k] = wrap(fz + k, g.nz);
    if (ax >= g.W0) wx[k] = 0.0f;   // only taps inside the footprint
    if (ay >= g.W1) wy[k] = 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int a = 0; a < S; ++a) {
    float inner = 0.0f;
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const float* col = f + ((size_t)gx[a] * g.n1 + gy[b]) * g.nz;
      float sz = 0.0f;
#pragma unroll
      for (int p = 0; p < S; ++p) sz = fmaf(col[gz[p]], wz[p], sz);
      inner = fmaf(wy[b], sz, inner);
    }
    acc = fmaf(wx[a], inner, acc);
  }
  out[s] = acc;
}

}  // namespace

// Launches on `stream` the instantiation for S = g.support (IB_4's own
// at IB_4); returns
// cudaGetLastError() of the launch.
extern "C" int packed_interp_launch(const int* tid, const float* Xb,
                                    const float* f, float* out, int Q, int c,
                                    TileGeom g, void* stream) {
  const long long slots = (long long)Q * c;
  const long long blocks = (slots + kThreads - 1) / kThreads;
  return with_support(g, [&](auto s, auto ib4) {
    if (blocks == 0) return 0;
    packed_interp_kernel<decltype(s)::value, decltype(ib4)::value>
        <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
            tid, Xb, f, out, Q, c, g);
    return (int)cudaGetLastError();
  });
}

// The limits of the instantiation for support S; nonzero for an S that
// has none.
extern "C" int packed_interp_limits(int S, int* max_chunk, int* max_width,
                                    int* min_z) {
  if (S < 2 || S > 6) return (int)cudaErrorInvalidValue;
  *max_chunk = 1 << 30;   // one thread per slot: any chunk size
  *max_width = kMaxWidth;
  *min_z = S + 1;         // S distinct z stencil planes
  return 0;
}
