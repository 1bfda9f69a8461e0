// Shared device code of the transfer kernels: the tile geometry passed by
// value from Python, and the weights of the ten named isotropic deltas
// that a spread and its interp must evaluate identically. This is the
// port of _marker_weight_preamble (ibamr_tpu/ops/pallas_interaction.py:52),
// phi under _phi_safe's clip of the wrapped distance at every footprint
// offset, cut to the S offsets a marker's weight can be nonzero at:
// footprint_weights<S> gives a marker's S weights on one axis, for the
// taps first_tap<S>(xi) + k, k < S, and tap_weight<S> one of them.
//
// Every float operation below is an explicit round-to-nearest intrinsic,
// so nvcc never contracts a multiply-add into an FMA here: a weight is the
// same bits in all four kernels, whatever each kernel's surroundings, and
// the spread stays the interp's adjoint. Each delta is the formula of
// ibamr_tpu_torch/ops/delta.py, operation for operation.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// The deltas, by the ids of ibamr_tpu_torch/ops/delta.py::CUDA_DELTAS.
enum DeltaId : int {
  kIB4 = 0,
  kCosine = 1,
  kBspline4 = 2,
  kPiecewiseLinear = 3,
  kBspline2 = 4,
  kIB3 = 5,
  kBspline3 = 6,
  kBspline5 = 7,
  kIB6 = 8,
  kBspline6 = 9,
};

// Mirrors ibamr_tpu_torch/ops/cuda_interaction.py::_Geom field by field.
struct TileGeom {
  int nb1;              // tiles along y
  int t0, t1;           // tile extent along x, y
  int W0, W1;           // footprint widths along x, y (tile + support + 1)
  int n0, n1, nz;       // grid extents
  int support;          // S, the delta's support in grid points (2..6)
  int delta;            // DeltaId
  int cut;              // bits a spread term gives up (spread_column.cuh)
  float lo0, lo1, lo2;  // grid lower corner
  float dx0, dx1, dx2;  // cell sizes
  float off0, off1, off2;  // centering offsets of the field
  const double* tab;    // IB_6's table (6 * 4096 + 1 entries), else null
};

// i mod n
__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}
// i mod n for i in [-n, 2n), without a division
__device__ __forceinline__ int wrap1(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// Continuous grid coordinate of a marker along one axis.
__device__ __forceinline__ float grid_coord(float x, float lo, float dx,
                                            float off) {
  return __fsub_rn(__fdiv_rn(__fsub_rn(x, lo), dx), off);
}

// The first of the S stencil points of a marker at grid coordinate xi,
// floor(xi - S/2) + 1 (the first point of the port's bucketing,
// ops/interaction_fast.py::_marker_tile_ids), formed without rounding
// xi - S/2: floor(xi) - S/2 + 1 for even S, and floor(xi - 1/2) -
// (S - 3)/2 for odd S (xi - 1/2 is exact for xi in [1/4, 2^23) and cannot
// cross an integer below that). The S points first_tap + k hold every
// point with |xi - j| < S/2.
template <int S>
__device__ __forceinline__ int first_tap(float xi) {
  if constexpr (S % 2 == 0) {
    return (int)floorf(xi) - S / 2 + 1;
  } else {
    return (int)floorf(__fsub_rn(xi, 0.5f)) - (S - 3) / 2;
  }
}

// The 4 nonzero IB_4 weights of a marker at grid coordinate xi, for the
// points floor(xi) - 1 + k, k = 0..3 (periodic images alike): with
// r = xi - floor(xi) and q = sqrt(1 + 4r - 4r^2), phi at the distances
// 1+r, r, 1-r, 2-r is (3-2r-q)/8, (3-2r+q)/8, (1+2r+q)/8, (1+2r-q)/8.
// One square root instead of four evaluations of phi; the weights agree
// with ops/delta.py's _phi_ib4 to f32 rounding (w[3] = 0 exactly at r = 0).
__device__ __forceinline__ void ib4_weights(float xi, float w[4]) {
  const float r = __fsub_rn(xi, floorf(xi));
  const float q = sqrtf(
      fmaxf(__fadd_rn(1.0f, __fmul_rn(__fmul_rn(4.0f, r),
                                      __fsub_rn(1.0f, r))), 0.0f));
  const float lo = __fsub_rn(3.0f, __fmul_rn(2.0f, r));  // 3 - 2r
  const float hi = __fadd_rn(1.0f, __fmul_rn(2.0f, r));  // 1 + 2r
  w[0] = __fmul_rn(0.125f, __fsub_rn(lo, q));
  w[1] = __fmul_rn(0.125f, __fadd_rn(lo, q));
  w[2] = __fmul_rn(0.125f, __fadd_rn(hi, q));
  w[3] = __fmul_rn(0.125f, __fsub_rn(hi, q));
}

// _phi_piecewise_linear: max(1 - |r|, 0).
__device__ __forceinline__ float phi_piecewise_linear(float r) {
  return fmaxf(__fsub_rn(1.0f, fabsf(r)), 0.0f);
}

// _phi_cosine: (1 + cos(pi a / 2)) / 4 for a = |r| < 2.
__device__ __forceinline__ float phi_cosine(float r) {
  const float a = fabsf(r);
  const float v =
      __fmul_rn(0.25f, __fadd_rn(1.0f, cosf(__fmul_rn(1.5707964f, a))));
  return a < 2.0f ? v : 0.0f;
}

// _phi_ib3: (1 + sqrt(1 - 3a^2)) / 3 for a < 1/2, (5 - 3a - sqrt(1 -
// 3(1-a)^2)) / 6 for a < 3/2.
__device__ __forceinline__ float phi_ib3(float r) {
  const float a = fabsf(r);
  const float s_in = sqrtf(
      fmaxf(__fsub_rn(1.0f, __fmul_rn(__fmul_rn(3.0f, a), a)), 0.0f));
  const float inner = __fdiv_rn(__fadd_rn(1.0f, s_in), 3.0f);
  const float b = __fsub_rn(1.0f, a);
  const float s_out = sqrtf(
      fmaxf(__fsub_rn(1.0f, __fmul_rn(3.0f, __fmul_rn(b, b))), 0.0f));
  const float outer = __fdiv_rn(
      __fsub_rn(__fsub_rn(5.0f, __fmul_rn(3.0f, a)), s_out), 6.0f);
  return a < 0.5f ? inner : (a < 1.5f ? outer : 0.0f);
}

// x^Y by binary exponentiation, the products in _integer_pow's order.
template <int Y>
__device__ __forceinline__ float integer_pow(float x) {
  float acc = 1.0f;
  bool has = false;
  int y = Y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // Y < 16
    if (y > 0) {
      if (y & 1) {
        acc = has ? __fmul_rn(acc, x) : x;
        has = true;
      }
      y >>= 1;
      if (y) x = __fmul_rn(x, x);
    }
  }
  return acc;
}

// (-1)^j C(k, j) / (k-1)!, rounded once to double, as Python forms it.
__host__ __device__ constexpr double bspline_coef(int k, int j) {
  double c = 1.0;  // C(k, j), exact
  for (int i = 0; i < j; ++i) c = c * (k - i) / (i + 1);
  double f = 1.0;  // (k - 1)!
  for (int i = 2; i < k; ++i) f *= i;
  return ((j % 2) ? -c : c) / f;
}

// _make_bspline(K): the truncated-power sum
// sum_j c_j max(r + K/2 - j, 0)^(K-1), term by term in the formula's
// order; the caller clips it to |r| < K/2.
template <int K>
__device__ __forceinline__ float phi_bspline(float r) {
  float out = 0.0f;
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    const float c = (float)bspline_coef(K, j);
    const float x =
        fmaxf(__fsub_rn(__fadd_rn(r, 0.5f * K), (float)j), 0.0f);
    out = __fadd_rn(out, __fmul_rn(c, integer_pow<K - 1>(x)));
  }
  return out;
}

// _phi_ib6: the table lerped. t and frac in f32, the lerp in f64 against
// the f64 table, one rounding to f32 at the end.
__device__ __forceinline__ float phi_ib6(float r, const double* tab) {
  constexpr int m = 4096;
  const float t = __fmul_rn(__fadd_rn(fminf(fmaxf(r, -3.0f), 3.0f), 3.0f),
                            (float)m);
  const int i = min(max((int)floorf(t), 0), 6 * m - 1);
  const float frac = __fsub_rn(t, (float)i);
  const double lo = __ldg(tab + i), hi = __ldg(tab + i + 1);
  const double v = __dadd_rn(lo, __dmul_rn((double)frac, __dsub_rn(hi, lo)));
  return fabsf(r) < 3.0f ? __double2float_rn(v) : 0.0f;
}

// _phi_safe(phi, S)(t): phi of t clipped to [-S/2, S/2], exactly 0 unless
// |t| < S/2; the delta is g.delta among those of support S.
template <int S>
__device__ __forceinline__ float phi_safe(float t, const TileGeom& g) {
  constexpr float half = 0.5f * S;
  if (!(fabsf(t) < half)) return 0.0f;
  if constexpr (S == 2) {
    return g.delta == kPiecewiseLinear ? phi_piecewise_linear(t)
                                       : phi_bspline<2>(t);
  } else if constexpr (S == 3) {
    return g.delta == kIB3 ? phi_ib3(t) : phi_bspline<3>(t);
  } else if constexpr (S == 4) {
    return g.delta == kCosine ? phi_cosine(t) : phi_bspline<4>(t);
  } else if constexpr (S == 5) {
    return phi_bspline<5>(t);
  } else {
    return g.delta == kIB6 ? phi_ib6(t, g.tab) : phi_bspline<6>(t);
  }
}

// The weight of a marker at grid coordinate xi for the footprint point
// at coordinate kf of a periodic axis of n cells: phi_safe of the
// distance wrapped by rounding half to even (rintf, as jnp.round and
// torch.round do), the same f32 operations as the plain version's and
// the reference's preamble, so that the weight is theirs bit for bit.
// Only a distance of n/2 or more changes in the wrap (a tap across the
// periodic seam), so only such a distance pays the division.
template <int S>
__device__ __forceinline__ float tap_weight(float xi, int kf, int n,
                                            const TileGeom& g) {
  float t = __fsub_rn(xi, (float)kf);
  if (!(fabsf(t) < 0.5f * (float)n)) {
    const float fn = (float)n;
    t = __fsub_rn(t, __fmul_rn(rintf(__fdiv_rn(t, fn)), fn));
  }
  return phi_safe<S>(t, g);
}

// The S weights of a marker at grid coordinate xi on one axis, for the
// points first_tap<S>(xi) + k of a footprint that starts at point o - 1
// (the tile's origin o on a blocked axis; o = 1 on the periodic z axis,
// whose footprint is the whole axis): tap k is the footprint point of
// offset wrap(first_tap + 1 + k - o, n). IB_4 (IB4: an instantiation of
// its own, so that its kernels carry no other delta's code) keeps its
// closed form.
template <int S, bool IB4>
__device__ __forceinline__ void footprint_weights(float xi, int o, int n,
                                                  const TileGeom& g,
                                                  float w[S]) {
  if constexpr (IB4) {
    static_assert(S == 4, "IB_4 has support 4");
    ib4_weights(xi, w);
  } else {
    const int base = wrap(first_tap<S>(xi) + 1 - o, n);
#pragma unroll
    for (int k = 0; k < S; ++k)
      w[k] = tap_weight<S>(xi, o - 1 + wrap1(base + k, n), n, g);
  }
}

// The instantiations of the kernels: fn(std::integral_constant<int, S>,
// std::bool_constant<IB4>) for the geometry's support S, IB4 for IB_4 (its
// closed form, in an instantiation of its own), or cudaErrorInvalidValue.
template <typename Fn>
__host__ int with_support(const TileGeom& g, Fn fn) {
  using std::integral_constant;
  switch (g.support) {
    case 2: return fn(integral_constant<int, 2>(), std::false_type());
    case 3: return fn(integral_constant<int, 3>(), std::false_type());
    case 4:
      return g.delta == kIB4
                 ? fn(integral_constant<int, 4>(), std::true_type())
                 : fn(integral_constant<int, 4>(), std::false_type());
    case 5: return fn(integral_constant<int, 5>(), std::false_type());
    case 6: return fn(integral_constant<int, 6>(), std::false_type());
    default: return (int)cudaErrorInvalidValue;
  }
}
