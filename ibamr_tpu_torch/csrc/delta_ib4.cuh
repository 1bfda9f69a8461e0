// Shared device code of the transfer kernels: the tile geometry passed by
// value from Python, and the IB_4 weights that a spread and its interp
// must evaluate identically. delta_weight is the port of
// _marker_weight_preamble (ibamr_tpu/ops/pallas_interaction.py) for one
// marker and one offset (the packed kernels); ib4_weights gives a
// marker's 4 nonzero weights on one axis at once (the tile kernels).
//
// Every float operation below is an explicit round-to-nearest intrinsic,
// so nvcc never contracts a multiply-add into an FMA here: the weight is
// the same bits in both kernels, whatever each kernel's surroundings.
#pragma once

#include <cuda_runtime.h>

// Mirrors ibamr_tpu_torch/ops/cuda_interaction.py::_Geom field by field.
struct TileGeom {
  int nb1;              // tiles along y
  int t0, t1;           // tile extent along x, y
  int W0, W1;           // footprint widths along x, y (tile + support + 1)
  int n0, n1, nz;       // grid extents
  float lo0, lo1, lo2;  // grid lower corner
  float dx0, dx1, dx2;  // cell sizes
  float off0, off1, off2;  // centering offsets of the field
};

// Continuous grid coordinate of a marker along one axis.
__device__ __forceinline__ float grid_coord(float x, float lo, float dx,
                                            float off) {
  return __fsub_rn(__fdiv_rn(__fsub_rn(x, lo), dx), off);
}

// Peskin's 4-point kernel phi(r), branch-free as in ops/delta.py.
__device__ __forceinline__ float phi_ib4(float r) {
  const float a = fabsf(r);
  const float a2 = __fmul_rn(__fmul_rn(4.0f, a), a);
  const float s_in =
      sqrtf(fmaxf(__fsub_rn(__fadd_rn(1.0f, __fmul_rn(4.0f, a)), a2), 0.0f));
  const float inner =
      __fmul_rn(0.125f, __fadd_rn(__fsub_rn(3.0f, __fmul_rn(2.0f, a)), s_in));
  const float s_out = sqrtf(
      fmaxf(__fsub_rn(__fadd_rn(-7.0f, __fmul_rn(12.0f, a)), a2), 0.0f));
  const float outer =
      __fmul_rn(0.125f, __fsub_rn(__fsub_rn(5.0f, __fmul_rn(2.0f, a)), s_out));
  return a < 1.0f ? inner : (a < 2.0f ? outer : 0.0f);
}

// Weight of a marker at coordinate xi for the grid point at integer
// coordinate k on a periodic axis of n cells. The wrap rounds half to
// even (rintf), as jnp.round does; roundf would round half away from
// zero. Outside |t| < 2 the weight is exactly 0 (_phi_safe).
__device__ __forceinline__ float delta_weight(float xi, float k, float n) {
  float t = __fsub_rn(xi, k);
  t = __fsub_rn(t, __fmul_rn(rintf(__fdiv_rn(t, n)), n));
  if (!(fabsf(t) < 2.0f)) return 0.0f;
  return phi_ib4(fminf(fmaxf(t, -2.0f), 2.0f));
}

// The 4 nonzero IB_4 weights of a marker at grid coordinate xi, for the
// points floor(xi) - 1 + k, k = 0..3 (periodic images alike): with
// r = xi - floor(xi) and q = sqrt(1 + 4r - 4r^2), phi at the distances
// 1+r, r, 1-r, 2-r is (3-2r-q)/8, (3-2r+q)/8, (1+2r+q)/8, (1+2r-q)/8.
// One square root instead of four evaluations of phi; the weights agree
// with delta_weight to f32 rounding (w[3] = 0 exactly at r = 0).
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
