// Device code shared by the three VCC projected-gradient kernels
// (pgd_epoch.cu, pgd_epoch_ens.cu, joint_step.cu).
//
// Layout: one warp per cluster row, hour h in lane h, lanes H..31 masked
// ("on" is false there). Masked lanes stay out of every reduction: -inf in
// a max, +inf in a min, 0 in a sum. A butterfly reduction gives every lane
// the same bits, so branches on a reduced value are uniform across the warp.
//
// The compiler may contract a multiply and an add into one FMA wherever it
// sees them. The step expressions that pgd_epoch and pgd_epoch_ens share
// (power_at, descend) spell their roundings out with explicit FMA and
// round-to-nearest intrinsics, which the compiler neither splits nor
// contracts, so both kernels give the same bits for them whatever the code
// around them (the identical-members contract between the two rides on
// this).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace vcc_pgd {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The hour's power at the step's point: pow_nom + (pi d) tau24, where
// pi_d = __fmul_rn(pi, d); one FMA.
__device__ __forceinline__ float power_at(float pow_nom, float pi_d,
                                          float tau24) {
  return __fmaf_rn(pi_d, tau24, pow_nom);
}

// The gradient step at the hour: d - lr (lambda_e eta + price w) pi tau24,
// with eta and w the (member-weighted) intensity and softmax weight.
__device__ __forceinline__ float descend(float d, float lr, float lam,
                                         float eta, float price, float w,
                                         float pi, float tau24) {
  const float g = __fmaf_rn(lam, eta, __fmul_rn(price, w));
  return __fmaf_rn(-lr, __fmul_rn(__fmul_rn(g, pi), tau24), d);
}

// softmax_h(pw / temp) at this lane's hour (0 on masked lanes): 2 reductions
__device__ __forceinline__ float softmax_weight(float pw, float temp, bool on) {
  const float s = on ? pw / temp : -INFINITY;
  const float s_max = warp_max(s);
  const float ex = on ? expf(s - s_max) : 0.f;
  return ex / warp_sum(ex);
}

// Projection of the row z onto {sum_h d = 0} ∩ [lo, ub]: clip(z - nu, lo,
// ub) with nu from exactly `proj_iters` bisection steps on the bracket
// [min z - max ub, max z - min lo] (no tolerance stop, as the reference).
// ub_max / lo_min are the row's reduced box terms. 2 + proj_iters
// reductions.
__device__ __forceinline__ float project(float z, float lo_h, float ub_h,
                                         float ub_max, float lo_min, bool on,
                                         int proj_iters) {
  float a = warp_min(on ? z : INFINITY) - ub_max;
  float b = warp_max(on ? z : -INFINITY) - lo_min;
  for (int k = 0; k < proj_iters; ++k) {
    const float m = 0.5f * (a + b);
    const float f = warp_sum(on ? fminf(fmaxf(z - m, lo_h), ub_h) : 0.f);
    if (f > 0.f) a = m; else b = m;
  }
  const float nu = 0.5f * (a + b);
  return fminf(fmaxf(z - nu, lo_h), ub_h);
}

}  // namespace vcc_pgd
