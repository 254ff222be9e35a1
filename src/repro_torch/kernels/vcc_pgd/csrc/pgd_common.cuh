// Device code shared by the three VCC projected-gradient kernels
// (pgd_epoch.cu, pgd_epoch_ens.cu, joint_step.cu).
//
// All three take the row-group layout of the last section of this file: a
// row of H <= 32 hours goes to a group of kLanes lanes, and lane j of the
// group keeps hours j, j + kLanes, j + 2 kLanes, ... (NH = ceil(H / kLanes)
// of them) in registers; a warp holds 32 / kLanes rows. A reduction runs
// over the lane's own hours in registers (a fixed pairwise tree), then
// takes log2(kLanes) __shfl_xor_sync stages with offsets < kLanes. The
// whole-warp reduction warp_reduce (five stages) serves joint_step.cu's
// bisection of the fleet-coupled shift, whose row is a rollout's n
// clusters spread over one warp.
//
// A masked hour stays out of every reduction (-inf in a max, +inf in a
// min, 0 in a sum), and a butterfly gives every lane of the row the same
// bits (each stage adds the same two values, whichever lane adds them), so
// a value reduced over the row is uniform across its lanes.
//
// The compiler may contract a multiply and an add into one FMA wherever it
// sees them. The step expressions that pgd_epoch and pgd_epoch_ens share
// (power_at, descend) spell their roundings out with explicit FMA and
// round-to-nearest intrinsics, which the compiler neither splits nor
// contracts, so both kernels give the same bits for them whatever the code
// around them (the identical-members contract between the two rides on
// this, and on both calling the same group primitives in the same order).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace vcc_pgd {

constexpr unsigned kFull = 0xffffffffu;

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

// ------------------------------- row groups (all three kernels)

// Lanes a row (a power of two) and whether the bisection stops once its
// brackets stop moving. tools/pgd_probe.py builds other values with -D
// (and -DPGD_ONLY_NH=n, one instance of NH hours a lane, to build fast);
// the shipped kernels take these defaults, chosen by that probe and by
// tools/joint_probe.py (their numbers: the headers of pgd_epoch.cu and
// joint_step.cu).
#ifndef PGD_LANES
#define PGD_LANES 4
#endif
#ifndef PGD_EARLY_EXIT
#define PGD_EARLY_EXIT 1
#endif

constexpr int kLanes = PGD_LANES;
static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8 ||
                  kLanes == 16 || kLanes == 32,
              "PGD_LANES: a power of two <= 32");
constexpr bool kEarlyExit = PGD_EARLY_EXIT != 0;
constexpr int kRowsPerWarp = 32 / kLanes;
constexpr int kBlockWarps = 2;  // small blocks: the last wave is short
constexpr int kBlockRows = kBlockWarps * kRowsPerWarp;
// the NH (hours a lane) instances built: all that H <= 32 needs
#ifdef PGD_ONLY_NH
constexpr int kFirstNH = PGD_ONLY_NH, kLastNH = PGD_ONLY_NH;
#else
constexpr int kFirstNH = 1, kLastNH = 32 / kLanes;
#endif

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};
struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};
struct Min {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fminf(a, b);
  }
};

// x[B] op ... op x[B + N - 1] as a fixed pairwise tree (N - 1 operations,
// log2 N deep)
template <int B, int N, int NH, class Op>
__device__ __forceinline__ float tree(const float (&x)[NH], Op op) {
  if constexpr (N == 1) {
    return x[B];
  } else {
    return op(tree<B, N / 2>(x, op), tree<B + N / 2, N - N / 2>(x, op));
  }
}

// The group's stages of a reduction under op: v, the lane's own part, with
// log2(kLanes) butterfly stages within the group.
template <class Op>
__device__ __forceinline__ float group_finish(float v, Op op) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// group_finish of KB values at once, stage by stage: the KB shuffles of a
// stage are in flight together, and each value gets group_finish's bits.
template <int KB, class Op>
__device__ __forceinline__ void group_finish_many(float (&v)[KB], Op op) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    float u[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) u[k] = __shfl_xor_sync(kFull, v[k], o);
#pragma unroll
    for (int k = 0; k < KB; ++k) v[k] = op(v[k], u[k]);
  }
}

// v reduced under op over the whole warp: five butterfly stages, the
// same bits on every lane.
template <class Op>
__device__ __forceinline__ float warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Whether v holds on every lane of this lane's group: one ballot of the
// warp, read at the group's kLanes bits.
__device__ __forceinline__ bool group_all(bool v) {
  constexpr unsigned kGroupBits =
      kLanes == 32 ? kFull : (1u << (kLanes & 31)) - 1u;
  const unsigned bad = __ballot_sync(kFull, !v);
  const int first = (threadIdx.x & 31) & ~(kLanes - 1);
  return ((bad >> first) & kGroupBits) == 0u;
}

// The row's reduction under op of x, this lane's NH hours: the lane's own
// hours by the tree, then the group's stages.
template <int NH, class Op>
__device__ __forceinline__ float group_reduce(const float (&x)[NH], Op op) {
  return group_finish(tree<0, NH>(x, op), op);
}

// softmax_h(pw / temp) at this lane's hours, into w (0 where masked), given
// rtemp = 1 / temp: 2 reductions. The two divisions an hour are multiplies
// by a reciprocal (__frcp_rn: of temp once an epoch, of the sum once a
// step): an IEEE division compiles to a call with a slow path, a
// convergence barrier and register moves around it, and those took most of
// kernel #2's instructions. Against the plain version's divisions this
// moves a softmax logit by an ulp or so.
template <int NH>
__device__ __forceinline__ void softmax_weights(const float (&pw)[NH],
                                                float rtemp,
                                                const bool (&on)[NH],
                                                float (&w)[NH]) {
  float s[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) s[i] = on[i] ? pw[i] * rtemp : -INFINITY;
  const float s_max = group_reduce(s, Max());
#pragma unroll
  for (int i = 0; i < NH; ++i) s[i] = on[i] ? expf(s[i] - s_max) : 0.f;
  const float rden = __frcp_rn(group_reduce(s, Add()));
#pragma unroll
  for (int i = 0; i < NH; ++i) w[i] = s[i] * rden;
}

// softmax_weights of KB rows at once (x: their powers in, their weights
// out), their reductions interleaved stage by stage; row by row the same
// operations on the same values, so the same bits as softmax_weights.
template <int KB, int NH>
__device__ __forceinline__ void softmax_weights_many(float (&x)[KB][NH],
                                                     float rtemp,
                                                     const bool (&on)[NH]) {
  float r[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
#pragma unroll
    for (int i = 0; i < NH; ++i) x[k][i] = on[i] ? x[k][i] * rtemp : -INFINITY;
    r[k] = tree<0, NH>(x[k], Max());
  }
  group_finish_many(r, Max());
#pragma unroll
  for (int k = 0; k < KB; ++k) {
#pragma unroll
    for (int i = 0; i < NH; ++i)
      x[k][i] = on[i] ? expf(x[k][i] - r[k]) : 0.f;
    r[k] = tree<0, NH>(x[k], Add());
  }
  group_finish_many(r, Add());
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float rden = __frcp_rn(r[k]);
#pragma unroll
    for (int i = 0; i < NH; ++i) x[k][i] = x[k][i] * rden;
  }
}

// The row z (this lane's hours, in place) projected onto {sum_h d = 0} ∩
// [lo, ub]: clip(z - nu, lo, ub), nu from `proj_iters` bisection steps on
// the bracket [min z - max ub, max z - min lo] (the plain version's
// ref.project_row, without a tolerance stop); ub_max /
// lo_min are the row's reduced box terms. Masked hours hold z = lo = ub =
// 0, so they add 0 to the bisection's sums without a select. The groups of
// a warp disagree on f > 0, so the bracket moves by selects, not branches.
// With kEarlyExit the warp leaves the loop once a step has left the
// brackets of all its groups as they were, bit for bit: a step is a
// function of the bracket alone, so every later step would leave them so
// too, and the result is that of all proj_iters steps.
// 2 + proj_iters reductions (fewer with kEarlyExit).
template <int NH>
__device__ __forceinline__ void project_rows(float (&z)[NH],
                                             const float (&lo)[NH],
                                             const float (&ub)[NH],
                                             float ub_max, float lo_min,
                                             const bool (&on)[NH],
                                             int proj_iters) {
  float t[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) t[i] = on[i] ? z[i] : INFINITY;
  float a = group_reduce(t, Min()) - ub_max;
#pragma unroll
  for (int i = 0; i < NH; ++i) t[i] = on[i] ? z[i] : -INFINITY;
  float b = group_reduce(t, Max()) - lo_min;
  for (int k = 0; k < proj_iters; ++k) {
    const float m = 0.5f * (a + b);
#pragma unroll
    for (int i = 0; i < NH; ++i) t[i] = fminf(fmaxf(z[i] - m, lo[i]), ub[i]);
    const float f = group_reduce(t, Add());
    const float a2 = f > 0.f ? m : a;
    const float b2 = f > 0.f ? b : m;
    const bool still = __float_as_uint(a2) == __float_as_uint(a) &&
                       __float_as_uint(b2) == __float_as_uint(b);
    a = a2;
    b = b2;
    if (kEarlyExit && __all_sync(kFull, still)) break;
  }
  const float nu = 0.5f * (a + b);
#pragma unroll
  for (int i = 0; i < NH; ++i) z[i] = fminf(fmaxf(z[i] - nu, lo[i]), ub[i]);
}

// The box is fixed for an epoch: its bracket terms max ub and min lo are
// reduced once (2 reductions).
template <int NH>
__device__ __forceinline__ void box_terms(const float (&lo)[NH],
                                          const float (&ub)[NH],
                                          const bool (&on)[NH],
                                          float& ub_max, float& lo_min) {
  float t[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) t[i] = on[i] ? ub[i] : -INFINITY;
  ub_max = group_reduce(t, Max());
#pragma unroll
  for (int i = 0; i < NH; ++i) t[i] = on[i] ? lo[i] : INFINITY;
  lo_min = group_reduce(t, Min());
}

}  // namespace vcc_pgd
