// CVaR ensemble VCC projected-gradient epoch for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/vcc_pgd/kernel.py:251
// pgd_epoch_ens_pallas (body _pgd_ens_kernel). One epoch runs `iters`
// steps of, per cluster row of H <= 32 hours and K <= 32 forecast members:
//
//   pow_k  = pow_nom_k + pi * d * tau24                       (each member)
//   w_k    = softmax_h(pow_k / temp)
//   cost_k = lambda_e * sum_h eta_k pow_k + price * sum_h w_k pow_k
//   z_k    = cost_k - cost_0,  scale = mean_k |cost_k - mean cost| + 1e-9
//   wm_k   = softmax_k(risk_s * z_k / scale)
//   eta_w  = eta_0 + sum_k wm_k (eta_k - eta_0)   (anchored on member 0)
//   w_w    = w_0   + sum_k wm_k (w_k - w_0)
//   grad   = (lambda_e * eta_w + price * w_w) * pi * tau24
//   d      = project(d - lr * grad)                 (as in pgd_epoch.cu)
//
// Design: kernel #1's layout (one warp per row, hour h in lane h, lanes
// H..31 masked; pgd_common.cuh). Each warp keeps its row's K members of eta
// and pow_nom, this step's K softmax rows, the K member costs and the K
// member logits (then weights) in its own slice of shared memory:
// (3 * 32 K + 64) floats, so 8 / 4 / 2 warps per block for K <= 8 / 16 /
// 32 (about 25 KB a block). In the member softmax over K, lane k forms
// member k's logit, exponential and weight once; every lane reduces the
// same K values in the same order, so the bisection branch stays uniform.
// With K identical members every anchored deviation is exactly 0, and the
// step is kernel #1's step.
//
// Operand layout: the member stacks are read where they lie, (B, K, n, H)
// contiguous with rows = B * n (B = 1 for a (K, rows, H) stack): member k of
// row r = b * n + c is at ((b * K + k) * n + c) * H. The dispatcher does not
// copy them per launch.
//
// Reductions a row and step: 4 K (softmax max and sum, two cost sums per
// member) + 52 (the projection); 2 more once an epoch.
#include "pgd_common.cuh"

namespace {

using namespace vcc_pgd;

__global__ void pgd_epoch_ens_kernel(
    const float* __restrict__ delta, const float* __restrict__ eta_e,
    const float* __restrict__ pi, const float* __restrict__ pow_e,
    const float* __restrict__ tau24, const float* __restrict__ price,
    const float* __restrict__ lo, const float* __restrict__ ub,
    const float* __restrict__ lr, const float* __restrict__ temp,
    const float* __restrict__ lambda_e, const float* __restrict__ risk_s,
    float* __restrict__ out, int rows, int H, int n, int K, int iters,
    int proj_iters, int warps_per_block) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * warps_per_block + warp;
  if (row >= rows) return;  // the whole warp leaves together
  const bool on = lane < H;
  const size_t off = static_cast<size_t>(row) * H + lane;

  float* s_eta = smem + static_cast<size_t>(warp) * (3 * 32 * K + 64);
  float* s_pow = s_eta + 32 * K;
  float* s_w = s_pow + 32 * K;
  float* s_cost = s_w + 32 * K;
  float* s_t = s_cost + 32;

  const size_t b = static_cast<size_t>(row / n);
  const size_t c = static_cast<size_t>(row % n);
  for (int k = 0; k < K; ++k) {
    const size_t m = ((b * K + k) * n + c) * H + lane;
    s_eta[k * 32 + lane] = on ? eta_e[m] : 0.f;
    s_pow[k * 32 + lane] = on ? pow_e[m] : 0.f;
  }

  float d = on ? delta[off] : 0.f;
  const float p_h = on ? pi[off] : 0.f;
  const float lo_h = on ? lo[off] : 0.f;
  const float ub_h = on ? ub[off] : 0.f;
  const float t24 = tau24[row];
  const float pr = price[row];
  const float step = lr[row];
  const float tmp = temp[row];
  const float lam = lambda_e[row];
  const float rs = risk_s[row];
  const float kf = static_cast<float>(K);

  const float ub_max = warp_max(on ? ub_h : -INFINITY);
  const float lo_min = warp_min(on ? lo_h : INFINITY);

  for (int it = 0; it < iters; ++it) {
    const float pi_d = __fmul_rn(p_h, d);
    for (int k = 0; k < K; ++k) {
      const float ph = power_at(s_pow[k * 32 + lane], pi_d, t24);
      const float w = softmax_weight(ph, tmp, on);
      s_w[k * 32 + lane] = w;
      const float ce = warp_sum(on ? s_eta[k * 32 + lane] * ph : 0.f);
      const float cw = warp_sum(on ? w * ph : 0.f);
      if (lane == 0) s_cost[k] = lam * ce + pr * cw;
    }
    __syncwarp();

    // member weights: the mean and deviation are a scalar loop that every
    // lane runs alike; lane k < K forms member k's logit, exponential and
    // weight once and shares it through s_t / s_cost, and every lane then
    // reads the same K values in the same order, so the max and the sum
    // (and the bisection branch after them) stay uniform
    const float c0 = s_cost[0];
    float mean = 0.f;
    for (int k = 0; k < K; ++k) mean += s_cost[k];
    mean = mean / kf;
    float mad = 0.f;
    for (int k = 0; k < K; ++k) mad += fabsf(s_cost[k] - mean);
    const float scale = mad / kf + 1e-9f;
    const bool mem = lane < K;
    const float t = mem ? rs * (s_cost[lane] - c0) / scale : 0.f;
    if (mem) s_t[lane] = t;
    __syncwarp();  // logits in; every lane has read the costs
    float t_max = -INFINITY;
    for (int k = 0; k < K; ++k) t_max = fmaxf(t_max, s_t[k]);
    const float e = mem ? expf(t - t_max) : 0.f;
    if (mem) s_cost[lane] = e;
    __syncwarp();  // exponentials in; every lane has read the logits
    float denom = 0.f;
    for (int k = 0; k < K; ++k) denom += s_cost[k];
    if (mem) s_t[lane] = e / denom;
    __syncwarp();  // weights in

    const float eta0 = s_eta[lane];
    const float w0 = s_w[lane];
    float eta_acc = 0.f, w_acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wm = s_t[k];
      eta_acc += wm * (s_eta[k * 32 + lane] - eta0);
      w_acc += wm * (s_w[k * 32 + lane] - w0);
    }

    const float z = descend(d, step, lam, eta0 + eta_acc, pr, w0 + w_acc,
                            p_h, t24);
    d = project(z, lo_h, ub_h, ub_max, lo_min, on, proj_iters);
  }
  if (on) out[off] = d;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Device pointers to contiguous
// float32: wide operands (rows, H); member stacks (B, K, n, H) with
// B * n = rows; slim operands (rows, 1). Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).
extern "C" int pgd_epoch_ens_f32(const float* delta, const float* eta_e,
                                 const float* pi, const float* pow_e,
                                 const float* tau24, const float* price,
                                 const float* lo, const float* ub,
                                 const float* lr, const float* temp,
                                 const float* lambda_e, const float* risk_s,
                                 float* out, int rows, int H, int n, int K,
                                 int iters, int proj_iters, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (H < 1 || H > 32 || K < 1 || K > 32 || n < 1 || rows % n != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wpb = K <= 8 ? 8 : (K <= 16 ? 4 : 2);
  const size_t smem = static_cast<size_t>(wpb) * (3 * 32 * K + 64) *
                      sizeof(float);
  const int blocks = (rows + wpb - 1) / wpb;
  pgd_epoch_ens_kernel<<<blocks, wpb * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      delta, eta_e, pi, pow_e, tau24, price, lo, ub, lr, temp, lambda_e,
      risk_s, out, rows, H, n, K, iters, proj_iters, wpb);
  return static_cast<int>(cudaGetLastError());
}
