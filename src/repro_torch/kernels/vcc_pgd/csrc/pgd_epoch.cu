// Fused VCC projected-gradient epoch for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/vcc_pgd/kernel.py:122
// pgd_epoch_pallas (body _pgd_kernel, projection _project_rows). One epoch
// runs `iters` steps of, per cluster row of H <= 32 hours:
//
//   pow  = pow_nom + pi * d * tau24
//   w    = softmax_h(pow / temp)
//   grad = (lambda_e * eta + price * w) * pi * tau24
//   z    = d - lr * grad
//   d    = clip(z - nu, lo, ub), nu by exactly `proj_iters` bisection steps
//          on sum_h clip(z - nu, lo, ub) = 0 from the bracket
//          [min z - max ub, max z - min lo]
//
// Design: one warp per row, hour h in lane h; lanes H..31 are masked (see
// pgd_common.cuh, which holds the reductions, the softmax and the
// projection). Each lane keeps its delta, eta, pi, pow_nom, lo and ub in
// registers for the whole epoch and the row's five scalars are read once,
// so the epoch reads every input once and writes delta once, as the TPU
// kernel does in VMEM.
//
// What bounds it: not bytes (the epoch moves 4 * (7H + 5) bytes a row) and
// not its FP32 operations (about 5,400 a row and step at H = 24), but the
// warp shuffles of its reductions: 270 a row and step (54 five-stage
// butterflies, 50 of them in the bisection), and an SM issues one warp
// shuffle a clock. PERF.md holds the measured times beside these floors.
// Eight rows (warps) per block; ceil(rows / 8) blocks.
#include "pgd_common.cuh"

namespace {

using namespace vcc_pgd;

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pgd_epoch_kernel(const float* __restrict__ delta, const float* __restrict__ eta,
                 const float* __restrict__ pi, const float* __restrict__ pow_nom,
                 const float* __restrict__ tau24, const float* __restrict__ price,
                 const float* __restrict__ lo, const float* __restrict__ ub,
                 const float* __restrict__ lr, const float* __restrict__ temp,
                 const float* __restrict__ lambda_e, float* __restrict__ out,
                 int rows, int H, int iters, int proj_iters) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const bool on = lane < H;
  const size_t off = static_cast<size_t>(row) * H + lane;

  float d = on ? delta[off] : 0.f;
  const float e_h = on ? eta[off] : 0.f;
  const float p_h = on ? pi[off] : 0.f;
  const float pn_h = on ? pow_nom[off] : 0.f;
  const float lo_h = on ? lo[off] : 0.f;
  const float ub_h = on ? ub[off] : 0.f;
  const float t24 = tau24[row];
  const float pr = price[row];
  const float step = lr[row];
  const float tmp = temp[row];
  const float lam = lambda_e[row];

  // the box is fixed for the epoch: its bracket terms are reduced once
  const float ub_max = warp_max(on ? ub_h : -INFINITY);
  const float lo_min = warp_min(on ? lo_h : INFINITY);

  for (int it = 0; it < iters; ++it) {
    const float pw = power_at(pn_h, __fmul_rn(p_h, d), t24);
    const float w = softmax_weight(pw, tmp, on);
    const float z = descend(d, step, lam, e_h, pr, w, p_h, t24);
    d = project(z, lo_h, ub_h, ub_max, lo_min, on, proj_iters);
  }
  if (on) out[off] = d;
}

}  // namespace

// Plain C entry point (loaded with ctypes). All pointers are device
// pointers to contiguous float32: wide operands (rows, H), slim operands
// (rows, 1). Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 = launched).
extern "C" int pgd_epoch_f32(const float* delta, const float* eta,
                             const float* pi, const float* pow_nom,
                             const float* tau24, const float* price,
                             const float* lo, const float* ub, const float* lr,
                             const float* temp, const float* lambda_e,
                             float* out, int rows, int H, int iters,
                             int proj_iters, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (H < 1 || H > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  pgd_epoch_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      delta, eta, pi, pow_nom, tau24, price, lo, ub, lr, temp, lambda_e, out,
      rows, H, iters, proj_iters);
  return static_cast<int>(cudaGetLastError());
}
