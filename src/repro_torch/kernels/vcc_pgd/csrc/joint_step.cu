// One joint spatio-temporal VCC step for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/vcc_pgd/kernel.py:207
// joint_step_pallas (body _joint_kernel). Per cluster row of H <= 32 hours,
// at the shifted budget tau_s = tau + s:
//
//   t24    = max(tau_s / 24, 1e-9)
//   ub     = clip(min((u_pow_cap - u_if_q) / t24 - 1,
//                     (capacity / ratio - u_if) / t24 - 1), -drop, 24)
//   feas   = sum_h ub >= 0  and  tau_s > 1e-6  and  all_h ub > -drop + 1e-9
//   lo, ub = feas ? (-drop, ub) : (0, 0)          (core.vcc.delta_bounds)
//   pow    = pow_nom + pi * (d * tau_s + s) / 24
//   w      = softmax_h(pow / temp)
//   gcoef  = (lambda_e * eta + price * w) * pi
//   d'     = project(d - lr_d * gcoef * (tau_s / 24))   (as pgd_epoch.cu)
//   g_s    = sum_h gcoef * (1 + d) / 24
//
// One step per launch, as the reference: the shift s is projected onto the
// fleet-coupled {sum_c s = 0} ∩ [lo_s, ub_s] between launches, outside the
// kernel (core.solver.joint_epochs).
//
// Design: kernel #1's layout (one warp per row, hour h in lane h, lanes
// H..31 masked; pgd_common.cuh). Masked lanes load ratio = 1 so that no lane
// divides by zero. The feasibility test's "all hours" is a warp vote. Eight
// rows (warps) per block. Reductions a row: 2 (softmax) + 1 (sum ub) + 1
// (g_s) + 2 (box terms) + 52 (projection), and one vote.
#include "pgd_common.cuh"

namespace {

using namespace vcc_pgd;

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
joint_step_kernel(const float* __restrict__ d, const float* __restrict__ s,
                  const float* __restrict__ eta, const float* __restrict__ pi,
                  const float* __restrict__ pow_nom,
                  const float* __restrict__ tau, const float* __restrict__ u_if,
                  const float* __restrict__ u_if_q,
                  const float* __restrict__ ratio,
                  const float* __restrict__ u_pow_cap,
                  const float* __restrict__ capacity,
                  const float* __restrict__ price,
                  const float* __restrict__ lr_d,
                  const float* __restrict__ temp,
                  const float* __restrict__ lambda_e,
                  float* __restrict__ d_out, float* __restrict__ gs_out,
                  int rows, int H, float drop, float feas_thr,
                  int proj_iters) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const bool on = lane < H;
  const size_t off = static_cast<size_t>(row) * H + lane;

  const float dv = on ? d[off] : 0.f;
  const float e_h = on ? eta[off] : 0.f;
  const float p_h = on ? pi[off] : 0.f;
  const float pn_h = on ? pow_nom[off] : 0.f;
  const float ui_h = on ? u_if[off] : 0.f;
  const float uq_h = on ? u_if_q[off] : 0.f;
  const float r_h = on ? ratio[off] : 1.f;
  const float sv = s[row];
  const float tau_s = tau[row] + sv;
  const float upc = u_pow_cap[row];
  const float cap = capacity[row];
  const float pr = price[row];
  const float step = lr_d[row];
  const float tmp = temp[row];
  const float lam = lambda_e[row];

  // the temporal box at the shifted budget
  const float t24 = fmaxf(tau_s / 24.f, 1e-9f);
  float ub_h = fminf((upc - uq_h) / t24 - 1.f, (cap / r_h - ui_h) / t24 - 1.f);
  ub_h = fminf(fmaxf(ub_h, -drop), 24.f);
  const float ub_sum = warp_sum(on ? ub_h : 0.f);
  const bool above = __all_sync(kFull, !on || ub_h > feas_thr);
  const bool feas = ub_sum >= 0.f && tau_s > 1e-6f && above;
  const float lo_h = feas ? -drop : 0.f;
  ub_h = feas ? ub_h : 0.f;

  // gradient at the shifted point
  const float pw = pn_h + p_h * (dv * tau_s + sv) / 24.f;
  const float w = softmax_weight(pw, tmp, on);
  const float gcoef = (lam * e_h + pr * w) * p_h;
  const float g_d = gcoef * (tau_s / 24.f);
  const float g_s = warp_sum(on ? gcoef * (1.f + dv) : 0.f) / 24.f;

  const float ub_max = warp_max(on ? ub_h : -INFINITY);
  const float lo_min = warp_min(on ? lo_h : INFINITY);
  const float z = dv - step * g_d;
  const float dn = project(z, lo_h, ub_h, ub_max, lo_min, on, proj_iters);
  if (on) d_out[off] = dn;
  if (lane == 0) gs_out[row] = g_s;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Device pointers to contiguous
// float32: wide operands (rows, H), slim operands (rows, 1). `drop` is the
// problem's drop_limit and `feas_thr` the float32 value of -drop + 1e-9.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// (0 = launched).
extern "C" int joint_step_f32(const float* d, const float* s, const float* eta,
                              const float* pi, const float* pow_nom,
                              const float* tau, const float* u_if,
                              const float* u_if_q, const float* ratio,
                              const float* u_pow_cap, const float* capacity,
                              const float* price, const float* lr_d,
                              const float* temp, const float* lambda_e,
                              float* d_out, float* gs_out, int rows, int H,
                              float drop, float feas_thr, int proj_iters,
                              void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  if (H < 1 || H > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  joint_step_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      d, s, eta, pi, pow_nom, tau, u_if, u_if_q, ratio, u_pow_cap, capacity,
      price, lr_d, temp, lambda_e, d_out, gs_out, rows, H, drop, feas_thr,
      proj_iters);
  return static_cast<int>(cudaGetLastError());
}
