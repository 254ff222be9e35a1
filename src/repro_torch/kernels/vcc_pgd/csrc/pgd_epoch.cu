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
// Design: the row-group layout of pgd_common.cuh. A row goes to a group of
// kLanes lanes (4), each lane keeping ceil(H / kLanes) of its hours (6 at
// H = 24) of delta, eta, pi, pow_nom, lo and ub in registers for the whole
// epoch; a warp holds 32 / kLanes rows (8). A reduction runs over the
// lane's hours in registers, then log2(kLanes) shuffle stages (2). The
// row's five scalars are read once, so the epoch reads every input once
// and writes delta once, as the TPU kernel does in VMEM. A warp's last
// groups may lie past `rows`: they run along on zeros (lo = ub = 0, temp =
// 1), take part in every shuffle and store nothing. Two warps a block, so
// the last wave of blocks is short.
//
// What bounded the first design (one warp a row, hour h in lane h, lanes
// 24..31 idle): its shuffles. Each reduction was a five-stage butterfly,
// 270 warp shuffles a row and step (54 reductions, 50 in the bisection),
// and an SM issues one shuffle a clock: a floor of 1.86 ms at the main
// path's 22,528 rows, where it took 2.2461 ms (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md). In groups of 4 a row and step costs 54 x 2 / 8 =
// 13.5 shuffles (a floor of 0.093 ms). What bounds it now is the
// bisection: per step and warp about 41 instructions (the subtract, max
// and min of 6 hours, a 5-add tree, 2 shuffles, the midpoint, compare,
// selects and the exit vote; cuobjdump of the NH = 6 instance) on a
// dependent chain through two shuffles and a vote, 21 warps an SM. The
// early exit leaves after ~31.5 of the 50 steps a warp (a float32 replay of
// the bisection on the CPU). The two divisions an hour of the softmax are
// multiplies by a reciprocal (pgd_common.cuh).
//
// kLanes = 4 and the early exit were chosen by tools/pgd_probe.py (NVIDIA
// H100 80GB HBM3, 700 W; ms, CUDA events, median of 20):
//
//   L, early exit     #1, 22,528 rows   #1, 14,336 rows   #2, 14,336, K = 8
//   1 off / on        0.6831 / 0.5593   0.4317 / 0.3723   5.6093 / 5.4417
//   2 off / on        0.5301 / 0.4537   0.3945 / 0.3327   1.5321 / 1.4126
//   4 off / on        0.6256 / 0.5281   0.4451 / 0.3761   1.2530 / 1.1879
//   8 off / on        0.7916 / 0.6788   0.5239 / 0.4602   1.6103 / 1.4650
//
// L = 2 is the fastest #1 (14% less time at the main path's rows), but #2,
// whose K member stacks then take twice the registers a lane, loses more
// there than #1 gains (a day of the slice path runs 20 of each); #1 and #2
// must share L to keep identical members bitwise. So L = 4, early exit on.
#include "pgd_common.cuh"

namespace {

using namespace vcc_pgd;

struct EpochArgs {
  const float *delta, *eta, *pi, *pow_nom, *tau24, *price, *lo, *ub, *lr,
      *temp, *lambda_e;
  float* out;
  int rows, H, iters, proj_iters;
};

template <int NH>
__global__ void __launch_bounds__(kBlockWarps * 32)
pgd_epoch_kernel(const EpochArgs a) {
  const int j = threadIdx.x % kLanes;
  const int row = blockIdx.x * kBlockRows + threadIdx.x / kLanes;
  const bool live = row < a.rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * a.H + j;

  float d[NH], e[NH], p[NH], pn[NH], lo[NH], ub[NH];
  bool on[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    on[i] = j + kLanes * i < a.H;
    const bool ld = live && on[i];
    const size_t off = base + kLanes * i;
    d[i] = ld ? a.delta[off] : 0.f;
    e[i] = ld ? a.eta[off] : 0.f;
    p[i] = ld ? a.pi[off] : 0.f;
    pn[i] = ld ? a.pow_nom[off] : 0.f;
    lo[i] = ld ? a.lo[off] : 0.f;
    ub[i] = ld ? a.ub[off] : 0.f;
  }
  const float t24 = live ? a.tau24[row] : 0.f;
  const float pr = live ? a.price[row] : 0.f;
  const float step = live ? a.lr[row] : 0.f;
  const float rtmp = __frcp_rn(live ? a.temp[row] : 1.f);
  const float lam = live ? a.lambda_e[row] : 0.f;

  float ub_max, lo_min;
  box_terms(lo, ub, on, ub_max, lo_min);

  for (int it = 0; it < a.iters; ++it) {
    float pw[NH], w[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i)
      pw[i] = power_at(pn[i], __fmul_rn(p[i], d[i]), t24);
    softmax_weights(pw, rtmp, on, w);
#pragma unroll
    for (int i = 0; i < NH; ++i)
      d[i] = descend(d[i], step, lam, e[i], pr, w[i], p[i], t24);
    project_rows(d, lo, ub, ub_max, lo_min, on, a.proj_iters);
  }
#pragma unroll
  for (int i = 0; i < NH; ++i)
    if (live && on[i]) a.out[base + kLanes * i] = d[i];
}

// Launch the instance of NH = nh hours a lane.
template <int NH>
int launch(int nh, const EpochArgs& a, cudaStream_t stream) {
  if (nh == NH) {
    const int blocks = (a.rows + kBlockRows - 1) / kBlockRows;
    pgd_epoch_kernel<NH><<<blocks, kBlockWarps * 32, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (NH < kLastNH) {
    return launch<NH + 1>(nh, a, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const EpochArgs a{delta, eta, pi, pow_nom, tau24, price, lo, ub, lr, temp,
                    lambda_e, out, rows, H, iters, proj_iters};
  return launch<kFirstNH>((H + kLanes - 1) / kLanes, a,
                          static_cast<cudaStream_t>(stream));
}
