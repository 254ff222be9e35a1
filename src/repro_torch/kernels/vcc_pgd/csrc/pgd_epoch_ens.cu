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
// Design: kernel #1's row-group layout (pgd_common.cuh; kLanes lanes a
// row, ceil(H / kLanes) hours a lane, 32 / kLanes rows a warp, tail groups
// on zeros). Where a lane keeps its hours of the member stacks:
//
// * K <= 8: the K members of eta and pow_nom, and the K member scalars, in
//   registers (2 K NH + K floats, the member loops unrolled 8 times); the
//   step's K softmax rows in the lane's own slots of shared memory (K NH
//   floats: in registers they would cost another K NH a thread, and
//   occupancy with them). ptxas gives the H = 24 instance 254 registers,
//   no spills: 8 warps an SM;
// * 8 < K <= 32: all of it in the lane's own slots (3 K NH + K floats; up to
//   102 KB a warp at K = 32, H = 32, so two warps a block fit the SM's
//   227 KB at kLanes >= 4 only).
//
// The member softmaxes run 8 (K <= 8) or 4 members a pass with their
// reductions interleaved stage by stage (softmax_weights_many): one member
// at a time, each of its four reductions waited on two shuffles in turn,
// and the step was a chain of 32 of them. The divisions of the softmax and
// of the member weights are multiplies by a reciprocal: as IEEE divisions
// they were calls with a slow path and took most of the kernel's
// instructions (cuobjdump; 1.86 -> 1.19 ms at the slice path's shape).
//
// A lane's slots are 32 floats apart and no other lane touches them, so
// they are free of bank conflicts and need no barrier. The member weights
// (mean, deviation, logits, softmax over K) are a scalar loop that every
// lane of a group runs alike on the group's reduced costs, so the inputs of
// the bisection stay the same bits on every lane of the group.
//
// #2 calls the group primitives of #1 (softmax_weights, project_rows,
// box_terms) in #1's order and the explicit-FMA step expressions (power_at,
// descend): with K identical members every anchored deviation is exactly
// 0, and the epoch gives #1's bits.
//
// Operand layout: the member stacks are read where they lie, (B, K, n, H)
// contiguous with rows = B * n (B = 1 for a (K, rows, H) stack): member k of
// row r = b * n + c is at ((b * K + k) * n + c) * H. The dispatcher does not
// copy them per launch.
//
// Reductions a row and step: 4 K (softmax max and sum, two cost sums per
// member) + 52 (the projection, fewer with the early exit); 2 more once an
// epoch; each log2(kLanes) shuffle stages. At kLanes = 4 and K = 8, 21
// warp shuffles a row and step, where the warp-per-row design issued 420.
#include "pgd_common.cuh"

namespace {

using namespace vcc_pgd;

constexpr int kRegMembers = 8;  // K <= 8: eta and pow_nom in registers

struct EnsArgs {
  const float *delta, *eta_e, *pi, *pow_e, *tau24, *price, *lo, *ub, *lr,
      *temp, *lambda_e, *risk_s;
  float* out;
  int rows, H, n, K, iters, proj_iters;
};

// A lane's stack of per-member values, NH hours each: KR > 0 holds up to KR
// members in registers (member loops unrolled KR times, so every index is
// a constant), KR == 0 any K in the lane's own shared-memory slots.
template <int NH, int KR>
struct Stack {
  float v[KR][NH];
  __device__ __forceinline__ explicit Stack(float*) {}
  __device__ __forceinline__ float& operator()(int k, int i) {
    return v[k][i];
  }
};

template <int NH>
struct Stack<NH, 0> {
  float* p;  // this lane's first slot
  __device__ __forceinline__ explicit Stack(float* slots) : p(slots) {}
  __device__ __forceinline__ float& operator()(int k, int i) {
    return p[(k * NH + i) * 32];
  }
};

// Shared-memory slots a lane takes: the step's softmax rows (K NH), and
// with KR == 0 also the member stacks of eta and pow_nom (2 K NH) and the
// member scalars (K).
__host__ __device__ constexpr int lane_slots(int K, int NH, int KR) {
  return KR > 0 ? K * NH : 3 * K * NH + K;
}

template <int NH, int KR>
__global__ void __launch_bounds__(kBlockWarps * 32)
pgd_epoch_ens_kernel(const EnsArgs a) {
  extern __shared__ float smem[];
  constexpr int kUnroll = KR > 0 ? KR : 1;
  // members a pass of the softmax: all KR of them from registers, else 4
  constexpr int kMemberBatch = KR > 0 ? KR : 4;
  constexpr int kChunkUnroll = KR > 0 ? 2 : 1;  // one pass, or a loop
  const int K = a.K;
  const int kEnd = KR > 0 ? KR : K;   // member loops: k < kEnd and k < K
  const int lane = threadIdx.x & 31;
  const int j = threadIdx.x % kLanes;
  const int row = blockIdx.x * kBlockRows + threadIdx.x / kLanes;
  const bool live = row < a.rows;
  const size_t base = static_cast<size_t>(live ? row : 0) * a.H + j;

  float* slots = smem + (threadIdx.x >> 5) * 32 * lane_slots(K, NH, KR) +
                 lane;
  Stack<NH, 0> w(slots);
  Stack<NH, KR> eta_k(slots + 32 * K * NH);
  Stack<NH, KR> pow_k(slots + 64 * K * NH);
  Stack<1, KR> c(slots + 96 * K * NH);  // member costs, logits, exps

  float d[NH], p[NH], lo[NH], ub[NH];
  bool on[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    on[i] = j + kLanes * i < a.H;
    const bool ld = live && on[i];
    const size_t off = base + kLanes * i;
    d[i] = ld ? a.delta[off] : 0.f;
    p[i] = ld ? a.pi[off] : 0.f;
    lo[i] = ld ? a.lo[off] : 0.f;
    ub[i] = ld ? a.ub[off] : 0.f;
  }
  const size_t rb = live ? row / a.n : 0;
  const size_t rc = live ? row % a.n : 0;
#pragma unroll (kUnroll)
  for (int k = 0; k < kEnd; ++k) {
    if (k < K) {
      const size_t m = ((rb * K + k) * a.n + rc) * a.H + j;
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const bool ld = live && on[i];
        eta_k(k, i) = ld ? a.eta_e[m + kLanes * i] : 0.f;
        pow_k(k, i) = ld ? a.pow_e[m + kLanes * i] : 0.f;
      }
    }
  }
  const float t24 = live ? a.tau24[row] : 0.f;
  const float pr = live ? a.price[row] : 0.f;
  const float step = live ? a.lr[row] : 0.f;
  const float rtmp = __frcp_rn(live ? a.temp[row] : 1.f);
  const float lam = live ? a.lambda_e[row] : 0.f;
  const float rs = live ? a.risk_s[row] : 0.f;
  const float rk = __frcp_rn(static_cast<float>(K));

  float ub_max, lo_min;
  box_terms(lo, ub, on, ub_max, lo_min);

  for (int it = 0; it < a.iters; ++it) {
    float pi_d[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) pi_d[i] = __fmul_rn(p[i], d[i]);
    // each member's softmax row and cost, kMemberBatch members at a time
    // with their reductions interleaved (all K <= 8 in one pass); masked
    // hours hold eta = pow = 0 and w = 0, so they add 0 to the cost sums
    // without a select
#pragma unroll (kChunkUnroll)
    for (int k0 = 0; k0 < kEnd; k0 += kMemberBatch) {
      float x[kMemberBatch][NH], ce[kMemberBatch], cw[kMemberBatch];
#pragma unroll
      for (int kk = 0; kk < kMemberBatch; ++kk) {
        const bool mk = k0 + kk < K;
        float t[NH];
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          x[kk][i] = power_at(mk ? pow_k(k0 + kk, i) : 0.f, pi_d[i], t24);
          t[i] = (mk ? eta_k(k0 + kk, i) : 0.f) * x[kk][i];
        }
        ce[kk] = tree<0, NH>(t, Add());
      }
      softmax_weights_many(x, rtmp, on);
#pragma unroll
      for (int kk = 0; kk < kMemberBatch; ++kk) {
        const bool mk = k0 + kk < K;
        float t[NH];
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          const float ph =
              power_at(mk ? pow_k(k0 + kk, i) : 0.f, pi_d[i], t24);
          t[i] = x[kk][i] * ph;
          if (mk) w(k0 + kk, i) = x[kk][i];
        }
        cw[kk] = tree<0, NH>(t, Add());
      }
      group_finish_many(ce, Add());
      group_finish_many(cw, Add());
#pragma unroll
      for (int kk = 0; kk < kMemberBatch; ++kk)
        if (k0 + kk < K) c(k0 + kk, 0) = lam * ce[kk] + pr * cw[kk];
    }

    // member weights, on every lane alike: mean and deviation of the
    // costs, the logits (over c, then their exponentials over c)
    const float c0 = c(0, 0);
    float mean = 0.f;
#pragma unroll (kUnroll)
    for (int k = 0; k < kEnd; ++k)
      if (k < K) mean += c(k, 0);
    mean = mean * rk;
    float mad = 0.f;
#pragma unroll (kUnroll)
    for (int k = 0; k < kEnd; ++k)
      if (k < K) mad += fabsf(c(k, 0) - mean);
    const float rscale = __frcp_rn(mad * rk + 1e-9f);
    float t_max = -INFINITY;
#pragma unroll (kUnroll)
    for (int k = 0; k < kEnd; ++k) {
      if (k < K) {
        const float t = rs * (c(k, 0) - c0) * rscale;
        c(k, 0) = t;
        t_max = fmaxf(t_max, t);
      }
    }
    float denom = 0.f;
#pragma unroll (kUnroll)
    for (int k = 0; k < kEnd; ++k) {
      if (k < K) {
        const float ex = expf(c(k, 0) - t_max);
        c(k, 0) = ex;
        denom += ex;
      }
    }

    const float rden = __frcp_rn(denom);
    // the anchored member sums, member by member
    float eta_acc[NH], w_acc[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) eta_acc[i] = w_acc[i] = 0.f;
#pragma unroll (kUnroll)
    for (int k = 0; k < kEnd; ++k) {
      if (k < K) {
        const float wm = c(k, 0) * rden;
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          eta_acc[i] += wm * (eta_k(k, i) - eta_k(0, i));
          w_acc[i] += wm * (w(k, i) - w(0, i));
        }
      }
    }

#pragma unroll
    for (int i = 0; i < NH; ++i)
      d[i] = descend(d[i], step, lam, eta_k(0, i) + eta_acc[i], pr,
                     w(0, i) + w_acc[i], p[i], t24);
    project_rows(d, lo, ub, ub_max, lo_min, on, a.proj_iters);
  }
#pragma unroll
  for (int i = 0; i < NH; ++i)
    if (live && on[i]) a.out[base + kLanes * i] = d[i];
}

template <int NH, int KR>
int launch_members(const EnsArgs& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kBlockWarps) * 32 *
                      lane_slots(a.K, NH, KR) * sizeof(float);
  // above 48 KB only once allowed (up to 227 KB: K = 32 at H = 32 takes
  // 205 KB at kLanes = 4)
  const cudaError_t err = cudaFuncSetAttribute(
      pgd_epoch_ens_kernel<NH, KR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.rows + kBlockRows - 1) / kBlockRows;
  pgd_epoch_ens_kernel<NH, KR><<<blocks, kBlockWarps * 32, smem, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// Launch the instance of NH = nh hours a lane, members in registers or in
// shared memory by K.
template <int NH>
int launch(int nh, const EnsArgs& a, cudaStream_t stream) {
  if (nh == NH) {
    return a.K <= kRegMembers ? launch_members<NH, kRegMembers>(a, stream)
                              : launch_members<NH, 0>(a, stream);
  }
  if constexpr (NH < kLastNH) {
    return launch<NH + 1>(nh, a, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const EnsArgs a{delta, eta_e, pi,    pow_e,   tau24, price, lo,
                  ub,    lr,    temp,  lambda_e, risk_s, out, rows,
                  H,     n,     K,     iters,   proj_iters};
  return launch<kFirstNH>((H + kLanes - 1) / kLanes, a,
                          static_cast<cudaStream_t>(stream));
}
