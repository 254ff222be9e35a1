// The joint spatio-temporal VCC step for Hopper (sm_90a), in two routes.
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
// and then, per rollout of n clusters, the fleet-coupled shift update of
// core.solver.joint_epochs (the reference runs it outside the kernel):
//
//   z      = s - lr_s * g_s                  (two roundings, as the plain
//                                             version: __fmul_rn, __fsub_rn)
//   s'     = clip(z - nu, lo_s, ub_s), nu by bisection on
//            sum_c clip(z - nu, lo_s, ub_s) = 0 from the bracket
//            [min z - max ub_s, max z - min lo_s]        (ref.project_row)
//
// Routes. The split route is the strict counterpart of joint_step_pallas:
// joint_step_kernel writes (d', g_s), and s_project_kernel (one block per
// rollout) then writes s': two launches a step. The fused route,
// joint_step_s_kernel, writes (d', s') in one launch: a thread-block cluster
// of C blocks per rollout, each block taking R = ceil(n / C) of its rows.
// A block runs the row step on its rows, keeps their g_s in its shared
// memory, and after cluster.sync() gathers the rollout's n values of g_s
// from the C blocks through distributed shared memory (map_shared_rank).
// Every block of the cluster then runs the same bisection on the same
// inputs in the same order, so all C find the same nu bit for bit, and
// each writes s' for its own rows. The second cluster.sync() follows the
// gather: after it no block reads another's shared memory, so any block
// may leave. The wrapper picks the route by n (kernel.joint_plan): the
// fused route needs the n clusters to fit C <= 8 (the portable cluster
// size) blocks of R <= 256 rows.
//
// Row step design: the row groups of pgd_common.cuh (kLanes = 4 lanes a
// row, 6 hours a lane at H = 24, 8 rows a warp, two shuffle stages a
// reduction; the bisection leaves once no bracket of the warp moves, the
// fixed count's bits). The feasibility test's "all hours" is a ballot read
// at the group's bits. The softmax divides by reciprocals. A group past
// the last row runs on zeros (ratio = temp = 1, so nothing divides by zero;
// tau_s = 0 makes its box {0}), takes part in every shuffle, stores nothing
// and adds 0 to g_s. The fused route's block has at most kMaxThreads
// threads, and a block of R rows on fewer groups than R runs its rows in
// passes. Reductions a row: sum ub, softmax max and sum, g_s, box max and
// min, bracket min and max, and one a bisection step; and one ballot.
//
// Shift update design: one warp (the block's first) bisects; lane l holds
// clusters l, l + 32, ... of z, lo_s and ub_s (the first kShiftRegs of
// them in registers, any others in shared memory), sums its own in four
// partial sums, then five butterfly stages; no block barrier sits in the
// loop, which leaves early as the row bisection does.
//
// What bounds it: neither bytes nor operations (the bound is 0.0035 ms at
// the slice path's 28 x 512, by its 11.6 MB), but latency: a row's chain
// of up to 58 dependent reductions, then the shift's chain of up to 50
// dependent warp sums on one warp a block, each a few hundred cycles. The
// fused route removes the split route's second launch, and the eager
// projection's hundreds of launches a step that it replaces.
//
// The choices below were made by tools/joint_probe.py (NVIDIA H100 80GB
// HBM3, 700 W; ms, CUDA events, median of 20, two alternating rounds, at
// 28 rollouts x 512 clusters, H = 24; every variant within its limits of
// the plain version, the early-exit-off and shared-memory builds bitwise
// the shipped one):
//
//   fused, C = 4 blocks of 128 rows (shipped)     0.0230 / 0.0230
//   fused, C = 2 of 256 (two passes of 128 rows)  0.0297 / 0.0296
//   fused, C = 8 of 64                            0.0235 / 0.0235
//   fused, C = 4, 8 lanes a row                   0.0253 / 0.0253
//   fused, C = 4, early exit off                  0.0268 / 0.0269
//   fused, C = 4, the shift in shared memory      0.0276 / 0.0276
//   split (two launches, shipped)                 0.0229 / 0.0229
//   split, 8 lanes a row                          0.0231 / 0.0231
//   split, early exit off                         0.0274 / 0.0274
//   split, the shift in shared memory             0.0286 / 0.0286
//   the split route's step alone                  0.0135 / 0.0135
//
// So C = 4 (kernel.BLOCK_ROWS = 128), 4 lanes a row, the early exit on,
// and a lane's first 16 clusters of the shift in registers. On the device
// the two routes take the same time at this shape; the fused route's gain
// is the host's: one wrapper call and one launch a step instead of two.
#include <cooperative_groups.h>

#include "pgd_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace vcc_pgd;

// the fused route's limits: threads a block (rows beyond run in passes),
// rows a block, blocks a cluster (the portable size) and clusters a
// rollout (kMaxClusterN = kMaxCluster * kMaxBlockRows, in shared memory)
constexpr int kMaxThreads = 512;
constexpr int kMaxBlockRows = 256;
constexpr int kMaxCluster = 8;
constexpr int kMaxClusterN = kMaxCluster * kMaxBlockRows;
// s_project: threads a block (they stage the rollout; one warp bisects),
// and the clusters of a rollout it takes (z, lo_s, ub_s in shared memory)
constexpr int kProjThreads = 256;
constexpr int kMaxProjectN = 16384;
// returned when no cluster of the requested shape fits the card
constexpr int kNoClusterFits = 10001;

struct JointArgs {
  const float *d, *s, *eta, *pi, *pow_nom, *tau, *u_if, *u_if_q, *ratio,
      *u_pow_cap, *capacity, *price, *lr_d, *temp, *lambda_e;
  float* d_out;
  int H;
  float drop, feas_thr;
  int proj_iters;
};

// The joint step of row `row` on lane j of its group (live = false: run on
// zeros, store nothing). Writes d' and returns the row's g_s, uniform
// across the group (0 where not live).
template <int NH>
__device__ __forceinline__ float joint_row(const JointArgs& a, int row,
                                           bool live, int j) {
  const size_t base = static_cast<size_t>(live ? row : 0) * a.H + j;
  const float sv = live ? a.s[row] : 0.f;
  const float tau_s = (live ? a.tau[row] : 0.f) + sv;
  const float upc = live ? a.u_pow_cap[row] : 0.f;
  const float cap = live ? a.capacity[row] : 0.f;
  const float pr = live ? a.price[row] : 0.f;
  const float step = live ? a.lr_d[row] : 0.f;
  const float rtmp = __frcp_rn(live ? a.temp[row] : 1.f);
  const float lam = live ? a.lambda_e[row] : 0.f;

  // the temporal box at the shifted budget
  const float t24 = fmaxf(tau_s / 24.f, 1e-9f);
  float d[NH], e[NH], p[NH], pn[NH], lo[NH], ub[NH];
  bool on[NH];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    on[i] = j + kLanes * i < a.H;
    const bool ld = live && on[i];
    const size_t off = base + kLanes * i;
    d[i] = ld ? a.d[off] : 0.f;
    e[i] = ld ? a.eta[off] : 0.f;
    p[i] = ld ? a.pi[off] : 0.f;
    pn[i] = ld ? a.pow_nom[off] : 0.f;
    const float ui = ld ? a.u_if[off] : 0.f;
    const float uq = ld ? a.u_if_q[off] : 0.f;
    const float r = ld ? a.ratio[off] : 1.f;
    float u = fminf((upc - uq) / t24 - 1.f, (cap / r - ui) / t24 - 1.f);
    u = fminf(fmaxf(u, -a.drop), 24.f);
    ub[i] = on[i] ? u : 0.f;
    ok = ok && (!on[i] || u > a.feas_thr);
  }
  const float ub_sum = group_reduce(ub, Add());
  const bool all_ok = group_all(ok);  // every lane votes: no short circuit
  const bool feas = ub_sum >= 0.f && tau_s > 1e-6f && all_ok;
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    lo[i] = feas && on[i] ? -a.drop : 0.f;
    ub[i] = feas ? ub[i] : 0.f;
  }

  // the gradient at the shifted point
  float w[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i)
    w[i] = __fadd_rn(pn[i], __fdiv_rn(__fmul_rn(p[i], __fmaf_rn(d[i], tau_s,
                                                                 sv)),
                                      24.f));
  softmax_weights(w, rtmp, on, w);
  const float tau24 = tau_s / 24.f;
  float gs[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const float gcoef =
        __fmul_rn(__fmaf_rn(lam, e[i], __fmul_rn(pr, w[i])), p[i]);
    gs[i] = __fmul_rn(gcoef, __fadd_rn(1.f, d[i]));
    d[i] = __fmaf_rn(-step, __fmul_rn(gcoef, tau24), d[i]);  // z; 0 masked
  }
  const float g_s = __fdiv_rn(group_reduce(gs, Add()), 24.f);

  float ub_max, lo_min;
  box_terms(lo, ub, on, ub_max, lo_min);
  project_rows(d, lo, ub, ub_max, lo_min, on, a.proj_iters);
#pragma unroll
  for (int i = 0; i < NH; ++i)
    if (live && on[i]) a.d_out[base + kLanes * i] = d[i];
  return live ? g_s : 0.f;
}

// Clusters of a rollout a lane keeps in registers for the shift's
// bisection (lane l: clusters l + 32 k, k < kShiftRegs, so all of them for
// n <= 32 kShiftRegs); the rest it reads from shared memory at every step.
// tools/joint_probe.py builds 0 (all in shared memory) with -D.
#ifndef JOINT_SHIFT_REGS
#define JOINT_SHIFT_REGS 16
#endif
constexpr int kShiftRegs = JOINT_SHIFT_REGS;
static_assert(kShiftRegs % 4 == 0, "JOINT_SHIFT_REGS: a multiple of 4");

// nu of the shift's projection, on one whole warp: z, lo and ub hold the
// rollout's n clusters (shared memory), lane l takes clusters l + 32 k.
// Cluster l + 32 k goes into the lane's partial sum k % 4 (four chains of
// dependent adds, and shorter sums to round), and the four are added
// pairwise; a cluster past n, held as z = lo = ub = 0, adds 0. The bracket
// and every step's f are the same bits on all lanes, so the loop's exit is
// uniform. width: the final bracket's b - a.
__device__ __forceinline__ float shift_nu(const float* z, const float* lo,
                                          const float* ub, int n,
                                          int proj_iters, float& width) {
  constexpr int kR = kShiftRegs > 0 ? kShiftRegs : 1;
  const int lane = threadIdx.x & 31;
  float zr[kR], lr[kR], ur[kR];
  float z_min = INFINITY, z_max = -INFINITY, ub_max = -INFINITY,
        lo_min = INFINITY;
#pragma unroll
  for (int k = 0; k < kShiftRegs; ++k) {
    const int c = lane + 32 * k;
    const bool on = c < n;
    zr[k] = on ? z[c] : 0.f;
    lr[k] = on ? lo[c] : 0.f;
    ur[k] = on ? ub[c] : 0.f;
    z_min = fminf(z_min, on ? zr[k] : INFINITY);
    z_max = fmaxf(z_max, on ? zr[k] : -INFINITY);
    ub_max = fmaxf(ub_max, on ? ur[k] : -INFINITY);
    lo_min = fminf(lo_min, on ? lr[k] : INFINITY);
  }
  const int rest = lane + 32 * kShiftRegs;
  for (int c = rest; c < n; c += 32) {
    z_min = fminf(z_min, z[c]);
    z_max = fmaxf(z_max, z[c]);
    ub_max = fmaxf(ub_max, ub[c]);
    lo_min = fminf(lo_min, lo[c]);
  }
  float a = warp_reduce(z_min, Min()) - warp_reduce(ub_max, Max());
  float b = warp_reduce(z_max, Max()) - warp_reduce(lo_min, Min());
  for (int k = 0; k < proj_iters; ++k) {
    const float m = 0.5f * (a + b);
    float f[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kShiftRegs; ++i)
      f[i % 4] += fminf(fmaxf(zr[i] - m, lr[i]), ur[i]);
    auto term = [&](int c) { return fminf(fmaxf(z[c] - m, lo[c]), ub[c]); };
    int c = rest;
    for (; c + 96 < n; c += 128) {
      f[0] += term(c);
      f[1] += term(c + 32);
      f[2] += term(c + 64);
      f[3] += term(c + 96);
    }
    if (c < n) f[0] += term(c);
    if (c + 32 < n) f[1] += term(c + 32);
    if (c + 64 < n) f[2] += term(c + 64);
    const float fs = warp_reduce((f[0] + f[1]) + (f[2] + f[3]), Add());
    const float a2 = fs > 0.f ? m : a;
    const float b2 = fs > 0.f ? b : m;
    const bool still = __float_as_uint(a2) == __float_as_uint(a) &&
                       __float_as_uint(b2) == __float_as_uint(b);
    a = a2;
    b = b2;
    if (kEarlyExit && still) break;
  }
  width = b - a;
  return 0.5f * (a + b);
}

// ------------------------------------------------------------ split route

template <int NH>
__global__ void __launch_bounds__(kBlockWarps * 32)
joint_step_kernel(const JointArgs a, float* __restrict__ gs_out, int rows) {
  const int j = threadIdx.x % kLanes;
  const int row = blockIdx.x * kBlockRows + threadIdx.x / kLanes;
  const bool live = row < rows;
  const float g_s = joint_row<NH>(a, row, live, j);
  if (live && j == 0) gs_out[row] = g_s;
}

struct ShiftArgs {
  const float *s, *g_s, *lr_s, *lo_s, *ub_s;
  float *s_out, *nu_out;  // nu_out: (nu, width) per block, or null
  int n, proj_iters;
};

// One block per rollout: stage z, lo_s and ub_s in shared memory, then the
// first warp bisects and writes s' for all n clusters.
__global__ void __launch_bounds__(kProjThreads)
s_project_kernel(const ShiftArgs a) {
  extern __shared__ float smem[];
  float* z = smem;
  float* lo = smem + a.n;
  float* ub = smem + 2 * a.n;
  const size_t base = static_cast<size_t>(blockIdx.x) * a.n;
  const float lr = a.lr_s[blockIdx.x];
  for (int c = threadIdx.x; c < a.n; c += blockDim.x) {
    z[c] = __fsub_rn(a.s[base + c], __fmul_rn(lr, a.g_s[base + c]));
    lo[c] = a.lo_s[base + c];
    ub[c] = a.ub_s[base + c];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  float width;
  const float nu = shift_nu(z, lo, ub, a.n, a.proj_iters, width);
  for (int c = threadIdx.x; c < a.n; c += 32)
    a.s_out[base + c] = fminf(fmaxf(z[c] - nu, lo[c]), ub[c]);
  if (a.nu_out != nullptr && threadIdx.x == 0) {
    a.nu_out[2 * blockIdx.x] = nu;
    a.nu_out[2 * blockIdx.x + 1] = width;
  }
}

// ------------------------------------------------------------ fused route

struct ClusterArgs {
  const float *lo_s, *ub_s, *lr_s;
  float *s_out, *nu_out;  // nu_out: (nu, width) per block, or null
  int n, C, R;            // clusters a rollout, blocks a cluster, rows a block
};

// Grid B x C, clusters of C blocks: block rank r of rollout b takes rows
// b n + r R + [0, R) (those below n).
template <int NH>
__global__ void __launch_bounds__(kMaxThreads)
joint_step_s_kernel(const JointArgs a, const ClusterArgs k) {
  __shared__ float gs_own[kMaxBlockRows];
  __shared__ float z[kMaxClusterN], lo[kMaxClusterN], ub[kMaxClusterN];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / k.C;
  const size_t base = static_cast<size_t>(b) * k.n;
  const int j = threadIdx.x % kLanes;
  const int groups = blockDim.x / kLanes;

  // 1-2. the row step on this block's rows; their g_s into shared memory
  for (int first = 0; first < k.R; first += groups) {
    const int local = first + static_cast<int>(threadIdx.x) / kLanes;
    const int c = rank * k.R + local;
    const bool live = local < k.R && c < k.n;
    const float g = joint_row<NH>(a, static_cast<int>(base) + c, live, j);
    if (local < k.R && j == 0) gs_own[local] = g;
  }
  // 3-5. every block's g_s, gathered in rank order, with s, lo_s and ub_s
  cluster.sync();
  const float lr = k.lr_s[b];
  for (int c = threadIdx.x; c < k.n; c += blockDim.x) {
    const float g = cluster.map_shared_rank(&gs_own[0], c / k.R)[c % k.R];
    z[c] = __fsub_rn(a.s[base + c], __fmul_rn(lr, g));
    lo[c] = k.lo_s[base + c];
    ub[c] = k.ub_s[base + c];
  }
  // no block reads another's shared memory after this
  cluster.sync();
  // 6-7. the shift's bisection, and s' of this block's rows
  if (threadIdx.x >= 32) return;
  float width;
  const float nu = shift_nu(z, lo, ub, k.n, a.proj_iters, width);
  const int c1 = min(k.n, (rank + 1) * k.R);
  for (int c = rank * k.R + static_cast<int>(threadIdx.x); c < c1; c += 32)
    k.s_out[base + c] = fminf(fmaxf(z[c] - nu, lo[c]), ub[c]);
  if (k.nu_out != nullptr && threadIdx.x == 0) {
    k.nu_out[2 * blockIdx.x] = nu;
    k.nu_out[2 * blockIdx.x + 1] = width;
  }
}

// Launch the instance of NH = nh hours a lane of the split route.
template <int NH>
int launch_split(int nh, const JointArgs& a, float* gs_out, int rows,
                 cudaStream_t stream) {
  if (nh == NH) {
    const int blocks = (rows + kBlockRows - 1) / kBlockRows;
    joint_step_kernel<NH><<<blocks, kBlockWarps * 32, 0, stream>>>(
        a, gs_out, rows);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (NH < kLastNH) {
    return launch_split<NH + 1>(nh, a, gs_out, rows, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch the instance of NH = nh hours a lane of the fused route: B
// clusters of C blocks. Checks once per shape that such a cluster fits the
// card (cudaOccupancyMaxActiveClusters > 0).
template <int NH>
int launch_fused(int nh, const JointArgs& a, const ClusterArgs& k, int B,
                 cudaStream_t stream) {
  if (nh == NH) {
    const int groups = min(k.R, kMaxThreads / kLanes);
    const int threads = (groups * kLanes + 31) / 32 * 32;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * k.C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static int fits[kMaxCluster + 1][kMaxThreads / 32 + 1] = {};
    int& known = fits[k.C][threads / 32];
    if (known == 0) {
      int clusters = 0;
      const cudaError_t err = cudaOccupancyMaxActiveClusters(
          &clusters, reinterpret_cast<const void*>(&joint_step_s_kernel<NH>),
          &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (clusters == 0) return kNoClusterFits;
      known = clusters;
    }
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, joint_step_s_kernel<NH>, a, k);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (NH < kLastNH) {
    return launch_fused<NH + 1>(nh, a, k, B, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Device pointers to contiguous
// float32: wide operands (rows, H), slim operands (rows, 1), per-rollout
// operands (B, 1) with rows = B n. `drop` is the problem's drop_limit and
// `feas_thr` the float32 value of -drop + 1e-9. Each launches on `stream`,
// allocates nothing, and returns cudaGetLastError() (0 = launched),
// cudaErrorInvalidValue (1) for a shape it does not take, or 10001 when no
// cluster of the requested shape fits the card.

// The split route's step: (d', g_s).
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
  const JointArgs a{d,        s,         eta,      pi,    pow_nom, tau,
                    u_if,     u_if_q,    ratio,    u_pow_cap,
                    capacity, price,     lr_d,     temp,  lambda_e,
                    d_out,    H,         drop,     feas_thr, proj_iters};
  return launch_split<kFirstNH>((H + kLanes - 1) / kLanes, a, gs_out, rows,
                                static_cast<cudaStream_t>(stream));
}

// The split route's shift update: s' of B rollouts of n clusters from s,
// g_s, lo_s and ub_s (rows, 1) and lr_s (B, 1); nu_out (B, 2) or null.
extern "C" int s_project_f32(const float* s, const float* g_s,
                             const float* lr_s, const float* lo_s,
                             const float* ub_s, float* s_out, float* nu_out,
                             int B, int n, int proj_iters, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 1 || n > kMaxProjectN)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = 3 * sizeof(float) * static_cast<size_t>(n);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        s_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const ShiftArgs a{s, g_s, lr_s, lo_s, ub_s, s_out, nu_out, n, proj_iters};
  s_project_kernel<<<B, kProjThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The fused route: (d', s') of B rollouts of n clusters in one launch, C
// blocks of R rows a rollout (C <= 8, R <= 256, C R >= n); nu_out
// (B C, 2) or null.
extern "C" int joint_step_s_f32(
    const float* d, const float* s, const float* eta, const float* pi,
    const float* pow_nom, const float* tau, const float* u_if,
    const float* u_if_q, const float* ratio, const float* u_pow_cap,
    const float* capacity, const float* price, const float* lr_d,
    const float* temp, const float* lambda_e, const float* lo_s,
    const float* ub_s, const float* lr_s, float* d_out, float* s_out,
    float* nu_out, int B, int n, int C, int R, int H, float drop,
    float feas_thr, int proj_iters, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (H < 1 || H > 32 || n < 1 || C < 1 || C > kMaxCluster || R < 1 ||
      R > kMaxBlockRows || C * R < n || n > kMaxClusterN)
    return static_cast<int>(cudaErrorInvalidValue);
  const JointArgs a{d,        s,         eta,      pi,    pow_nom, tau,
                    u_if,     u_if_q,    ratio,    u_pow_cap,
                    capacity, price,     lr_d,     temp,  lambda_e,
                    d_out,    H,         drop,     feas_thr, proj_iters};
  const ClusterArgs k{lo_s, ub_s, lr_s, s_out, nu_out, n, C, R};
  return launch_fused<kFirstNH>((H + kLanes - 1) / kLanes, a, k, B,
                                static_cast<cudaStream_t>(stream));
}
