// Flash attention for Hopper (sm_90a), the decode route (Sq <= 16, bf16 or
// float32): split-KV partials, then a combine.
//
// Replaces, with flash_prefill.cu and flash_attention.cu, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py, flash_attention (body
// _flash_kernel), for the calls a decode step makes: a few query rows at a
// runtime position q_offset over a KV cache filled to a runtime length.
//
// What bounds it on this card: bytes. A decode call reads every cached key
// and value it attends once (Zamba2-7B, batch 4: ~60 MB, 18 us at 3.35
// TB/s) and does 4 H flops per key and query row.
//
// What the design does about it:
// - Enough blocks in flight. The attended keys [k_begin, k_end) are cut
//   into `splits` chunks (the wrapper picks `splits`), and the grid holds
//   one block per (batch, KV head, group of query rows, split), all on the
//   grid's x axis.
// - Each key read once per KV head. A block's rows are the G = N / K query
//   heads that share its KV head, times Sq, in groups of up to RB = 4.
// - Many loads in flight. A key row of H elements lies on LPK lanes, each
//   with E consecutive elements; a lane group takes U = 2 keys a step, and
//   each lane copies its pieces of the next S - 1 = 3 steps' keys and
//   values into its own slots of a shared-memory ring with cp.async
//   (16-byte pieces, bypassing L1, where base and strides allow; element
//   loads otherwise). A lane reads back only what it copied, so the ring
//   needs no barrier. (Loads into registers under a bounds branch were
//   waited on one after another, which left the first design at 2.4x
//   this one's time at Zamba2's decode; PERF.md.)
// - A dot product is reduced over the key's lanes by shuffles. Each lane
//   group keeps its own online-softmax state (m, l, acc) in float32
//   registers; the groups merge by shuffles and the warps through shared
//   memory once, at the end, and the block writes float32 partials
//   (acc[H], m, l) per row and split.
// - The combine kernel writes, with m = max_s m_s,
//   sum_s e^(m_s - m) acc_s / max(sum_s e^(m_s - m) l_s, 1e-30) in q's type
//   (in one pass over the splits, rescaling as the running max grows).
// Masked scores take the reference's finite -1e30 (only a lane slot past
// its split's end takes -inf, which never wins a max over m >= -1e30); a
// split with no key in range leaves m = -1e30, l = 0, acc = 0, which gets
// weight 0 beside any split with a key and gives no NaN.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NW = 4;           // warps per block
constexpr int NT = 32 * NW;     // threads per block
constexpr int U = 2;            // keys a lane group takes a step
constexpr int S = 4;            // ring stages: S - 1 steps in flight
constexpr int MAX_SPLITS = 64;  // as the wrapper's limit

// Stage a lane's CH 16-byte pieces of one key row, row[col0, col0 + E),
// into its ring slots `dst` (NT apart): by cp.async where `vec`, else by
// element loads; zeros where !ok or past H. Each lane later reads back only
// what it staged itself, so no barrier is needed between the two.
template <typename T, int CH>
__device__ __forceinline__ void stage_row(uint4* dst, const T* row, int col0,
                                          int H, bool vec, bool ok) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = col0 + j * VEC;
    if (vec) {
      const bool in = ok && c < H;
      cp_async16(dst + j * NT, row + (in ? c : 0), in ? 16 : 0);
    } else {
      __align__(16) T x[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        x[i] = ok && c + i < H ? row[c + i] : from_f<T>(0.f);
      dst[j * NT] = *reinterpret_cast<const uint4*>(x);
    }
  }
}

template <typename T, int CH>
__device__ __forceinline__ void unpack(const uint4* src,
                                       float (&x)[CH * 16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const uint4 raw = src[j * NT];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[j * VEC + i] = to_f(e[i]);
  }
}

// How a lane group holds a key row of HP elements of type T: LPK lanes,
// each with E consecutive elements in CH 16-byte pieces; KPW groups a warp.
template <typename T, int HP>
struct Lanes {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int LPK = HP / VEC < 32 ? HP / VEC : 32;
  static constexpr int E = HP / LPK;
  static constexpr int CH = E / VEC;
  static constexpr int KPW = 32 / LPK;
  static constexpr int RING_BYTES = S * U * 2 * CH * NT * 16;
};

// One block: RB query rows of one (batch, KV head) over one split of keys.
template <typename T, int HP, int RB>
__global__ void __launch_bounds__(NT)
flash_decode_split_kernel(const Args a, float* __restrict__ part,
                          int splits, int vec) {
  using L = Lanes<T, HP>;
  constexpr int LPK = L::LPK, E = L::E, CH = L::CH, KPW = L::KPW;
  constexpr int STEP = NW * KPW * U;                    // keys a block step
  extern __shared__ uint4 ring[];                       // [S][U][2][CH][NT]
  __shared__ float sm_acc[NW][RB][HP];
  __shared__ float sm_m[NW][RB], sm_l[NW][RB];

  const int G = a.N / a.K, R = G * a.Sq, groups = (R + RB - 1) / RB;
  int bx = blockIdx.x;
  const int split = bx % splits;
  bx /= splits;
  const int rg = bx % groups;
  bx /= groups;
  const int kh = bx % a.K, b = bx / a.K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = lane / LPK, col0 = (lane % LPK) * E;

  // this split's keys
  int k_begin, k_end;
  key_span(a, a.q_offset, a.q_offset + a.Sq - 1, &k_begin, &k_end);
  const int n_keys = max(0, k_end - k_begin);
  const int chunk = (n_keys + splits - 1) / splits;
  const int s0 = min(k_begin + split * chunk, k_end);
  const int s1 = min(s0 + chunk, k_end);
  const int n_steps = (s1 - s0 + STEP - 1) / STEP;

  // rows r = qi * G + gi, query head n = kh * G + gi
  int qpos[RB];
  float qf[RB][E];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int r = rg * RB + i, qi = min(r, R - 1) / G;
    const int n = kh * G + min(r, R - 1) % G;
    qpos[i] = a.q_offset + qi;
    const T* qrow = static_cast<const T*>(a.q) + b * a.sq[0] +
                    qi * a.sq[1] + n * a.sq[2];
#pragma unroll
    for (int e = 0; e < E; ++e)
      qf[i][e] = r < R && col0 + e < a.H ? to_f(qrow[col0 + e]) : 0.f;
  }
  float m[RB], l[RB], acc[RB][E];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  // S - 1 steps of keys in flight per lane group, in a ring of S stages
  const T* kbase = static_cast<const T*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const T* vbase = static_cast<const T*>(a.v) + b * a.sv[0] + kh * a.sv[2];
  uint4* mine = ring + threadIdx.x;
  auto stage = [&](int step) {
    if (step < n_steps) {
      const int k0 = s0 + step * STEP + (warp * KPW + slot) * U;
      uint4* dst = mine + (step % S) * U * 2 * CH * NT;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = k0 + u < s1;
        const long long kp = ok ? k0 + u : s0;
        stage_row<T, CH>(dst + (2 * u) * CH * NT, kbase + kp * a.sk[1], col0,
                         a.H, vec, ok);
        stage_row<T, CH>(dst + (2 * u + 1) * CH * NT, vbase + kp * a.sv[1],
                         col0, a.H, vec, ok);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int step = 0; step < S - 1; ++step) stage(step);
  for (int step = 0; step < n_steps; ++step) {
    stage(step + S - 1);
    cp_wait<S - 1>();
    const int k0 = s0 + step * STEP + (warp * KPW + slot) * U;
    const uint4* src = mine + (step % S) * U * 2 * CH * NT;
    float kf[U][E], vf[U][E];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      unpack<T, CH>(src + (2 * u) * CH * NT, kf[u]);
      unpack<T, CH>(src + (2 * u + 1) * CH * NT, vf[u]);
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[i][e], kf[u][e], d);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        float x = d * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const int kpos = k0 + u;
        // a slot past the split takes no part; a masked key takes -1e30
        s[u] = kpos >= s1 ? __int_as_float(0xff800000)  // -inf
                          : (attends(a, qpos[i], kpos) ? x : NEG_INF);
      }
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u]);
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      float p[U], sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = expf(s[u] - mx);
        sum += p[u];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float o = acc[i][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) o = fmaf(p[u], vf[u][e], o);
        acc[i][e] = o;
      }
    }
  }
  cp_wait<0>();

  // merge the warp's lane groups, then the warps
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      const float wa = expf(m[i] - mn), wb = expf(mo - mn);
      l[i] = l[i] * wa + lo * wb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[i][e], off);
        acc[i][e] = acc[i][e] * wa + ao * wb;
      }
      m[i] = mn;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][i][col0 + e] = acc[i][e];
      if (lane == 0) {
        sm_m[warp][i] = m[i];
        sm_l[warp][i] = l[i];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < RB * HP; t += NT) {
    const int i = t / HP, c = t % HP, r = rg * RB + i;
    if (r >= R || c >= a.H) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][i]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = expf(sm_m[w][i] - mx);
      A = fmaf(wt, sm_acc[w][i][c], A);
      L = fmaf(wt, sm_l[w][i], L);
    }
    const int qi = r / G, n = kh * G + r % G;
    float* rec = part + ((((long long)split * a.B + b) * a.Sq + qi) * a.N + n) *
                            (a.H + 2);
    rec[c] = A;
    if (c == 0) {
      rec[a.H] = mx;
      rec[a.H + 1] = L;
    }
  }
}

// One warp per output row: the log-sum-exp merge of the row's partials,
// in one pass over the splits (a running max, with earlier sums rescaled
// when it grows), so that the loads of UNROLL splits are in flight at once.
// Lane j holds columns j, j + 32, ... (HP / 32 of them).
template <typename T, int HP>
__global__ void __launch_bounds__(NT)
flash_decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                            int rows, int H, int splits) {
  constexpr int C = HP / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * NW + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long rec = (long long)rows * (H + 2);
  const float* p = part + (long long)row * (H + 2);
  float M = NEG_INF, L = 0.f, A[C];
#pragma unroll
  for (int j = 0; j < C; ++j) A[j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float* ps = p + s * rec;
    const float ms = ps[H], ls = ps[H + 1];
    float x[C];
#pragma unroll
    for (int j = 0; j < C; ++j)
      x[j] = lane + 32 * j < H ? ps[lane + 32 * j] : 0.f;
    const float mn = fmaxf(M, ms);
    const float old = expf(M - mn), w = expf(ms - mn);
    L = L * old + w * ls;
#pragma unroll
    for (int j = 0; j < C; ++j) A[j] = A[j] * old + w * x[j];
    M = mn;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (lane + 32 * j < H)
      o[(long long)row * H + lane + 32 * j] = from_f<T>(A[j] * inv);
}

template <typename T, int HP, int RB>
cudaError_t run(const Args& a, float* part, int splits, int vec,
                cudaStream_t stream) {
  constexpr int smem = Lanes<T, HP>::RING_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_split_kernel<T, HP, RB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int R = (a.N / a.K) * a.Sq;
  const long long blocks =
      (long long)splits * ((R + RB - 1) / RB) * a.K * a.B;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_decode_split_kernel<T, HP, RB>
      <<<(unsigned)blocks, NT, smem, stream>>>(a, part, splits, vec);
  return cudaGetLastError();
}

template <typename T, int HP>
cudaError_t decode(const Args& a, float* part, int splits, int rb, int vec,
                   int combine, cudaStream_t stream) {
  cudaError_t err = rb == 1   ? run<T, HP, 1>(a, part, splits, vec, stream)
                    : rb == 2 ? run<T, HP, 2>(a, part, splits, vec, stream)
                              : run<T, HP, 4>(a, part, splits, vec, stream);
  if (err != cudaSuccess || !combine) return err;
  const int rows = a.B * a.Sq * a.N;
  flash_decode_combine_kernel<T, HP><<<(rows + NW - 1) / NW, NT, 0, stream>>>(
      part, static_cast<T*>(a.o), rows, a.H, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, float* part, int splits, int rb,
                     int combine, cudaStream_t stream) {
  const int esize = sizeof(T);
  const int vec = a.H % (16 / esize) == 0 &&
                  aligned(a.k, a.sk, esize, 16) && aligned(a.v, a.sv, esize, 16);
  if (a.H <= 64)
    return decode<T, 64>(a, part, splits, rb, vec, combine, stream);
  if (a.H <= 128)
    return decode<T, 128>(a, part, splits, rb, vec, combine, stream);
  return decode<T, 256>(a, part, splits, rb, vec, combine, stream);
}

}  // namespace

// dtype 0: float32, 1: bfloat16. q (B, Sq, N, H), k and v (B, Sk, K, H),
// each with unit stride over H and the given strides (in elements) over
// batch, sequence and head. part: float32 (splits, B, Sq, N, H + 2), each
// record acc[0..H), m, l; o (B, Sq, N, H) contiguous in q's type, written
// only when combine != 0. rows_per_block is 1, 2 or 4 (of the G * Sq rows a
// KV head serves). window <= 0 means no window; keys at or past kv_len are
// masked out.
extern "C" int flash_decode_fwd(
    const void* q, const void* k, const void* v, void* o, void* part,
    int dtype, int B, int Sq, int Sk, int N, int K, int H, int sqb, int sqs,
    int sqn, int skb, int sks, int skn, int svb, int svs, int svn, int causal,
    int window, int q_offset, int kv_len, int splits, int rows_per_block,
    int combine, float scale, float softcap, void* stream) {
  if (H < 1 || H > 256 || K < 1 || N % K != 0 || splits < 1 ||
      splits > MAX_SPLITS ||
      (rows_per_block != 1 && rows_per_block != 2 && rows_per_block != 4))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, B, Sq, Sk, N, K, H,
         {sqb, sqs, sqn}, {skb, sks, skn}, {svb, svs, svn},
         causal, window, q_offset, kv_len, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  return (int)(dtype == 1
                   ? dispatch<__nv_bfloat16>(a, pf, splits, rows_per_block,
                                             combine, st)
                   : dispatch<float>(a, pf, splits, rows_per_block, combine,
                                     st));
}
