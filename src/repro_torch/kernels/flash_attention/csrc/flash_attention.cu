// Flash attention for Hopper (sm_90a), the float32 prefill route: block-
// tiled online softmax on the CUDA cores.
//
// Replaces, with flash_prefill.cu (bf16 prefill) and flash_decode.cu
// (decode, Sq <= 16, both types), the TPU kernel
// src/repro/kernels/flash_attention/kernel.py, flash_attention (body
// _flash_kernel), and computes what ref.attention_reference computes: GQA,
// causal and sliding-window masks, logit softcap, a runtime query offset
// and a runtime cache length.
//
// Only float32 calls with Sq > 16 come here. They stay on the CUDA cores on
// purpose: TF32 tensor cores keep about three decimal digits, which would
// miss the float32 cases' 2e-5 limit, and those cases exist to catch a mask
// one key off. The kernel is the first port's, unchanged.
//
// What bounds it on this card: a prefill (Sq = Sk = 512, H = 112) does
// 4 * H flops per attended (q, k) pair, FP32 operations at 67 TFLOP/s.
//
// What the design does about it: one block of 128 threads per (batch *
// query head, tile of BM query rows); the TPU's sequential kv grid axis is
// a loop over tiles of 32 keys inside the block, with the (m, l) softmax
// state in shared memory and the (BM, H) accumulator in registers. Each
// tile is staged in shared memory as float32 (rows padded to H + 1 floats,
// so the score loop reads without bank conflicts), the scores form a
// register micro-tile of RM x 4 per thread, and tiles that the causal mask,
// the window or the cache length masks whole are never loaded. The query
// head folds onto its KV head by index (n / (N / K)); q, k and v are read
// through their strides and accumulated in float32.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NT = 128;            // threads per block
constexpr int BN = 32;             // keys per tile
template <int BM, int HMAX>
constexpr int smem_floats() {
  // Q tile, K tile (rows padded to HMAX + 1), V tile, probabilities
  // (rows padded to BN + 1), and per row m, l and this tile's rescale
  return BM * (HMAX + 1) + BN * (HMAX + 1) + BN * HMAX + BM * (BN + 1) +
         3 * BM;
}

template <typename T, int BM, int HMAX>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const Args a) {
  constexpr int RM = BM / 16;    // query rows per thread
  constexpr int OC = HMAX / 8;   // output columns per thread
  constexpr int SC = BN / 8;     // score columns per thread
  constexpr int QP = HMAX + 1;   // padded row of the Q and K tiles
  constexpr int PP = BN + 1;     // padded row of the probabilities
  constexpr int TPR = NT / BM;   // threads sharing one row in the softmax
  constexpr int CPT = BN / TPR;  // columns each of them takes
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * QP;
  float* Vs = Ks + BN * QP;
  float* Ps = Vs + BN * HMAX;
  float* Ms = Ps + BM * PP;
  float* Ls = Ms + BM;
  float* As = Ls + BM;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int bn = blockIdx.y, b = bn / a.N, n = bn % a.N;
  const int kh = n / (a.N / a.K);  // GQA fold
  const int q0 = blockIdx.x * BM;
  const int H = a.H;
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + n * a.sq[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + kh * a.sv[2];

  for (int idx = tid; idx < BM * HMAX; idx += NT) {
    const int r = idx / HMAX, c = idx % HMAX, i = q0 + r;
    Qs[r * QP + c] =
        (i < a.Sq && c < H) ? to_f(qp[(long long)i * a.sq[1] + c]) : 0.f;
  }
  for (int r = tid; r < BM; r += NT) {
    Ms[r] = NEG_INF;
    Ls[r] = 0.f;
  }
  float acc[RM][OC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  // the keys any row of this tile may attend: skip the tiles outside
  const int q_first = a.q_offset + q0;
  const int q_last = a.q_offset + min(q0 + BM, a.Sq) - 1;
  int k_end = a.kv_len;
  if (a.causal) k_end = min(k_end, q_last + 1);
  const int k_begin = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  const int j_begin = k_begin / BN;
  const int j_end = k_end > 0 ? (k_end + BN - 1) / BN : 0;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int k0 = jt * BN;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < BN * HMAX; idx += NT) {
      const int r = idx / HMAX, c = idx % HMAX, kpos = k0 + r;
      const bool ok = kpos < a.Sk && c < H;
      Ks[r * QP + c] = ok ? to_f(kp[(long long)kpos * a.sk[1] + c]) : 0.f;
      Vs[r * HMAX + c] = ok ? to_f(vp[(long long)kpos * a.sv[1] + c]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i and keys tx + 8 j
    float s[RM][SC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < H; ++d) {
      float qv[RM], kv[SC];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < SC; ++j) kv[j] = Ks[(tx + 8 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i, qpos = a.q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = tx + 8 * j, kpos = k0 + c;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const bool ok = kpos < a.kv_len && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || qpos - kpos < a.window);
        Ps[r * PP + c] = ok ? x : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: TPR neighbouring lanes share a row
    {
      const int r = tid / TPR, part = tid % TPR;
      float* pr = Ps + r * PP + part * CPT;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) mx = fmaxf(mx, pr[c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        Ls[r] = Ls[r] * alpha + sum;
        Ms[r] = m_new;
        As[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, columns tx + 8 c
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float al = As[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= al;
    }
#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = Vs[j * HMAX + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= a.Sq) continue;
    const float denom = fmaxf(Ls[r], 1e-30f);
    T* orow = op + (((long long)b * a.Sq + qi) * a.N + n) * H;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = tx + 8 * c;
      if (col < H) orow[col] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int BM, int HMAX>
cudaError_t run(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<BM, HMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, BM, HMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BM - 1) / BM, a.B * a.N);
  flash_attention_kernel<T, BM, HMAX><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.H <= 64) return run<float, 64, 64>(a, stream);
  if (a.H <= 128) return run<float, 64, 128>(a, stream);
  return run<float, 32, 256>(a, stream);
}

}  // namespace

// q (B, Sq, N, H), k and v (B, Sk, K, H), float32, each with unit stride
// over H and the given strides (in elements) over batch, sequence and head;
// o (B, Sq, N, H) contiguous. window <= 0 means no window; keys at or past
// kv_len are masked out. The grid's y axis holds B * N (< 65,536).
extern "C" int flash_prefill_f32_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int N, int K, int H, int sqb, int sqs, int sqn, int skb, int sks,
    int skn, int svb, int svs, int svn, int causal, int window, int q_offset,
    int kv_len, float scale, float softcap, void* stream) {
  if (H < 1 || H > 256 || K < 1 || N % K != 0 || B * N > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, B, Sq, Sk, N, K, H,
         {sqb, sqs, sqn}, {skb, sks, skn}, {svb, svs, svn},
         causal, window, q_offset, kv_len, scale, softcap};
  return (int)dispatch(a, static_cast<cudaStream_t>(stream));
}
