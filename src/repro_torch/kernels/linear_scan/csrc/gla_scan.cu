// Chunked gated linear attention (GLA) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/kernel.py,
// gla_pallas (body _gla_kernel), and computes what ref.gla_chunked
// computes: the output and the final (K, V) state, from an optional initial
// state, with a scalar (Mamba2) or per-channel (RWKV6) decay, the RWKV6
// bonus u and the strict (h_{t-1}) mode. The TPU kernel returns no final
// state and takes no initial state; this one does both.
//
// What bounds it on this card: a Mamba2 layer's prefill reads v (B, S, H, V)
// and writes o of the same size in bf16, q and k once (broadcast over the
// heads) and the decay, and does ~6 K V flops a token and head: ~25 flops a
// byte, so its bound is the bytes. The chunk's exact pairwise decays cost one
// exponential per (t, s) pair (per (t, s, k) triple with per-channel decay).
//
// What the design does about it: one block of 256 threads per (batch, head)
// carries the float32 (K, V) state in shared memory across a loop over the
// sequence in tiles of T = min(chunk, 64) rows (the TPU's sequential chunk
// axis). A tile is staged in shared memory as float32 (q, k and the
// cumulative decay in rows padded to K + 1 floats, so a warp reading K-rows
// of different positions hits different banks); each warp takes one output
// row at a time, forms that row's intra-tile scores A[t, s] lane by lane
// into its own row buffer, and then accumulates the inter-tile term, the
// intra-tile term and the bonus over its lanes' value columns. All
// exponents are <= 0, as in the reference. A 256-row Mamba2 chunk is taken
// as four 64-row tiles: the same function, other rounding. q and k are read
// through their strides, so Mamba2's B and C, broadcast over the heads with
// stride 0, are never copied; a scalar decay is read as (B, S, H).
// Decode steps (one token) stay plain PyTorch, as in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int NW = NT / 32;
constexpr int TMAX = 64;  // rows per tile
constexpr int DMAX = 64;  // largest K and V

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ld;
  const float* bonus;  // (H, K) or null
  const float* h0;     // (B, H, K, V) or null
  void* o;             // (B, S, H, V) contiguous
  float* hT;           // (B, H, K, V) contiguous
  int B, S, H, K, V;
  long long sq[3], sk[3], sv[3], sl[3];  // strides over (batch, seq, head)
  int vec, strict, T;
};

__host__ __device__ constexpr int smem_floats(int K, int V, int T, int vec) {
  // state, q, k, v, the cumulative decay, q * exp(cum_q) (reused for the
  // state update's k * exp(cum_last - cum)), the warps' score rows, bonus
  return K * V + 3 * T * (K + 1) + T * V + (vec ? T * (K + 1) : T) +
         NW * T + K;
}

template <typename T>
__global__ void __launch_bounds__(NT) gla_scan_kernel(const Args a) {
  extern __shared__ float smem[];
  const int K = a.K, V = a.V, TT = a.T, KP = K + 1;
  float* Hs = smem;             // K x V
  float* Qs = Hs + K * V;       // TT x KP
  float* Ks = Qs + TT * KP;     // TT x KP
  float* QE = Ks + TT * KP;     // TT x KP
  float* Vs = QE + TT * KP;     // TT x V
  float* Cs = Vs + TT * V;      // TT x KP (vector) or TT (scalar)
  float* Aw = Cs + (a.vec ? TT * KP : TT);  // NW x TT
  float* Us = Aw + NW * TT;     // K

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const T* qp = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const float* lp = a.ld + b * a.sl[0] + h * a.sl[2];
  T* op = static_cast<T*>(a.o);
  const long long bh = (long long)b * a.H + h;

  for (int i = tid; i < K * V; i += NT)
    Hs[i] = a.h0 ? a.h0[bh * K * V + i] : 0.f;
  for (int i = tid; i < K; i += NT)
    Us[i] = a.bonus ? a.bonus[(long long)h * K + i] : 0.f;

  // cumulative log decay of row t (inclusive) and its query side
  auto cum = [&](int t, int kk) -> float {
    return a.vec ? Cs[t * KP + kk] : Cs[t];
  };
  auto cum_q = [&](int t, int kk) -> float {
    return a.strict ? (t > 0 ? cum(t - 1, kk) : 0.f) : cum(t, kk);
  };

  for (int t0 = 0; t0 < a.S; t0 += TT) {
    const int nt = min(TT, a.S - t0);  // rows past nt pad: k, v, decay 0
    __syncthreads();  // the previous tile's state update is done
    for (int i = tid; i < TT * K; i += NT) {
      const int t = i / K, kk = i % K;
      const bool ok = t < nt;
      const long long s = t0 + t;
      Qs[t * KP + kk] = ok ? to_f(qp[s * a.sq[1] + kk]) : 0.f;
      Ks[t * KP + kk] = ok ? to_f(kp[s * a.sk[1] + kk]) : 0.f;
      if (a.vec) Cs[t * KP + kk] = ok ? lp[s * a.sl[1] + kk] : 0.f;
    }
    for (int i = tid; i < TT * V; i += NT) {
      const int t = i / V, vv = i % V;
      Vs[i] = t < nt ? to_f(vp[(long long)(t0 + t) * a.sv[1] + vv]) : 0.f;
    }
    if (!a.vec)
      for (int t = tid; t < TT; t += NT)
        Cs[t] = t < nt ? lp[(long long)(t0 + t) * a.sl[1]] : 0.f;
    __syncthreads();
    // inclusive cumulative sum over the tile's rows, in row order
    if (a.vec) {
      for (int kk = tid; kk < K; kk += NT) {
        float run = 0.f;
        for (int t = 0; t < TT; ++t) {
          run += Cs[t * KP + kk];
          Cs[t * KP + kk] = run;
        }
      }
    } else if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < TT; ++t) {
        run += Cs[t];
        Cs[t] = run;
      }
    }
    __syncthreads();
    for (int i = tid; i < TT * K; i += NT) {
      const int t = i / K, kk = i % K;
      QE[t * KP + kk] = Qs[t * KP + kk] * expf(cum_q(t, kk));
    }
    __syncthreads();

    // output rows: one warp a row
    float* arow = Aw + warp * TT;
    for (int t = warp; t < nt; t += NW) {
      const int last = a.strict ? t - 1 : t;  // attended rows s <= last
      for (int s = lane; s <= last; s += 32) {
        float acc = 0.f;
        if (a.vec) {
          for (int kk = 0; kk < K; ++kk)
            acc += Qs[t * KP + kk] * Ks[s * KP + kk] *
                   expf(cum_q(t, kk) - cum(s, kk));
        } else {
          for (int kk = 0; kk < K; ++kk)
            acc = fmaf(Qs[t * KP + kk], Ks[s * KP + kk], acc);
          acc *= expf(cum_q(t, 0) - cum(s, 0));
        }
        arow[s] = acc;
      }
      float coef = 0.f;
      if (a.bonus) {
        for (int kk = lane; kk < K; kk += 32)
          coef += Qs[t * KP + kk] * Us[kk] * Ks[t * KP + kk];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          coef += __shfl_xor_sync(0xffffffffu, coef, off);
      }
      __syncwarp();
      for (int vv = lane; vv < V; vv += 32) {
        float inter = 0.f;
        for (int kk = 0; kk < K; ++kk)
          inter = fmaf(QE[t * KP + kk], Hs[kk * V + vv], inter);
        float intra = 0.f;
        for (int s = 0; s <= last; ++s)
          intra = fmaf(arow[s], Vs[s * V + vv], intra);
        float o = inter + intra;
        if (a.bonus) o += coef * Vs[t * V + vv];
        op[((bh / a.H * a.S + t0 + t) * a.H + h) * V + vv] = from_f<T>(o);
      }
      __syncwarp();  // the row buffer is free for the warp's next row
    }
    __syncthreads();

    // state update: h = exp(cum_last) h + sum_t k_t exp(cum_last - cum_t) v_t
    for (int i = tid; i < TT * K; i += NT) {
      const int t = i / K, kk = i % K;
      QE[t * KP + kk] = Ks[t * KP + kk] * expf(cum(TT - 1, kk) - cum(t, kk));
    }
    __syncthreads();
    for (int i = tid; i < K * V; i += NT) {
      const int kk = i / V, vv = i % V;
      float add = 0.f;
      for (int t = 0; t < TT; ++t)
        add = fmaf(QE[t * KP + kk], Vs[t * V + vv], add);
      Hs[i] = expf(cum(TT - 1, kk)) * Hs[i] + add;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * V; i += NT) a.hT[bh * K * V + i] = Hs[i];
}

template <typename T>
cudaError_t run(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.K, a.V, a.T, a.vec);
  cudaError_t err = cudaFuncSetAttribute(
      gla_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gla_scan_kernel<T><<<a.B * a.H, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (q, k, v and o). q, k (B, S, H, K) and
// v (B, S, H, V) with unit stride over their last dim and the given strides
// (in elements) over batch, sequence and head; log_decay float32 (B, S, H)
// when vec == 0, else (B, S, H, K) with unit stride over K; bonus (H, K) and
// h0 (B, H, K, V) float32 contiguous or null; o (B, S, H, V) contiguous;
// hT (B, H, K, V) float32 contiguous. K, V <= 64; tile rows 1..64.
extern "C" int gla_scan_fwd(
    const void* q, const void* k, const void* v, const void* ld,
    const void* bonus, const void* h0, void* o, void* hT, int dtype, int B,
    int S, int H, int K, int V, int sqb, int sqs, int sqh, int skb, int sks,
    int skh, int svb, int svs, int svh, int slb, int sls, int slh, int vec,
    int strict, int tile, void* stream) {
  if (K < 1 || K > DMAX || V < 1 || V > DMAX || tile < 1 || tile > TMAX)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const float*>(ld),
         static_cast<const float*>(bonus), static_cast<const float*>(h0), o,
         static_cast<float*>(hT), B, S, H, K, V,
         {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh}, {slb, sls, slh},
         vec, strict, tile};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? run<__nv_bfloat16>(a, st) : run<float>(a, st));
}
