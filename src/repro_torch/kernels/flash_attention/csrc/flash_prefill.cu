// Flash attention for Hopper (sm_90a), the bf16 prefill route (Sq > 16):
// FlashAttention-2 tiles on the tensor cores.
//
// Replaces, with flash_decode.cu and flash_attention.cu, the TPU kernel
// src/repro/kernels/flash_attention/kernel.py, flash_attention (body
// _flash_kernel), for bf16 calls of more than 16 query rows: GQA, causal
// and sliding-window masks, logit softcap, a runtime query offset and a
// runtime cache length, as ref.attention_reference computes them.
//
// What bounds it on this card: operations. A prefill (Sq = Sk = 1,024,
// H = 112) does 4 H flops per attended (q, k) pair against 2 H * 2 bytes
// per key, far above the ~295 flops a byte where the bf16 tensor cores and
// not the memory set the limit.
//
// What the design does about it:
// - Tensor cores. S = Q K^T and O += P V are mma.sync.m16n8k16 bf16
//   products with float32 accumulators; operands come from shared memory
//   by ldmatrix (V by ldmatrix.trans). wgmma, TMA and warp specialisation
//   are later work.
// - One block of 4 warps per (batch * query head, 64 query rows), each warp
//   16 rows; heavy (late) query tiles are launched first. The Q tile is
//   loaded once as bf16; tiles of BN keys (64 at HP = 64, else 32, which
//   leaves registers and shared memory for three blocks an SM at HP = 128)
//   are double-buffered with cp.async
//   (16-byte pieces where base and strides allow, else element loads).
//   Shared rows are padded by 8 bf16 so that ldmatrix has no bank
//   conflicts; columns from H to the padded width HP (64, 128 or 256) are
//   zero.
// - The softmax stays in registers. Scale, softcap and mask are applied to
//   the accumulator fragments; per-element masks only on tiles that
//   straddle the causal diagonal, the window edge or the cache length, and
//   wholly masked tiles are never loaded. A row's values lie in a quad of
//   lanes, so its max and sum take two __shfl_xor_sync steps. P is rounded
//   to bf16 straight from the score fragments into A-operand fragments, as
//   the reference rounds P to v's type before P V.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NW = 4;        // warps per block
constexpr int NT = 32 * NW;  // threads per block
constexpr int BM = 16 * NW;  // query rows per block
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b for one 16 x 8 x 16 tile: a row-major 16 x 16, b 16 x 8
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [r0, r0 + ROWS) of one head (rows at or past `limit` and
// columns at or past H read as zero) into a (ROWS, HP + 8) bf16 tile.
template <int ROWS, int HP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int r0,
                                          int limit, int H, bool vec) {
  constexpr int PITCH = HP + 8, PIECES = HP / 8;
  for (int idx = threadIdx.x; idx < ROWS * PIECES; idx += NT) {
    const int r = idx / PIECES, c = (idx % PIECES) * 8;
    const bool row_ok = r0 + r < limit;
    const __nv_bfloat16* g = src + (row_ok ? (r0 + r) * row_stride : 0) + c;
    __nv_bfloat16* s = dst + r * PITCH + c;
    if (vec) {
      cp_async16(s, g, row_ok && c < H ? 16 : 0);
    } else {
      __align__(16) __nv_bfloat16 x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = row_ok && c + i < H ? g[i] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(s) = *reinterpret_cast<const uint4*>(x);
    }
  }
}

template <int HP, int BN>
__global__ void __launch_bounds__(NT)
flash_prefill_bf16_kernel(const Args a, int vec) {
  constexpr int PITCH = HP + 8;      // shared row, bf16
  constexpr int DT = HP / 8;         // 8-column tiles of the output
  constexpr int NTL = BN / 8;        // 8-key tiles of a score tile
  constexpr bool QREG = HP <= 128;   // Q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * PITCH;   // two stages
  __nv_bfloat16* Vs = Ks + 2 * BN * PITCH;

  const int BNh = a.B * a.N, n_qt = (a.Sq + BM - 1) / BM;
  const int qt = n_qt - 1 - blockIdx.x / BNh;  // late (heavy) tiles first
  const int bn = blockIdx.x % BNh, b = bn / a.N, n = bn % a.N;
  const int kh = n / (a.N / a.K);
  const int q0 = qt * BM, H = a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0] + n * a.sq[2];
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kh * a.sk[2];
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kh * a.sv[2];

  const int q_first = a.q_offset + q0;
  const int q_last = a.q_offset + min(q0 + BM, a.Sq) - 1;
  int k_begin, k_end;
  key_span(a, q_first, q_last, &k_begin, &k_end);
  const int j_begin = k_begin / BN;
  const int j_end = k_end > k_begin ? (k_end + BN - 1) / BN : j_begin;

  load_tile<BM, HP>(Qs, qp, a.sq[1], q0, a.Sq, H, vec);
  if (j_begin < j_end) {
    load_tile<BN, HP>(Ks, kp, a.sk[1], j_begin * BN, a.Sk, H, vec);
    load_tile<BN, HP>(Vs, vp, a.sv[1], j_begin * BN, a.Sk, H, vec);
  }
  cp_commit();

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t qf[QREG ? HP / 16 : 1][4];
  const float scale_l2 = a.scale * LOG2E;
  // this thread's rows, g and g + 8 of the warp's 16
  const int qpos0 = q_first + warp * 16 + g;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int st = (jt - j_begin) & 1, k0 = jt * BN;
    if (jt + 1 < j_end) {
      const int nx = st ^ 1;
      load_tile<BN, HP>(Ks + nx * BN * PITCH, kp, a.sk[1], k0 + BN, a.Sk, H,
                        vec);
      load_tile<BN, HP>(Vs + nx * BN * PITCH, vp, a.sv[1], k0 + BN, a.Sk, H,
                        vec);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + st * BN * PITCH;
    const __nv_bfloat16* Vt = Vs + st * BN * PITCH;
    const __nv_bfloat16* Qw = Qs + (warp * 16 + (lane & 15)) * PITCH +
                              (lane >> 4) * 8;
    if constexpr (QREG) {
      if (jt == j_begin) {
#pragma unroll
        for (int kk = 0; kk < HP / 16; ++kk) ldsm_x4(qf[kk], Qw + kk * 16);
      }
    }

    // S = Q K^T: NTL fragments of 16 x 8
    float s[NTL][4];
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk) {
      uint32_t a4[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a4[e] = qf[kk][e];
      } else {
        ldsm_x4(a4, Qw + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NTL / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * PITCH +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s[2 * np], a4, bk[0], bk[1]);
        mma(s[2 * np + 1], a4, bk[2], bk[3]);
      }
    }

    // scale, softcap and mask, in log2 units
    const bool edge = k0 + BN > a.kv_len ||
                      (a.causal && k0 + BN - 1 > q_first) ||
                      (a.window > 0 && k0 < q_last - a.window + 1);
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (a.softcap > 0.f)
          x = a.softcap * tanhf(x * a.scale / a.softcap) * LOG2E;
        else
          x *= scale_l2;
        if (edge) {
          const int qpos = qpos0 + (e >> 1) * 8;
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          if (!attends(a, qpos, kpos)) x = NEG_INF;
        }
        s[j][e] = x;
      }

    // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < NTL; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NTL; ++j) {
        const float p0 = exp2f(s[j][2 * i] - mx);
        const float p1 = exp2f(s[j][2 * i + 1] - mx);
        s[j][2 * i] = p0;
        s[j][2 * i + 1] = p1;
        sum += p0 + p1;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * i] *= alpha;
        o[d][2 * i + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HP / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, Vt + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              PITCH +
                          dp * 16 + (lane >> 4) * 8);
        mma(o[2 * dp], pa, bv[0], bv[1]);
        mma(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_wait<0>();

  // a row's sum over its quad, then O / l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + warp * 16 + g + 8 * i;
    if (qi >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = op + (((long long)b * a.Sq + qi) * a.N + n) * H;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = d * 8 + 2 * t;
      const float x0 = o[d][2 * i] * inv, x1 = o[d][2 * i + 1] * inv;
      if ((H & 1) == 0 && col + 1 < H) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < H) orow[col] = __float2bfloat16(x0);
        if (col + 1 < H) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int HP, int BN>
cudaError_t run(const Args& a, int vec, cudaStream_t stream) {
  constexpr size_t smem = sizeof(__nv_bfloat16) * (BM + 4 * BN) * (HP + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_bf16_kernel<HP, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.Sq + BM - 1) / BM) * a.B * a.N;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_prefill_bf16_kernel<HP, BN>
      <<<(unsigned)blocks, NT, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, N, H), k and v (B, Sk, K, H), bf16, each with unit stride over
// H and the given strides (in elements) over batch, sequence and head; o
// (B, Sq, N, H) contiguous bf16. window <= 0 means no window; keys at or
// past kv_len are masked out.
extern "C" int flash_prefill_bf16_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int N, int K, int H, int sqb, int sqs, int sqn, int skb, int sks,
    int skn, int svb, int svs, int svn, int causal, int window, int q_offset,
    int kv_len, float scale, float softcap, void* stream) {
  if (H < 1 || H > 256 || K < 1 || N % K != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, B, Sq, Sk, N, K, H,
         {sqb, sqs, sqn}, {skb, sks, skn}, {svb, svs, svn},
         causal, window, q_offset, kv_len, scale, softcap};
  const int vec = H % 8 == 0 && aligned(q, a.sq, 2, 16) &&
                  aligned(k, a.sk, 2, 16) && aligned(v, a.sv, 2, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (H <= 64) err = run<64, 64>(a, vec, st);
  else if (H <= 128) err = run<128, 32>(a, vec, st);
  else err = run<256, 32>(a, vec, st);
  return (int)err;
}
