// Flash attention for Hopper (sm_90a), the float32 prefill route (Sq > 16):
// FlashAttention-2 tiles on the tensor cores in split TF32 (3xTF32).
//
// Replaces, with flash_prefill.cu (bf16 prefill) and flash_decode.cu
// (decode, Sq <= 16, both types), the TPU kernel
// src/repro/kernels/flash_attention/kernel.py, flash_attention (body
// _flash_kernel), for float32 calls of more than 16 query rows, and computes
// what ref.attention_reference computes: GQA, causal and sliding-window
// masks, logit softcap, a runtime query offset and a runtime cache length,
// H <= 256, q, k and v read through their strides.
//
// What bounds it on this card: operations. A prefill does 4 H flops per
// attended (q, k) pair (DeepSeek-V2's MLA prefill at 2 x 512^2, 128 heads of
// 192: 25.8 GFLOP against 0.1 GB). On the CUDA cores (67 TFLOP/s FP32) that
// takes 0.386 ms at best. One TF32 tensor-core product keeps 10 mantissa
// bits and misses the float32 cases' 2e-5 limit by 50-75x; the split product
// below keeps about 21 and stays inside it, at 495 / 3 = 165 TFLOP/s of
// float32-accurate work (0.156 ms for that call) with wgmma. mma.sync
// reaches 311 TFLOP/s of TF32 on an H100 (tools/mma_probe.py), and the
// splits add about three ALU operations a product: the issue rate and the
// latency of the dependent chains, not the tensor cores, set the pace.
//
// What the design does about it:
// - Split TF32. S = Q K^T and O += P V are mma.sync.m16n8k8 tf32 products
//   with float32 accumulators. Each float32 operand x is split in registers
//   as its fragment is loaded: hi = x rounded to TF32 (to nearest, ties away
//   from zero: the bits cvt.rna.tf32.f32 gives, by two integer operations,
//   which measured faster than cvt), lo = x - hi exactly, which the tensor
//   core reads truncated to TF32 (rounding it too cost 4-11% and moved no
//   error by more than 1.2e-7). A product is lo.hi + hi.lo + hi.hi; lo.lo
//   is dropped. In S each of the three runs in an accumulator of its own
//   over the k-steps (three independent chains), summed (lo.hi + hi.lo) +
//   hi.hi. Shared memory holds the float32 values, one plane and not two.
//   H runs in k-steps of 8: columns from H up to the next multiple of 8 are
//   zero, and none past it is loaded or multiplied.
// - The tensor cores' float32 sums truncate. Summed into O over every key,
//   that bias grew to 5.6e-6 at DeepSeek-V2's call and moved DeepSeekMoE's
//   float32 scatter-vs-einsum logits by 1.05e-4 (limit 1e-4; 1.4e-6 with
//   the CUDA-core kernel). So each key tile's P V is summed from zero in
//   the tensor cores (the three products in turn, lo.hi, hi.lo, hi.hi) and
//   O = O alpha + it by an FMA: O takes one rounded sum a key tile (2.9e-6
//   and 1.444e-6).
// - One block of 4 warps per (batch * query head, 64 query rows) on a
//   one-dimensional grid (B * N is bounded by no grid axis), heavy (late)
//   query tiles first. Tiles of BN keys (32 at HMAX = 64 and 128, 16 at 192
//   and 256: H = 192 fits two blocks an SM) are double-buffered with
//   cp.async (16-byte pieces where base and strides allow, else 4-byte
//   ones), one barrier a tile between them. Shared rows are padded to
//   HMAX + 4 floats, so the ldmatrix loads of Q and K fragments and the
//   scalar loads of V's hit distinct banks. Q's fragments are loaded and
//   split again each key tile: held in registers at HMAX = 64 they took
//   242 registers a thread against 165, 2 blocks an SM against 3 (the
//   B * N = 65,536 case 1.71 -> 1.16 ms; Whisper's cross prefill 5% and
//   train_carbon_aware's call 2% faster with them).
// - S and the softmax by rows: each warp takes 16 rows of S. The softmax
//   stays in registers on the accumulator fragments: scale, softcap and
//   mask, in log2 units; per-element masks only on tiles that straddle the
//   causal diagonal, the window edge or the cache length, and wholly masked
//   tiles are never loaded. A row's values lie in a quad of lanes, so its
//   max takes two __shfl_xor_sync steps (its sum two at the end).
// - P V by columns: the warps publish P and each row's rescale to shared
//   memory (a second barrier), and each warp takes a quarter of O's columns
//   for all 64 rows, so that each V value is split once a block and not
//   once a warp (0.91 -> 0.78 ms at DeepSeek-V2's call). P's A fragment
//   takes its k = t as key 2t and k = t + 4 as key 2t + 1, the pair a score
//   accumulator holds, and V's B fragment reads its rows in that order (the
//   sum over keys does not care). Over a group of output tiles (all of the
//   warp's up to HMAX = 128, 2 wider: each group holds its partial sums)
//   each of the three products goes in turn, so that no product waits on
//   the one before it into the same tile. The first product of a sum takes
//   no accumulator in, so no register is zeroed.
// Measured alternatives that lost, on an H100 at 700 W (tools/flash_probe.py
// --f32): 32 keys a tile at HMAX = 192 (one block an SM, 1.5x slower); P V
// groups of 3 and 4 output tiles at HMAX = 192 and 256; skipping the masked
// 8-key tiles of a diagonal tile, and O's rescale where no row's max moved
// (the branches cost more than they saved). 64 keys a tile at HMAX = 64 is
// 8-10% faster at 128-1,500 keys and 2x slower at 24 (each block computes
// a whole tile); a tile size chosen by the key span is untried.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NW = 4;        // warps per block
constexpr int NT = 32 * NW;  // threads per block
constexpr int BM = 16 * NW;  // query rows per block
constexpr float LOG2E = 1.4426950408889634f;

// Four 8 x 4 float32 matrices (8 rows of 16 bytes each): thread (g, t) of
// a warp gets word t of row g of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest with
// ties away from zero: the bits cvt.rna.tf32.f32 gives, by two integer
// operations), lo = x - hi exactly, which the tensor core reads truncated
// to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const uint32_t (&x)[4],
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(x[e]), hi[e], lo[e]);
}

// d += a b for one 16 x 8 x 8 tile: a row-major 16 x 8, b 8 x 8
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp_async16's four-byte form, for operands whose rows are not 16-byte
// aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// d = a b for one 16 x 8 x 8 tile, with no accumulator in
__device__ __forceinline__ void mma_z(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Stage rows [r0, r0 + ROWS) of one head into a (ROWS, PITCH) float tile:
// columns [0, HK), those at or past H and rows at or past `limit` zero
template <int ROWS, int PITCH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int limit, int H, int HK,
                                          bool vec) {
  constexpr int PIECES = (PITCH - 4) / 4;  // 16-byte pieces of a row
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * PIECES; idx += NT) {
    const int r = idx / PIECES, c = (idx % PIECES) * 4;
    if (c >= HK) continue;
    const bool row_ok = r0 + r < limit;
    const float* g = src + (row_ok ? (r0 + r) * row_stride : 0) + c;
    float* s = dst + r * PITCH + c;
    if (vec) {
      cp_async16(s, g, row_ok && c < H ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cp_async4(s + e, g + e, row_ok && c + e < H ? 4 : 0);
    }
  }
}

// S += Q K^T over one k-step of 8 columns for the NTL 8-key tiles of a key
// tile, each of the three products into an accumulator of its own (s[0]
// q_lo k_hi, s[1] q_hi k_lo, s[2] q_hi k_hi: three independent chains over
// the k-steps, not one); kp points at this lane's ldmatrix row of the tile
// at the k-step; FIRST (the first k-step) starts the sums from zero
template <int NTL, int PITCH, bool FIRST>
__device__ __forceinline__ void score_step(float (&s)[3][NTL][4],
                                           const uint32_t (&qh)[4],
                                           const uint32_t (&ql)[4],
                                           const float* kp) {
#pragma unroll
  for (int np = 0; np < NTL / 2; ++np) {
    uint32_t x[4], kh[4], kl[4];
    ldsm_x4(x, kp + np * 16 * PITCH);
    split4(x, kh, kl);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * np + h;
      if constexpr (FIRST) {
        mma_z(s[0][j], ql, kh[2 * h], kh[2 * h + 1]);
        mma_z(s[1][j], qh, kl[2 * h], kl[2 * h + 1]);
        mma_z(s[2][j], qh, kh[2 * h], kh[2 * h + 1]);
      } else {
        mma(s[0][j], ql, kh[2 * h], kh[2 * h + 1]);
        mma(s[1][j], qh, kl[2 * h], kl[2 * h + 1]);
        mma(s[2][j], qh, kh[2 * h], kh[2 * h + 1]);
      }
    }
  }
}

template <int HMAX, int BN>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const Args a, int vec) {
  constexpr int PITCH = HMAX + 4;   // shared row, floats
  constexpr int DT = HMAX / 8;      // 8-column k-steps and output tiles
  constexpr int NTL = BN / 8;       // 8-key tiles of a score tile
  // O += P V: each warp takes DW of O's 8-column tiles for all BM rows,
  // with P through shared memory, so that each V value is split once a
  // block and not once a warp
  constexpr int DW = DT / NW;
  // output tiles of a P V group: all of the warp's up to HMAX = 128, else
  // 2 (a group's partial sums take 8 DG registers)
  constexpr int DG = DW <= 4 ? DW : 2;
  constexpr int PP = (BN + 31) / 32 * 32 + 8;  // P's shared row, floats
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * PITCH;      // two stages
  float* Vs = Ks + 2 * BN * PITCH;  // two stages
  float* Ps = Vs + 2 * BN * PITCH;  // P, then alpha and l by row
  float* As = Ps + BM * PP;
  float* Ls = As + BM;

  const int BNh = a.B * a.N, n_qt = (a.Sq + BM - 1) / BM;
  const int qt = n_qt - 1 - blockIdx.x / BNh;  // late (heavy) tiles first
  const int bn = blockIdx.x % BNh, b = bn / a.N, n = bn % a.N;
  const int kh = n / (a.N / a.K);              // GQA fold
  const int q0 = qt * BM, H = a.H, HK = (H + 7) & ~7, nk = HK / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int dw0 = warp * DW;                   // this warp's first O tile
  const float* qp = static_cast<const float*>(a.q) + b * a.sq[0] +
                    n * a.sq[2];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] +
                    kh * a.sk[2];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] +
                    kh * a.sv[2];

  const int q_first = a.q_offset + q0;
  const int q_last = a.q_offset + min(q0 + BM, a.Sq) - 1;
  int k_begin, k_end;
  key_span(a, q_first, q_last, &k_begin, &k_end);
  const int j_begin = k_begin / BN;
  const int j_end = k_end > k_begin ? (k_end + BN - 1) / BN : j_begin;

  load_tile<BM, PITCH>(Qs, qp, a.sq[1], q0, a.Sq, H, HK, vec);
  if (j_begin < j_end) {
    load_tile<BN, PITCH>(Ks, kp, a.sk[1], j_begin * BN, a.Sk, H, HK, vec);
    load_tile<BN, PITCH>(Vs, vp, a.sv[1], j_begin * BN, a.Sk, H, HK, vec);
  }
  cp_commit();

  float o[NW][DW][4];  // rows 16 mi + (g, g + 8), columns 8 (dw0 + d) + 2t
#pragma unroll
  for (int mi = 0; mi < NW; ++mi)
#pragma unroll
    for (int d = 0; d < DW; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float scale_l2 = a.scale * LOG2E;
  // this thread's rows of S, g and g + 8 of the warp's 16
  const int qpos0 = q_first + warp * 16 + g;
  // ldmatrix rows: Q's (rows g, g + 8 by column halves t, t + 4) and K's
  // (keys of two 8-key tiles by column halves)
  const float* Qw = Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             PITCH + (lane >> 4) * 4;
  const int k_lane = ((lane & 7) + (lane >> 4) * 8) * PITCH +
                     ((lane >> 3) & 1) * 4;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int st = (jt - j_begin) & 1, k0 = jt * BN;
    cp_wait<0>();
    // tile jt has landed, and every warp is done with tile jt - 1: its
    // stage takes tile jt + 1 while this one is computed
    __syncthreads();
    if (jt + 1 < j_end) {
      const int nx = st ^ 1;
      load_tile<BN, PITCH>(Ks + nx * BN * PITCH, kp, a.sk[1], k0 + BN, a.Sk,
                           H, HK, vec);
      load_tile<BN, PITCH>(Vs + nx * BN * PITCH, vp, a.sv[1], k0 + BN, a.Sk,
                           H, HK, vec);
      cp_commit();
    }
    const float* Kt = Ks + st * BN * PITCH + k_lane;
    const float* Vt = Vs + st * BN * PITCH;

    // S = Q K^T: NTL fragments of 16 x 8, the three products apart, then
    // summed small terms first; Q's fragments split again each key tile
    float s3[3][NTL][4];
    uint32_t qx[4], ah[4], al[4];
    ldsm_x4(qx, Qw);
    split4(qx, ah, al);
    score_step<NTL, PITCH, true>(s3, ah, al, Kt);
#pragma unroll 2
    for (int kk = 1; kk < nk; ++kk) {
      ldsm_x4(qx, Qw + kk * 8);
      split4(qx, ah, al);
      score_step<NTL, PITCH, false>(s3, ah, al, Kt + kk * 8);
    }
    float s[NTL][4];
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = (s3[0][j][e] + s3[1][j][e]) + s3[2][j][e];

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
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < NTL; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2f(m[i] - mx);
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
      l[i] = l[i] * alpha[i] + sum;
    }

    // O = O alpha + P V: publish this warp's rows of P and their alpha
    float* pw = Ps + (warp * 16 + g) * PP + 2 * t;
#pragma unroll
    for (int j = 0; j < NTL; ++j) {
      *reinterpret_cast<float2*>(pw + j * 8) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(pw + 8 * PP + j * 8) =
          make_float2(s[j][2], s[j][3]);
    }
    if (t == 0) {
      As[warp * 16 + g] = alpha[0];
      As[warp * 16 + g + 8] = alpha[1];
    }
    __syncthreads();
    float ar[NW][2];
#pragma unroll
    for (int mi = 0; mi < NW; ++mi) {
      ar[mi][0] = As[mi * 16 + g];
      ar[mi][1] = As[mi * 16 + g + 8];
    }

    // this tile's P V for a group of DG output tiles, from zero, then
    // O = O alpha + it (P's A fragment: k = t is key 2t, k = t + 4 key 2t + 1)
#pragma unroll
    for (int d0 = 0; d0 < DW; d0 += DG) {
      float pv[NW][DG][4];
#pragma unroll
      for (int ks = 0; ks < NTL; ++ks) {
        uint32_t ph[NW][4], pl[NW][4];
#pragma unroll
        for (int mi = 0; mi < NW; ++mi) {
          // rows g, g + 8 at key 2t, then at key 2t + 1
          const float* pr = Ps + (mi * 16 + g) * PP + ks * 8 + 2 * t;
          const float2 x0 = *reinterpret_cast<const float2*>(pr);
          const float2 x1 = *reinterpret_cast<const float2*>(pr + 8 * PP);
          split(x0.x, ph[mi][0], pl[mi][0]);
          split(x1.x, ph[mi][1], pl[mi][1]);
          split(x0.y, ph[mi][2], pl[mi][2]);
          split(x1.y, ph[mi][3], pl[mi][3]);
        }
        const float* v0 = Vt + (ks * 8 + 2 * t) * PITCH + g + (dw0 + d0) * 8;
        uint32_t vh[DG][2], vl[DG][2];
#pragma unroll
        for (int i = 0; i < DG; ++i)
          if (dw0 + d0 + i < nk) {
            split(v0[i * 8], vh[i][0], vl[i][0]);
            split(v0[PITCH + i * 8], vh[i][1], vl[i][1]);
          }
#pragma unroll
        for (int mi = 0; mi < NW; ++mi)
#pragma unroll
          for (int i = 0; i < DG; ++i)
            if (dw0 + d0 + i < nk) {
              if (ks == 0)
                mma_z(pv[mi][i], pl[mi], vh[i][0], vh[i][1]);
              else
                mma(pv[mi][i], pl[mi], vh[i][0], vh[i][1]);
            }
#pragma unroll
        for (int mi = 0; mi < NW; ++mi)
#pragma unroll
          for (int i = 0; i < DG; ++i)
            if (dw0 + d0 + i < nk) mma(pv[mi][i], ph[mi], vl[i][0], vl[i][1]);
#pragma unroll
        for (int mi = 0; mi < NW; ++mi)
#pragma unroll
          for (int i = 0; i < DG; ++i)
            if (dw0 + d0 + i < nk) mma(pv[mi][i], ph[mi], vh[i][0], vh[i][1]);
      }
#pragma unroll
      for (int mi = 0; mi < NW; ++mi)
#pragma unroll
        for (int i = 0; i < DG; ++i)
          if (dw0 + d0 + i < nk) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              o[mi][d0 + i][e] =
                  fmaf(o[mi][d0 + i][e], ar[mi][e >> 1], pv[mi][i][e]);
          }
    }
  }

  cp_wait<0>();  // a block with no key tile still has Q's copies in flight

  // a row's sum over its quad, published by its warp, then O / l
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (t == 0) {
    Ls[warp * 16 + g] = l[0];
    Ls[warp * 16 + g + 8] = l[1];
  }
  __syncthreads();
  float* op = static_cast<float*>(a.o);
#pragma unroll
  for (int mi = 0; mi < NW; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = mi * 16 + g + 8 * i, qi = q0 + r;
      if (qi >= a.Sq) continue;
      const float inv = 1.f / fmaxf(Ls[r], 1e-30f);
      float* orow = op + (((long long)b * a.Sq + qi) * a.N + n) * H;
#pragma unroll
      for (int d = 0; d < DW; ++d) {
        const int col = (dw0 + d) * 8 + 2 * t;
        if (dw0 + d >= nk) break;
        const float x0 = o[mi][d][2 * i] * inv, x1 = o[mi][d][2 * i + 1] * inv;
        if ((H & 1) == 0 && col + 1 < H) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        } else {
          if (col < H) orow[col] = x0;
          if (col + 1 < H) orow[col + 1] = x1;
        }
      }
    }
}

template <int HMAX, int BN>
cudaError_t run(const Args& a, int vec, cudaStream_t stream) {
  constexpr int PP = (BN + 31) / 32 * 32 + 8;
  constexpr size_t smem =
      sizeof(float) * ((BM + 4 * BN) * (HMAX + 4) + BM * PP + 2 * BM);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HMAX, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((a.Sq + BM - 1) / BM) * a.B * a.N;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_attention_kernel<HMAX, BN>
      <<<(unsigned)blocks, NT, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, N, H), k and v (B, Sk, K, H), float32, each with unit stride
// over H and the given strides (in elements) over batch, sequence and head;
// o (B, Sq, N, H) contiguous. window <= 0 means no window; keys at or past
// kv_len are masked out.
extern "C" int flash_prefill_f32_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int N, int K, int H, int sqb, int sqs, int sqn, int skb, int sks,
    int skn, int svb, int svs, int svn, int causal, int window, int q_offset,
    int kv_len, float scale, float softcap, void* stream) {
  if (H < 1 || H > 256 || K < 1 || N % K != 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, B, Sq, Sk, N, K, H,
         {sqb, sqs, sqn}, {skb, sks, skn}, {svb, svs, svn},
         causal, window, q_offset, kv_len, scale, softcap};
  const int vec = H % 4 == 0 && aligned(q, a.sq, 4, 16) &&
                  aligned(k, a.sk, 4, 16) && aligned(v, a.sv, 4, 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (H <= 64) err = run<64, 32>(a, vec, st);
  else if (H <= 128) err = run<128, 32>(a, vec, st);
  else if (H <= 192) err = run<192, 16>(a, vec, st);
  else err = run<256, 16>(a, vec, st);
  return (int)err;
}
