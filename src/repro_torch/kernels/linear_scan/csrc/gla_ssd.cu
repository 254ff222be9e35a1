// Chunked gated linear attention for Hopper (sm_90a), the tensor-core route
// for Mamba2's state-space duality (SSD) form: bf16 q, k and v, a scalar
// decay per (batch, position, head), K and V in {16, 32, 48, 64}, no bonus,
// not strict. bf16 with RWKV6's per-channel decay goes to gla_vec.cu;
// float32, other widths and a scalar decay with the bonus or the strict mode
// to gla_scan.cu (the same tiles in split TF32).
//
// Replaces, with gla_vec.cu and gla_scan.cu, the TPU kernel
// src/repro/kernels/linear_scan/kernel.py, gla_pallas (body _gla_kernel), and
// computes what ref.gla_chunked computes: the output and the float32 final
// (K, V) state, from an optional initial state. A chunk is taken in tiles of
// T = 64 rows and the state passes at tile boundaries: the same function,
// other rounding.
//
// What bounds it on this card: bytes. Zamba2-7B's prefill (B = 4, S = 1,024,
// H = 112, K = V = 64) must move v and o in bf16 (59 MB each way), the
// decay, the final state and q and k once (broadcast over the heads): 0.0381
// ms at 3.35 TB/s. Its 11.3 GFLOP (0.0115 ms at 989 TFLOP/s) become ~22
// GFLOP of mma here, since three of the four products take split operands.
//
// What the design does about it:
// - Tensor cores. Every product is mma.sync.m16n8k16 bf16 with float32
//   accumulators, operands from shared memory by ldmatrix (.trans where the
//   tile is stored the other way round). Per 64-row tile and head:
//   S = Q K^T; A = S o exp(cum[t] - cum[s]) on s <= t; o = exp(cum[t]) Q H
//   + A V; H <- exp(cum_last) H + (K o w)^T V with w_s = exp(cum_last -
//   cum[s]). Every exponent is <= 0 (the pairwise decay is never factored
//   into exp(cum[t]) exp(-cum[s]), which overflows on strong decays).
// - Precision. q, k and v are bf16, so their products are exact; every
//   float32 value that enters a product (A, H, K o w) is split into a bf16
//   high part and a bf16 residual, two mma each (relative error ~2^-16
//   instead of bf16's 2^-9), which holds the output to 1e-4 of max|o|.
// - The warps split the value columns, not the rows. Warp w of a block owns
//   16 value columns: its slice of the state, H^T (16 values x K), lives in
//   mma accumulators for the whole sequence (32 registers a lane at K = 64)
//   and never leaves registers until the end. The accumulator layout of H^T
//   is the B-operand layout of H, so Q H takes H straight from registers,
//   and no warp waits for another's state.
// - A is formed once a block and tile and shared through shared memory: the
//   10 (row tile, key block) pairs on or below the diagonal are dealt out
//   to the warps (3, 3, 2, 2), each writes its pairs' A as bf16 hi and lo
//   tiles, and after a barrier every warp reads the fragments it needs by
//   ldmatrix. Q and K are shared by the warps in the same way (one staged
//   tile), so a head's scores are formed once, not once a warp.
// - One block of V / 16 warps per (batch, head): 448 blocks of 4 warps at
//   Zamba2's shape, all resident at once (4 blocks an SM: 46 KB of shared
//   memory, 27 KB of staged q, k and v and 18 KB of A, and 128 registers a
//   thread). A tile takes three barriers: staged, A formed, consumed; the
//   other three blocks of the SM overlap a block's loads. Loads are cp.async
//   (16-byte pieces where base and strides allow, else element loads); q
//   and k are read through their strides, so Mamba2's B and C, broadcast
//   over the heads with stride 0, are read once per batch row and tile from
//   device memory and from L2 for the other heads. Each warp loads its
//   tile's 64 decays (two a lane) a tile ahead into registers and takes
//   their cumulative sum as a warp scan with shuffles.
// - The output goes out from the accumulators as bf16 pairs: a quad of
//   lanes writes 16 contiguous bytes and the warp's two 8-column tiles fill
//   its 32-byte sector of each row; staging in shared memory would cost the
//   occupancy above.
//
// The choices, timed by tools/gla_probe.py at Zamba2's prefill (NVIDIA H100
// 80GB HBM3, 700.00 W; ms, two rounds alternated in one call): shipped
// 0.1946 / 0.1934; q, k and v double-buffered (-DGLA_STAGES=2, 74 KB: 3
// blocks an SM, so two waves) 0.2512 / 0.2510. The same call timed three
// designs that lost and were then taken out of this source (PERF.md §6):
// every warp forming the whole A for itself (no A tiles, no second
// barrier) 0.2397 / 0.2383, double-buffered 0.2353 / 0.2349; S = Q K^T
// once per (batch, tile) in a pre-pass kernel that all 112 heads read from
// L2, 0.1994 / 0.1990: no gain for a second launch and a scratch, so each
// head forms its own scores; two blocks of 32 value columns per (batch,
// head) (8 warps an SM) 0.3056 / 0.3059. The probe as it stands, rerun on
// this source: shipped 0.1950 / 0.1947, GLA_STAGES=2 0.2535 / 0.2531.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GLA_STAGES
#define GLA_STAGES 1  // staged q, k and v tiles (1 or 2)
#endif

namespace {

constexpr int T = 64;       // rows of a tile
constexpr int DMAX = 64;    // largest K and V
constexpr int AP = T + 8;   // pitch of the shared A tiles
constexpr int PAIRS = 10;   // (row tile, key block) pairs on or below the
                            // diagonal of a tile
constexpr float LOG2E = 1.4426950408889634f;
typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* ld;      // (B, S, H) log decay
  const float* h0;      // (B, H, K, V) or null
  bf16* o;              // (B, S, H, V) contiguous
  float* hT;            // (B, H, K, V) contiguous
  int B, S, H, K, V;
  long long sq[3], sk[3], sv[3], sl[3];  // strides over (batch, seq, head)
  int vec;              // q, k and v allow 16-byte pieces
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) = hi + lo, each a bf16 pair (x0 in the low half, the first
// element of an operand pair)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// the two bf16 of a pair, as floats (low half first)
__device__ __forceinline__ float2 unpack(uint32_t x) {
  return make_float2(__uint_as_float(x << 16),
                     __uint_as_float(x & 0xffff0000u));
}

// Stage rows [r0, r0 + T) of one head, C columns (a multiple of 16), into a
// (T, C + 8) bf16 tile; rows at or past `limit` read as zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int r0,
                                          int limit, int C, bool vec) {
  const int pieces = C / 8, pitch = C + 8;
  for (int idx = threadIdx.x; idx < T * pieces; idx += blockDim.x) {
    const int r = idx / pieces, c = (idx % pieces) * 8;
    const bool ok = r0 + r < limit;
    const bf16* g = src + (ok ? (long long)(r0 + r) * row_stride : 0) + c;
    bf16* s = dst + r * pitch + c;
    if (vec) {
      cp_async16(s, g, ok ? 16 : 0);
    } else {
      __align__(16) bf16 x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = ok ? g[i] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(s) = *reinterpret_cast<const uint4*>(x);
    }
  }
}

// bf16 elements of one stage: the q, k and v tiles
__host__ __device__ constexpr int stage_elems(int K, int V) {
  return 2 * T * (K + 8) + T * (V + 8);
}

template <int STAGES>
__global__ void __launch_bounds__(128, 4) gla_ssd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = a.K, KP = K + 8, V = a.V, VP = V + 8;
  const int nks = K / 16;                  // 16-wide steps over K
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int c0 = warp * 16;                // the warp's value columns
  const bf16* qp = a.q + b * a.sq[0] + h * a.sq[2];
  const bf16* kp = a.k + b * a.sk[0] + h * a.sk[2];
  const bf16* vp = a.v + b * a.sv[0] + h * a.sv[2];
  bf16* As = smem + STAGES * stage_elems(K, V);  // A's hi and lo tiles
  const float* lp = a.ld + b * a.sl[0] + h * a.sl[2];
  const int ntiles = (a.S + T - 1) / T;

  // H^T of the warp's 16 columns: hs[nk] rows v = c0 + g (e < 2) and
  // c0 + g + 8 (e >= 2), cols k = 8 nk + 2 tq + (e & 1)
  float hs[DMAX / 8][4];
  const long long hbase = (long long)bh * K * a.V;
#pragma unroll
  for (int nk = 0; nk < DMAX / 8; ++nk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 8 * nk + 2 * tq + (e & 1), vv = c0 + g + 8 * (e >> 1);
      hs[nk][e] = (a.h0 && nk < K / 8) ? a.h0[hbase + kk * a.V + vv] : 0.f;
    }

  auto stage = [&](int j, int st) {
    bf16* Qs = smem + st * stage_elems(K, V);
    load_tile(Qs, qp, a.sq[1], j * T, a.S, K, a.vec);
    load_tile(Qs + T * KP, kp, a.sk[1], j * T, a.S, K, a.vec);
    load_tile(Qs + 2 * T * KP, vp, a.sv[1], j * T, a.S, V, a.vec);
    cp_commit();
  };
  // this lane's two decays of tile j (rows 2 lane, 2 lane + 1)
  auto decays = [&](int j, float& d0, float& d1) {
    const int t = j * T + 2 * lane;
    d0 = t < a.S ? lp[(long long)t * a.sl[1]] : 0.f;
    d1 = t + 1 < a.S ? lp[(long long)(t + 1) * a.sl[1]] : 0.f;
  };

  stage(0, 0);
  float nd0, nd1;
  decays(0, nd0, nd1);
  for (int j = 0; j < ntiles; ++j) {
    const int st = STAGES == 2 ? (j & 1) : 0, t0 = j * T;
    cp_wait_all();
    __syncthreads();  // tile j has landed; tile j - 1 is no longer read
    if (STAGES == 2 && j + 1 < ntiles) stage(j + 1, st ^ 1);
    const bf16* Qs = smem + st * stage_elems(K, V);
    const bf16* Ks = Qs + T * KP;
    const bf16* Vs = Ks + T * KP;

    // cumulative log decay: cum[2 lane] = ce, cum[2 lane + 1] = co
    const float d0 = nd0, d1 = nd1;
    if (j + 1 < ntiles) decays(j + 1, nd0, nd1);
    float inc = d0 + d1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += y;
    }
    float ex = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) ex = 0.f;
    const float ce = ex + d0, co = ce + d1;
    const float cl = __shfl_sync(0xffffffffu, co, 31);
    // cum at row 16 i + g + 8 hh of the tile
    auto cum_row = [&](int i, int hh) {
      const int src = 8 * i + 4 * hh + (g >> 1);
      const float e0 = __shfl_sync(0xffffffffu, ce, src);
      const float e1 = __shfl_sync(0xffffffffu, co, src);
      return (g & 1) ? e1 : e0;
    };
    // cum at columns 16 sb + 8 n + 2 tq + e: cc[2 n + e]
    auto cum_cols = [&](int sb, float (&cc)[4]) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int src = 8 * sb + 4 * n + tq;
        cc[2 * n] = __shfl_sync(0xffffffffu, ce, src);
        cc[2 * n + 1] = __shfl_sync(0xffffffffu, co, src);
      }
    };

    // the Q fragments of row tile i
    auto q_frags = [&](int i, uint32_t (&qa)[DMAX / 16][4]) {
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks)
        if (ks < nks)
          ldsm_x4(qa[ks], Qs + (16 * i + (lane & 15)) * KP + ks * 16 +
                              (lane >> 4) * 8);
    };
    // A = S o exp(cum[t] - cum[s]) on s <= t for row tile i and key block
    // sb, as A fragments (hi, lo); r0, r1: cum at the lane's two rows
    auto form_a = [&](int i, int sb, const uint32_t (&qa)[DMAX / 16][4],
                      float r0, float r1, uint32_t (&ahi)[4],
                      uint32_t (&alo)[4]) {
      float sc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks) {
        if (ks >= nks) break;
        uint32_t bk[4];
        ldsm_x4(bk, Ks + (sb * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma(sc[0], qa[ks], bk[0], bk[1]);
        mma(sc[1], qa[ks], bk[2], bk[3]);
      }
      float cc[4];
      cum_cols(sb, cc);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float x[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float r = hh ? r1 : r0;
            x[e] = sc[n][2 * hh + e] * exp2f((r - cc[2 * n + e]) * LOG2E);
            // above the diagonal: no pair (the exponent may be > 0)
            if (sb == i && 8 * n + 2 * tq + e > g + 8 * hh) x[e] = 0.f;
          }
          split(x[0], x[1], ahi[2 * n + hh], alo[2 * n + hh]);
        }
    };

    // the block forms A once: warp w takes pairs w, w + warps, ... of the
    // 10 (row tile i, key block sb <= i), p = i (i + 1) / 2 + sb
    for (int p = warp; p < PAIRS; p += blockDim.x / 32) {
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= p) ++i;
      const int sb = p - i * (i + 1) / 2;
      uint32_t qa[DMAX / 16][4], ahi[4], alo[4];
      q_frags(i, qa);
      form_a(i, sb, qa, cum_row(i, 0), cum_row(i, 1), ahi, alo);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int off = (16 * i + g + 8 * hh) * AP + 16 * sb + 8 * n + 2 * tq;
          *reinterpret_cast<uint32_t*>(As + off) = ahi[2 * n + hh];
          *reinterpret_cast<uint32_t*>(As + T * AP + off) = alo[2 * n + hh];
        }
    }
    __syncthreads();  // A is formed

    // o = exp(cum[t]) Q H: H's B fragments (hi, lo) from the accumulators
    float o[T / 16][2][4];
#pragma unroll
    for (int i = 0; i < T / 16; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DMAX / 16; ++ks) {
      if (ks >= nks) break;
      uint32_t hb[2][2][2];  // [value tile n][hi, lo][b0, b1]
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          split(hs[2 * ks + half][2 * n], hs[2 * ks + half][2 * n + 1],
                hb[n][0][half], hb[n][1][half]);
#pragma unroll
      for (int i = 0; i < T / 16; ++i) {
        uint32_t qa[4];
        ldsm_x4(qa, Qs + (16 * i + (lane & 15)) * KP + ks * 16 +
                        (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma(o[i][n], qa, hb[n][0][0], hb[n][0][1]);
          mma(o[i][n], qa, hb[n][1][0], hb[n][1][1]);
        }
      }
    }

    // o += A V, row tile by row tile; only key blocks at or below the
    // diagonal
#pragma unroll
    for (int i = 0; i < T / 16; ++i) {
      const float r0 = cum_row(i, 0), r1 = cum_row(i, 1);
      const float e0 = exp2f(r0 * LOG2E), e1 = exp2f(r1 * LOG2E);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        o[i][n][0] *= e0;
        o[i][n][1] *= e0;
        o[i][n][2] *= e1;
        o[i][n][3] *= e1;
      }
#pragma unroll
      for (int sb = 0; sb <= i; ++sb) {
        uint32_t ahi[4], alo[4];
        ldsm_x4(ahi, As + (16 * i + (lane & 15)) * AP + 16 * sb +
                         (lane >> 4) * 8);
        ldsm_x4(alo, As + T * AP + (16 * i + (lane & 15)) * AP + 16 * sb +
                         (lane >> 4) * 8);
        uint32_t bv[4];
        ldsm_x4_t(bv, Vs + (sb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              VP + c0 + (lane >> 4) * 8);
        mma(o[i][0], ahi, bv[0], bv[1]);
        mma(o[i][1], ahi, bv[2], bv[3]);
        mma(o[i][0], alo, bv[0], bv[1]);
        mma(o[i][1], alo, bv[2], bv[3]);
      }
      // rows 16 i + g and 16 i + g + 8, columns c0 + 8 n + 2 tq (+1)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 16 * i + g + 8 * hh;
        if (t >= a.S) continue;
        bf16* orow = a.o + (((long long)b * a.S + t) * a.H + h) * V + c0 +
                     2 * tq;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
              __floats2bfloat162_rn(o[i][n][2 * hh], o[i][n][2 * hh + 1]);
      }
    }

    // H^T <- exp(cl) H^T + V^T (K o w), w_s = exp(cl - cum[s])
    const float ecl = exp2f(cl * LOG2E);
#pragma unroll
    for (int nk = 0; nk < DMAX / 8; ++nk)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[nk][e] *= ecl;
#pragma unroll
    for (int ss = 0; ss < T / 16; ++ss) {
      float cc[4], w[4];
      cum_cols(ss, cc);
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = exp2f((cl - cc[e]) * LOG2E);
      uint32_t va[4];
      ldsm_x4_t(va, Vs + (ss * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * VP +
                        c0 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < DMAX / 16; ++np) {
        if (np >= nks) break;
        uint32_t bk[4];
        ldsm_x4_t(bk, Ks + (ss * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              KP + 16 * np + (lane >> 4) * 8);
        // bk[2 m + r]: key tile 2 np + m, rows s = 16 ss + 8 r + 2 tq (+1)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t hi[2], lo[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 kv = unpack(bk[2 * m + r]);
            split(kv.x * w[2 * r], kv.y * w[2 * r + 1], hi[r], lo[r]);
          }
          mma(hs[2 * np + m], va, hi[0], hi[1]);
          mma(hs[2 * np + m], va, lo[0], lo[1]);
        }
      }
    }
    if (STAGES == 1 && j + 1 < ntiles) {
      __syncthreads();  // every warp is done with the tile
      stage(j + 1, 0);
    }
  }

#pragma unroll
  for (int nk = 0; nk < DMAX / 8; ++nk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 8 * nk + 2 * tq + (e & 1), vv = c0 + g + 8 * (e >> 1);
      if (nk < K / 8) a.hT[hbase + kk * a.V + vv] = hs[nk][e];
    }
}

bool aligned16(const void* p, const long long* st) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if ((st[i] * 2) % 16) return false;
  return true;
}

}  // namespace

// q, k (B, S, H, K) and v (B, S, H, V) bf16 with unit stride over their last
// dim and the given strides (in elements) over batch, sequence and head;
// log_decay float32 (B, S, H); h0 (B, H, K, V) float32 contiguous or null; o
// (B, S, H, V) bf16 and hT (B, H, K, V) float32 contiguous. K, V in {16,
// 32, 48, 64}.
extern "C" int gla_ssd_fwd(
    const void* q, const void* k, const void* v, const void* ld,
    const void* h0, void* o, void* hT, int B, int S, int H,
    int K, int V, int sqb, int sqs, int sqh, int skb, int sks, int skh,
    int svb, int svs, int svh, int slb, int sls, int slh, void* stream) {
  if (K < 16 || K > DMAX || K % 16 || V < 16 || V > DMAX || V % 16 ||
      S < 0 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const float*>(ld),
         static_cast<const float*>(h0), static_cast<bf16*>(o),
         static_cast<float*>(hT), B, S, H, K, V, {sqb, sqs, sqh},
         {skb, sks, skh}, {svb, svs, svh}, {slb, sls, slh}, 0};
  a.vec = aligned16(q, a.sq) && aligned16(k, a.sk) && aligned16(v, a.sv);
  const size_t smem =
      sizeof(bf16) * (GLA_STAGES * stage_elems(K, V) + 2 * T * AP);
  const cudaError_t err = cudaFuncSetAttribute(
      gla_ssd_kernel<GLA_STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gla_ssd_kernel<GLA_STAGES><<<(unsigned)blocks, 32 * (V / 16), smem,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
