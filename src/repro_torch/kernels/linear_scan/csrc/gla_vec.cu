// Chunked gated linear attention for Hopper (sm_90a), the tensor-core route
// for RWKV6's per-channel decay: bf16 q, k and v, a float32 log decay per
// (batch, position, head, key channel), an optional float32 bonus u (H, K),
// the strict (h_{t-1}) or the inclusive mode, K and V in {16, 32, 48, 64}.
// Mamba2's scalar decay goes to gla_ssd.cu; float32, other widths and a
// bf16 scalar decay with the bonus or the strict mode to gla_scan.cu (the
// same tiles in split TF32).
//
// Replaces, with gla_ssd.cu and gla_scan.cu, the TPU kernel
// src/repro/kernels/linear_scan/kernel.py:71, gla_pallas (body _gla_kernel),
// in its RWKV6 mode, and computes what ref.gla_chunked computes: the output
// and the float32 final (K, V) state, from an optional initial state. A chunk
// is taken in tiles of T = 64 rows and the state passes at tile boundaries:
// the same function, other rounding.
//
// What bounds it on this card: bytes. RWKV6-7B's serving prefill (B = 4, S =
// 1,024, H = 64, K = V = 64, bonus, strict) must read q, k and v in bf16 and
// the float32 decay once and write o: 0.206 GB, 0.0614 ms at 3.35 TB/s. Its
// 7.0 GFLOP (0.0071 ms at 989 TFLOP/s) become ~17 GFLOP of mma here, since
// every product takes split operands.
//
// What the design does about it:
// - The per-channel decay. exp(cum_q[t, k] - cum[s, k]) over (t, s, k) is no
//   single matrix product. A tile is cut into four 16-row sub-blocks. For
//   query sub-block i and key sub-block j < i, with b_j the cumulative log
//   decay at the last row of sub-block j, the decay factors into
//   exp(cum_q[t] - b_j) exp(b_j - cum[s]), both exponents <= 0 in either
//   mode, so neither factor overflows and an underflow to 0 is right to
//   float32's range (the true product is smaller than either factor). So
//   A_ij = (q_i o e^{cum_q - b_j}) (k_j o e^{b_j - cum})^T is one product on
//   the tensor cores; a tile has 6 such pairs. (Factoring through the tile
//   start, e^{cum_q} e^{-cum}, overflows once a tile's decay passes ~88
//   nats.) Within a diagonal sub-block the same factoring through its row 7
//   puts rows 8-15 x columns 0-7 on the tensor cores too (the lower half of
//   a 16 x 8 product whose upper rows are zero), so only its two 8-row
//   triangles take the exact pairwise form, on the CUDA cores: 4 x 2 x 28 x
//   K exponentials a tile where the whole tile's pairs take 64 x 63 / 2 x
//   K (the first port's CUDA-core gla_scan.cu). A warp
//   forms a diagonal sub-block with the key channels split over its lanes
//   (two a lane), rows r and r + 8 at a time, summed over the lanes by a
//   reduce-scatter of 16 shuffles. The bonus goes on A's diagonal: A[t, t]
//   = sum_k q k u (strict) or sum_k q k (1 + u) (inclusive).
// - Tensor cores for every other product: mma.sync.m16n8k16 bf16 with
//   float32 accumulators. The scores of the 6 pairs, the inter-tile term
//   (q o e^{cum_q}) H, A V, and the state update H^T <- H^T diag(e^{cum_last})
//   + V^T (k o e^{cum_last - cum}).
// - Precision. Both operands of the scores and of the inter-tile term are
//   float32 scaled values: each is split into a bf16 high part and a bf16
//   residual and takes three products (hi hi + hi lo + lo hi). A V and the
//   state update take one float32 operand (A, k o w) against bf16 v: two
//   products. The limit stays 1e-4 of max|o| plus one bf16 ulp and 1e-4 of
//   max|state|. Exponentials are ex2.approx on log2-scaled cumulative sums.
// - Layout (gla_ssd.cu's): one block of V / 16 warps per (batch, head); warp
//   w owns 16 value columns and keeps its slice of H^T in mma accumulators
//   for the whole sequence. A tile's A (hi, lo), q o e^{cum_q} and
//   k o e^{cum_last - cum} are formed once a block into shared memory and
//   every warp reads its fragments by ldmatrix. The forming is dealt to the
//   warps in four tasks of a diagonal sub-block and one or two pairs that
//   share k_j o e^{b_j - cum}.
// - Loads: the Tensor Memory Accelerator. Four tensor copies a tile (q, k,
//   the decay and v; one thread issues them), each a box of the tile's rows
//   at the shared tiles' pitch, the padding columns and the rows past S
//   filled with zeros, complete on an mbarrier. Once a tile's A and scaled
//   operands are formed its q, k and decay are no longer read, so the next
//   tile's copies run under this tile's products (v double-buffered).
//   Element loads where a base or a stride is not a nonzero multiple of 16
//   bytes. The decay's cumulative sum: a warp per 16 channels, a lane per
//   channel and half tile, one shuffle joining the halves. 110 KB of shared
//   memory a block at K = V = 64: two blocks an SM, 256 blocks at RWKV6-7B's
//   shape, one wave.
//
// The choices, timed by tools/gla_probe.py --route vec at RWKV6-7B's serving
// prefill (NVIDIA H100 80GB HBM3, 700.00 W; ms, two rounds alternated in one
// call): shipped 0.2179 / 0.2141; the value columns split over two blocks
// per (batch, head), each forming A again (-DGLA_VSPLIT=2; still two blocks
// an SM by shared memory, so 512 blocks take two waves) 0.5414 / 0.5371;
// the next tile loaded after this tile's products (-DGLA_PREFETCH=0) 0.2232
// / 0.2218; the CUDA-core gla_scan.cu of the time 2.1316 / 2.1306 (its
// split-TF32 redesign: 0.3869 in its own call). By phase (-DGLA_CLOCKS), a
// tile
// takes ~21,400 SM clocks with two blocks an SM: forming A ~15,800 (the
// diagonal sub-blocks 7,100), the products ~5,000. Designs timed on the
// way, then taken out of this source (PERF.md §6): the first version
// (pairs dealt 3 / 2 / 1 / 0 to the warps, whole 16-row diagonal
// sub-blocks a row at a time, a two-pass cumulative sum, cp.async loads)
// 0.2940 / 0.2913; whole 16-row diagonal sub-blocks two rows at a time
// 0.2553 / 0.2545 against the 8-row split's 0.2296 / 0.2280; 4-row
// triangles with two more 4 x 4 quadrants on the tensor cores 0.2172 /
// 0.2159 against 0.2159 / 0.2155; cp.async loads (16-byte pieces, their
// issue holding the warps ~3,000 clocks a tile) 0.2272 / 0.2277, and one
// bulk copy a row (256 a tile through one TMA unit) 0.3231 / 0.3175, each
// in its own call (the CUDA-core gla_scan.cu within 0.5% across the
// calls); the middle
// sub-blocks' q o e^{cum_q} and k o e^{cum_last - cum} from the pairs'
// operands 0.2489 / 0.2440.
#include <cuda.h>  // CUtensorMap (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GLA_VSPLIT
#define GLA_VSPLIT 1  // blocks per (batch, head), each V / GLA_VSPLIT columns
#endif
#ifndef GLA_PREFETCH
#define GLA_PREFETCH 1  // the next tile loads while this tile's products run
#endif

#ifdef GLA_CLOCKS
// SM clocks of each phase of a tile, summed over the tiles, per warp of
// block 0 (tools/gla_probe.py --clocks reads them through gla_vec_clocks)
constexpr int NPHASE = 9;
__device__ unsigned long long gla_clocks[NPHASE][4];
#define CLK(ph)                       \
  do {                                \
    const long long now = clock64();  \
    clk[ph] += now - clk0;            \
    clk0 = now;                       \
  } while (0)
#else
#define CLK(ph)
#endif

namespace {

constexpr int T = 64;         // rows of a tile
constexpr int SB = 16;        // rows of a sub-block
constexpr int NSB = T / SB;   // sub-blocks of a tile
constexpr int DMAX = 64;      // largest K and V
constexpr int AP = T + 8;     // pitch of the shared A tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* ld;      // (B, S, H, K) log decay
  const float* u;       // (H, K) bonus or null
  const float* h0;      // (B, H, K, V) or null
  bf16* o;              // (B, S, H, V) contiguous
  float* hT;            // (B, H, K, V) contiguous
  int B, S, H, K, V;
  long long sq[3], sk[3], sv[3], sl[3];  // strides over (batch, seq, head)
  int strict;
  int vec;              // q, k, v and the decay come by tensor copies
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Bulk copies (the Tensor Memory Accelerator) into shared memory that
// complete on an mbarrier, which counts the bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive, and expect `bytes` more of the phase's copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one box of a 4-d tensor map at coordinates (c0, c1, c2, c3) into shared
// memory (128-byte aligned); elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// order this thread's shared-memory accesses before later bulk copies
// into the same memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// 2^x (flushes results below float32's normal range to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

__device__ __forceinline__ float2 pair(const bf16* p) {
  return unpack(*reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ float2 pairf(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Rows [r0, r0 + T) of one head, C elements a row (a multiple of 16
// bytes), into a tile of pitch P elements by element loads; rows at or past
// `limit` read as zero.
template <typename E>
__device__ __forceinline__ void load_rows(E* dst, const E* src,
                                          long long row_stride, int r0,
                                          int limit, int C, int P) {
  constexpr int PER = 16 / sizeof(E);
  const int pieces = C / PER;
  for (int idx = threadIdx.x; idx < T * pieces; idx += blockDim.x) {
    const int r = idx / pieces, c = (idx % pieces) * PER;
    E* s = dst + r * P + c;
    if (r0 + r < limit) {
      const E* g = src + (long long)(r0 + r) * row_stride + c;
#pragma unroll
      for (int i = 0; i < PER; ++i) s[i] = g[i];
    } else {
      *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Sum p over the warp's lanes, entry by entry: lanes 2 m and 2 m + 1
// return the sum of p[m] (a reduce-scatter, 16 shuffles in 5 rounds).
__device__ __forceinline__ float reduce_scatter16(const float (&p)[16],
                                                  int lane) {
  float a8[8], a4[4], a2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    a8[i] = (b4 ? p[i + 8] : p[i]) +
            __shfl_xor_sync(FULL, b4 ? p[i] : p[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a4[i] = (b3 ? a8[i + 4] : a8[i]) +
            __shfl_xor_sync(FULL, b3 ? a8[i] : a8[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a2[i] = (b2 ? a4[i + 2] : a4[i]) +
            __shfl_xor_sync(FULL, b2 ? a4[i] : a4[i + 2], 4);
  const float a1 =
      (b1 ? a2[1] : a2[0]) + __shfl_xor_sync(FULL, b1 ? a2[0] : a2[1], 2);
  return a1 + __shfl_xor_sync(FULL, a1, 1);
}

__host__ __device__ constexpr size_t smem_bytes(int K, int V) {
  // q, k, q o e^{cum_q} (hi, lo), k o e^{cl - cum} (hi, lo); v twice; A (hi,
  // lo); then float: the cumulative decay and e^{cl}; the copies' mbarrier
  return sizeof(bf16) * ((size_t)6 * T * (K + 8) + (size_t)2 * T * (V + 8) +
                         (size_t)2 * T * AP) +
         sizeof(float) * ((size_t)T * (K + 8) + DMAX) + sizeof(uint64_t);
}

// the tensor maps of q, k, the decay and v: dims (channel, head, sequence,
// batch), a box of (channels + 8, 1, T, 1): a tile's rows at the tiles'
// pitch, the 8 padding columns and the rows past S filled with zeros
struct Maps {
  CUtensorMap q, k, ld, v;
};

__global__ void __launch_bounds__(128, 2)
    gla_vec_kernel(const Args a, const __grid_constant__ Maps m) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int K = a.K, KP = K + 8, CP = K + 8, V = a.V, VP = V + 8;
  const int nks = K / 16;                  // 16-wide steps over K
  const int NW = blockDim.x / 32;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + T * KP;
  bf16* QHh = Ks + T * KP;                 // q o e^{cum_q}, hi and lo
  bf16* QHl = QHh + T * KP;
  bf16* KBh = QHl + T * KP;                // k o e^{cum_last - cum}
  bf16* KBl = KBh + T * KP;
  bf16* Vbuf = KBl + T * KP;               // two v tiles
  bf16* Ah = Vbuf + 2 * T * VP;            // A, hi and lo
  bf16* Al = Ah + T * AP;
  float* Cs = reinterpret_cast<float*>(Al + T * AP);  // cumulative log2 decay
  float* ecl = Cs + T * CP;                // 2^{cum_last}
  uint64_t* bar = reinterpret_cast<uint64_t*>(ecl + DMAX);

  const int bh = blockIdx.x / GLA_VSPLIT, part = blockIdx.x % GLA_VSPLIT;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int c0 = part * (V / GLA_VSPLIT) + warp * 16;  // the warp's columns
  const bf16* qp = a.q + b * a.sq[0] + h * a.sq[2];
  const bf16* kp = a.k + b * a.sk[0] + h * a.sk[2];
  const bf16* vp = a.v + b * a.sv[0] + h * a.sv[2];
  const float* lp = a.ld + b * a.sl[0] + h * a.sl[2];
  const int ntiles = (a.S + T - 1) / T;

  // H^T of the warp's 16 columns: hs[nk] rows v = c0 + g (e < 2) and
  // c0 + g + 8 (e >= 2), cols k = 8 nk + 2 tq + (e & 1)
  float hs[DMAX / 8][4];
  const long long hbase = (long long)bh * K * V;
#pragma unroll
  for (int nk = 0; nk < DMAX / 8; ++nk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 8 * nk + 2 * tq + (e & 1), vv = c0 + g + 8 * (e >> 1);
      hs[nk][e] = (a.h0 && nk < K / 8) ? a.h0[hbase + kk * V + vv] : 0.f;
    }

  // the lane's two key channels in the diagonal blocks, and their diagonal
  // weight: 1 (inclusive) or 0 (strict), plus the bonus
  const int kc = 2 * lane;
  const bool has = kc < K;
  float dk0 = 0.f, dk1 = 0.f;
  if (has) {
    dk0 = dk1 = a.strict ? 0.f : 1.f;
    if (a.u) {
      dk0 += a.u[(long long)h * K + kc];
      dk1 += a.u[(long long)h * K + kc + 1];
    }
  }

  // query-side cumulative log2 decay at row t, channels kk and kk + 1
  auto cum_q = [&](int t, int kk) -> float2 {
    const int r = a.strict ? t - 1 : t;
    return r < 0 ? make_float2(0.f, 0.f) : pairf(Cs + r * CP + kk);
  };
  // tile j's q, k, decay and v: four tensor copies (thread 0 issues them)
  // where bases and strides allow, else element loads
  auto stage = [&](int j) {
    bf16* Vd = Vbuf + (j & 1) * T * VP;
    if (a.vec) {
      if (tid == 0) {
        mbar_expect(bar, T * (2 * 2 * KP + 4 * CP + 2 * VP));
        tma_load(Qs, &m.q, 0, h, j * T, b, bar);
        tma_load(Ks, &m.k, 0, h, j * T, b, bar);
        tma_load(Cs, &m.ld, 0, h, j * T, b, bar);
        tma_load(Vd, &m.v, 0, h, j * T, b, bar);
      }
    } else {
      load_rows(Qs, qp, a.sq[1], j * T, a.S, K, KP);
      load_rows(Ks, kp, a.sk[1], j * T, a.S, K, KP);
      load_rows(Cs, lp, a.sl[1], j * T, a.S, K, CP);
      load_rows(Vd, vp, a.sv[1], j * T, a.S, V, VP);
    }
  };
  if (tid == 0) mbar_init(bar);
  // the diagonal sub-blocks' upper-right 8 x 8 quadrants stay zero
  for (int i = tid; i < NSB * 64; i += blockDim.x) {
    const int w = i / 64, r = (i / 8) % 8, c = i % 8;
    const int off = (SB * w + r) * AP + SB * w + 8 + c;
    Ah[off] = Al[off] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();  // the mbarrier is initialised

  if (ntiles > 0) stage(0);
#ifdef GLA_CLOCKS
  long long clk0 = clock64(), clk[NPHASE] = {};
#endif
  for (int j = 0; j < ntiles; ++j) {
    const int t0 = j * T;
    if (a.vec) mbar_wait(bar, j & 1);
    __syncthreads();  // tile j has landed; tile j - 1 is no longer read
    CLK(0);
    const bf16* Vs = Vbuf + (j & 1) * T * VP;

    // cumulative log2 decay, in place: a warp takes 16 channels, a lane one
    // channel's upper or lower 32 rows; the lower half adds the upper's
    // total
    for (int cg = warp; cg < K / 16; cg += NW) {
      float* c = Cs + (lane >> 4) * 32 * CP + 16 * cg + (lane & 15);
      float x[32], run = 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) x[r] = c[r * CP];
#pragma unroll
      for (int r = 0; r < 32; ++r) x[r] = run = fmaf(x[r], LOG2E, run);
      const float top = __shfl_sync(FULL, run, lane & 15);
      const float off = lane & 16 ? top : 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) c[r * CP] = x[r] + off;
    }
    __syncthreads();
    CLK(1);

    // e^{cum_last}; q o e^{cum_q} and k o e^{cum_last - cum} as hi + lo
    for (int kk = tid; kk < K; kk += blockDim.x)
      ecl[kk] = ex2(Cs[(T - 1) * CP + kk]);
    for (int base = tid; base < T * K / 2; base += 8 * blockDim.x) {
      // eight pairs' loads first, then their products and stores
      float2 qv[8], kv[8], cq[8], cs[8], cl[8];
      int at[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = min(base + u * (int)blockDim.x, T * K / 2 - 1);
        const int t = idx / (K / 2), kk = 2 * (idx % (K / 2));
        at[u] = t * KP + kk;
        qv[u] = pair(Qs + at[u]), kv[u] = pair(Ks + at[u]);
        cq[u] = cum_q(t, kk), cs[u] = pairf(Cs + t * CP + kk);
        cl[u] = pairf(Cs + (T - 1) * CP + kk);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (base + u * (int)blockDim.x >= T * K / 2) break;
        uint32_t hi, lo;
        split(qv[u].x * ex2(cq[u].x), qv[u].y * ex2(cq[u].y), hi, lo);
        *reinterpret_cast<uint32_t*>(QHh + at[u]) = hi;
        *reinterpret_cast<uint32_t*>(QHl + at[u]) = lo;
        split(kv[u].x * ex2(cl[u].x - cs[u].x),
              kv[u].y * ex2(cl[u].y - cs[u].y), hi, lo);
        *reinterpret_cast<uint32_t*>(KBh + at[u]) = hi;
        *reinterpret_cast<uint32_t*>(KBl + at[u]) = lo;
      }
    }
    CLK(2);

    // A in four tasks, dealt to the warps: task w forms the diagonal
    // sub-block (w, w), then its pairs (i, j), which share k_j o e^{b_j -
    // cum}: task 0 (1, 0) and (2, 0); 1 (2, 1) and (3, 1); 2 (3, 2); 3 (3, 0)
    static_assert(NSB == 4, "the tasks below deal out four sub-blocks");
    for (int w = warp; w < NSB; w += NW) {
      int r0 = w * SB;
      {
        // exact pairwise decay, the lane's two channels; the 16 rows' k
        // and cum in registers
        float kf[SB][2], cs[SB][2];
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          const float2 kv = has ? pair(Ks + (r0 + s) * KP + kc)
                                : make_float2(0.f, 0.f);
          const float2 c = has ? pairf(Cs + (r0 + s) * CP + kc)
                               : make_float2(0.f, 0.f);
          kf[s][0] = kv.x, kf[s][1] = kv.y, cs[s][0] = c.x, cs[s][1] = c.y;
        }
        // the two 8 x 8 diagonal triangles, rows r and r + 8 at a time:
        // lanes 2 m and 2 m + 1 end with A at row r + 8 (m >> 3), column m
        // of the sub-block
        float xr[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float p[SB];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int rr = r + 8 * hh;
            const float2 qv = has ? pair(Qs + (r0 + rr) * KP + kc)
                                  : make_float2(0.f, 0.f);
            const float2 cq = has ? cum_q(r0 + rr, kc)
                                  : make_float2(0.f, 0.f);
#pragma unroll
            for (int s = 8 * hh; s < 8 * hh + 8; ++s) {
              float x = 0.f;
              if (s < rr)
                x = qv.x * kf[s][0] * ex2(cq.x - cs[s][0]) +
                    qv.y * kf[s][1] * ex2(cq.y - cs[s][1]);
              else if (s == rr)
                x = qv.x * kf[s][0] * dk0 + qv.y * kf[s][1] * dk1;
              p[s] = x;
            }
          }
          xr[r] = reduce_scatter16(p, lane);
        }
        // the quadrant rows 8-15 x columns 0-7, through b = cum at the
        // sub-block's row 7, as the lower half of a 16 x 8 product (the
        // upper half's rows are zero)
        {
          const float* bq = Cs + (r0 + 7) * CP;
          float sc[4] = {};
#pragma unroll
          for (int ks = 0; ks < DMAX / 16; ++ks) {
            if (ks >= nks) break;
            uint32_t qh[4] = {}, ql[4] = {}, kh[2], kl[2];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int kk = 16 * ks + 2 * tq + 8 * half;
              const int t = r0 + 8 + g, s = r0 + g;
              const float2 qv = pair(Qs + t * KP + kk), cq = cum_q(t, kk);
              const float2 kv = pair(Ks + s * KP + kk);
              const float2 c = pairf(Cs + s * CP + kk), bb = pairf(bq + kk);
              split(qv.x * ex2(cq.x - bb.x), qv.y * ex2(cq.y - bb.y),
                    qh[1 + 2 * half], ql[1 + 2 * half]);
              split(kv.x * ex2(bb.x - c.x), kv.y * ex2(bb.y - c.y), kh[half],
                    kl[half]);
            }
            mma(sc, qh, kh[0], kh[1]);
            mma(sc, qh, kl[0], kl[1]);
            mma(sc, ql, kh[0], kh[1]);
          }
          uint32_t hi, lo;
          split(sc[2], sc[3], hi, lo);
          const int off = (r0 + 8 + g) * AP + r0 + 2 * tq;
          *reinterpret_cast<uint32_t*>(Ah + off) = hi;
          *reinterpret_cast<uint32_t*>(Al + off) = lo;
        }
        if (!(lane & 1)) {
          const int m = lane >> 1;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const bf16 xh = __float2bfloat16_rn(xr[r]);
            const int off = (r0 + r + 8 * (m >> 3)) * AP + r0 + m;
            Ah[off] = xh;
            Al[off] = __float2bfloat16_rn(xr[r] - __bfloat162float(xh));
          }
        }
      }
      CLK(3);
      const int jb = w == 3 ? 0 : w, i0 = w == 3 ? 3 : w + 1;
      const int i1 = w == 0 ? 2 : 3;
      r0 = jb * SB;
      // k_j o e^{b_j - cum} as B fragments (hi, lo): kb[ks][n][hi/lo][b0/b1],
      // key rows r0 + 8 n + g, channels 16 ks + 2 tq (+8)
      const float* bj = Cs + (r0 + SB - 1) * CP;
      uint32_t kb[DMAX / 16][2][2][2];
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks) {
        if (ks >= nks) break;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int s = r0 + 8 * n + g, kk = 16 * ks + 2 * tq + 8 * half;
            const float2 kv = pair(Ks + s * KP + kk);
            const float2 c = pairf(Cs + s * CP + kk), bb = pairf(bj + kk);
            split(kv.x * ex2(bb.x - c.x), kv.y * ex2(bb.y - c.y),
                  kb[ks][n][0][half], kb[ks][n][1][half]);
          }
      }
      // the task's one or two pairs' scores, then their stores
      float sc[2][2][4] = {};
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        const int i = i0 + pi;
        if (i > i1) break;
#pragma unroll
        for (int ks = 0; ks < DMAX / 16; ++ks) {
          if (ks >= nks) break;
          // q_i o e^{cum_q - b} as an A fragment (hi, lo)
          uint32_t qh[4], ql[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = SB * i + g + 8 * (e & 1);
            const int kk = 16 * ks + 2 * tq + 8 * (e >> 1);
            const float2 qv = pair(Qs + t * KP + kk);
            const float2 cq = cum_q(t, kk), bb = pairf(bj + kk);
            split(qv.x * ex2(cq.x - bb.x), qv.y * ex2(cq.y - bb.y), qh[e],
                  ql[e]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma(sc[pi][n], qh, kb[ks][n][0][0], kb[ks][n][0][1]);
            mma(sc[pi][n], qh, kb[ks][n][1][0], kb[ks][n][1][1]);
            mma(sc[pi][n], ql, kb[ks][n][0][0], kb[ks][n][0][1]);
          }
        }
      }
#pragma unroll
      for (int pi = 0; pi < 2; ++pi) {
        if (i0 + pi > i1) break;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            uint32_t hi, lo;
            split(sc[pi][n][2 * hh], sc[pi][n][2 * hh + 1], hi, lo);
            const int off =
                (SB * (i0 + pi) + g + 8 * hh) * AP + r0 + 8 * n + 2 * tq;
            *reinterpret_cast<uint32_t*>(Ah + off) = hi;
            *reinterpret_cast<uint32_t*>(Al + off) = lo;
          }
      }
      CLK(4);
    }
    // this tile's reads of q, k and the decay (and the last tile's of v)
    // come before the bulk copies that overwrite them
    fence_proxy_async();
    __syncthreads();  // A and the scaled operands are formed
    if (GLA_PREFETCH && j + 1 < ntiles) stage(j + 1);
    CLK(5);

    // o = (q o e^{cum_q}) H: H's B fragments (hi, lo) from the accumulators
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
        uint32_t qh[4], ql[4];
        const int off = (16 * i + (lane & 15)) * KP + ks * 16 + (lane >> 4) * 8;
        ldsm_x4(qh, QHh + off);
        ldsm_x4(ql, QHl + off);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma(o[i][n], qh, hb[n][0][0], hb[n][0][1]);
          mma(o[i][n], qh, hb[n][1][0], hb[n][1][1]);
          mma(o[i][n], ql, hb[n][0][0], hb[n][0][1]);
        }
      }
    }

    CLK(6);
    // o += A V, row tile by row tile; only key blocks at or below the
    // diagonal
#pragma unroll
    for (int i = 0; i < T / 16; ++i) {
#pragma unroll
      for (int sb = 0; sb <= i; ++sb) {
        uint32_t ahi[4], alo[4], bv[4];
        const int off = (16 * i + (lane & 15)) * AP + 16 * sb + (lane >> 4) * 8;
        ldsm_x4(ahi, Ah + off);
        ldsm_x4(alo, Al + off);
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

    CLK(7);
    // H^T <- H^T diag(e^{cl}) + V^T (k o e^{cl - cum})
#pragma unroll
    for (int nk = 0; nk < DMAX / 8; ++nk) {
      if (nk >= K / 8) break;
      const float2 e = pairf(ecl + 8 * nk + 2 * tq);
      hs[nk][0] *= e.x;
      hs[nk][1] *= e.y;
      hs[nk][2] *= e.x;
      hs[nk][3] *= e.y;
    }
#pragma unroll
    for (int ss = 0; ss < T / 16; ++ss) {
      uint32_t va[4];
      ldsm_x4_t(va, Vs + (ss * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * VP +
                        c0 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < DMAX / 16; ++np) {
        if (np >= nks) break;
        // [2 m + r]: key tile 2 np + m, rows s = 16 ss + 8 r + 2 tq (+1)
        uint32_t bh_[4], bl_[4];
        const int off = (ss * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KP +
                        16 * np + (lane >> 4) * 8;
        ldsm_x4_t(bh_, KBh + off);
        ldsm_x4_t(bl_, KBl + off);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma(hs[2 * np + m], va, bh_[2 * m], bh_[2 * m + 1]);
          mma(hs[2 * np + m], va, bl_[2 * m], bl_[2 * m + 1]);
        }
      }
    }
    CLK(8);
    if (!GLA_PREFETCH && j + 1 < ntiles) {
      fence_proxy_async();
      __syncthreads();  // every warp is done with the tile
      stage(j + 1);
    }
  }

#pragma unroll
  for (int nk = 0; nk < DMAX / 8; ++nk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 8 * nk + 2 * tq + (e & 1), vv = c0 + g + 8 * (e >> 1);
      if (nk < K / 8) a.hT[hbase + kk * V + vv] = hs[nk][e];
    }
#ifdef GLA_CLOCKS
  if (blockIdx.x == 0 && lane == 0)
    for (int ph = 0; ph < NPHASE; ++ph) gla_clocks[ph][warp] += clk[ph];
#endif
}

// bases 16-byte aligned and strides nonzero multiples of 16 bytes: what a
// tensor map takes
bool aligned16(const void* p, const long long* st, int elem) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] <= 0 || (st[i] * elem) % 16) return false;
  return true;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a (B, S, H, C) array with strides st over (batch, sequence,
// head) in elements of `elem` bytes
bool encode(CUtensorMap* map, const void* base, bool bf, int B, int S, int H,
            int C, const long long* st) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const int elem = bf ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(st[2] * elem),
                                 (cuuint64_t)(st[1] * elem),
                                 (cuuint64_t)(st[0] * elem)};
  const cuuint32_t box[4] = {(cuuint32_t)(C + 8), 1, T, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k (B, S, H, K) and v (B, S, H, V) bf16 and log_decay (B, S, H, K)
// float32, with unit stride over their last dim and the given strides (in
// elements) over batch, sequence and head; bonus (H, K) and h0 (B, H, K, V)
// float32 contiguous or null; o (B, S, H, V) bf16 and hT (B, H, K, V)
// float32 contiguous. K, V in {16, 32, 48, 64}.
extern "C" int gla_vec_fwd(
    const void* q, const void* k, const void* v, const void* ld,
    const void* bonus, const void* h0, void* o, void* hT, int B, int S,
    int H, int K, int V, int sqb, int sqs, int sqh, int skb, int sks,
    int skh, int svb, int svs, int svh, int slb, int sls, int slh,
    int strict, void* stream) {
  if (K < 16 || K > DMAX || K % 16 || V < 16 || V > DMAX ||
      V % (16 * GLA_VSPLIT) || S < 0 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
         static_cast<const bf16*>(v), static_cast<const float*>(ld),
         static_cast<const float*>(bonus), static_cast<const float*>(h0),
         static_cast<bf16*>(o), static_cast<float*>(hT), B, S, H, K, V,
         {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh}, {slb, sls, slh},
         strict, 0};
  a.vec = S > 0 && aligned16(q, a.sq, 2) && aligned16(k, a.sk, 2) &&
          aligned16(v, a.sv, 2) && aligned16(ld, a.sl, 4);
  Maps m;
  if (a.vec)
    a.vec = encode(&m.q, q, true, B, S, H, K, a.sq) &&
            encode(&m.k, k, true, B, S, H, K, a.sk) &&
            encode(&m.ld, ld, false, B, S, H, K, a.sl) &&
            encode(&m.v, v, true, B, S, H, V, a.sv);
  const size_t smem = smem_bytes(K, V);
  cudaError_t err = cudaFuncSetAttribute(
      gla_vec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gla_vec_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * GLA_VSPLIT;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gla_vec_kernel<<<(unsigned)blocks, 32 * (V / 16 / GLA_VSPLIT), smem,
                   static_cast<cudaStream_t>(stream)>>>(a, m);
  return (int)cudaGetLastError();
}

#ifdef GLA_CLOCKS
// the phase clocks of the launches since the last call (NPHASE x 4
// unsigned 64-bit), then zero
extern "C" int gla_vec_clocks(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, gla_clocks, sizeof(gla_clocks));
  if (err != cudaSuccess) return (int)err;
  static unsigned long long zeros[NPHASE][4] = {};
  return (int)cudaMemcpyToSymbol(gla_clocks, zeros, sizeof(zeros));
}
#endif
