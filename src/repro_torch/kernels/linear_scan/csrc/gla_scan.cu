// Chunked gated linear attention (GLA) for Hopper (sm_90a), the float32
// route: 64-row tiles on the tensor cores in split TF32 (3xTF32).
//
// Replaces, with gla_ssd.cu (bf16, scalar decay) and gla_vec.cu (bf16,
// per-channel decay), the TPU kernel src/repro/kernels/linear_scan/kernel.py,
// gla_pallas (body _gla_kernel), and computes what ref.gla_chunked computes:
// the output and the float32 final (K, V) state, from an optional initial
// state. It takes every call the two bf16 routes do not: float32 q, k and v
// with a scalar (Mamba2) or a per-channel (RWKV6) decay, with or without the
// bonus u, strict (h_{t-1}) or inclusive; bf16 with a scalar decay and the
// bonus or the strict mode; bf16 at widths outside {16, 32, 48, 64}. K, V <=
// 64, any width (padded with zeros in shared memory to a multiple of 8
// (K) and of 16 (V)). A chunk is taken in tiles of T = 64 rows and the state
// passes at tile boundaries: the same function, other rounding.
//
// What bounds it on this card: operations. Zamba2-7B's layer in float32 (1
// x 1,024 tokens, 112 heads, K = V = 64) does 2.8 GFLOP against 63 MB: the
// bytes take 0.019 ms at 3.35 TB/s, the operations 0.042 ms at float32's 67
// TFLOP/s on the CUDA cores. One TF32 tensor-core product keeps 10 mantissa
// bits and misses the 1e-4 limit; the split product below keeps about 21
// and holds it, at 495 / 3 TFLOP/s of float32-accurate work (a ceiling of
// max(bytes, 3 x ops / 495 TFLOP/s) = 0.019 ms at that call).
//
// What the design does about it:
// - Split TF32 (flash_attention.cu's arithmetic). Every product is
//   mma.sync.m16n8k8 tf32 with float32 accumulators. Each float32 operand x
//   is split as its fragment is loaded: hi = x rounded to TF32 (to nearest,
//   ties away, by two integer operations), lo = x - hi, read truncated by the
//   tensor core; a product is lo.hi + hi.lo + hi.hi (lo.lo dropped). bf16
//   v has no lo part: its products are two. Shared memory holds float32
//   values, one plane.
// - Fragments as 32-bit words. ldmatrix moves 16-bit pairs, so fragments are
//   loaded from shared memory as floats. The k index of an 8-deep product is
//   permuted (k = tq is column 2 tq, k = tq + 4 column 2 tq + 1): an A
//   fragment or a B fragment along its contiguous dim is one float2 a row.
//   Rows read as float2 (q, k, their scaled forms, the decay, A, H^T) have
//   a pitch of 8 mod 16 floats; rows read a column at a time (v and k o
//   e^{cl - cum}, the state update's operands along the sequence) 4 mod 8:
//   both keep a warp's reads on distinct banks.
// - The tensor cores' float32 sums truncate (flash_attention.cu's finding).
//   The state is never an accumulator: each tile's contribution V^T (k o
//   e^{cl - cum}) is summed from zero and merged by one FMA, H^T = H^T
//   e^{cl} + it; each tile's output (q o e^{cum_q}) H + A V is summed from
//   zero too.
// - Scores. Scalar decay: S = Q K^T for the 10 (row tile, key block) pairs
//   on or below the diagonal, each of the three products in an accumulator
//   of its own, then A = S o 2^{cum_q[t] - cum[s]} (every exponent <= 0) and
//   the bonus on the diagonal; e^{cum_q} and e^{cl - cum} once a row.
//   Per-channel decay: gla_vec.cu's factoring (16-row sub-blocks; between
//   sub-blocks i > j the decay as e^{cum_q - b_j} e^{b_j - cum} through the
//   last row b_j of key sub-block j, both exponents <= 0, so an underflow to
//   0 is right to float32's range; the diagonal sub-blocks' quadrant rows
//   8-15 x columns 0-7 through their row 7; their two 8-row triangles, with
//   the bonus, exactly and pairwise on the CUDA cores), in 16 tasks: each
//   triangle pair in two halves of as many pairs (rows 0, 3, 4, 7 and 1, 2,
//   5, 6), the six sub-block pairs one a task, the four quadrants two a
//   task.
// - Layout: one block per (batch, head), four warps per 16 value columns
//   (16 warps at V = 64, 128 registers). Warp (w, r) takes row tile r's
//   output for columns 16 w.. 16 w + 15 and a quarter of those columns'
//   state, H^T's 8-column tiles 2 r and 2 r + 1 (of K / 8), which it keeps
//   in registers and publishes to shared memory at each tile's start, where
//   the inter-tile term reads H. The block forms A, q o e^{cum_q} and k o
//   e^{cum_last - cum} once a tile in shared memory. The next tile's q, k,
//   decay and v load while this tile's products run, v double-buffered: by
//   four tensor copies (the Tensor Memory Accelerator, on an mbarrier; q
//   and k broadcast over the heads with stride 0, Mamba2's, by a map
//   without the head dim) where bases and strides are multiples of 16
//   bytes, else cp.async (4-byte pieces); bf16 by cp.async into a staging
//   tile widened to float at the tile's start, or element loads; a scalar
//   decay into warp 0's registers. 160 KB of shared
//   memory at K = V = 64 with a per-channel decay: one block an SM, and
//   calls of B x H <= 132 blocks (the float32 models' at batch 1 or 2) are
//   one wave.
// - Exponentials are ex2.approx on cumulative sums of the decay in log2
//   units, summed in row order.
//
// The choices, timed by tools/gla_probe.py --route scan (NVIDIA H100 80GB
// HBM3, 700.00 W; ms, two rounds alternated in one call, Zamba2 float32 /
// RWKV6 float32 (2 x 1,024, 64 heads, bonus, strict, from a state)):
// shipped 0.1276, 0.1272 / 0.1512, 0.1505; the parent commit's CUDA-core
// gla_scan.cu 0.9835, 0.9837 / 1.2921, 1.3003; the value columns over two
// blocks a head, each forming A again (-DGLA_VSPLIT=2) 0.2535, 0.2520 /
// 0.2832, 0.2811, over four 0.5887, 0.5878 / 0.6877, 0.6876 (one block an
// SM by shared memory: two and four waves). By phase (-DGLA_CLOCKS), a
// Zamba2 tile takes ~13,300 SM clocks: the tile's wait ~450, the decay's
// scan ~1,000, q o e^{cum_q} and k o e^{cl - cum} ~1,550, A ~3,150 (10 of
// 16 warps), (q o e^{cum_q}) H ~2,250, A V 1,300-2,650 (row tiles 0-3),
// the state update ~3,100. Designs timed on the way in earlier calls, then
// taken out of this source (PERF.md §6): two warps per 16 columns, each
// updating all of their state, loads by cp.async (0.2183 / 0.2491); the
// state split over them through shared memory (0.1820 / 0.2077); with
// tensor copies, one and two warps per 16 columns against four, Zamba2
// 0.2261 / 0.1599 against 0.1326; A, q o e^{cum_q} and k o e^{cl - cum}
// stored split (hi, lo planes) 0.1298 / 0.1705 against 0.1318 / 0.1688; a
// warp per two row tiles and 8 columns (as many pairs each) 0.1385 /
// 0.1625 against 0.1307 / 0.1676.
#include <cuda.h>  // CUtensorMap (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GLA_VSPLIT
#define GLA_VSPLIT 1  // blocks per (batch, head), each V / GLA_VSPLIT columns
#endif

#ifdef GLA_CLOCKS
// SM clocks of each phase of a tile, summed over the tiles, per warp of
// block 0 (tools/gla_probe.py --clocks reads them through gla_scan_clocks)
constexpr int NPHASE = 9;
__device__ unsigned long long gla_clocks[NPHASE][16];
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

constexpr int T = 64;        // rows of a tile
constexpr int SB = 16;       // rows of a sub-block
constexpr int NSB = T / SB;  // sub-blocks of a tile
constexpr int DMAX = 64;     // largest K and V
constexpr int AP = T + 8;    // pitch of the shared A tile
constexpr int RG = 4;        // warps for each 16 value columns
constexpr int MAXT = 32 * (DMAX / 16) / GLA_VSPLIT * RG;
constexpr int NKW = DMAX / 8 / RG;  // a warp's 8-column tiles of H^T
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
typedef __nv_bfloat16 bf16;


struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ld;   // (B, S, H) or (B, S, H, K) log decay
  const float* u;    // (H, K) bonus or null
  const float* h0;   // (B, H, K, V) or null
  void* o;           // (B, S, H, V) contiguous
  float* hT;         // (B, H, K, V) contiguous
  int B, S, H, K, V;
  long long sq[3], sk[3], sv[3], sl[3];  // strides over (batch, seq, head)
  int strict;
  int vq, vl;        // q, k and v (vq) and the decay (vl) load in 16-byte
                     // pieces
  int tma;           // q, k, the decay and v come by tensor copies
  int q3, k3;        // q's or k's map has no head dim (stride 0 over H)
};

// the tensor maps of q, k, the decay and v: dims (channel, head, sequence,
// batch), or (channel, sequence, batch) for an operand broadcast over the
// heads; a box of a tile's rows at the shared tiles' pitch, the padding
// columns and the rows past S filled with zeros
struct Maps {
  CUtensorMap q, k, ld, v;
};

// Widths and pitches (floats) of the shared tiles: K padded to Kp (a
// multiple of 8), pitch KP = 8 mod 16 for rows read as float2, KWP = 4 mod 8
// for k o e^{cl - cum}, read a column at a time; V padded to Vc (16 a
// warp), pitch VP = 4 mod 8.
struct Geo {
  int Kp, KP, KWP, nwv, Vc, VP;
};
__host__ __device__ __forceinline__ Geo geo(int K, int V) {
  Geo g;
  g.Kp = (K + 7) & ~7;
  g.KP = g.Kp | 8;
  g.KWP = g.Kp + 4;
  g.nwv = (V + 15) / 16;
  g.Vc = 16 * g.nwv;
  g.VP = g.Vc + 4;
  return g;
}

__host__ __device__ constexpr size_t smem_floats(const Geo& g, bool vec,
                                                bool bf) {
  // q, k, the decay (a row of K, or one value a row); v twice; A; q o
  // e^{cum_q}; k o e^{cl - cum}; H (rows v); e^{cl}, the bonus; a scalar
  // decay's e^{cum_q} and e^{cl - cum} and the bonus coefficient by row;
  // the copies' mbarrier (four floats); bf16 q, k and v as they arrive
  return (size_t)2 * T * g.KP + (vec ? (size_t)T * g.KP : T) +
         (size_t)2 * T * g.VP + (size_t)T * AP + (size_t)T * g.KP +
         (size_t)T * g.KWP + (size_t)g.Vc * g.KP + 2 * DMAX + 3 * T + 4 +
         (bf ? (size_t)T * (2 * g.Kp + g.Vc) / 2 : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 or 4 bytes from global to shared memory; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
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
// one box of a tensor map at coordinates (c0, c1, c2[, c3]) into shared
// memory (128-byte aligned); elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
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
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          int c0, int c1, int c2,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}
// order this thread's shared-memory accesses before later bulk copies
// into the same memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest with
// ties away from zero: the bits cvt.rna.tf32.f32 gives), lo = x - hi
// exactly, which the tensor core reads truncated to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b for one 16 x 8 x 8 tile: a row-major 16 x 8, b 8 x 8
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the three products of a split product into one sum, small ones first;
// LO_A false: a has no lo part (bf16 v), two products
template <bool LO_A = true>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (LO_A) mma(d, al, bh[0], bh[1]);
  mma(d, ah, bl[0], bl[1]);
  mma(d, ah, bh[0], bh[1]);
}

// 2^x (flushes results below float32's normal range to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 pairf(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// An A fragment (hi, lo) of a 16 x 8 tile at p (row 0, column 0) of pitch
// P, the k index permuted: rows g and g + 8, columns 2 tq and 2 tq + 1
__device__ __forceinline__ void afrag(const float* p, int P, int g, int tq,
                                      uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 x0 = pairf(p + g * P + 2 * tq);
  const float2 x1 = pairf(p + (g + 8) * P + 2 * tq);
  split(x0.x, hi[0], lo[0]);
  split(x1.x, hi[1], lo[1]);
  split(x0.y, hi[2], lo[2]);
  split(x1.y, hi[3], lo[3]);
}

// A B fragment (hi, lo) from a float pair: (k = tq, k = tq + 4)
__device__ __forceinline__ void bsplit(float2 x, uint32_t (&hi)[2],
                                       uint32_t (&lo)[2]) {
  split(x.x, hi[0], lo[0]);
  split(x.y, hi[1], lo[1]);
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename E> __device__ __forceinline__ E from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast does
}

// Rows [r0, r0 + T) of one head, columns [0, C), into a float tile of pitch
// P: columns [C, W) and rows at or past `limit` zero. float32 by cp.async,
// in 16-byte pieces when `vec` (C and W multiples of 4), else 4-byte ones;
// bf16 (whose 16-byte pieces go through the staging tile instead) by
// element loads, eight into registers, then their stores.
template <typename E>
__device__ __forceinline__ void load_rows(float* dst, const E* src,
                                          long long rs, int r0, int limit,
                                          int C, int W, int P, bool vec) {
  const int nt = blockDim.x;
  if constexpr (sizeof(E) == 4) {
    if (vec) {
      const int pieces = W / 4;
      for (int idx = threadIdx.x; idx < T * pieces; idx += nt) {
        const int r = idx / pieces, c = (idx % pieces) * 4;
        const bool ok = r0 + r < limit && c < C;
        cp_async16(dst + r * P + c,
                   src + (ok ? (long long)(r0 + r) * rs + c : 0),
                   ok ? 16 : 0);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < T * W; idx += nt) {
      const int r = idx / W, c = idx % W;
      const bool ok = r0 + r < limit && c < C;
      cp_async4(dst + r * P + c, src + (ok ? (long long)(r0 + r) * rs + c : 0),
                ok ? 4 : 0);
    }
  } else {
    const int n = T * W;
    for (int base = threadIdx.x; base < n; base += 8 * nt) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * nt, r = idx / W, c = idx % W;
        x[u] = (idx < n && r0 + r < limit && c < C)
                   ? to_f(src[(long long)(r0 + r) * rs + c])
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * nt;
        if (idx >= n) break;
        dst[(idx / W) * P + idx % W] = x[u];
      }
    }
  }
}

template <typename E, bool VEC>
__global__ void __launch_bounds__(MAXT)
    gla_scan_kernel(const Args a, const __grid_constant__ Maps m) {
  extern __shared__ __align__(128) float smem[];
  constexpr bool F32 = sizeof(E) == 4;
  const Geo G = geo(a.K, a.V);
  const int K = a.K, V = a.V, Kp = G.Kp, KP = G.KP, KWP = G.KWP, VP = G.VP;
  const int nk8 = Kp / 8;  // 8-deep steps over K
  float* Qs = smem;
  float* Ks = Qs + T * KP;
  float* Cs = Ks + T * KP;                 // decay, then cumulative log2
  float* Vb = Cs + (VEC ? T * KP : T);     // two v tiles
  float* As = Vb + 2 * T * VP;             // A
  float* QE = As + T * AP;                 // q o e^{cum_q}
  float* KW = QE + T * KP;                 // k o e^{cum_last - cum}
  float* Hs = KW + T * KWP;                // H^T: rows v, pitch KP
  float* ecl = Hs + G.Vc * KP;             // e^{cum_last}
  float* Us = ecl + DMAX;                  // the bonus, 0 past K
  float* Eq = Us + DMAX;                   // scalar decay: e^{cum_q} by row,
  float* Ew = Eq + T;                      // e^{cum_last - cum} by row and
  float* cf = Ew + T;                      // sum_k q u k by row
  uint64_t* bar = reinterpret_cast<uint64_t*>(cf + T);
  bf16* Sg = reinterpret_cast<bf16*>(cf + T + 4);  // bf16 q, k, v staged

  const int NW = blockDim.x / 32, NWV = NW / RG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wv = warp % NWV, wr = warp / NWV;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x / GLA_VSPLIT, part = blockIdx.x % GLA_VSPLIT;
  const int b = bh / a.H, h = bh % a.H;
  const int c0 = 16 * (part * NWV + wv);   // the warp's value columns
  const E* qp = static_cast<const E*>(a.q) + b * a.sq[0] + h * a.sq[2];
  const E* kp = static_cast<const E*>(a.k) + b * a.sk[0] + h * a.sk[2];
  const E* vp = static_cast<const E*>(a.v) + b * a.sv[0] + h * a.sv[2];
  const float* lp = a.ld + b * a.sl[0] + h * a.sl[2];
  const int ntiles = (a.S + T - 1) / T;

  // The state, H^T. The row groups of the warp's 16 columns share out its
  // 8-column tiles: this warp keeps nkw of them from nk0, hs[i] rows v =
  // c0 + g (e < 2) and c0 + g + 8 (e >= 2), cols k = 8 (nk0 + i) + 2 tq +
  // (e & 1), and publishes them to Hs each tile
  const int nkw = (nk8 + RG - 1) / RG, nk0 = wr * nkw;
  float hs[NKW][4];
  const long long hbase = (long long)bh * K * V;
#pragma unroll
  for (int i = 0; i < NKW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 8 * (nk0 + i) + 2 * tq + (e & 1);
      const int vv = c0 + g + 8 * (e >> 1);
      hs[i][e] = (a.h0 && i < nkw && kk < K && vv < V)
                     ? a.h0[hbase + kk * V + vv]
                     : 0.f;
    }
  for (int kk = tid; kk < DMAX; kk += blockDim.x)
    Us[kk] = (a.u && kk < K) ? a.u[(long long)h * K + kk] : 0.f;
  if (VEC)  // the diagonal sub-blocks' upper-right 8 x 8 quadrants stay 0
    for (int i = tid; i < NSB * 64; i += blockDim.x) {
      const int w = i / 64, r = (i / 8) % 8, c = i % 8;
      As[(SB * w + r) * AP + SB * w + 8 + c] = 0.f;
    }
  if (a.tma && tid == 0) mbar_init(bar);
  __syncthreads();  // the mbarrier is initialised

  // cumulative log2 decay at row t (inclusive) and its query side
  auto cum_q = [&](int t) -> float {  // a scalar decay's
    const int r = a.strict ? t - 1 : t;
    return r < 0 ? 0.f : Cs[r];
  };
  auto cum_q2 = [&](int t, int kk) -> float2 {  // two channels'
    const int r = a.strict ? t - 1 : t;
    return r < 0 ? make_float2(0.f, 0.f) : pairf(Cs + r * KP + kk);
  };
  // tile j's q, k, decay and v: four tensor copies (thread 0 issues them)
  // where bases and strides allow, else cp.async or element loads; a
  // scalar decay into warp 0's registers, two rows a lane
  float nd0 = 0.f, nd1 = 0.f;
  auto stage = [&](int j) {
    if (!VEC && warp == 0) {
      const int t = j * T + 2 * lane;
      nd0 = t < a.S ? lp[(long long)t * a.sl[1]] : 0.f;
      nd1 = t + 1 < a.S ? lp[(long long)(t + 1) * a.sl[1]] : 0.f;
    }
    float* Vd = Vb + (j & 1) * T * VP;
    if (a.tma) {
      if (tid == 0) {
        mbar_expect(bar, 4 * T * ((VEC ? 3 : 2) * KP + VP));
        if (a.q3)
          tma_load3(Qs, &m.q, 0, j * T, b, bar);
        else
          tma_load4(Qs, &m.q, 0, h, j * T, b, bar);
        if (a.k3)
          tma_load3(Ks, &m.k, 0, j * T, b, bar);
        else
          tma_load4(Ks, &m.k, 0, h, j * T, b, bar);
        if (VEC) tma_load4(Cs, &m.ld, 0, h, j * T, b, bar);
        tma_load4(Vd, &m.v, 0, h, j * T, b, bar);
      }
      return;
    }
    if (VEC) load_rows<float>(Cs, lp, a.sl[1], j * T, a.S, K, Kp, KP, a.vl);
    if (!F32 && a.vq) {
      // bf16 in 16-byte pieces by cp.async into Sg, widened to float at
      // the tile's start
      auto raw = [&](bf16* dst, const E* src, long long rs, int C, int W) {
        const int pieces = W / 8;
        for (int idx = tid; idx < T * pieces; idx += blockDim.x) {
          const int r = idx / pieces, c = (idx % pieces) * 8;
          const bool ok = j * T + r < a.S && c < C;
          cp_async16(dst + r * W + c,
                     src + (ok ? (long long)(j * T + r) * rs + c : 0),
                     ok ? 16 : 0);
        }
      };
      raw(Sg, qp, a.sq[1], K, Kp);
      raw(Sg + T * Kp, kp, a.sk[1], K, Kp);
      raw(Sg + 2 * T * Kp, vp, a.sv[1], V, G.Vc);
    } else {
      load_rows<E>(Qs, qp, a.sq[1], j * T, a.S, K, Kp, KP, a.vq);
      load_rows<E>(Ks, kp, a.sk[1], j * T, a.S, K, Kp, KP, a.vq);
      load_rows<E>(Vd, vp, a.sv[1], j * T, a.S, V, G.Vc, VP, a.vq);
    }
    cp_commit();
  };

  if (ntiles > 0) stage(0);
#ifdef GLA_CLOCKS
  long long clk0 = clock64(), clk[NPHASE] = {};
#endif
  for (int j = 0; j < ntiles; ++j) {
    const int t0 = j * T;
    if (a.tma) mbar_wait(bar, j & 1);
    cp_wait_all();
    __syncthreads();  // tile j has landed; tile j - 1 is no longer read
    const float* Vs = Vb + (j & 1) * T * VP;
    if (!F32 && a.vq) {  // the staged bf16 tile, widened
      auto widen = [&](float* dst, const bf16* src, int W, int P) {
        for (int idx = tid; idx < T * W / 2; idx += blockDim.x) {
          const int r = idx / (W / 2), c = 2 * (idx % (W / 2));
          const uint32_t x = *reinterpret_cast<const uint32_t*>(
              src + r * W + c);
          *reinterpret_cast<float2*>(dst + r * P + c) = make_float2(
              __uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
        }
      };
      widen(Qs, Sg, Kp, KP);
      widen(Ks, Sg + T * Kp, Kp, KP);
      widen(const_cast<float*>(Vs), Sg + 2 * T * Kp, G.Vc, VP);
      __syncthreads();
    }
    CLK(0);
    // publish this warp's tiles of H^T, the state at the tile's start
#pragma unroll
    for (int i = 0; i < NKW; ++i) {
      if (i >= nkw || nk0 + i >= nk8) break;
      float* hr = Hs + (c0 + g) * KP + 8 * (nk0 + i) + 2 * tq;
      *reinterpret_cast<float2*>(hr) = make_float2(hs[i][0], hs[i][1]);
      *reinterpret_cast<float2*>(hr + 8 * KP) =
          make_float2(hs[i][2], hs[i][3]);
    }

    // the decay's cumulative sum in log2 units, in place, in row order
    if (VEC) {
      // a warp takes 16 channels, a lane one channel's upper or lower 32
      // rows; the lower half adds the upper's total
      for (int cg = warp; cg < (Kp + 15) / 16; cg += NW) {
        const int ch = 16 * cg + (lane & 15);
        const bool ok = ch < Kp;
        float* c = Cs + (lane >> 4) * 32 * KP + ch;
        float x[32], run = 0.f;
#pragma unroll
        for (int r = 0; r < 32; ++r) x[r] = ok ? c[r * KP] : 0.f;
#pragma unroll
        for (int r = 0; r < 32; ++r) x[r] = run = fmaf(x[r], LOG2E, run);
        const float top = __shfl_sync(FULL, run, lane & 15);
        const float off = lane & 16 ? top : 0.f;
        if (ok)
#pragma unroll
          for (int r = 0; r < 32; ++r) c[r * KP] = x[r] + off;
      }
    } else {
      if (warp == 0) {  // two rows a lane, a warp scan
        const float d0 = nd0 * LOG2E, d1 = nd1 * LOG2E;
        float inc = d0 + d1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(FULL, inc, off);
          if (lane >= off) inc += y;
        }
        float ex = __shfl_up_sync(FULL, inc, 1);
        if (lane == 0) ex = 0.f;
        const float ce = ex + d0, co = ce + d1;
        const float cl = __shfl_sync(FULL, co, 31);
        // the query side: cum[t] (inclusive) or cum[t - 1] (strict)
        float q0 = ce, q1 = co;
        if (a.strict) {
          q1 = ce;
          q0 = __shfl_up_sync(FULL, co, 1);
          if (lane == 0) q0 = 0.f;
        }
        Cs[2 * lane] = ce;
        Cs[2 * lane + 1] = co;
        Eq[2 * lane] = ex2(q0);
        Eq[2 * lane + 1] = ex2(q1);
        Ew[2 * lane] = ex2(cl - ce);
        Ew[2 * lane + 1] = ex2(cl - co);
        if (lane == 0) ecl[0] = ex2(cl);
      }
      if (a.u)  // the bonus's coefficient of each row, sum_k q u k
        for (int t0r = warp; t0r < T; t0r += 4 * NW) {
          float sm[4] = {};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = min(t0r + u * NW, T - 1);
            for (int kk = lane; kk < Kp; kk += 32)
              sm[u] = fmaf(Qs[t * KP + kk] * Us[kk], Ks[t * KP + kk], sm[u]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              sm[u] += __shfl_xor_sync(FULL, sm[u], off);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (lane == 0 && t0r + u * NW < T) cf[t0r + u * NW] = sm[u];
        }
    }
    __syncthreads();
    CLK(1);

    // q o e^{cum_q} and k o e^{cum_last - cum} (and e^{cum_last} by
    // channel), four pairs' loads first, then their products and stores
    if (VEC)
      for (int kk = tid; kk < Kp; kk += blockDim.x)
        ecl[kk] = ex2(Cs[(T - 1) * KP + kk]);
    {
      const int half = Kp / 2, n = T * half, nt = blockDim.x;
      for (int base = tid; base < n; base += 4 * nt) {
        float2 q2[4], k2[4], fq[4], fw[4];
        int t[4], kk[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = min(base + u * nt, n - 1);
          t[u] = idx / half, kk[u] = 2 * (idx % half);
          q2[u] = pairf(Qs + t[u] * KP + kk[u]);
          k2[u] = pairf(Ks + t[u] * KP + kk[u]);
          if (VEC) {
            fq[u] = cum_q2(t[u], kk[u]);
            fw[u] = pairf(Cs + t[u] * KP + kk[u]);
          } else {
            fq[u].x = fq[u].y = Eq[t[u]];
            fw[u].x = fw[u].y = Ew[t[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (base + u * nt >= n) break;
          if (VEC) {
            const float2 cl = pairf(Cs + (T - 1) * KP + kk[u]);
            fq[u] = make_float2(ex2(fq[u].x), ex2(fq[u].y));
            fw[u] = make_float2(ex2(cl.x - fw[u].x), ex2(cl.y - fw[u].y));
          }
          *reinterpret_cast<float2*>(QE + t[u] * KP + kk[u]) =
              make_float2(q2[u].x * fq[u].x, q2[u].y * fq[u].y);
          *reinterpret_cast<float2*>(KW + t[u] * KWP + kk[u]) =
              make_float2(k2[u].x * fw[u].x, k2[u].y * fw[u].y);
        }
      }
    }
    CLK(2);

    if (!VEC) {
      // A = (Q K^T) o 2^{cum_q[t] - cum[s]} on s < t (s <= t inclusive),
      // the bonus's coefficient on the diagonal: the 10 (row tile i, key
      // block sb <= i) pairs, p = i (i + 1) / 2 + sb, dealt to the warps
      for (int p = warp; p < 10; p += NW) {
        int i = 0;
        while ((i + 1) * (i + 2) / 2 <= p) ++i;
        const int sb = p - i * (i + 1) / 2;
        float sc[3][2][4] = {};  // lo.hi, hi.lo, hi.hi apart
#pragma unroll
        for (int ks = 0; ks < DMAX / 8; ++ks) {
          if (ks >= nk8) break;
          uint32_t ah[4], al[4];
          afrag(Qs + 16 * i * KP + 8 * ks, KP, g, tq, ah, al);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint32_t bh[2], bl[2];
            bsplit(pairf(Ks + (16 * sb + 8 * n + g) * KP + 8 * ks + 2 * tq),
                   bh, bl);
            mma(sc[0][n], al, bh[0], bh[1]);
            mma(sc[1][n], ah, bl[0], bl[1]);
            mma(sc[2][n], ah, bh[0], bh[1]);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int t = 16 * i + g + 8 * hh;
            float x[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = 16 * sb + 8 * n + 2 * tq + e, c = 2 * hh + e;
              const float y = (sc[0][n][c] + sc[1][n][c]) + sc[2][n][c];
              if (s < t)
                x[e] = y * ex2(cum_q(t) - Cs[s]);
              else if (s == t)
                x[e] = (a.strict ? 0.f : y) + (a.u ? cf[t] : 0.f);
              else
                x[e] = 0.f;
            }
            *reinterpret_cast<float2*>(As + t * AP + 16 * sb + 8 * n +
                                       2 * tq) = make_float2(x[0], x[1]);
          }
      }
    } else {
      // A in 16 tasks, dealt to the warps: each diagonal sub-block's
      // triangles in two halves of four rows of as many pairs (rows 0, 3,
      // 4, 7 and 1, 2, 5, 6), the six pairs (i, j): (1, 0), (2, 0), (3, 0),
      // (2, 1), (3, 1), (3, 2), and the diagonal sub-blocks' quadrants, two
      // a task
      for (int task = warp; task < 2 * NSB + 8; task += NW) {
        if (task < 2 * NSB) {
          const int r0 = (task >> 1) * SB, half = task & 1;
          // the half's rr-th row
          auto row = [&](int rr) {
            return 4 * (rr >> 1) + (half ? 1 + (rr & 1) : 3 * (rr & 1));
          };
          // exact pairwise decay, the lane's two channels; the 16 rows' k
          // and cum in registers
          const int kc = 2 * lane;
          const bool has = kc < Kp;
          float dk0 = 0.f, dk1 = 0.f;
          if (has) {
            dk0 = (a.strict ? 0.f : 1.f) + Us[kc];
            dk1 = (a.strict ? 0.f : 1.f) + Us[kc + 1];
          }
          float kf[SB][2], cs[SB][2];
#pragma unroll
          for (int s = 0; s < SB; ++s) {
            const float2 kv = has ? pairf(Ks + (r0 + s) * KP + kc)
                                  : make_float2(0.f, 0.f);
            const float2 c = has ? pairf(Cs + (r0 + s) * KP + kc)
                                 : make_float2(0.f, 0.f);
            kf[s][0] = kv.x, kf[s][1] = kv.y, cs[s][0] = c.x, cs[s][1] = c.y;
          }
          // rows r and r + 8 of the two 8 x 8 diagonal triangles at a time:
          // lanes 2 m and 2 m + 1 end with A at row r + 8 (m >> 3), column
          // m of the sub-block
          float xr[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int r = row(rr);
            float p[SB];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int rw = r + 8 * hh;
              const float2 qv = has ? pairf(Qs + (r0 + rw) * KP + kc)
                                    : make_float2(0.f, 0.f);
              const float2 cq = has ? cum_q2(r0 + rw, kc)
                                    : make_float2(0.f, 0.f);
#pragma unroll
              for (int s = 8 * hh; s < 8 * hh + 8; ++s) {
                float x = 0.f;
                if (s < rw)
                  x = qv.x * kf[s][0] * ex2(cq.x - cs[s][0]) +
                      qv.y * kf[s][1] * ex2(cq.y - cs[s][1]);
                else if (s == rw)
                  x = qv.x * kf[s][0] * dk0 + qv.y * kf[s][1] * dk1;
                p[s] = x;
              }
            }
            xr[rr] = reduce_scatter16(p, lane);
          }
          if (!(lane & 1)) {
            const int mc = lane >> 1;
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
              As[(r0 + row(rr) + 8 * (mc >> 3)) * AP + r0 + mc] = xr[rr];
          }
        } else if (task >= 2 * NSB + 6) {
          // the quadrants rows 8-15 x columns 0-7 of two diagonal
          // sub-blocks, through b = cum at the sub-block's row 7, as the
          // lower half of a 16 x 8 product (the upper half's rows are zero)
          for (int w = 2 * (task - 2 * NSB - 6); w < 2 * (task - 2 * NSB - 5);
               ++w) {
            const int r0 = w * SB;
            const float* bq = Cs + (r0 + 7) * KP;
            float sc[3][4] = {};
#pragma unroll
            for (int ks = 0; ks < DMAX / 8; ++ks) {
              if (ks >= nk8) break;
              const int kk = 8 * ks + 2 * tq;
              const int t = r0 + 8 + g, s = r0 + g;
              const float2 qv = pairf(Qs + t * KP + kk), cq = cum_q2(t, kk);
              const float2 kv = pairf(Ks + s * KP + kk);
              const float2 c = pairf(Cs + s * KP + kk), bb = pairf(bq + kk);
              uint32_t ah[4] = {}, al[4] = {}, bh[2], bl[2];
              split(qv.x * ex2(cq.x - bb.x), ah[1], al[1]);
              split(qv.y * ex2(cq.y - bb.y), ah[3], al[3]);
              bsplit(make_float2(kv.x * ex2(bb.x - c.x),
                                 kv.y * ex2(bb.y - c.y)), bh, bl);
              mma(sc[0], al, bh[0], bh[1]);
              mma(sc[1], ah, bl[0], bl[1]);
              mma(sc[2], ah, bh[0], bh[1]);
            }
            *reinterpret_cast<float2*>(As + (r0 + 8 + g) * AP + r0 + 2 * tq) =
                make_float2((sc[0][2] + sc[1][2]) + sc[2][2],
                            (sc[0][3] + sc[1][3]) + sc[2][3]);
          }
        } else {
          const int pt = task - 2 * NSB;
          const int i = pt < 3 ? pt + 1 : pt < 5 ? pt - 1 : 3;
          const int jb = pt < 3 ? 0 : pt < 5 ? 1 : 2;
          // A_ij = (q_i o e^{cum_q - b_j}) (k_j o e^{b_j - cum})^T, b_j the
          // cumulative decay at key sub-block j's last row
          const float* bj = Cs + (SB * jb + SB - 1) * KP;
          float sc[3][2][4] = {};
#pragma unroll
          for (int ks = 0; ks < DMAX / 8; ++ks) {
            if (ks >= nk8) break;
            const int kk = 8 * ks + 2 * tq;
            const float2 bb = pairf(bj + kk);
            uint32_t ah[4], al[4];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int t = SB * i + g + 8 * hh;
              const float2 qv = pairf(Qs + t * KP + kk), cq = cum_q2(t, kk);
              split(qv.x * ex2(cq.x - bb.x), ah[hh], al[hh]);
              split(qv.y * ex2(cq.y - bb.y), ah[2 + hh], al[2 + hh]);
            }
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int s = SB * jb + 8 * n + g;
              const float2 kv = pairf(Ks + s * KP + kk);
              const float2 c = pairf(Cs + s * KP + kk);
              uint32_t bh[2], bl[2];
              bsplit(make_float2(kv.x * ex2(bb.x - c.x),
                                 kv.y * ex2(bb.y - c.y)), bh, bl);
              mma(sc[0][n], al, bh[0], bh[1]);
              mma(sc[1][n], ah, bl[0], bl[1]);
              mma(sc[2][n], ah, bh[0], bh[1]);
            }
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int c = 2 * hh;
              *reinterpret_cast<float2*>(
                  As + (SB * i + g + 8 * hh) * AP + SB * jb + 8 * n +
                  2 * tq) =
                  make_float2((sc[0][n][c] + sc[1][n][c]) + sc[2][n][c],
                              (sc[0][n][c + 1] + sc[1][n][c + 1]) +
                                  sc[2][n][c + 1]);
            }
        }
      }
    }
    CLK(3);
    // this tile's reads of q, k and the decay (and the last tile's of v)
    // come before the bulk copies that overwrite them
    fence_proxy_async();
    __syncthreads();  // A and the scaled operands are formed
    CLK(4);
    if (j + 1 < ntiles) stage(j + 1);  // q, k and the decay are free
    CLK(5);

    // o = (q o e^{cum_q}) H + A V for the warp's row tile wr, from zero
    const int mi = wr;
    float o[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DMAX / 8; ++ks) {
      if (ks >= nk8) break;
      // H's B fragments (hi, lo): rows v of H^T, k = 8 ks + 2 tq (+1)
      uint32_t hbh[2][2], hbl[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        bsplit(pairf(Hs + (c0 + 8 * n + g) * KP + 8 * ks + 2 * tq), hbh[n],
               hbl[n]);
      uint32_t ah[4], al[4];
      afrag(QE + 16 * mi * KP + 8 * ks, KP, g, tq, ah, al);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma3(o[n], ah, al, hbh[n], hbl[n]);
    }
    CLK(6);
    for (int sb = 0; sb <= mi; ++sb)
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const int s0 = 16 * sb + 8 * k2;
        uint32_t ah[4], al[4];
        afrag(As + 16 * mi * AP + s0, AP, g, tq, ah, al);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          // v's B fragment: rows s0 + 2 tq (+1), column c0 + 8 n + g
          const float* vr = Vs + (s0 + 2 * tq) * VP + c0 + 8 * n + g;
          uint32_t vh[2], vl[2];
          bsplit(make_float2(vr[0], vr[VP]), vh, vl);
          mma(o[n], al, vh[0], vh[1]);
          if (F32) mma(o[n], ah, vl[0], vl[1]);  // bf16 v: no lo part
          mma(o[n], ah, vh[0], vh[1]);
        }
      }
    // rows 16 mi + g and 16 mi + g + 8, columns c0 + 8 n + 2 tq (+1)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + 16 * mi + g + 8 * hh;
      if (t >= a.S) continue;
      E* orow = static_cast<E*>(a.o) +
                (((long long)b * a.S + t) * a.H + h) * V;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = c0 + 8 * n + 2 * tq;
        const float x0 = o[n][2 * hh], x1 = o[n][2 * hh + 1];
        if (!(V & 1) && col + 1 < V) {
          if constexpr (F32)
            *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
          else
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < V) orow[col] = from_f<E>(x0);
          if (col + 1 < V) orow[col + 1] = from_f<E>(x1);
        }
      }
    }
    CLK(7);

    // H^T <- H^T diag(e^{cl}) + V^T (k o e^{cl - cum}) on this warp's
    // tiles of H^T: the tile's part summed from zero, then one FMA
    float dh[NKW][4];
#pragma unroll
    for (int i = 0; i < NKW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[i][e] = 0.f;
#pragma unroll
    for (int ss = 0; ss < T / 8; ++ss) {
      // V^T's A fragment: rows c0 + g (+8), sequence 8 ss + 2 tq (+1)
      const float* vr = Vs + (8 * ss + 2 * tq) * VP + c0 + g;
      uint32_t vh[4], vl[4];
      split(vr[0], vh[0], vl[0]);
      split(vr[8], vh[1], vl[1]);
      split(vr[VP], vh[2], vl[2]);
      split(vr[VP + 8], vh[3], vl[3]);
      const float* kr = KW + (8 * ss + 2 * tq) * KWP + 8 * nk0 + g;
#pragma unroll
      for (int i = 0; i < NKW; ++i) {
        if (i >= nkw || nk0 + i >= nk8) break;
        uint32_t bh[2], bl[2];
        bsplit(make_float2(kr[8 * i], kr[KWP + 8 * i]), bh, bl);
        mma3<F32>(dh[i], vh, vl, bh, bl);
      }
    }
#pragma unroll
    for (int i = 0; i < NKW; ++i) {
      if (i >= nkw || nk0 + i >= nk8) break;
      const float2 e = VEC ? pairf(ecl + 8 * (nk0 + i) + 2 * tq)
                           : make_float2(ecl[0], ecl[0]);
      hs[i][0] = fmaf(hs[i][0], e.x, dh[i][0]);
      hs[i][1] = fmaf(hs[i][1], e.y, dh[i][1]);
      hs[i][2] = fmaf(hs[i][2], e.x, dh[i][2]);
      hs[i][3] = fmaf(hs[i][3], e.y, dh[i][3]);
    }
    CLK(8);
  }

#pragma unroll
  for (int i = 0; i < NKW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = 8 * (nk0 + i) + 2 * tq + (e & 1);
      const int vv = c0 + g + 8 * (e >> 1);
      if (i < nkw && kk < K && vv < V) a.hT[hbase + kk * V + vv] = hs[i][e];
    }
#ifdef GLA_CLOCKS
  if (blockIdx.x == 0 && lane == 0)
    for (int ph = 0; ph < NPHASE; ++ph) gla_clocks[ph][warp] += clk[ph];
#endif
}

// base 16-byte aligned and strides whole multiples of 16 bytes (stride 0,
// a broadcast, included), elements of `elem` bytes
bool aligned16(const void* p, const long long* st, int elem) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if ((st[i] * elem) % 16) return false;
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

// the map of a float32 (B, S, H, C) array with strides st over (batch,
// sequence, head) in elements, boxes of `box` columns and a tile's rows;
// with `three`, of (B, S, C), the head dim left out (stride 0 over it)
bool encode(CUtensorMap* map, const void* base, int B, int S, int H, int C,
            int box, const long long* st, bool three) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims4[4] = {(cuuint64_t)C, (cuuint64_t)H, (cuuint64_t)S,
                               (cuuint64_t)B};
  const cuuint64_t dims3[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t str4[3] = {(cuuint64_t)(st[2] * 4),
                              (cuuint64_t)(st[1] * 4),
                              (cuuint64_t)(st[0] * 4)};
  const cuuint64_t str3[2] = {(cuuint64_t)(st[1] * 4),
                              (cuuint64_t)(st[0] * 4)};
  const cuuint32_t box4[4] = {(cuuint32_t)box, 1, T, 1};
  const cuuint32_t box3[3] = {(cuuint32_t)box, T, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, three ? 3 : 4,
            const_cast<void*>(base), three ? dims3 : dims4,
            three ? str3 : str4, three ? box3 : box4, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, bool VEC>
cudaError_t run(const Args& a, const Maps& m, cudaStream_t stream) {
  const Geo G = geo(a.K, a.V);
  if (G.nwv % GLA_VSPLIT) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(G, VEC, sizeof(E) == 2);
  cudaError_t err = cudaFuncSetAttribute(
      gla_scan_kernel<E, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.B * a.H * GLA_VSPLIT;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  gla_scan_kernel<E, VEC><<<(unsigned)blocks,
                            32 * G.nwv / GLA_VSPLIT * RG, smem,
                            stream>>>(a, m);
  return cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16 (q, k, v and o). q, k (B, S, H, K) and
// v (B, S, H, V) with unit stride over their last dim and the given strides
// (in elements) over batch, sequence and head; log_decay float32 (B, S, H)
// when vec == 0, else (B, S, H, K) with unit stride over K; bonus (H, K) and
// h0 (B, H, K, V) float32 contiguous or null; o (B, S, H, V) contiguous;
// hT (B, H, K, V) float32 contiguous. 1 <= K, V <= 64.
extern "C" int gla_scan_fwd(
    const void* q, const void* k, const void* v, const void* ld,
    const void* bonus, const void* h0, void* o, void* hT, int dtype, int B,
    int S, int H, int K, int V, int sqb, int sqs, int sqh, int skb, int sks,
    int skh, int svb, int svs, int svh, int slb, int sls, int slh, int vec,
    int strict, void* stream) {
  if (K < 1 || K > DMAX || V < 1 || V > DMAX || S < 0 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, static_cast<const float*>(ld),
         static_cast<const float*>(bonus), static_cast<const float*>(h0), o,
         static_cast<float*>(hT), B, S, H, K, V,
         {sqb, sqs, sqh}, {skb, sks, skh}, {svb, svs, svh}, {slb, sls, slh},
         strict, 0, 0, 0, 0, 0};
  const int elem = dtype == 1 ? 2 : 4, piece = 16 / elem;
  a.vq = K % piece == 0 && V % piece == 0 && aligned16(q, a.sq, elem) &&
         aligned16(k, a.sk, elem) && aligned16(v, a.sv, elem);
  a.vl = vec && K % 4 == 0 && aligned16(ld, a.sl, 4);
  // tensor copies: float32 in 16-byte pieces, every stride but q's and k's
  // over the heads nonzero
  Maps m{};
  const Geo G = geo(K, V);
  auto pos = [](const long long* st, int from) {
    for (int i = from; i < 3; ++i)
      if (st[i] <= 0) return false;
    return true;
  };
  a.q3 = sqh == 0, a.k3 = skh == 0;
  a.tma = dtype == 0 && S > 0 && a.vq && (!vec || a.vl) &&
          sqb > 0 && sqs > 0 && skb > 0 && sks > 0 && pos(a.sv, 0) &&
          (!vec || pos(a.sl, 0)) &&
          encode(&m.q, q, B, S, H, K, G.KP, a.sq, a.q3) &&
          encode(&m.k, k, B, S, H, K, G.KP, a.sk, a.k3) &&
          encode(&m.v, v, B, S, H, V, G.VP, a.sv, false) &&
          (!vec || encode(&m.ld, ld, B, S, H, K, G.KP, a.sl, false));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vec ? run<bf16, true>(a, m, st) : run<bf16, false>(a, m, st);
  else
    err = vec ? run<float, true>(a, m, st) : run<float, false>(a, m, st);
  return (int)err;
}

#ifdef GLA_CLOCKS
// the phase clocks of the launches since the last call (NPHASE x 16
// unsigned 64-bit), then zero
extern "C" int gla_scan_clocks(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, gla_clocks, sizeof(gla_clocks));
  if (err != cudaSuccess) return (int)err;
  static unsigned long long zeros[NPHASE][16] = {};
  return (int)cudaMemcpyToSymbol(gla_clocks, zeros, sizeof(zeros));
}
#endif
