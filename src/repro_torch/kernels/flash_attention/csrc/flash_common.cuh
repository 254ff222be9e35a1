// What the three flash-attention sources share: the launch arguments, the
// mask value, bf16 / float32 conversions and the key range a call attends.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;  // the reference's mask value, never -inf

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
  return __float2bfloat16(x);  // round to nearest even, as a cast does
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, N, K, H;
  long long sq[3], sk[3], sv[3];  // strides over (batch, seq, head)
  int causal, window, q_offset, kv_len;
  float scale, softcap;
};

// The keys some query row in [q_first, q_last] attends: [*begin, *end).
__host__ __device__ __forceinline__ void key_span(const Args& a, int q_first,
                                                  int q_last, int* begin,
                                                  int* end) {
  int e = a.kv_len;
  if (a.causal && q_last + 1 < e) e = q_last + 1;
  int b = 0;
  if (a.window > 0 && q_first - a.window + 1 > 0) b = q_first - a.window + 1;
  *begin = b;
  *end = e;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without holding registers;
// src_bytes = 0 writes zeros and reads nothing.
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
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool attends(const Args& a, int qpos, int kpos) {
  return kpos < a.kv_len && (!a.causal || kpos <= qpos) &&
         (a.window <= 0 || qpos - kpos < a.window);
}

// True when x's base and its strides over batch, sequence and head are
// whole multiples of `bytes`, so rows can be read in `bytes`-wide pieces.
inline bool aligned(const void* p, const long long* st, int esize,
                    int bytes) {
  if (reinterpret_cast<uintptr_t>(p) % bytes) return false;
  for (int i = 0; i < 3; ++i)
    if ((st[i] * esize) % bytes) return false;
  return true;
}

}  // namespace flash
