#!/usr/bin/env python3
"""Measure the tensor-core and conversion rates that the float32 prefill
route (``kernels/flash_attention/csrc/flash_attention.cu``) is built from,
on one CUDA card.

    python3 tools/mma_probe.py

Builds one CUDA source (below) into ``build/probe/`` and times, with CUDA
events over a launch on every SM:

* ``mma.sync.m16n8k8`` tf32 (the route's product) and ``mma.sync.m16n8k16``
  bf16 (the bf16 prefill route's): throughput with 8 independent
  accumulators a warp at 4, 8 and 16 warps an SM, and latency as one
  dependent chain in one warp an SM;
* the split of a float32 value into TF32 hi + lo: by ``cvt.rna.tf32.f32``
  twice (with hi's low bits cleared), by integer rounding (the same bits),
  and a plain FADD chain as the yardstick, 8 independent chains a thread
  at 16 warps an SM.

Prints each rate with the card's name and power limit; the summary goes to
``chiprun_out/mma_probe.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import nvcc  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mode 0: tf32 mma, mode 1: bf16 mma; CH independent accumulators
template <int CH>
__global__ void mma_kernel(float* out, int iters, int mode) {
  float d[CH][4];
  for (int c = 0; c < CH; ++c)
    for (int e = 0; e < 4; ++e) d[c][e] = 0.f;
  const uint32_t x = 0x3c000000u + threadIdx.x;  // small positive floats
  const uint32_t a[4] = {x, x ^ 1u, x ^ 2u, x ^ 3u};
  if (mode == 0) {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int c = 0; c < CH; ++c) mma_tf32(d[c], a, x, x ^ 4u);
  } else {
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int c = 0; c < CH; ++c) mma_bf16(d[c], a, x, x ^ 4u);
  }
  float s = 0.f;
  for (int c = 0; c < CH; ++c)
    for (int e = 0; e < 4; ++e) s += d[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// mode 0: FADD only; 1: FADD + split by cvt.rna twice; 2: FADD + split by
// integer rounding; 8 independent chains a thread
__global__ void split_kernel(float* out, int iters, int mode) {
  float f[8];
  uint32_t acc = 0;
  for (int c = 0; c < 8; ++c) f[c] = 1.f + 1e-3f * (threadIdx.x + c);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float x = f[c] + 1.2345e-4f;
      uint32_t h, l;
      if (mode == 1) {
        asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
        h &= 0xffffe000u;
        asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l)
                     : "f"(x - __uint_as_float(h)));
      } else if (mode == 2) {
        h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
        l = (__float_as_uint(x - __uint_as_float(h)) + 0x1000u) &
            0xffffe000u;
      } else {
        h = __float_as_uint(x);
        l = 0u;
      }
      acc ^= l;
      f[c] = __uint_as_float(h);
    }
  }
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += f[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s + (float)acc;
}

extern "C" int probe(int kind, int chains, int blocks, int threads, int iters,
                     int mode, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0 && chains == 1)
    mma_kernel<1><<<blocks, threads, 0, st>>>(out, iters, mode);
  else if (kind == 0)
    mma_kernel<8><<<blocks, threads, 0, st>>>(out, iters, mode);
  else
    split_kernel<<<blocks, threads, 0, st>>>(out, iters, mode);
  return (int)cudaGetLastError();
}
"""


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mma_probe: needs one CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out_dir = nvcc.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "mma_probe.cu"
    src.write_text(SOURCE)
    lib, _, log = nvcc.build(src, (), nvcc.FLAGS, verbose=True)
    print(f"[mma] ptxas: {[x for x in log.splitlines() if 'registers' in x]}",
          flush=True)
    fn = getattr(ctypes.CDLL(str(lib)), "probe")
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 1024, device="cuda")

    def timed(kind, chains, blocks, threads, iters, mode):
        stream = torch.cuda.current_stream().cuda_stream
        args = (kind, chains, blocks, threads, iters, mode, out.data_ptr(),
                stream)
        if fn(*args) != 0:
            raise RuntimeError("probe launch failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    result = {"card": card}
    iters = 4096
    for name, mode, flop in (("tf32 m16n8k8", 0, 2 * 16 * 8 * 8),
                             ("bf16 m16n8k16", 1, 2 * 16 * 8 * 16)):
        for warps in (4, 8, 16):
            ms = timed(0, 8, sms * warps // 4, 128, iters, mode)
            mmas = sms * warps * iters * 8
            rate = mmas * flop / ms / 1e9
            result[f"{name} {warps} warps/SM TFLOP/s"] = rate
            print(f"[mma] {name}, 8 chains a warp, {warps} warps an SM: "
                  f"{ms:.4f} ms, {rate:.1f} TFLOP/s", flush=True)
        ms = timed(0, 1, sms, 32, iters, mode)
        result[f"{name} chain ns"] = 1e6 * ms / iters
        print(f"[mma] {name}, one dependent chain, one warp an SM: "
              f"{1e6 * ms / iters:.2f} ns a product", flush=True)
    for name, mode in (("FADD only", 0), ("split by cvt.rna", 1),
                       ("split by integer rounding", 2)):
        ms = timed(1, 8, sms * 4, 128, iters, mode)
        per = sms * 16 * 32 * iters * 8 / ms / 1e9
        result[f"{name} G/s"] = per
        print(f"[mma] {name}, 16 warps an SM: {ms:.4f} ms, {per:.1f} G "
              f"values/s", flush=True)
    print(f"[mma] {card}")
    res = ROOT / "chiprun_out"
    res.mkdir(exist_ok=True)
    (res / "mma_probe.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
