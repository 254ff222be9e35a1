"""Kernel #4, flash attention, on Hopper: build, bind, launch.

``csrc/flash_attention.cu`` replaces ``src/repro/kernels/flash_attention/
kernel.py:85`` (``flash_attention``, body ``_flash_kernel``). It computes
``ref.attention_reference``, the decode call included: a runtime
``q_offset`` and cache ``length``, which the TPU kernel refuses. Built and
loaded through ``kernels/nvcc.py`` at first use; nothing is compiled when
this module is imported.

``flash_attention_cuda`` launches on ``torch.cuda.current_stream()`` and
adds one to its ``launches`` attribute per launch. ``attention_flops`` and
``attention_bytes`` count the work the mask leaves (the bound in
``chip_smoke.py`` and PERF.md comes from them).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY = ("flash_attention_fwd",
          nvcc.P * 4 + nvcc.I * 7 + nvcc.I * 9 + nvcc.I * 4 + nvcc.F * 2)
_lib = {}


def build(verbose: bool = False):
    """Compile ``csrc/flash_attention.cu`` (``nvcc.build``); returns
    (library path, seconds, nvcc output)."""
    return nvcc.build(SOURCE, (), nvcc.FLAGS, verbose=verbose)


def _load():
    if "fn" not in _lib:
        _lib["fn"] = nvcc.load(build()[0], *_ENTRY)
    return _lib["fn"]


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         q_offset: int = 0, length: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel. q: (B, Sq, N, H); k, v: (B, Sk, K, H), N % K == 0,
    H <= 256; all float32 or all bfloat16 CUDA tensors on one device, read
    through their strides (unit stride over H). q_offset, length and window
    are ints (length <= Sk). Returns (B, Sq, N, H) contiguous in q's type."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"{name}: the kernel takes CUDA tensors")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"{name}: float32 or bfloat16 like q expected, "
                             f"got {x.dtype}")
        if x.device != q.device:
            raise ValueError("q, k and v must be on one CUDA device")
    sq, sk, sv = (nvcc.lead_strides(n, x, 4) for n, x in (("q", q),
                                                           ("k", k),
                                                           ("v", v)))
    B, Sq, N, H = q.shape
    _, Sk, K, Hk = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or Hk != H:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not (1 <= H <= MAX_HEAD_DIM and N % K == 0 and B * N < 65536):
        raise ValueError(f"the kernel takes H <= {MAX_HEAD_DIM}, N % K == 0 "
                         f"and B * N < 65536 (H={H}, N={N}, K={K}, B={B})")
    kv_len = Sk if length is None else int(length)
    if not 0 <= kv_len <= Sk:
        raise ValueError(f"length {kv_len} outside [0, {Sk}]")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    out = torch.empty((B, Sq, N, H), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = (H ** -0.5) if scale is None else float(scale)
    nvcc.launch(_load(), q.device, (
        q, k, v, out, _DTYPES[q.dtype], B, Sq, Sk, N, K, H, *sq, *sk, *sv,
        int(bool(causal)), 0 if window is None else int(window),
        int(q_offset), kv_len, float(np.float32(scale)),
        0.0 if softcap is None else float(softcap)), "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def _key_ranges(Sq, Sk, *, causal=True, window=None, q_offset=0,
                length=None):
    """Per query row, the first and one past the last key it attends."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.full(Sq, Sk if length is None else int(length), np.int64)
    if causal:
        hi = np.minimum(hi, qpos + 1)
    lo = np.zeros(Sq, np.int64) if window is None else \
        np.maximum(qpos - int(window) + 1, 0)
    return lo, np.maximum(hi, lo)


def attention_pairs(Sq, Sk, *, causal=True, window=None, q_offset=0,
                    length=None) -> int:
    """The (query, key) pairs the mask leaves, per batch row and head."""
    lo, hi = _key_ranges(Sq, Sk, causal=causal, window=window,
                         q_offset=q_offset, length=length)
    return int((hi - lo).sum())


def attention_flops(B, Sq, Sk, N, H, **mask) -> int:
    """Matmul operations of the two products over the attended pairs:
    2 H for q . k and 2 H for p v, each pair and query head."""
    return 4 * B * N * H * attention_pairs(Sq, Sk, **mask)


def attention_bytes(B, Sq, Sk, N, K, H, itemsize, **mask) -> int:
    """Bytes the call must move: q read and the output written once, and
    the keys and values some query attends read once."""
    lo, hi = _key_ranges(Sq, Sk, **mask)
    keys = int(hi.max() - lo.min()) if Sq else 0
    return itemsize * (2 * B * Sq * N * H + 2 * B * keys * K * H)
