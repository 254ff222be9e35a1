"""Kernel #4, flash attention, on Hopper: build, bind, launch.

Three CUDA C++ sources under ``csrc/`` (sharing ``csrc/flash_common.cuh``)
replace ``src/repro/kernels/flash_attention/kernel.py:85``
(``flash_attention``, body ``_flash_kernel``) and compute
``ref.attention_reference``, the decode call included: a runtime
``q_offset`` and cache ``length``, which the TPU kernel refuses.
``flash_attention_cuda`` picks one by the call's shape and type:

* ``Sq <= 16``, bf16 or float32: ``flash_decode.cu``, split-KV partials of
  the cached keys over many blocks, then a combine kernel;
* ``Sq > 16``, bf16: ``flash_prefill.cu``, FlashAttention-2 tiles on the
  tensor cores (``mma.sync``);
* ``Sq > 16``, float32: ``flash_attention.cu``, FlashAttention-2 tiles on
  the tensor cores in split TF32 (``mma.sync`` tf32, each float32 operand
  split into hi + lo TF32 parts and each product taken as lo.hi + hi.lo +
  hi.hi): one TF32 product would miss float32's 2e-5 limit, the split keeps
  about 21 mantissa bits (``tests/test_torch_flash_f32_split.py`` models
  it).

How the bf16 routes round P (the probabilities before P V). The TPU kernel
(``src/repro/kernels/flash_attention/kernel.py:54-82``) casts q, k and v to
float32, keeps P in float32 and rounds only the output; its XLA reference,
and ``ref.attention_reference`` with it, rounds the normalised P to v's type
before P V. The decode route keeps P in float32, as the TPU kernel does. The
prefill route rounds the unnormalised exp(s - m) to bf16 for ``mma.sync``
and divides by the float32 row sum at the end. Against float32 attention of
the same bf16 inputs, rounded to bf16 at the output (the TPU kernel's
arithmetic), at the serving shapes (``chip_smoke.py``'s "P rounding" lines;
NVIDIA H100 80GB HBM3, 700 W), mean |error| over the output:

=====================  ===========  ==========================
call                   this route   ``ref.attention_reference``
=====================  ===========  ==========================
Zamba2 prefill         1.003e-04    1.233e-04
Qwen3 prefill          1.001e-04    1.233e-04
Zamba2 decode          1.294e-08    6.812e-05
Qwen3 decode           1.164e-10    6.589e-05
=====================  ===========  ==========================

The max |error| of both prefill sides is one bf16 unit of the largest
outputs (1.562e-02 at |o| up to 4); decode's is 1.221e-04 / 9.537e-07
against the reference's 9.766e-04. So the prefill route deviates from the
TPU kernel by less than the reference does, and the decode route matches
it; a decode step and a prefill of the same tokens differ by the prefill's
rounding of P. The 2e-2 limit against the reference holds on both routes.

Each source is built and loaded through ``kernels/nvcc.py`` at first use;
nothing is compiled when this module is imported. ``flash_attention_cuda``
launches on ``torch.cuda.current_stream()`` and adds one to its
``launches`` attribute per call, and one to ``routes[route]``. ``attention_flops`` and
``attention_bytes`` count the work the mask leaves (the bound in
``chip_smoke.py`` and PERF.md comes from them).
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.flash_attention import ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"flash_prefill": CSRC / "flash_prefill.cu",
           "flash_decode": CSRC / "flash_decode.cu",
           "flash_attention": CSRC / "flash_attention.cu"}
HEADERS = (CSRC / "flash_common.cuh",)
MAX_HEAD_DIM = 256
DECODE_MAX_SQ = 16       # calls with at most this many query rows decode
MIN_SPLIT_KEYS = 64      # a split of the decode route holds at least these
MAX_SPLITS = 64          # the decode source's limit
BLOCKS_PER_SM = 2        # decode splits aim at this many blocks an SM
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = nvcc.P, nvcc.I, nvcc.F
_SHAPE = _I * 6 + _I * 9 + _I * 4     # B..H, 9 strides, causal..kv_len
_ENTRY = {"flash_prefill": ("flash_prefill_bf16_fwd", _P * 4 + _SHAPE + _F * 2),
          "flash_decode": ("flash_decode_fwd",
                           _P * 5 + _I + _SHAPE + _I * 3 + _F * 2),
          "flash_attention": ("flash_prefill_f32_fwd",
                              _P * 4 + _SHAPE + _F * 2)}
_libs = {}


def build(name: str = "flash_prefill", verbose: bool = False):
    """Compile ``SOURCES[name]`` (``nvcc.build``); returns (library path,
    seconds, nvcc output)."""
    return nvcc.build(SOURCES[name], HEADERS, nvcc.FLAGS, verbose=verbose)


def _load(name: str):
    if name not in _libs:
        _libs[name] = nvcc.load(build(name)[0], *_ENTRY[name])
    return _libs[name]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route(Sq: int, dtype: torch.dtype) -> str:
    """The source that computes a call of ``Sq`` query rows in ``dtype``."""
    if Sq <= DECODE_MAX_SQ:
        return "flash_decode"
    return "flash_prefill" if dtype == torch.bfloat16 else "flash_attention"


def decode_rows_per_block(rows: int) -> int:
    """Query rows a decode block holds (1, 2 or 4) of the G * Sq rows that
    share one KV head."""
    return 1 if rows <= 1 else 2 if rows == 2 else 4


def decode_splits(B: int, K: int, rows: int, keys: int, sms: int) -> int:
    """Key splits of a decode call: enough that B * K * row groups * splits
    is about ``BLOCKS_PER_SM`` blocks an SM, with at least
    ``MIN_SPLIT_KEYS`` keys a split (one split under that)."""
    groups = -(-rows // decode_rows_per_block(rows))
    want = -(-BLOCKS_PER_SM * sms // (B * K * groups))
    return max(1, min(want, keys // MIN_SPLIT_KEYS, MAX_SPLITS))


def _checked(q, k, v, length, window):
    """Validate a call; returns (shape (B, Sq, Sk, N, K, H), the nine
    strides, kv_len)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"{name}: the kernel takes CUDA tensors")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"{name}: float32 or bfloat16 like q expected, "
                             f"got {x.dtype}")
        if x.device != q.device:
            raise ValueError("q, k and v must be on one CUDA device")
    strides = [st for n, x in (("q", q), ("k", k), ("v", v))
               for st in nvcc.lead_strides(n, x, 4)]
    B, Sq, N, H = q.shape
    _, Sk, K, Hk = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or Hk != H:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not (1 <= H <= MAX_HEAD_DIM and N % K == 0):
        raise ValueError(f"the kernel takes H <= {MAX_HEAD_DIM} and "
                         f"N % K == 0 (H={H}, N={N}, K={K})")
    kv_len = Sk if length is None else int(length)
    if not 0 <= kv_len <= Sk:
        raise ValueError(f"length {kv_len} outside [0, {Sk}]")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return (B, Sq, Sk, N, K, H), strides, kv_len


def _mask_args(causal, window, q_offset, kv_len):
    return (int(bool(causal)), 0 if window is None else int(window),
            int(q_offset), kv_len)


def _scale(H, scale):
    return float(np.float32((H ** -0.5) if scale is None else scale))


def _decode(q, k, v, out, splits, combine, shape, strides, mask, scale,
            softcap):
    """Launch the decode route: the split kernel into a float32 scratch of
    (splits, B, Sq, N, H + 2) records (acc[H], m, l), then, if ``combine``,
    the combine kernel into ``out``. Returns the scratch."""
    B, Sq, Sk, N, K, H = shape
    rows = (N // K) * Sq
    part = torch.empty((splits, B, Sq, N, H + 2), dtype=torch.float32,
                       device=q.device)
    nvcc.launch(_load("flash_decode"), q.device, (
        q, k, v, out, part, _DTYPES[q.dtype], *shape, *strides, *mask,
        splits, decode_rows_per_block(rows), int(combine), scale,
        0.0 if softcap is None else float(softcap)), "flash_decode")
    return part


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         q_offset: int = 0, length: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel for this call's route (``route``). q: (B, Sq, N,
    H); k, v: (B, Sk, K, H), N % K == 0, H <= 256; all float32 or all
    bfloat16 CUDA tensors on one device, read through their strides (unit
    stride over H). q_offset, length and window are ints (length <= Sk).
    Returns (B, Sq, N, H) contiguous in q's type."""
    shape, strides, kv_len = _checked(q, k, v, length, window)
    B, Sq, Sk, N, K, H = shape
    out = torch.empty((B, Sq, N, H), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    mask = _mask_args(causal, window, q_offset, kv_len)
    scale = _scale(H, scale)
    name = route(Sq, q.dtype)
    if name == "flash_decode":
        begin, end = ref.key_span(Sq, Sk, causal=causal, window=window,
                                  q_offset=q_offset, length=kv_len)
        splits = decode_splits(B, K, (N // K) * Sq, end - begin,
                               _sms(q.device.index or 0))
        _decode(q, k, v, out, splits, True, shape, strides, mask, scale,
                softcap)
    else:
        nvcc.launch(_load(name), q.device, (
            q, k, v, out, *shape, *strides, *mask, scale,
            0.0 if softcap is None else float(softcap)), name)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.routes[name] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.routes = dict.fromkeys(SOURCES, 0)   # calls by route


def flash_decode_partials_cuda(q, k, v, *, splits: int, causal: bool = True,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               q_offset: int = 0,
                               length: Optional[int] = None,
                               scale: Optional[float] = None):
    """The decode route's split kernel alone, with ``splits`` given: the
    float32 (m, l, acc) of each key split, shaped (splits, B, Sq, N),
    (splits, B, Sq, N) and (splits, B, Sq, N, H), as
    ``ref.attention_partials`` gives them. For tests; Sq <= 16."""
    shape, strides, kv_len = _checked(q, k, v, length, window)
    B, Sq, Sk, N, K, H = shape
    if not (1 <= Sq <= DECODE_MAX_SQ and 1 <= splits <= MAX_SPLITS):
        raise ValueError(f"the decode route takes 1 <= Sq <= {DECODE_MAX_SQ}"
                         f" and 1 <= splits <= {MAX_SPLITS}")
    part = _decode(q, k, v, q, int(splits), False, shape, strides,
                   _mask_args(causal, window, q_offset, kv_len),
                   _scale(H, scale), softcap)
    flash_decode_partials_cuda.launches += 1
    return part[..., H], part[..., H + 1], part[..., :H]


flash_decode_partials_cuda.launches = 0


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
