"""Kernel #5, the chunked GLA scan, on Hopper: build, bind, launch.

Three CUDA C++ sources under ``csrc/`` replace
``src/repro/kernels/linear_scan/kernel.py:71`` (``gla_pallas``, body
``_gla_kernel``) and compute ``ref.gla_chunked``: the output and the final
state, from an optional initial state (the TPU kernel returns no final state
and takes no initial one). ``gla_cuda`` picks one by the call (``route``):

* bf16 q, k and v with a scalar decay (Mamba2), no bonus, not strict, K and
  V in ``SSD_DIMS``: ``gla_ssd.cu``, 64-row tiles on the tensor cores
  (``mma.sync``), the float32 operands split into two bf16 parts;
* bf16 q, k and v with a per-channel decay (RWKV6), with or without the
  bonus, strict or not, K and V in ``SSD_DIMS``: ``gla_vec.cu``, 64-row
  tiles in 16-row sub-blocks, the decay between two sub-blocks factored
  into two factors <= 1 so that their scores are products on the tensor
  cores, only the diagonal sub-blocks' 8-row triangles pairwise on the
  CUDA cores;
* everything else (float32, a scalar decay with the bonus or the strict
  mode, other widths up to 64): ``gla_scan.cu``, 64-row tiles on the tensor
  cores in split TF32 (``mma.sync`` tf32 on a TF32 high part and the
  residual of every float32 operand, three products each), which holds
  float32's 1e-4 limit where one bf16 or TF32 product would miss it; a
  tile's state contribution and output are summed from zero and merged by
  an FMA, since the tensor cores' sums truncate.

Each source is built and loaded through ``kernels/nvcc.py`` at first use;
nothing is compiled when this module is imported. ``gla_cuda`` launches on
``torch.cuda.current_stream()`` and adds one to its ``launches`` attribute
per call, and one to ``routes[route]``. ``gla_flops`` and ``gla_bytes``
count the reference's work (the bound in ``chip_smoke.py`` and PERF.md
comes from them, whichever source runs).
"""
from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.kernels import nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"gla_ssd": CSRC / "gla_ssd.cu", "gla_vec": CSRC / "gla_vec.cu",
           "gla_scan": CSRC / "gla_scan.cu"}
MAX_DIM = 64          # largest K and V the kernels' shared memory holds
MAX_TILE = 64         # rows of a tile; longer chunks are taken in tiles
SSD_DIMS = (16, 32, 48, 64)   # the K and V the tensor-core routes take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = nvcc.P, nvcc.I
_ENTRY = {"gla_scan": ("gla_scan_fwd", _P * 8 + _I * 6 + _I * 12 + _I * 2),
          "gla_ssd": ("gla_ssd_fwd", _P * 7 + _I * 5 + _I * 12),
          "gla_vec": ("gla_vec_fwd", _P * 8 + _I * 5 + _I * 12 + _I)}
_libs = {}


def build(name: str = "gla_ssd", verbose: bool = False, defines=()):
    """Compile ``SOURCES[name]`` with a ``-D`` flag for each of ``defines``
    (``nvcc.build``); returns (library path, seconds, nvcc output)."""
    flags = nvcc.FLAGS + tuple(f"-D{d}" for d in defines)
    return nvcc.build(SOURCES[name], (), flags, verbose=verbose)


def variant(name: str, defines):
    """The entry point of ``SOURCES[name]`` built with ``defines`` (such
    as ``("GLA_STAGES=2",)``). Put it in ``_libs[name]`` and the wrapper
    launches it; the shipped build is the one without."""
    return nvcc.load(build(name, defines=defines)[0], *_ENTRY[name])


def _load(name: str):
    """The C entry point of source ``name``, built and loaded at first
    use."""
    if name not in _libs:
        _libs[name] = variant(name, ())
    return _libs[name]


def route(dtype: torch.dtype, K: int, V: int, *, vec: bool = False,
          bonus: bool = False, strict: bool = False) -> str:
    """The source that computes a call: for bf16 with K, V in ``SSD_DIMS``,
    ``gla_vec`` with a per-channel decay, ``gla_ssd`` with a scalar decay,
    no bonus and not strict; else ``gla_scan``."""
    if dtype == torch.bfloat16 and K in SSD_DIMS and V in SSD_DIMS:
        if vec:
            return "gla_vec"
        if not (bonus or strict):
            return "gla_ssd"
    return "gla_scan"


def tile_rows(chunk: int) -> int:
    """Rows of a tile of the reference's work for a chunk size (the chunk,
    up to ``MAX_TILE``): ``gla_flops`` counts a tile's pairs by it. The
    kernels take 64-row tiles whatever the chunk."""
    return max(1, min(int(chunk), MAX_TILE))


def gla_cuda(q, k, v, log_decay, *, bonus=None, strict: bool = False,
             chunk: int = 64, initial_state=None):
    """Launch the scan on this call's route (``route``). q, k: (B, S, H, K);
    v: (B, S, H, V), all float32 or all bfloat16, read through their
    strides (unit stride over the last dim; q and k may be broadcast over H
    with stride 0); log_decay float32 (B, S, H) or (B, S, H, K); bonus (H,
    K) and initial_state (B, H, K, V) float32 or None; K, V <= 64. Returns
    (o (B, S, H, V) in q's type, final_state (B, H, K, V) float32)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or not x.is_cuda:
            raise ValueError(f"{name}: the kernel takes CUDA tensors")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"{name}: float32 or bfloat16 like q expected, "
                             f"got {x.dtype}")
    B, S, H, K = q.shape
    V = v.shape[-1]
    vec = log_decay.dim() == 4
    if tuple(k.shape) != (B, S, H, K) or tuple(v.shape[:3]) != (B, S, H):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if tuple(log_decay.shape) != ((B, S, H, K) if vec else (B, S, H)):
        raise ValueError(f"log_decay: (B, S, H[, K]) expected, got "
                         f"{tuple(log_decay.shape)}")
    if not (1 <= K <= MAX_DIM and 1 <= V <= MAX_DIM):
        raise ValueError(f"the kernel takes K, V <= {MAX_DIM} (K={K}, V={V})")
    extra = [("log_decay", log_decay)]
    if bonus is not None:
        if tuple(bonus.shape) != (H, K):
            raise ValueError(f"bonus: ({H}, {K}) expected")
        extra.append(("bonus", bonus))
    if initial_state is not None:
        if tuple(initial_state.shape) != (B, H, K, V):
            raise ValueError(f"initial_state: ({B}, {H}, {K}, {V}) expected")
        extra.append(("initial_state", initial_state))
    for name, x in extra:
        if not x.is_cuda or x.dtype != torch.float32:
            raise ValueError(f"{name}: float32 CUDA tensor expected")
        if x.device != q.device:
            raise ValueError("all operands must be on one CUDA device")
    if any(x.device != q.device for x in (k, v)):
        raise ValueError("all operands must be on one CUDA device")
    if (bonus is not None and not bonus.is_contiguous()) or (
            initial_state is not None and not initial_state.is_contiguous()):
        raise ValueError("bonus and initial_state must be contiguous")
    name = route(q.dtype, K, V, vec=vec, bonus=bonus is not None,
                 strict=strict)
    out = run_source(name, q, k, v, log_decay, bonus=bonus, strict=strict,
                     chunk=chunk, initial_state=initial_state)
    if B * H:
        gla_cuda.launches += 1
        gla_cuda.routes[name] += 1
    return out


def run_source(name: str, q, k, v, log_decay, *, bonus=None,
               strict: bool = False, chunk: int = 64, initial_state=None):
    """Launch source ``name`` on operands ``gla_cuda`` has checked (and
    count nothing): ``gla_cuda`` calls it with its route; ``chip_smoke.py``
    and ``tools/gla_probe.py`` call it to time another source on the same
    call. Returns (o, final_state)."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    vec = log_decay.dim() == 4
    sq, sk = nvcc.lead_strides("q", q, 4), nvcc.lead_strides("k", k, 4)
    sv = nvcc.lead_strides("v", v, 4)
    sl = nvcc.lead_strides("log_decay", log_decay, 4 if vec else 3)
    o = torch.empty((B, S, H, V), dtype=q.dtype, device=q.device)
    hT = torch.empty((B, H, K, V), dtype=torch.float32, device=q.device)
    if B * H == 0:
        return o, hT
    fn = _load(name)
    if name == "gla_ssd":
        nvcc.launch(fn, q.device, (
            q, k, v, log_decay, initial_state, o, hT, B, S, H, K, V,
            *sq, *sk, *sv, *sl), name)
    elif name == "gla_vec":
        nvcc.launch(fn, q.device, (
            q, k, v, log_decay, bonus, initial_state, o, hT, B, S, H, K, V,
            *sq, *sk, *sv, *sl, int(bool(strict))), name)
    else:
        nvcc.launch(fn, q.device, (
            q, k, v, log_decay, bonus, initial_state, o, hT,
            _DTYPES[q.dtype], B, S, H, K, V, *sq, *sk, *sv, *sl, int(vec),
            int(bool(strict))), name)
    return o, hT


gla_cuda.launches = 0
gla_cuda.routes = dict.fromkeys(SOURCES, 0)   # calls by route


def gla_flops(B, S, H, K, V, *, vec=False, bonus=False, strict=False,
              chunk=64) -> int:
    """Multiply-add operations of the reference's work, two each (the
    pairs of a tile counted over its valid rows, the state update over the
    whole tile): per row the inter-tile term 2 K V
    and the bonus 2 K + 2 V; per attended (t, s) pair the score 2 K (3 K
    with per-channel decay) and the intra-tile term 2 V; per tile the
    state update 2 T K V. Exponentials are not counted."""
    T = tile_rows(chunk)
    full, rest = divmod(S, T)

    def pairs(n):
        return n * (n - 1) // 2 if strict else n * (n + 1) // 2

    n_pairs = full * pairs(T) + pairs(rest)
    tiles = full + (rest > 0)
    per_row = 2 * K * V + ((2 * K + 2 * V) if bonus else 0)
    per_pair = (3 if vec else 2) * K + 2 * V
    return B * H * (S * per_row + n_pairs * per_pair + tiles * 2 * T * K * V)


def _stored_bytes(x) -> int:
    """Bytes of a tensor's distinct elements (dims of stride 0, a broadcast,
    count once)."""
    n = 1
    for size, st in zip(x.shape, x.stride()):
        if st != 0:
            n *= size
    return n * x.element_size()


def gla_bytes(q, k, v, log_decay, *, bonus=None, initial_state=None) -> int:
    """Bytes the scan must move: each input read once (a broadcast operand
    as stored), o and the float32 final state written once."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    ins = sum(_stored_bytes(x) for x in (q, k, v, log_decay, bonus,
                                          initial_state) if x is not None)
    return ins + B * S * H * V * v.element_size() + 4 * B * H * K * V
