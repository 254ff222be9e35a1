"""The attention op the models call: the counterpart of
``repro.kernels.flash_attention.ops.attention``.

A CUDA tensor goes to the hand-written kernel (kernel #4), the decode call
with its cache ``length`` and runtime ``q_offset`` included; a CPU tensor
goes to the plain ``ref.attention_chunked``. There is no fallback from one
to the other.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, q_offset: int = 0,
              length: Optional[int] = None, scale: Optional[float] = None):
    """Multi-head (GQA) attention. q: (B, Sq, N, H); k, v: (B, Sk, K, H)
    with N % K == 0; see ``ref.attention_reference`` for the options."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, length=length, scale=scale)
    if q.device.type == "cuda":
        return _kernel.flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return _ref.attention_chunked(q, k, v, **kw)
    raise ValueError(f"no attention route for device {q.device}")
