"""The attention op the models call: the counterpart of
``repro.kernels.flash_attention.ops.attention``.

A CUDA tensor goes to the hand-written kernel (kernel #4), the decode call
with its cache ``length`` and runtime ``q_offset`` included; a CPU tensor
goes to the plain ``ref.attention_chunked``. There is no fallback from one
to the other.

Gradients: the reference has no backward kernel (its CPU path
differentiates through ``ref.attention_chunked``), so a CUDA call that
autograd records goes through ``FlashAttention``, whose forward is the
kernel and whose backward recomputes the plain version on the saved q, k
and v under autograd. A call that records nothing (serving, under
``torch.inference_mode``) launches the kernel alone.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


class FlashAttention(torch.autograd.Function):
    """``apply(q, k, v, forward, opts)``: ``forward(q, k, v, **opts)`` (the
    kernel on the card; a test passes the plain version), and as backward
    the gradient of ``ref.attention_chunked(q, k, v, **opts)``."""

    @staticmethod
    def forward(ctx, q, k, v, forward, opts):
        ctx.save_for_backward(q, k, v)
        ctx.opts = opts
        return forward(q, k, v, **opts)

    @staticmethod
    def backward(ctx, do):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            o = _ref.attention_chunked(*xs, **ctx.opts)
            grads = iter(torch.autograd.grad(
                o, [x for x in xs if x.requires_grad], do))
        return (*(next(grads) if n else None for n in need), None, None)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, q_offset: int = 0,
              length: Optional[int] = None, scale: Optional[float] = None):
    """Multi-head (GQA) attention. q: (B, Sq, N, H); k, v: (B, Sk, K, H)
    with N % K == 0; see ``ref.attention_reference`` for the options."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, length=length, scale=scale)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v,
                                        _kernel.flash_attention_cuda, kw)
        return _kernel.flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return _ref.attention_chunked(q, k, v, **kw)
    raise ValueError(f"no attention route for device {q.device}")
