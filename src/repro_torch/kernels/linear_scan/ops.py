"""The GLA op the models call: the counterpart of
``repro.kernels.linear_scan.ops``.

``gla`` sends a CUDA tensor to the hand-written scan (kernel #5) and a CPU
tensor to the plain ``ref.gla_chunked``; there is no fallback from one to
the other. ``gla_step`` is the plain decode step on either device: one
token is O(1) work, so it needs no kernel (as in the reference).

Gradients: the reference has no backward kernel (its CPU path
differentiates through ``ref.gla_chunked``), so a CUDA call that autograd
records goes through ``GLAScan``, whose forward is the kernel and whose
backward recomputes the plain version on the saved inputs under autograd.
A call that records nothing (serving) launches the kernel alone.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan import kernel as _kernel
from repro_torch.kernels.linear_scan import ref as _ref

gla_step = _ref.gla_step


class GLAScan(torch.autograd.Function):
    """``apply(q, k, v, log_decay, bonus, initial_state, forward, opts)``:
    ``forward(q, k, v, log_decay, bonus=, initial_state=, **opts)`` (the
    kernel on the card; a test passes the plain version) -> (o,
    final_state); as backward the gradient of ``ref.gla_chunked`` on the
    same inputs, to q, k, v, log_decay, bonus and initial_state (those
    given), from the gradients of o and of the final state that are
    used."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, bonus, initial_state, forward,
                opts):
        ctx.save_for_backward(q, k, v, log_decay, bonus, initial_state)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        return forward(q, k, v, log_decay, bonus=bonus,
                       initial_state=initial_state, **opts)

    @staticmethod
    def backward(ctx, do, dstate):
        need = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            xs = [None if x is None else x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            q, k, v, ld, bonus, h0 = xs
            outs = _ref.gla_chunked(q, k, v, ld, bonus=bonus,
                                    initial_state=h0, **ctx.opts)
            used = [(o, g) for o, g in zip(outs, (do, dstate))
                    if g is not None]
            wrt = [x for x, n in zip(xs, need) if n]
            if not used:
                return (None,) * 8
            grads = iter(torch.autograd.grad(
                [o for o, _ in used], wrt, [g for _, g in used],
                allow_unused=True))
        return (*(next(grads) if n else None for n in need), None, None)


def gla(q, k, v, log_decay, *, bonus=None, strict: bool = False,
        chunk: int = 64, initial_state=None):
    """Chunked gated linear attention; see ``ref.gla_chunked`` for shapes.
    Returns (o, final_state)."""
    kw = dict(strict=strict, chunk=chunk)
    if q.device.type == "cuda":
        inputs = (q, k, v, log_decay, bonus, initial_state)
        if torch.is_grad_enabled() and any(
                x is not None and x.requires_grad for x in inputs):
            return GLAScan.apply(*inputs, _kernel.gla_cuda, kw)
        return _kernel.gla_cuda(q, k, v, log_decay, bonus=bonus,
                                initial_state=initial_state, **kw)
    if q.device.type == "cpu":
        return _ref.gla_chunked(q, k, v, log_decay, bonus=bonus,
                                initial_state=initial_state, **kw)
    raise ValueError(f"no gla route for device {q.device}")
