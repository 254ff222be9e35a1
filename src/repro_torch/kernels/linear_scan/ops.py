"""The GLA op the models call: the counterpart of
``repro.kernels.linear_scan.ops``.

``gla`` sends a CUDA tensor to the hand-written scan (kernel #5) and a CPU
tensor to the plain ``ref.gla_chunked``; there is no fallback from one to
the other. ``gla_step`` is the plain decode step on either device: one
token is O(1) work, so it needs no kernel (as in the reference).
"""
from __future__ import annotations

from repro_torch.kernels.linear_scan import kernel as _kernel
from repro_torch.kernels.linear_scan import ref as _ref

gla_step = _ref.gla_step


def gla(q, k, v, log_decay, *, bonus=None, strict: bool = False,
        chunk: int = 64, initial_state=None):
    """Chunked gated linear attention; see ``ref.gla_chunked`` for shapes.
    Returns (o, final_state)."""
    kw = dict(bonus=bonus, strict=strict, chunk=chunk,
              initial_state=initial_state)
    if q.device.type == "cuda":
        return _kernel.gla_cuda(q, k, v, log_decay, **kw)
    if q.device.type == "cpu":
        return _ref.gla_chunked(q, k, v, log_decay, **kw)
    raise ValueError(f"no gla route for device {q.device}")
