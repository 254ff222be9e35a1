"""Error-feedback int8 gradient compression: the counterpart of
``repro.optim.compression``.

Each gradient leaf is quantized to int8 with one scale per leaf; the
quantization residual is carried in an error-feedback buffer, so the
compression is unbiased over time (Seide et al. / EF-SGD). The compressed
form is what a runner would all-reduce between hosts; on one card the
trainer takes the round trip (``roundtrip``) inside its step when asked.
Trees are dicts of tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

f32 = torch.float32


def init_error_feedback(params):
    return {k: torch.zeros(p.shape, dtype=f32, device=p.device)
            for k, p in params.items()}


def _one(g, e):
    g = g.to(f32) + e
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale, g - q.to(f32) * scale


@torch.no_grad()
def compress(grads, ef):
    """Returns ((int8 dict, scales dict), new error feedback)."""
    qs, scales, errs = {}, {}, {}
    for k, g in grads.items():
        qs[k], scales[k], errs[k] = _one(g, ef[k])
    return (qs, scales), errs


def decompress(qtree, scales):
    return {k: q.to(f32) * scales[k] for k, q in qtree.items()}


def roundtrip(grads, ef) -> Tuple:
    """compress + decompress (what an all-reduce between hosts would
    carry)."""
    (q, s), ef = compress(grads, ef)
    return decompress(q, s), ef
