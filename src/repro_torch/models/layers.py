"""Shared model building blocks: initialisers, norms, RoPE, soft-capping,
sinusoidal positions, MLPs and the chunked vocabulary loss. The
counterpart of ``repro.models.layers``.

Initialisers draw from an explicit ``torch.Generator`` on the device the
weights live on. They follow the reference's distributions (truncated
normal over fan-in, normal embeddings), not its random stream: the parity
tests carry the reference's weights across (``convert.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

f32 = torch.float32


def torch_dtype(name: str) -> torch.dtype:
    """A config's ``dtype`` string as a torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------- init utils

def dense_init(shape, in_axes=(0,), dtype=torch.bfloat16, scale=1.0, *,
               generator, device):
    """Truncated normal (at +-2) with stddev scale / sqrt(fan_in)."""
    fan_in = math.prod(shape[a] for a in in_axes)
    w = torch.empty(shape, dtype=f32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    # scaled in place: a second float32 copy of DeepSeek-V2's experts
    # (10 GB a layer) would not fit beside the weights built before it
    return w.mul_(scale * fan_in ** -0.5).to(dtype)


def embed_init(vocab, d, dtype=torch.bfloat16, *, generator, device):
    w = torch.randn((vocab, d), dtype=f32, device=device,
                    generator=generator)
    return (w * d ** -0.5).to(dtype)


def init_rms(d, *, device):
    return torch.zeros((d,), dtype=f32, device=device)  # (1 + scale)


def init_ln(d, *, device, shape=None) -> nn.ParameterDict:
    """A layer norm's float32 ``scale`` (ones) and ``bias`` (zeros) of
    ``shape`` (default (d,)), as the reference's ``{"scale", "bias"}``."""
    shape = (d,) if shape is None else shape
    return nn.ParameterDict({
        "scale": param(torch.ones(shape, dtype=f32, device=device)),
        "bias": param(torch.zeros(shape, dtype=f32, device=device))})


def param(x) -> nn.Parameter:
    """A weight that takes gradients (the trainer's); serving runs under
    ``torch.inference_mode``, which records nothing for it."""
    return nn.Parameter(x)


# --------------------------------------------------------------------- norms

def rms_norm(x, scale, eps=1e-6):
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(f32))
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis in float32 with the population
    variance (``jnp.var``'s mean squared deviation), cast back to x's
    type."""
    xf = x.to(f32)
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.to(f32) + bias.to(f32)).to(x.dtype)


def group_norm_heads(x, scale, bias, eps=1e-5):
    """Per-head layer norm (RWKV's ``ln_x``): x (..., H, hd) normalised
    over hd; scale, bias (H, hd)."""
    return layer_norm(x, scale, bias, eps)


# ---------------------------------------------------------------------- rope

def rope(x, positions, theta: float):
    """Rotary embedding, llama rotate-half convention. x: (B, S, N, H);
    positions: (S,) or (B, S)."""
    if theta == 0.0:
        return x
    H = x.shape[-1]
    half = H // 2
    freqs = torch.pow(float(theta), -torch.arange(
        0, half, dtype=f32, device=x.device) / half)
    pos = positions.to(f32)
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[:, :, None] * freqs[None, None, :]        # (B|1, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.to(f32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def sinusoidal_positions(positions, d: int, base: float = 10_000.0):
    """Whisper-style sinusoidal embeddings in float32: positions (S,) ->
    (S, d), the sines of the d // 2 frequencies, then their cosines."""
    half = d // 2
    freqs = torch.pow(float(base), -torch.arange(
        half, dtype=f32, device=positions.device) / max(half - 1, 1))
    ang = positions.to(f32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ----------------------------------------------------------------------- mlp

class MLP(nn.Module):
    """``init_mlp`` / ``apply_mlp``: swiglu, geglu (tanh GELU, as
    ``jax.nn.gelu``), gelu and relu2."""

    def __init__(self, d_model, d_ff, act: str, dtype, *, generator,
                 device):
        super().__init__()
        gated = act in ("swiglu", "geglu")
        if act not in ("swiglu", "geglu", "gelu", "relu2"):
            raise ValueError(act)
        self.act = act
        self.wi = param(dense_init((d_model, (2 if gated else 1) * d_ff),
                                   (0,), dtype, generator=generator,
                                   device=device))
        self.wo = param(dense_init((d_ff, d_model), (0,), dtype,
                                   generator=generator, device=device))

    def forward(self, x):
        h = x @ self.wi
        if self.act in ("swiglu", "geglu"):
            g, u = h.chunk(2, dim=-1)
            g = F.silu(g) if self.act == "swiglu" else \
                F.gelu(g, approximate="tanh")
            h = g * u
        elif self.act == "gelu":
            h = F.gelu(h, approximate="tanh")
        else:
            h = torch.square(F.relu(h))
        return h @ self.wo


# -------------------------------------------------------- chunked vocab loss

def _xent_chunk(h, head, labels, mask, cap):
    """One chunk's sums: (sum nll, sum lse^2, sum correct, sum mask). The
    logits are float32 products of the native-type operands, as the
    reference's ``preferred_element_type=float32`` einsum."""
    logits = softcap(h.to(f32) @ head.to(f32).T, cap)          # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    correct = (torch.argmax(logits, -1) == labels).to(f32) * mask
    return (((lse - ll) * mask).sum(), (torch.square(lse) * mask).sum(),
            correct.sum(), mask.sum())


def chunked_xent(hidden, head, labels, *, mask=None,
                 logit_softcap: Optional[float] = None, chunk: int = 512,
                 z_loss: float = 1e-4):
    """Cross-entropy over a large vocabulary without materializing all the
    logits: the counterpart of ``repro.models.layers.chunked_xent``.

    hidden: (B, S, D); head: (V, D) (the unembedding or tied embedding);
    labels: (B, S) int; mask: (B, S) or None. The sequence is cut into
    chunks of ``chunk`` positions; each chunk's (B, chunk, V) logits are
    transient: ``torch.utils.checkpoint`` keeps only its inputs and
    recomputes them in the backward pass (the reference's
    ``jax.checkpoint(body)``). The last chunk is not padded to ``chunk``
    (the reference pads it with masked positions, which add exact zeros).
    Returns (mean loss + ``z_loss`` x mean lse^2, {"xent", "accuracy",
    "tokens"})."""
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=f32, device=hidden.device)
    mask = mask.to(f32)
    labels = labels.long()
    sums = [torch.zeros((), dtype=f32, device=hidden.device)] * 4
    for i in range(0, S, chunk):
        part = checkpoint(_xent_chunk, hidden[:, i:i + chunk], head,
                          labels[:, i:i + chunk], mask[:, i:i + chunk],
                          logit_softcap, use_reentrant=False)
        sums = [a + b for a, b in zip(sums, part)]
    nll, zl, correct, n = sums
    n = torch.clamp(n, min=1.0)
    loss = nll / n + z_loss * zl / n
    return loss, {"xent": nll / n, "accuracy": correct / n, "tokens": n}
