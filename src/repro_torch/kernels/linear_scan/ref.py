"""Plain PyTorch chunked gated linear attention (GLA): the counterpart of
``repro.kernels.linear_scan.ref``.

One primitive covers both recurrent families:

* **Mamba2 / SSD** (scalar per-head decay): ``h_t = d_t h_{t-1} + k_t v_t^T``,
  ``o_t = q_t @ h_t`` (inclusive, ``strict=False``);
* **RWKV6** (per-key-dim decay and bonus): ``h_t = diag(w_t) h_{t-1} +
  k_t v_t^T``, ``o_t = q_t @ (h_{t-1} + diag(u) k_t v_t^T)`` (``strict=True``,
  ``bonus=u``).

The chunked form takes the intra-chunk decay products pairwise, so every
exponent is <= 0 and strong decays cannot overflow. ``gla_naive`` is the
sequential recurrence that validates it; ``gla_step`` is one decode step.
All arithmetic is float32; outputs take q's type, states stay float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
f32 = torch.float32


def _effective_cum(cum, strict):
    """Query-side cumulative log decay: cum[t] (inclusive) or cum[t-1]
    (strict), along axis 1."""
    if not strict:
        return cum
    pad = [0, 0] * (cum.dim() - 2) + [1, 0]
    return F.pad(cum, pad)[:, :-1]


def _initial(initial_state, B, H, K, V, device):
    if initial_state is None:
        return torch.zeros((B, H, K, V), dtype=f32, device=device)
    return initial_state.to(f32)


def gla_naive(q, k, v, log_decay, *, bonus=None, strict: bool = False,
              initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential recurrence. q, k: (B, S, H, K); v: (B, S, H, V);
    log_decay: (B, S, H) or (B, S, H, K); bonus: (H, K) or None;
    initial_state: (B, H, K, V) or None. Returns (o (B, S, H, V),
    final_state (B, H, K, V))."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    scalar = log_decay.dim() == 3
    h = _initial(initial_state, B, H, K, V, q.device)
    outs = []
    for t in range(S):
        qt, kt, vt = q[:, t].to(f32), k[:, t].to(f32), v[:, t].to(f32)
        d = torch.exp(log_decay[:, t].to(f32))
        d = d[..., None, None] if scalar else d[..., :, None]
        kv = kt[..., :, None] * vt[..., None, :]
        if strict:
            ho = h
            if bonus is not None:
                ho = ho + bonus.to(f32)[None, :, :, None] * kv
            o = torch.einsum("bhk,bhkv->bhv", qt, ho)
            h = d * h + kv
        else:
            h = d * h + kv
            o = torch.einsum("bhk,bhkv->bhv", qt, h)
        outs.append(o)
    return torch.stack(outs, 1).to(q.dtype), h


def gla_chunked(q, k, v, log_decay, *, bonus=None, strict: bool = False,
                chunk: int = 64, initial_state=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked (parallel within a chunk) GLA. Same contract as
    ``gla_naive``; the ragged tail is padded with decay 0 (factor 1) and
    k 0 (no state contribution), as the reference pads it."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    scalar = log_decay.dim() == 3
    c = min(chunk, S)
    pad = (-S) % c
    nc = (S + pad) // c

    def chunks(x):  # (B, S, ...) -> (B, nc, c, ...), zero-padded
        x = F.pad(x, [0, 0] * (x.dim() - 2) + [0, pad])
        return x.reshape((B, nc, c) + x.shape[2:])

    qp, kp, vp, ldp = (chunks(x) for x in (q, k, v, log_decay))
    h = _initial(initial_state, B, H, K, V, q.device)
    t_idx = torch.arange(c, device=q.device)
    valid = (t_idx[:, None] > t_idx[None, :]) if strict else \
        (t_idx[:, None] >= t_idx[None, :])
    outs = []
    for j in range(nc):
        qc, kc, vc = qp[:, j].to(f32), kp[:, j].to(f32), vp[:, j].to(f32)
        cum = torch.cumsum(ldp[:, j].to(f32), dim=1)      # (B, c, H[, K])
        cum_q = _effective_cum(cum, strict)
        cum_last = cum[:, -1]                              # (B, H[, K])
        # inter-chunk: the queries against the chunk-start state
        qs = qc * torch.exp(cum_q[..., None] if scalar else cum_q)
        o = torch.einsum("bthk,bhkv->bthv", qs, h)
        # intra-chunk
        if scalar:
            dmat = cum_q[:, :, None] - cum[:, None, :]    # (B, t, s, H)
            dmat = torch.where(valid[None, :, :, None], dmat, NEG_INF)
            A = torch.einsum("bthk,bshk->btsh", qc, kc) * torch.exp(dmat)
        else:
            dmat = cum_q[:, :, None] - cum[:, None, :]    # (B, t, s, H, K)
            dmat = torch.where(valid[None, :, :, None, None], dmat, NEG_INF)
            A = torch.einsum("bthk,bshk,btshk->btsh", qc, kc,
                             torch.exp(dmat))
        o = o + torch.einsum("btsh,bshv->bthv", A, vc)
        if bonus is not None:
            coef = torch.einsum("bthk,hk,bthk->bth", qc, bonus.to(f32), kc)
            o = o + coef[..., None] * vc
        # state update
        decay_out = torch.exp(cum_last)
        rem = cum_last[:, None] - cum
        ks = kc * (torch.exp(rem)[..., None] if scalar else torch.exp(rem))
        h = (decay_out[..., None, None] if scalar
             else decay_out[..., :, None]) * h
        h = h + torch.einsum("bthk,bthv->bhkv", ks, vc)
        outs.append(o)
    o = torch.stack(outs, 1).reshape(B, nc * c, H, V)[:, :S]
    return o.to(q.dtype), h


def gla_step(q, k, v, log_decay, state, *, bonus=None, strict: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. q, k: (B, H, K); v: (B, H, V); log_decay: (B, H)
    or (B, H, K); state: (B, H, K, V). Returns (o (B, H, V), new state)."""
    scalar = log_decay.dim() == 2
    d = torch.exp(log_decay.to(f32))
    d = d[..., None, None] if scalar else d[..., :, None]
    kv = k.to(f32)[..., :, None] * v.to(f32)[..., None, :]
    st = state.to(f32)
    if strict:
        ho = st
        if bonus is not None:
            ho = ho + bonus.to(f32)[None, :, :, None] * kv
        o = torch.einsum("bhk,bhkv->bhv", q.to(f32), ho)
        new = d * st + kv
    else:
        new = d * st + kv
        o = torch.einsum("bhk,bhkv->bhv", q.to(f32), new)
    return o.to(q.dtype), new
