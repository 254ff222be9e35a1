"""Plain PyTorch attention: the counterpart of
``repro.kernels.flash_attention.ref``.

``attention_reference`` is the exact O(S^2)-memory version; on the CPU it is
what the models run, through ``attention_chunked`` (query-chunked, bounded
memory, the same row softmax). Both take GQA, causal and local masking,
logit soft-capping, cache-length masking for decode and a query position
offset. Products are taken in float32 over the native-dtype operands and
the softmax in float32; the probabilities are rounded to v's type before
they meet v, as the reference does, so the CPU path rounds as JAX does.

``attention_partials`` and ``combine_partials`` are the plain version of
the CUDA decode route's two kernels (split-KV partials and their
log-sum-exp merge); only tests use them.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
f32 = torch.float32


def _mask(qpos, kpos, *, causal, window, length):
    """(Sq, Sk) boolean mask (True = attend). Positions are absolute."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= (qpos[:, None] - kpos[None, :]) < window
    if length is not None:
        m &= kpos[None, :] < length
    return m


def _attend(q, k, v, scale, softcap, mask):
    """One exact attention block. q: (B,Sq,N,H); k,v: (B,Sk,K,H);
    mask: (Sq,Sk). Longer query blocks expand the KV heads to the N query
    heads; decode-sized ones (Sq <= 16) group the query heads by KV head,
    as the reference does."""
    B, Sq, N, H = q.shape
    _, Sk, K, _ = k.shape
    G = N // K
    if Sq > 16:
        if G > 1:
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
        s = torch.einsum("bqnh,bsnh->bnqs", q.to(f32), k.to(f32)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bnqs,bsnh->bqnh", p.to(v.dtype).to(f32), v.to(f32))
        return o.to(q.dtype)
    qg = q.reshape(B, Sq, K, G, H)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.to(f32), k.to(f32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).to(f32), v.to(f32))
    return o.reshape(B, Sq, N, H).to(q.dtype)


def attention_reference(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: int = 0, length: Optional[int] = None,
                        scale: Optional[float] = None):
    """Exact attention. q: (B,Sq,N,H); k,v: (B,Sk,K,H); N % K == 0.

    q_offset: absolute position of q[0] (decode: the current position).
    length: k positions >= length are masked out (the valid cache length).
    Returns (B, Sq, N, H) in q's dtype."""
    B, Sq, N, H = q.shape
    Sk = k.shape[1]
    scale = (H ** -0.5) if scale is None else scale
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    m = _mask(qpos, kpos, causal=causal, window=window, length=length)
    return _attend(q, k, v, scale, softcap, m)


def attention_chunked(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      q_offset: int = 0, length: Optional[int] = None,
                      scale: Optional[float] = None, q_chunk: int = 512):
    """Query-chunked attention with bounded memory (full-K rows per chunk):
    the same rows as ``attention_reference``, O(q_chunk * Sk) scores at a
    time."""
    Sq, H = q.shape[1], q.shape[3]
    if Sq <= q_chunk:
        return attention_reference(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   length=length, scale=scale)
    scale = (H ** -0.5) if scale is None else scale
    kpos = torch.arange(k.shape[1], device=q.device)
    # the last chunk is zero-padded to q_chunk rows, as the reference pads
    # it, so every chunk takes the same path through _attend
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, (-Sq) % q_chunk))
    outs = []
    for i in range(0, Sq, q_chunk):
        qpos = q_offset + i + torch.arange(q_chunk, device=q.device)
        m = _mask(qpos, kpos, causal=causal, window=window, length=length)
        outs.append(_attend(qp[:, i:i + q_chunk], k, v, scale, softcap, m))
    return torch.cat(outs, dim=1)[:, :Sq]


def key_span(Sq, Sk, *, causal=True, window=None, q_offset=0, length=None):
    """[begin, end): the keys some of the Sq query rows at ``q_offset``
    attends, as the decode route cuts them into splits (end <= begin: no
    key)."""
    end = Sk if length is None else int(length)
    if causal:
        end = min(end, q_offset + Sq)
    begin = 0 if window is None else max(0, q_offset - int(window) + 1)
    return begin, end


def split_bounds(splits, **span):
    """The decode route's key splits: ``key_span`` cut into ``splits``
    chunks of ceil(keys / splits) keys, the last ones possibly empty."""
    begin, end = key_span(**span)
    chunk = -(-max(0, end - begin) // splits)
    return [(min(begin + i * chunk, end), min(begin + (i + 1) * chunk, end))
            for i in range(splits)]


def attention_partials(q, k, v, splits: int, *, causal: bool = True,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None, q_offset: int = 0,
                       length: Optional[int] = None,
                       scale: Optional[float] = None):
    """Per key split (``split_bounds``), float32 (m, l, acc): the row max of
    the masked scores (-1e30 where the split has no key), the sum of
    exp(s - m) and that sum over v. Shapes (splits, B, Sq, N), (splits, B,
    Sq, N) and (splits, B, Sq, N, H); q, k, v as ``attention_reference``.
    The probabilities are not rounded to v's type."""
    B, Sq, N, H = q.shape
    _, Sk, K, _ = k.shape
    G = N // K
    scale = (H ** -0.5) if scale is None else scale
    qpos = q_offset + torch.arange(Sq, device=q.device)
    mask = _mask(qpos, torch.arange(Sk, device=q.device), causal=causal,
                 window=window, length=length)
    s = torch.einsum("bqkgh,bskh->bqkgs", q.to(f32).reshape(B, Sq, K, G, H),
                     k.to(f32)).reshape(B, Sq, N, Sk) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[None, :, None, :], s, NEG_INF)
    vn = v.to(f32).repeat_interleave(G, dim=2)
    ms, ls, accs = [], [], []
    for a, e in split_bounds(splits, Sq=Sq, Sk=Sk, causal=causal,
                             window=window, q_offset=q_offset,
                             length=length):
        if a >= e:
            ms.append(torch.full((B, Sq, N), NEG_INF, device=q.device))
            ls.append(torch.zeros((B, Sq, N), device=q.device))
            accs.append(torch.zeros((B, Sq, N, H), device=q.device))
            continue
        m = s[..., a:e].amax(-1)
        p = torch.exp(s[..., a:e] - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bqns,bsnh->bqnh", p, vn[:, a:e]))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials(m, l, acc, dtype=f32):
    """The log-sum-exp merge of ``attention_partials``: with M = max_s m_s,
    sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30), in
    ``dtype``."""
    w = torch.exp(m - m.amax(0))
    den = (w * l).sum(0).clamp_min(1e-30)
    return ((w[..., None] * acc).sum(0) / den[..., None]).to(dtype)
