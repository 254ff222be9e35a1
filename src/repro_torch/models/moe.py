"""Fine-grained Mixture-of-Experts (the DeepSeekMoE family): shared experts,
always on, plus routed experts with top-k gating. The counterpart of
``repro.models.moe``.

Tokens are cut into dispatch groups (``apply_moe``); each group routes its
tokens with a float32 softmax and top-k (``_route``), assigns slots
GShard-style (``_positions``: choice j takes the slots after all choices
< j, and an assignment past the expert's capacity is dropped), and runs
one of the reference's two dispatches, chosen by ``MoEConfig.dispatch``:

* ``"einsum"``: one-hot (group, token, expert, slot) dispatch and combine
  tensors, contracted with the tokens and the experts' outputs;
* ``"scatter"``: each kept token written to its (expert, slot) row, and
  gathered back from it.

Every expert is a SwiGLU over its (capacity, d_model) slots
(``_experts``). The reference computes all of this with plain ``jnp``
products and no Pallas kernel, so the port computes it with
``torch.einsum`` and indexing; decode (``no_drop=True``) gives every
expert a slot for each token of the group.

The functions take ``p``, the ``MoE`` module (``p.router``, ``p.wi``,
``p.wo``, ``p.shared``), where the reference takes its parameter dict.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models import layers as L

f32 = torch.float32


class MoE(nn.Module):
    """``init_moe``'s parameters: the float32 ``router`` (D, E), the
    experts' ``wi`` (E, D, 2F) and ``wo`` (E, F, D) with fan-in D and F,
    and the ``shared`` SwiGLU of width ``num_shared`` x F."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        m = cfg.moe
        D, E, Fe = cfg.d_model, m.num_experts, m.d_expert
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.router = L.param(L.dense_init((D, E), (0,), f32, **kw))
        self.wi = L.param(L.dense_init((E, D, 2 * Fe), (1,), dtype, **kw))
        self.wo = L.param(L.dense_init((E, Fe, D), (1,), dtype, **kw))
        if m.num_shared:
            self.shared = L.MLP(D, m.num_shared * Fe, "swiglu", dtype, **kw)

    def forward(self, x, *, no_drop: bool = False):
        return apply_moe(self, self.cfg, x, no_drop=no_drop)


@contextmanager
def _no_tf32():
    """cuBLAS in IEEE float32 for the router: a TF32 product (the state a
    caller may have set) would move probabilities by ~1e-3 and flip
    routes."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = before


def _top_k(probs, k: int):
    """``lax.top_k`` on the last axis: the k largest, ties to the lower
    index (the first k of a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(m, xg, router):
    """Top-k routing. xg: (G, S, D) -> probs (G, S, E), gate weights and
    expert indices (G, S, k)."""
    with _no_tf32():
        logits = torch.einsum("gsd,de->gse", xg.to(f32), router)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, m.top_k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def _aux_loss(m, probs, topi):
    """Switch-style load-balancing loss (per group, then averaged)."""
    E = m.num_experts
    me = probs.mean(dim=(0, 1))                               # (E,)
    ce = F.one_hot(topi[..., 0], E).to(f32).mean(dim=(0, 1))
    return E * torch.sum(me * ce)


def _capacity(m, S: int, no_drop: bool = False) -> int:
    if no_drop:
        return S        # worst case: every token routes to the same expert
    return max(1, int(S * m.top_k / m.num_experts * m.capacity_factor))


def _positions(m, topi, S, no_drop=False):
    """GShard slot assignment: choice j gets the slots after choices < j.
    Returns (pos (G, S, k) int64 slot in the expert, keep (G, S, k))."""
    E = m.num_experts
    C = _capacity(m, S, no_drop)
    pos_list, keep_list = [], []
    counts = 0
    for j in range(m.top_k):
        mj = F.one_hot(topi[..., j], E)                       # (G, S, E)
        cum = torch.cumsum(mj, dim=1) - mj + counts
        pj = torch.gather(cum, -1, topi[..., j:j + 1])[..., 0]
        keep_list.append(pj < C)
        pos_list.append(pj)
        counts = counts + mj.sum(1, keepdim=True)             # (G, 1, E)
    return torch.stack(pos_list, -1), torch.stack(keep_list, -1)


def _experts(p, xe):
    """xe: (G, E, C, D) -> (G, E, C, D) through each expert's SwiGLU."""
    h = torch.einsum("gecd,edf->gecf", xe, p.wi)
    g, u = h.chunk(2, dim=-1)
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, p.wo)


def _dispatch_einsum(p, m, xg, topv, topi, no_drop=False):
    G, S, D = xg.shape
    E, C = m.num_experts, _capacity(m, S, no_drop)
    pos, keep = _positions(m, topi, S, no_drop)
    dt = xg.dtype
    dispatch = xg.new_zeros((G, S, E, C))
    combine = torch.zeros((G, S, E, C), dtype=f32, device=xg.device)
    for j in range(m.top_k):
        # a dropped choice's slot is past C: its row of the product is
        # zeroed by keep either way, so the clamp changes no entry
        oh = (F.one_hot(topi[..., j], E).to(dt)[..., None]
              * F.one_hot(pos[..., j].clamp(max=C - 1), C).to(dt)[
                  ..., None, :])
        oh = oh * keep[..., j, None, None].to(dt)
        dispatch = dispatch + oh
        combine = combine + oh.to(f32) * topv[..., j, None, None]
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    ye = _experts(p, xe)
    return torch.einsum("gsec,gecd->gsd", combine.to(dt), ye)


def _dispatch_scatter(p, m, xg, topv, topi, no_drop=False):
    """Each kept (expert, slot) pair is one token's, so the kept tokens are
    written without accumulation (no atomic adds, whose order on the card
    is not fixed); a dropped choice, which adds exact zeros at slot C - 1
    in the reference, writes into a spare row that is cut off. The
    gather sums the choices in order, in the activation type."""
    G, S, D = xg.shape
    E, C = m.num_experts, _capacity(m, S, no_drop)
    k = m.top_k
    pos, keep = _positions(m, topi, S, no_drop)
    slot = topi * C + torch.clamp(pos, max=C - 1)              # (G, S, k)
    w = topv * keep.to(f32)
    rows = torch.where(keep, slot, E * C)
    group = torch.arange(G, device=xg.device)[:, None, None].expand(G, S, k)
    buf = xg.new_zeros((G, E * C + 1, D)).index_put(
        (group, rows), xg[:, :, None, :].expand(G, S, k, D))
    xe = buf[:, :E * C].reshape(G, E, C, D)
    ye = _experts(p, xe).reshape(G, E * C, D)
    out = None
    for j in range(k):
        yj = torch.gather(ye, 1, slot[..., j, None].expand(G, S, D))
        term = yj * w[..., j, None].to(ye.dtype)
        out = term if out is None else out + term
    return out


def _group_size(m, B: int, S: int) -> int:
    """The dispatch group size: ``group_size`` tokens, or all B x S of
    them in one group when they do not divide."""
    gs = min(m.group_size, B * S)
    return gs if (B * S) % gs == 0 else B * S


def apply_moe(p, cfg, x, *, no_drop: bool = False):
    """x: (B, S, D) -> (y, aux_loss). Routed top-k + shared experts.
    no_drop=True (decode/serving): capacity covers the worst case so no
    token is ever dropped."""
    m = cfg.moe
    B, S, D = x.shape
    gs = _group_size(m, B, S)
    xg = x.reshape(B * S // gs, gs, D)
    probs, topv, topi = _route(m, xg, p.router)
    dispatch = (_dispatch_scatter if m.dispatch == "scatter"
                else _dispatch_einsum)
    y = dispatch(p, m, xg, topv, topi, no_drop).reshape(B, S, D)
    if m.num_shared:
        y = y + p.shared(x)
    return y, m.router_aux_weight * _aux_loss(m, probs, topi)
