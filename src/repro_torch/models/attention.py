"""Attention mixers: GQA with qk-norm, local/global windows and logit
softcap, and DeepSeek-V2's multi-head latent attention (MLA). The
counterpart of ``repro.models.attention`` (``init_gqa``, ``_project_qkv``,
``apply_gqa``, ``apply_gqa_decode``; ``init_mla``, ``_mla_q``,
``_mla_kv_latent``, ``apply_mla``, ``apply_mla_decode``).

GQA's full-sequence and decode calls both go through
``kernels.flash_attention.ops.attention``: kernel #4 on the card, the plain
version on the CPU. Decode writes the step's key and value into the cache in
place (the reference returns a new cache; in place saves a copy of it a
step) and attends over it with a runtime ``q_offset`` and ``length``.

MLA's full-sequence call expands the latent into per-head keys and values
and goes through the same op; its decode keeps the reference's absorbed
form over the latent cache in plain torch (no kernel), writing the step's
latent entries in place. The reference's sequence-sharded flash decode of
the latent cache (``_mla_flash_decode``, ``cfg.flash_decode``) needs a mesh
and is out of scope on one card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models import layers as L

GLOBAL_WINDOW = 1 << 30  # "no window" sentinel large enough for any seq
f32 = torch.float32


class GQA(nn.Module):
    """Grouped-query attention; parameters as ``init_gqa`` names them."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        a = cfg.attn
        D, N, K, H = cfg.d_model, a.num_heads, a.num_kv_heads, a.head_dim
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.wq = L.param(L.dense_init((D, N, H), (0,), dtype, **kw))
        self.wk = L.param(L.dense_init((D, K, H), (0,), dtype, **kw))
        self.wv = L.param(L.dense_init((D, K, H), (0,), dtype, **kw))
        self.wo = L.param(L.dense_init((N, H, D), (0, 1), dtype, **kw))
        if a.qk_norm:
            self.q_norm = L.param(L.init_rms(H, device=device))
            self.k_norm = L.param(L.init_rms(H, device=device))

    def project_qkv(self, x, positions):
        """``_project_qkv``: (B, S, D) -> q (B, S, N, H), k, v (B, S, K, H)."""
        cfg, a = self.cfg, self.cfg.attn
        B, S, D = x.shape

        def proj(w):
            return (x @ w.reshape(D, -1)).reshape(B, S, w.shape[1],
                                                  w.shape[2])

        q, k, v = proj(self.wq), proj(self.wk), proj(self.wv)
        if a.qk_norm:
            q = L.rms_norm(q, self.q_norm, cfg.norm_eps)
            k = L.rms_norm(k, self.k_norm, cfg.norm_eps)
        q = L.rope(q, positions, a.rope_theta)
        k = L.rope(k, positions, a.rope_theta)
        return q, k, v

    def _out(self, o):
        B, S, N, H = o.shape
        return o.reshape(B, S, N * H) @ self.wo.reshape(N * H, -1)

    def forward(self, x, positions, *, causal: bool = True,
                window: Optional[int] = None, return_kv: bool = False):
        """``apply_gqa``: full-sequence attention. x: (B, S, D)."""
        q, k, v = self.project_qkv(x, positions)
        o = attn_ops.attention(q, k, v, causal=causal, window=window,
                               softcap=self.cfg.attn.attn_softcap)
        out = self._out(o)
        return (out, (k, v)) if return_kv else out

    def decode(self, x, kc, vc, pos: int, *, window: Optional[int] = None):
        """``apply_gqa_decode``: one step at position ``pos``. x: (B, 1, D);
        kc/vc: (B, Smax, K, H), written at ``pos`` in place. Returns
        (out (B, 1, D), kc, vc)."""
        positions = torch.arange(pos, pos + 1, device=x.device)
        q, k, v = self.project_qkv(x, positions)
        kc[:, pos:pos + 1] = k.to(kc.dtype)
        vc[:, pos:pos + 1] = v.to(vc.dtype)
        o = attn_ops.attention(q, kc, vc, causal=True, window=window,
                               softcap=self.cfg.attn.attn_softcap,
                               q_offset=pos, length=pos + 1)
        return self._out(o), kc, vc


class MLA(nn.Module):
    """Multi-head latent attention; parameters as ``init_mla`` names them:
    ``wq_a`` (D, q_lora), ``q_norm``, ``wq_b`` (q_lora, N, nope + rope),
    ``wkv_a`` (D, kv_lora + rope), ``kv_norm``, ``wk_b`` (kv_lora, N, nope),
    ``wv_b`` (kv_lora, N, v) and ``wo`` (N, v, D)."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        m, D, N = cfg.mla, cfg.d_model, cfg.attn.num_heads
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        qh = m.nope_head_dim + m.rope_head_dim
        self.wq_a = L.param(L.dense_init((D, m.q_lora_rank), (0,), dtype,
                                         **kw))
        self.q_norm = L.param(L.init_rms(m.q_lora_rank, device=device))
        self.wq_b = L.param(L.dense_init((m.q_lora_rank, N, qh), (0,), dtype,
                                         **kw))
        self.wkv_a = L.param(L.dense_init(
            (D, m.kv_lora_rank + m.rope_head_dim), (0,), dtype, **kw))
        self.kv_norm = L.param(L.init_rms(m.kv_lora_rank, device=device))
        self.wk_b = L.param(L.dense_init((m.kv_lora_rank, N, m.nope_head_dim),
                                         (0,), dtype, **kw))
        self.wv_b = L.param(L.dense_init((m.kv_lora_rank, N, m.v_head_dim),
                                         (0,), dtype, **kw))
        self.wo = L.param(L.dense_init((N, m.v_head_dim, D), (0, 1), dtype,
                                       **kw))
        self.scale = qh ** -0.5

    def project_q(self, x, positions):
        """``_mla_q``: (B, S, D) -> q_nope (B, S, N, nope), q_rope (B, S, N,
        rope), the latter rotated."""
        cfg, m = self.cfg, self.cfg.mla
        cq = L.rms_norm(x @ self.wq_a, self.q_norm, cfg.norm_eps)
        q = torch.einsum("bsl,lnh->bsnh", cq, self.wq_b)
        q_rope = L.rope(q[..., m.nope_head_dim:], positions,
                        cfg.attn.rope_theta)
        return q[..., :m.nope_head_dim], q_rope

    def kv_latent(self, x, positions):
        """``_mla_kv_latent``: (B, S, D) -> the normed latent ckv (B, S,
        kv_lora) and the rotated, head-shared k_rope (B, S, rope)."""
        cfg, m = self.cfg, self.cfg.mla
        kv = x @ self.wkv_a
        ckv = L.rms_norm(kv[..., :m.kv_lora_rank], self.kv_norm, cfg.norm_eps)
        k_rope = L.rope(kv[..., None, m.kv_lora_rank:], positions,
                        cfg.attn.rope_theta)[:, :, 0]
        return ckv, k_rope

    def forward(self, x, positions, *, return_kv: bool = False):
        """``apply_mla``, the expanded path: per-head keys [k_nope, k_rope
        broadcast over the heads] and values zero-padded to q's head dim,
        so that kernel #4 takes one head dim, then sliced back. x: (B, S,
        D). With ``return_kv``, also (ckv, k_rope) for the cache."""
        m = self.cfg.mla
        q_nope, q_rope = self.project_q(x, positions)
        ckv, k_rope = self.kv_latent(x, positions)
        k_nope = torch.einsum("bsl,lnh->bsnh", ckv, self.wk_b)
        v = torch.einsum("bsl,lnh->bsnh", ckv, self.wv_b)
        q = torch.cat([q_nope, q_rope], -1)
        # cat writes the broadcast rope part out: k is contiguous
        k = torch.cat([k_nope, k_rope[:, :, None].expand(
            *k_nope.shape[:3], m.rope_head_dim)], -1)
        vp = F.pad(v, (0, q.shape[-1] - v.shape[-1]))
        o = attn_ops.attention(q, k, vp, causal=True, scale=self.scale)
        out = torch.einsum("bsnv,nvd->bsd", o[..., :m.v_head_dim], self.wo)
        return (out, (ckv, k_rope)) if return_kv else out

    def decode(self, x, ckv_c, krope_c, pos: int):
        """``apply_mla_decode``: one step at position ``pos`` with W_UK
        absorbed into q. x: (B, 1, D); ckv_c (B, Smax, kv_lora) and
        krope_c (B, Smax, rope), written at ``pos`` in place. q_eff is
        formed in the model's type, the scores, softmax and context in
        float32, and the context cast back before ``wv_b``, as the
        reference casts them. Returns (out (B, 1, D), ckv_c, krope_c)."""
        positions = torch.arange(pos, pos + 1, device=x.device)
        q_nope, q_rope = self.project_q(x, positions)
        ckv, k_rope = self.kv_latent(x, positions)
        ckv_c[:, pos:pos + 1] = ckv.to(ckv_c.dtype)
        krope_c[:, pos:pos + 1] = k_rope.to(krope_c.dtype)
        q_eff = torch.einsum("bqnh,lnh->bqnl", q_nope, self.wk_b)
        ckv_f = ckv_c.to(f32)
        s = (torch.einsum("bqnl,bsl->bnqs", q_eff.to(f32), ckv_f)
             + torch.einsum("bqnr,bsr->bnqs", q_rope.to(f32),
                            krope_c.to(f32))) * self.scale
        mask = torch.arange(ckv_c.shape[1], device=x.device) <= pos
        s = torch.where(mask, s, torch.tensor(-1e30, dtype=f32,
                                              device=x.device))
        ctx = torch.einsum("bnqs,bsl->bqnl", torch.softmax(s, -1), ckv_f)
        o = torch.einsum("bqnl,lnv->bqnv", ctx.to(x.dtype), self.wv_b)
        return torch.einsum("bqnv,nvd->bqd", o, self.wo), ckv_c, krope_c
