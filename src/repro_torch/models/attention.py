"""Attention mixer: GQA with qk-norm, local/global windows and logit
softcap. The counterpart of ``repro.models.attention`` (``init_gqa``,
``_project_qkv``, ``apply_gqa``, ``apply_gqa_decode``); MLA waits for its
models (ROADMAP.md queue 1, item 4).

Both the full-sequence and the decode call go through
``kernels.flash_attention.ops.attention``: kernel #4 on the card, the plain
version on the CPU. Decode writes the step's key and value into the cache in
place (the reference returns a new cache; in place saves a copy of it a
step) and attends over it with a runtime ``q_offset`` and ``length``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models import layers as L

GLOBAL_WINDOW = 1 << 30  # "no window" sentinel large enough for any seq


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
