"""Whisper-style encoder-decoder: the counterpart of
``repro.models.encdec``. The conv / mel frontend is a stub: the encoder
takes precomputed frame embeddings, ``batch["frames"]`` (B, encoder_seq,
d_model).

Pre-LN layer-norm blocks, GELU MLPs (tanh GELU, as ``jax.nn.gelu``),
sinusoidal absolute positions in the encoder and the decoder (the
reference's substitute for Whisper's 448 learned decoder positions), no
rope, an embedding tied to the head and no logit softcap. Every attention
call goes through ``kernels.flash_attention.ops.attention``: the encoder's
non-causal self-attention, the decoder's causal self-attention and its
non-causal cross-attention over the encoder's output (in decode, over the
cross keys and values cached by the prefill).

Layers are modules of ``nn.ModuleList``s named as the reference names its
stacked parameters (``enc_stack``, ``dec_stack``; a decoder layer's
``self`` and ``cross`` attention), so ``convert.model_params_from_numpy``
carries a reference model across. The decode cache holds ``self_k`` /
``self_v`` (L, B, max_seq, N, H), written in place by ``decode_step``, and
``cross_k`` / ``cross_v`` (L, B, encoder_seq, N, H).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import _ln, pad_kv_to

f32 = torch.float32


class Attention(nn.Module):
    """``_init_attn`` / ``_attn``: self- or cross-attention, ``num_heads``
    heads of ``head_dim`` for queries, keys and values, no rope."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        D, N, H = cfg.d_model, cfg.attn.num_heads, cfg.attn.head_dim
        kw = dict(generator=generator, device=device)
        self.wq = L.param(L.dense_init((D, N, H), (0,), dtype, **kw))
        self.wk = L.param(L.dense_init((D, N, H), (0,), dtype, **kw))
        self.wv = L.param(L.dense_init((D, N, H), (0,), dtype, **kw))
        self.wo = L.param(L.dense_init((N, H, D), (0, 1), dtype, **kw))

    @staticmethod
    def _proj(x, w):
        B, S, D = x.shape
        return (x @ w.reshape(D, -1)).reshape(B, S, w.shape[1], w.shape[2])

    def kv(self, x_kv):
        """(B, S, D) -> k, v (B, S, N, H)."""
        return self._proj(x_kv, self.wk), self._proj(x_kv, self.wv)

    def forward(self, x_q, x_kv=None, *, causal: bool, kv=None,
                q_offset: int = 0, length=None):
        """Attention of ``x_q`` over ``x_kv``'s keys and values, or over
        ``kv`` = (k, v) given. Returns (out (B, Sq, D), (k, v))."""
        q = self._proj(x_q, self.wq)
        if kv is None:
            kv = self.kv(x_kv)
        o = attn_ops.attention(q, *kv, causal=causal, q_offset=q_offset,
                               length=length)
        B, S, N, H = o.shape
        return o.reshape(B, S, N * H) @ self.wo.reshape(N * H, -1), kv


class EncoderLayer(nn.Module):
    """``ln1``, non-causal self-attention ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.eps = cfg.norm_eps
        self.ln1 = L.init_ln(cfg.d_model, device=device)
        self.attn = Attention(cfg, dtype, **kw)
        self.ln2 = L.init_ln(cfg.d_model, device=device)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, **kw)

    def forward(self, x):
        h = _ln(self.ln1, x, self.eps)
        x = x + self.attn(h, h, causal=False)[0]
        return x + self.ffn(_ln(self.ln2, x, self.eps))


class DecoderLayer(nn.Module):
    """``ln1``, causal self-attention ``self``, ``ln2``, cross-attention
    ``cross`` over the encoder's output, ``ln3``, ``ffn``."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.eps = cfg.norm_eps
        self.ln1 = L.init_ln(cfg.d_model, device=device)
        self.self = Attention(cfg, dtype, **kw)
        self.ln2 = L.init_ln(cfg.d_model, device=device)
        self.cross = Attention(cfg, dtype, **kw)
        self.ln3 = L.init_ln(cfg.d_model, device=device)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, **kw)

    def forward(self, x, enc_out):
        """Returns (x, self (k, v), cross (k, v))."""
        h = _ln(self.ln1, x, self.eps)
        a, skv = self.self(h, h, causal=True)
        x = x + a
        a, ckv = self.cross(_ln(self.ln2, x, self.eps), enc_out,
                            causal=False)
        x = x + a
        return x + self.ffn(_ln(self.ln3, x, self.eps)), skv, ckv

    def decode(self, x, sk, sv, ck, cv, pos: int):
        """One token at ``pos``: its key and value written into the self
        cache ``sk`` / ``sv`` (B, Smax, N, H) in place, attended with
        ``q_offset=pos, length=pos + 1``; then non-causal attention over
        the cached cross keys and values."""
        h = _ln(self.ln1, x, self.eps)
        k, v = self.self.kv(h)
        sk[:, pos:pos + 1] = k.to(sk.dtype)
        sv[:, pos:pos + 1] = v.to(sv.dtype)
        x = x + self.self(h, causal=True, kv=(sk, sv), q_offset=pos,
                          length=pos + 1)[0]
        x = x + self.cross(_ln(self.ln2, x, self.eps), causal=False,
                           kv=(ck, cv))[0]
        return x + self.ffn(_ln(self.ln3, x, self.eps))


class EncDecLM(nn.Module):
    """``EncDecLM`` (``family == "encdec"``): the embedding (tied to the
    head), ``encoder_layers`` encoder layers and ``enc_norm``,
    ``num_layers`` decoder layers and ``dec_norm``. ``loss``, ``prefill``
    take ``batch = {"tokens": (B, S) int64, "frames": (B, encoder_seq,
    d_model)}``."""

    def __init__(self, cfg, *, generator, device):
        if cfg.family != "encdec":
            raise NotImplementedError(f"EncDecLM takes the encdec family, "
                                      f"not {cfg.family!r}")
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = L.torch_dtype(cfg.dtype)
        kw = dict(generator=generator, device=device)
        self.embed = L.param(L.embed_init(cfg.vocab_size, cfg.d_model, dt,
                                          **kw))
        self.enc_stack = nn.ModuleList(EncoderLayer(cfg, dt, **kw)
                                       for _ in range(cfg.encoder_layers))
        self.enc_norm = L.init_ln(cfg.d_model, device=device)
        self.dec_stack = nn.ModuleList(DecoderLayer(cfg, dt, **kw)
                                       for _ in range(cfg.num_layers))
        self.dec_norm = L.init_ln(cfg.d_model, device=device)

    def _positions(self, start: int, n: int, device):
        pos = torch.arange(start, start + n, device=device)
        return L.sinusoidal_positions(pos, self.cfg.d_model)

    def encode(self, frames):
        """frames (B, S, D) plus sinusoidal positions, the encoder layers,
        ``enc_norm``."""
        pos = self._positions(0, frames.shape[1], frames.device)
        x = frames + pos[None].to(frames.dtype)
        for layer in self.enc_stack:
            x = layer(x)
        return _ln(self.enc_norm, x, self.cfg.norm_eps)

    def decode_full(self, tokens, enc_out, *, collect_kv: bool = False):
        """The decoder over ``tokens`` (B, S) attending ``enc_out``; with
        ``collect_kv``, also each layer's self and cross (k, v)."""
        pos = self._positions(0, tokens.shape[1], tokens.device)
        x = F.embedding(tokens, self.embed) + pos[None].to(self.dtype)
        skvs, ckvs = [], []
        for layer in self.dec_stack:
            x, skv, ckv = layer(x, enc_out)
            skvs.append(skv)
            ckvs.append(ckv)
        x = _ln(self.dec_norm, x, self.cfg.norm_eps)
        return (x, skvs, ckvs) if collect_kv else x

    def _logits(self, x_last):
        return x_last.to(f32) @ self.embed.to(f32).T

    def loss(self, batch):
        """Next-token chunked cross-entropy of ``batch["tokens"]`` given
        ``batch["frames"]``, head tied to the embedding, no softcap, no aux
        loss. Returns (loss, metrics)."""
        tokens = batch["tokens"]
        x = self.decode_full(tokens[:, :-1], self.encode(batch["frames"]))
        return L.chunked_xent(x, self.embed, tokens[:, 1:])

    def init_cache(self, batch: int, max_seq: int):
        cfg, a = self.cfg, self.cfg.attn
        dev = self.embed.device

        def kv(s):
            return torch.zeros((cfg.num_layers, batch, s, a.num_heads,
                                a.head_dim), dtype=self.dtype, device=dev)

        return {"self_k": kv(max_seq), "self_v": kv(max_seq),
                "cross_k": kv(cfg.encoder_seq),
                "cross_v": kv(cfg.encoder_seq)}

    def prefill(self, batch, max_seq: int):
        x, skvs, ckvs = self.decode_full(
            batch["tokens"], self.encode(batch["frames"]), collect_kv=True)

        def stack(kvs, i):
            return torch.stack([kv[i] for kv in kvs])

        cache = {"self_k": pad_kv_to(stack(skvs, 0), max_seq, axis=2),
                 "self_v": pad_kv_to(stack(skvs, 1), max_seq, axis=2),
                 "cross_k": stack(ckvs, 0), "cross_v": stack(ckvs, 1)}
        return self._logits(x[:, -1]), cache

    def decode_step(self, cache, token, pos: int):
        """token: (B,); pos: the self cache's fill position."""
        x = F.embedding(token[:, None], self.embed) + self._positions(
            pos, 1, token.device)[None].to(self.dtype)
        for i, layer in enumerate(self.dec_stack):
            x = layer.decode(x, cache["self_k"][i], cache["self_v"][i],
                             cache["cross_k"][i], cache["cross_v"][i], pos)
        x = _ln(self.dec_norm, x, self.cfg.norm_eps)
        return self._logits(x[:, 0]), cache
