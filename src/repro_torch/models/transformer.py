"""Decoder LMs: ``DecoderLM`` (the dense and MoE families), the hybrid
``ZambaLM`` (Mamba2 backbone plus one weight-shared attention block) and
the attention-free ``RWKVLM`` (RWKV6). The counterpart of
``repro.models.transformer``'s blocks and those models; a block's mixer is
GQA or, where the config has ``mla`` (DeepSeek-V2), MLA, whose cache holds
the latent ``ckv`` and ``krope`` in place of ``k`` and ``v``.

The reference stacks per-layer parameters for ``lax.scan``; here each
layer is a module of an ``nn.ModuleList`` (``stack``; ``groups`` of
``attn_every`` Mamba2 layers and the ``trail`` after them; an MoE model's
leading dense blocks ``prefix_{i}`` stay single modules, as they stay
single subtrees there), named as the reference names its parameters, so
``convert.model_params_from_numpy`` carries a reference model across.
Every model exposes

    loss(batch) -> (loss, metrics)
    init_cache(batch, max_seq) -> decode cache
    prefill(batch, max_seq) -> (last-token logits, cache)
    decode_step(cache, token, pos) -> (logits, cache)

with ``batch = {"tokens": (B, S) int64}`` (``loss`` predicts tokens 1..S-1
from 0..S-2; a VLM's batch also holds ``vision_embeds``), ``token`` (B,)
and ``pos`` a Python int (the cache fill position). Caches keep the
reference's stacked layout and are written in place by ``decode_step``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.moe import MoE

f32 = torch.float32


class Block(nn.Module):
    """``init_block`` / ``apply_block`` / ``apply_block_decode`` with the
    GQA mixer (MLA where the config has ``mla``) and the ``ffn`` of the
    reference's kind: ``"mlp"`` (width ``d_ff``), ``"dense_prefix"`` (an
    MoE model's leading dense blocks, width ``moe.dense_d_ff``) or
    ``"moe"``."""

    def __init__(self, cfg, dtype, *, generator, device, ffn: str = "mlp"):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.ln1 = L.param(L.init_rms(cfg.d_model, device=device))
        self.ln2 = L.param(L.init_rms(cfg.d_model, device=device))
        if cfg.post_norm:
            self.ln1_post = L.param(L.init_rms(cfg.d_model, device=device))
            self.ln2_post = L.param(L.init_rms(cfg.d_model, device=device))
        self.is_mla = cfg.mla is not None
        self.mixer = (A.MLA if self.is_mla else A.GQA)(cfg, dtype, **kw)
        self.is_moe = ffn == "moe"
        if self.is_moe:
            self.ffn = MoE(cfg, dtype, **kw)
        else:
            d_ff = cfg.moe.dense_d_ff if (cfg.moe and ffn == "dense_prefix") \
                else cfg.d_ff
            self.ffn = L.MLP(cfg.d_model, d_ff, cfg.act, dtype, **kw)

    def _ffn(self, x, out, no_drop: bool = False):
        """Returns (x, aux loss: 0.0 for a dense ffn)."""
        cfg = self.cfg
        if cfg.post_norm:
            out = L.rms_norm(out, self.ln1_post, cfg.norm_eps)
        x = x + out
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        aux = 0.0
        if self.is_moe:
            out, aux = self.ffn(h, no_drop=no_drop)
        else:
            out = self.ffn(h)
        if cfg.post_norm:
            out = L.rms_norm(out, self.ln2_post, cfg.norm_eps)
        return x + out, aux

    def forward(self, x, positions, *, window: Optional[int] = None,
                return_kv: bool = False):
        """Returns (x, aux loss, the mixer's (k, v), or MLA's (ckv,
        k_rope), or None). MLA takes no window, as in the reference."""
        h = L.rms_norm(x, self.ln1, self.cfg.norm_eps)
        kw = {} if self.is_mla else dict(window=window)
        out = self.mixer(h, positions, return_kv=return_kv, **kw)
        kv = None
        if return_kv:
            out, kv = out
        x, aux = self._ffn(x, out)
        return x, aux, kv

    def decode(self, x, cache, pos: int, *, window: Optional[int] = None):
        """cache: {"k", "v"} (B, Smax, K, H), or MLA's {"ckv", "krope"}
        (B, Smax, kv_lora) and (B, Smax, rope), written in place. An MoE
        ffn runs with ``no_drop``."""
        h = L.rms_norm(x, self.ln1, self.cfg.norm_eps)
        if self.is_mla:
            out, ckv, krope = self.mixer.decode(h, cache["ckv"],
                                                cache["krope"], pos)
            new = {"ckv": ckv, "krope": krope}
        else:
            out, kc, vc = self.mixer.decode(h, cache["k"], cache["v"], pos,
                                            window=window)
            new = {"k": kc, "v": vc}
        x, _ = self._ffn(x, out, no_drop=True)
        return x, new


def attn_cache_shapes(cfg, batch: int, max_seq: int):
    """``_attn_cache_shapes``: one layer's KV cache shapes and dtypes (an
    MLA layer's latent ``ckv`` and ``krope``)."""
    a = cfg.attn
    dt = L.torch_dtype(cfg.dtype)
    if cfg.mla is not None:
        return {"ckv": ((batch, max_seq, cfg.mla.kv_lora_rank), dt),
                "krope": ((batch, max_seq, cfg.mla.rope_head_dim), dt)}
    shape = (batch, max_seq, a.num_kv_heads, a.head_dim)
    return {"k": (shape, dt), "v": (shape, dt)}


def pad_kv_to(x, max_seq: int, axis: int = 1):
    """``_pad_kv_to``: zero-pad the sequence axis to ``max_seq``. Raises
    ``ValueError`` if the axis is longer (the reference's ``jnp.pad``
    refuses a negative width; ``F.pad`` would crop)."""
    if x.shape[axis] > max_seq:
        raise ValueError(f"a cache of {x.shape[axis]} positions does not "
                         f"fit max_seq {max_seq}")
    pad = [0, 0] * (x.dim() - axis - 1) + [0, max_seq - x.shape[axis]]
    return F.pad(x, pad)


def _stack_kv(kvs, max_seq, names=("k", "v")):
    """Per-layer pairs (k, v) of (B, S, K, H), or MLA's (ckv, k_rope) ->
    {names} stacked on a leading layer axis, padded to max_seq."""
    return {name: pad_kv_to(torch.stack([kv[i] for kv in kvs]), max_seq,
                            axis=2) for i, name in enumerate(names)}


class _LM(nn.Module):
    """Embedding, final norm and head shared by the two models."""

    def __init__(self, cfg, *, generator, device, tied: bool,
                 layer_norm: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = L.torch_dtype(cfg.dtype)
        kw = dict(generator=generator, device=device)
        self.embed = L.param(L.embed_init(cfg.vocab_size, cfg.d_model,
                                          self.dtype, **kw))
        self.final_norm = (L.init_ln(cfg.d_model, device=device)
                           if layer_norm else
                           L.param(L.init_rms(cfg.d_model, device=device)))
        if not tied:
            self.lm_head = L.param(L.embed_init(cfg.vocab_size, cfg.d_model,
                                                self.dtype, **kw))

    def _logits(self, x_last, head, cap=None):
        """(B, D) -> float32 (B, vocab), as the reference's f32 einsum."""
        return L.softcap(x_last.to(f32) @ head.to(f32).T, cap)


class DecoderLM(_LM):
    """Dense, MoE and VLM decoders (``family`` ``"dense"``, ``"moe"`` or
    ``"vlm"``; GQA or MLA mixers): windows, post-norms, embedding scale,
    logit softcap and tied embeddings as the config says. An MoE model runs
    ``moe.first_dense_layers`` dense blocks (``prefix_{i}``, ffn width
    ``moe.dense_d_ff``) before its ``stack`` of MoE blocks (which may hold
    none: a config cut to its dense prefix); its loss adds the routers'
    auxiliary loss, summed over the layers. A VLM (the dense
    tree) puts ``batch["vision_embeds"]`` (B, vision_tokens, d_model),
    the stub frontend's output, in front of the tokens in ``forward``,
    ``prefill`` and ``loss``; its decode positions count them."""

    def __init__(self, cfg, *, generator, device):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"DecoderLM takes the dense, MoE and VLM families, not "
                f"{cfg.family!r}")
        super().__init__(cfg, generator=generator, device=device,
                         tied=cfg.tie_embeddings)
        dt = self.dtype
        kw = dict(generator=generator, device=device)
        self.n_prefix = cfg.moe.first_dense_layers if cfg.moe else 0
        self.n_stack = cfg.num_layers - self.n_prefix
        for i in range(self.n_prefix):
            setattr(self, f"prefix_{i}", Block(cfg, dt, ffn="dense_prefix",
                                               **kw))
        ffn = "moe" if cfg.moe else "mlp"
        self.stack = nn.ModuleList(Block(cfg, dt, ffn=ffn, **kw)
                                   for _ in range(self.n_stack))

    def _head(self):
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def prefix(self):
        return [getattr(self, f"prefix_{i}") for i in range(self.n_prefix)]

    def windows(self):
        """Per-stack-layer windows (gemma2's local/global alternation,
        counted from the first layer, prefix included) or None."""
        cfg = self.cfg
        if cfg.attn is None or cfg.attn.pattern != "local_global":
            return [None] * self.n_stack
        return [cfg.attn.window if (i + self.n_prefix) % 2 == 0
                else A.GLOBAL_WINDOW for i in range(self.n_stack)]

    def _embed(self, tokens, vision_embeds=None):
        x = F.embedding(tokens, self.embed)
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        if self.cfg.family == "vlm" and vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
        return x

    def forward(self, tokens, vision_embeds=None, *,
                collect_kv: bool = False):
        """Final hidden states (a VLM's vision positions first) and the
        summed aux loss (a tensor, or 0.0 without MoE blocks); with
        ``collect_kv``, also each prefix block's and each stack layer's
        (k, v)."""
        cfg = self.cfg
        x = self._embed(tokens, vision_embeds)
        positions = torch.arange(x.shape[1], device=x.device)
        aux, prefix_kv, kvs = 0.0, [], []
        for blk in self.prefix():
            x, a, kv = blk(x, positions, return_kv=collect_kv)
            aux = aux + a
            prefix_kv.append(kv)
        for blk, w in zip(self.stack, self.windows()):
            x, a, kv = blk(x, positions, window=w, return_kv=collect_kv)
            aux = aux + a
            kvs.append(kv)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return (x, aux, (prefix_kv, kvs)) if collect_kv else (x, aux)

    def loss(self, batch):
        """Next-token loss of ``batch["tokens"]`` (B, S): the chunked
        cross-entropy (with the config's logit softcap) plus the auxiliary
        loss, 0 for the dense family. A VLM scores the hidden states at
        vision_tokens - 1 ... vision_tokens + S - 3 against tokens 1..S-1,
        as the reference slices them: position vision_tokens - 1 + j has
        seen tokens 0..j-1 and is scored against token j + 1 (ROADMAP.md
        §3 pins this). Returns (loss, metrics)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        labels = tokens[:, 1:]
        x, aux = self.forward(tokens[:, :-1], batch.get("vision_embeds"))
        if cfg.family == "vlm":
            tv = cfg.vision_tokens
            x = x[:, tv - 1:tv - 1 + labels.shape[1]]
        loss, metrics = L.chunked_xent(x, self._head(), labels,
                                       logit_softcap=cfg.logit_softcap)
        if not torch.is_tensor(aux):
            aux = torch.zeros((), dtype=f32, device=x.device)
        metrics["aux_loss"] = aux
        return loss + aux, metrics

    def init_cache(self, batch: int, max_seq: int):
        shapes = attn_cache_shapes(self.cfg, batch, max_seq)
        dev = self.embed.device
        cache = {"stack": {k: torch.zeros((self.n_stack,) + sh, dtype=dt,
                                          device=dev)
                           for k, (sh, dt) in shapes.items()}}
        for i in range(self.n_prefix):
            cache[f"prefix_{i}"] = {k: torch.zeros(sh, dtype=dt, device=dev)
                                    for k, (sh, dt) in shapes.items()}
        return cache

    def prefill(self, batch, max_seq: int):
        x, _, (prefix_kv, kvs) = self.forward(
            batch["tokens"], batch.get("vision_embeds"), collect_kv=True)
        names = ("ckv", "krope") if self.cfg.mla is not None else ("k", "v")
        # a stack of no layers holds empty (0, B, max_seq, ...) leaves
        cache = {"stack": _stack_kv(kvs, max_seq, names) if kvs else
                 self.init_cache(x.shape[0], max_seq)["stack"]}
        for i, kv in enumerate(prefix_kv):
            cache[f"prefix_{i}"] = {n: pad_kv_to(t, max_seq)
                                    for n, t in zip(names, kv)}
        return self._logits(x[:, -1], self._head(),
                            self.cfg.logit_softcap), cache

    def decode_step(self, cache, token, pos: int):
        """token: (B,); pos: the cache fill position."""
        cfg = self.cfg
        x = self._embed(token[:, None])
        for i, blk in enumerate(self.prefix()):
            x, _ = blk.decode(x, cache[f"prefix_{i}"], pos)
        st = cache["stack"]
        for i, (blk, w) in enumerate(zip(self.stack, self.windows())):
            x, _ = blk.decode(x, {n: t[i] for n, t in st.items()}, pos,
                              window=w)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._logits(x[:, 0], self._head(), cfg.logit_softcap), cache


class MambaLayer(nn.Module):
    """A Zamba2 backbone layer: pre-norm and a Mamba2 mixer."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        self.cfg = cfg
        self.ln = L.param(L.init_rms(cfg.d_model, device=device))
        self.mamba = S.Mamba2(cfg, dtype, generator=generator, device=device)

    def forward(self, x, *, want_state: bool = False):
        h = L.rms_norm(x, self.ln, self.cfg.norm_eps)
        if want_state:
            y, st = self.mamba(h, return_state=True)
            return x + y, st
        return x + self.mamba(h), None

    def decode(self, x, conv_state, ssm_state):
        h = L.rms_norm(x, self.ln, self.cfg.norm_eps)
        y, conv_state, ssm_state = self.mamba.decode(h, conv_state, ssm_state)
        return x + y, conv_state, ssm_state


class ZambaLM(_LM):
    """``num_layers`` Mamba2 layers; one weight-shared transformer block
    after every ``attn_every`` of them (``groups``), the rest after
    (``trail``)."""

    def __init__(self, cfg, *, generator, device):
        if cfg.family != "hybrid":
            raise NotImplementedError(f"ZambaLM takes the hybrid family, not "
                                      f"{cfg.family!r}")
        super().__init__(cfg, generator=generator, device=device,
                         tied=False)
        self.m = cfg.attn_every
        self.n_groups = cfg.num_layers // self.m
        self.n_trail = cfg.num_layers - self.n_groups * self.m
        kw = dict(generator=generator, device=device)
        dt = self.dtype
        self.groups = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, dt, **kw) for _ in range(self.m))
            for _ in range(self.n_groups))
        self.shared = Block(cfg, dt, **kw)
        self.trail = nn.ModuleList(MambaLayer(cfg, dt, **kw)
                                   for _ in range(self.n_trail))

    def forward(self, tokens, *, collect: bool = False):
        """Final hidden states; with ``collect``, also the groups' and the
        trail's (conv, ssm) states and the shared block's (k, v) each
        application."""
        x = F.embedding(tokens, self.embed)
        positions = torch.arange(x.shape[1], device=x.device)
        g_states, g_kv, t_states = [], [], []
        for group in self.groups:
            states = []
            for layer in group:
                x, st = layer(x, want_state=collect)
                states.append(st)
            x, _, kv = self.shared(x, positions, return_kv=collect)
            g_states.append(states)
            g_kv.append(kv)
        for layer in self.trail:
            x, st = layer(x, want_state=collect)
            t_states.append(st)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return (x, (g_states, g_kv, t_states)) if collect else x

    def loss(self, batch):
        """Next-token chunked cross-entropy of ``batch["tokens"]`` (B, S),
        no softcap. Returns (loss, metrics)."""
        tokens = batch["tokens"]
        x = self.forward(tokens[:, :-1])
        return L.chunked_xent(x, self.lm_head, tokens[:, 1:])

    def init_cache(self, batch: int, max_seq: int):
        cs, ss = S.mamba_state_shapes(self.cfg, batch)
        dev, dt = self.embed.device, self.dtype
        ash = attn_cache_shapes(self.cfg, batch, max_seq)
        G, m, T = self.n_groups, self.m, self.n_trail
        return {
            "g_conv": torch.zeros((G, m) + cs, dtype=dt, device=dev),
            "g_ssm": torch.zeros((G, m) + ss, dtype=f32, device=dev),
            "t_conv": torch.zeros((T,) + cs, dtype=dt, device=dev),
            "t_ssm": torch.zeros((T,) + ss, dtype=f32, device=dev),
            "attn": {k: torch.zeros((G,) + sh, dtype=d, device=dev)
                     for k, (sh, d) in ash.items()},
        }

    def prefill(self, batch, max_seq: int):
        x, (g_states, g_kv, t_states) = self.forward(batch["tokens"],
                                                     collect=True)

        def stack(states, i):
            return torch.stack([st[i] for st in states])

        dev = x.device
        cache = {
            "g_conv": torch.stack([stack(g, 0) for g in g_states]),
            "g_ssm": torch.stack([stack(g, 1) for g in g_states]),
            "t_conv": (stack(t_states, 0) if self.n_trail else
                       torch.zeros((0,), dtype=self.dtype, device=dev)),
            "t_ssm": (stack(t_states, 1) if self.n_trail else
                      torch.zeros((0,), dtype=f32, device=dev)),
            "attn": _stack_kv(g_kv, max_seq),
        }
        return self._logits(x[:, -1], self.lm_head), cache

    def decode_step(self, cache, token, pos: int):
        x = F.embedding(token[:, None], self.embed)
        ak, av = cache["attn"]["k"], cache["attn"]["v"]
        for g, group in enumerate(self.groups):
            for i, layer in enumerate(group):
                x, cst, sst = layer.decode(x, cache["g_conv"][g, i],
                                           cache["g_ssm"][g, i])
                cache["g_conv"][g, i] = cst
                cache["g_ssm"][g, i] = sst
            x, _ = self.shared.decode(x, {"k": ak[g], "v": av[g]}, pos)
        for i, layer in enumerate(self.trail):
            x, cst, sst = layer.decode(x, cache["t_conv"][i],
                                       cache["t_ssm"][i])
            cache["t_conv"][i] = cst
            cache["t_ssm"][i] = sst
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self._logits(x[:, 0], self.lm_head), cache


def _ln(ln, x, eps):
    """``layer_norm`` with a ``{"scale", "bias"}`` parameter dict."""
    return L.layer_norm(x, ln["scale"], ln["bias"], eps)


class RWKVLayer(nn.Module):
    """An RWKV6 layer: ``ln1`` and the time mix, ``ln2`` and the channel
    mix, each residual."""

    def __init__(self, cfg, dtype, *, generator, device):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        self.ln1 = L.init_ln(cfg.d_model, device=device)
        self.ln2 = L.init_ln(cfg.d_model, device=device)
        self.tmix = S.RWKVTimeMix(cfg, dtype, **kw)
        self.cmix = S.RWKVChannelMix(cfg, dtype, **kw)

    def forward(self, x, *, want_state: bool = False):
        """Returns (x, (shift_t, wkv, shift_c) or None): the mixers' states
        after the sequence (each shift state is its mixer's normed input at
        the last position)."""
        eps = self.cfg.norm_eps
        y = self.tmix(_ln(self.ln1, x, eps), return_state=want_state)
        if want_state:
            y, (sh_t, wkv) = y
        x = x + y
        y = self.cmix(_ln(self.ln2, x, eps), return_state=want_state)
        if want_state:
            y, sh_c = y
            return x + y, (sh_t, wkv, sh_c)
        return x + y, None

    def decode(self, x, wkv, sh_t, sh_c):
        """One token from the layer's states; returns (x, wkv, shift_t,
        shift_c)."""
        eps = self.cfg.norm_eps
        y, sh_t, wkv = self.tmix.decode(_ln(self.ln1, x, eps), sh_t, wkv)
        x = x + y
        y, sh_c = self.cmix.decode(_ln(self.ln2, x, eps), sh_c)
        return x + y, wkv, sh_t, sh_c


class RWKVLM(_LM):
    """RWKV6 (``family == "ssm"``): the embedding, ``ln0``, ``num_layers``
    ``RWKVLayer``s (``stack``), the final layer norm and an untied
    ``lm_head``. Its decode cache holds each layer's float32 ``wkv`` state
    (L, B, H, hd, hd) and its two token-shift states ``shift_t`` and
    ``shift_c`` (L, B, 1, D) in the model's type; ``max_seq`` and ``pos``
    do not enter (the state is O(1) in the sequence)."""

    def __init__(self, cfg, *, generator, device):
        if cfg.family != "ssm" or cfg.rwkv is None:
            raise NotImplementedError(f"RWKVLM takes the ssm family, not "
                                      f"{cfg.family!r}")
        super().__init__(cfg, generator=generator, device=device,
                         tied=False, layer_norm=True)
        self.ln0 = L.init_ln(cfg.d_model, device=device)
        self.stack = nn.ModuleList(
            RWKVLayer(cfg, self.dtype, generator=generator, device=device)
            for _ in range(cfg.num_layers))

    def forward(self, tokens, *, collect: bool = False):
        """Final hidden states; with ``collect``, also the stacked
        (shift_t, wkv, shift_c) of every layer."""
        eps = self.cfg.norm_eps
        x = _ln(self.ln0, F.embedding(tokens, self.embed), eps)
        states = []
        for layer in self.stack:
            x, st = layer(x, want_state=collect)
            states.append(st)
        x = _ln(self.final_norm, x, eps)
        if not collect:
            return x
        return x, tuple(torch.stack(s) for s in zip(*states))

    def loss(self, batch):
        """Next-token chunked cross-entropy of ``batch["tokens"]`` (B, S),
        no softcap. Returns (loss, metrics)."""
        tokens = batch["tokens"]
        x = self.forward(tokens[:, :-1])
        return L.chunked_xent(x, self.lm_head, tokens[:, 1:])

    def init_cache(self, batch: int, max_seq: int):
        H, hd = S.rwkv_dims(self.cfg)
        n, D = self.cfg.num_layers, self.cfg.d_model
        dev, dt = self.embed.device, self.dtype
        return {"wkv": torch.zeros((n, batch, H, hd, hd), dtype=f32,
                                   device=dev),
                "shift_t": torch.zeros((n, batch, 1, D), dtype=dt,
                                       device=dev),
                "shift_c": torch.zeros((n, batch, 1, D), dtype=dt,
                                       device=dev)}

    def prefill(self, batch, max_seq: int):
        x, (sh_t, wkv, sh_c) = self.forward(batch["tokens"], collect=True)
        cache = {"wkv": wkv, "shift_t": sh_t, "shift_c": sh_c}
        return self._logits(x[:, -1], self.lm_head), cache

    def decode_step(self, cache, token, pos: int):
        eps = self.cfg.norm_eps
        x = _ln(self.ln0, F.embedding(token[:, None], self.embed), eps)
        for i, layer in enumerate(self.stack):
            x, wkv, sh_t, sh_c = layer.decode(
                x, cache["wkv"][i], cache["shift_t"][i], cache["shift_c"][i])
            cache["wkv"][i] = wkv
            cache["shift_t"][i] = sh_t
            cache["shift_c"][i] = sh_c
        x = _ln(self.final_norm, x, eps)
        return self._logits(x[:, 0], self.lm_head), cache
