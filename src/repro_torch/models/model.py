"""``build_model``: the counterpart of ``repro.models.model.build_model``
for every family (dense, MoE with or without MLA, VLM, hybrid, RWKV6's
ssm and the encoder-decoder). The reference's ``cache_specs``,
``batch_specs`` and ``input_specs`` are ``jax.eval_shape`` dry-run helpers
and have no counterpart (ROADMAP.md: out of scope on one card);
``param_count`` gives the parameter count its examples take from
``param_specs``.

``stub_inputs`` and ``prompt_start`` are what the reference's launchers
feed the two families with a stub frontend and where their decode
positions start."""
from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM, RWKVLM, ZambaLM

_MODELS = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
           "hybrid": ZambaLM, "ssm": RWKVLM, "encdec": EncDecLM}


def build_model(cfg, device=None, *, seed: int = 0, generator=None):
    """The model of ``cfg`` on ``device`` (default ``cuda``; raises without
    a card unless ``"cpu"`` is asked for), its weights drawn from
    ``generator`` or a generator on that device seeded with ``seed``.
    Raises ``NotImplementedError`` for a family it does not know and for
    ``flash_decode``, which is out of scope on one card."""
    dev = device_mod.resolve(device)
    if cfg.family not in _MODELS:
        raise NotImplementedError(f"{cfg.name}: no model of family "
                                  f"{cfg.family!r}")
    if cfg.flash_decode:
        raise NotImplementedError(f"{cfg.name}: flash_decode shards the "
                                  "cache over a mesh; out of scope on one "
                                  "card (ROADMAP.md: out of scope on one card)")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return _MODELS[cfg.family](cfg, generator=generator, device=dev)


def param_count(cfg) -> int:
    """The number of parameters of ``cfg``'s model, which is the reference's
    ``param_specs`` count. The model is built on the meta device: no memory
    is allocated and no weight is drawn."""
    model = build_model(cfg, "meta", generator=torch.Generator())
    return sum(p.numel() for p in model.parameters())


def stub_inputs(cfg, batch: int, device) -> dict:
    """The stub frontends' outputs that the reference's launchers add to a
    batch of ``batch`` prompts (``repro.launch.serve``: 57-62,
    ``repro.launch.train``: 139-146): a VLM's ``vision_embeds`` (batch,
    vision_tokens, d_model) and an encoder-decoder's ``frames`` (batch,
    encoder_seq, d_model), zeros in the config's type; nothing for the
    other families."""
    shape = {"vlm": ("vision_embeds", cfg.vision_tokens),
             "encdec": ("frames", cfg.encoder_seq)}.get(cfg.family)
    if shape is None:
        return {}
    name, n = shape
    return {name: torch.zeros((batch, n, cfg.d_model),
                              dtype=L.torch_dtype(cfg.dtype), device=device)}


def prompt_start(cfg) -> int:
    """The position of a prompt's first token: after a VLM's vision
    tokens, 0 otherwise."""
    return cfg.vision_tokens if cfg.family == "vlm" else 0
