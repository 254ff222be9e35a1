"""``build_model``: the counterpart of ``repro.models.model.build_model``
for the families ported so far (dense, MoE without MLA, hybrid and RWKV6's
ssm). The reference's ``param_specs``, ``cache_specs``, ``batch_specs``
and ``input_specs`` are ``jax.eval_shape`` dry-run helpers and have no
counterpart (ROADMAP.md: out of scope on one card)."""
from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.models.transformer import DecoderLM, RWKVLM, ZambaLM

_LATER = ("ROADMAP.md queue 1, item 4: the VLM, MLA and encoder-decoder "
          "models are ported one a PR")
_MODELS = {"dense": DecoderLM, "moe": DecoderLM, "hybrid": ZambaLM,
           "ssm": RWKVLM}


def build_model(cfg, device=None, *, seed: int = 0, generator=None):
    """The model of ``cfg`` on ``device`` (default ``cuda``; raises without
    a card unless ``"cpu"`` is asked for), its weights drawn from
    ``generator`` or a generator on that device seeded with ``seed``.
    Raises ``NotImplementedError`` for a family or option not ported."""
    dev = device_mod.resolve(device)
    if cfg.family not in _MODELS:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                                  f"ported yet ({_LATER})")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: MLA attention is not ported "
                                  f"yet ({_LATER})")
    if cfg.flash_decode:
        raise NotImplementedError(f"{cfg.name}: flash_decode shards the "
                                  "cache over a mesh; out of scope on one "
                                  "card (ROADMAP.md: out of scope on one card)")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return _MODELS[cfg.family](cfg, generator=generator, device=dev)
