"""Architecture registry: 10 assigned architectures + shapes.

The port's own copy of the JAX package's ``configs`` (data only, no JAX),
so ``get_arch`` and ``ARCHS`` work unchanged and the port imports nothing
of the JAX package.

Usage::

    from repro_torch.configs import get_arch, ARCHS, SHAPES
    arch = get_arch("yi-6b")
    arch.config    # full public config (dry-run only)
    arch.smoke     # reduced same-family config (CPU tests)
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import (Arch, AttentionConfig, MLAConfig,
                                      ModelConfig, MoEConfig, RWKVConfig,
                                      SHAPES, ShapeConfig, SSMConfig)

from repro_torch.configs import (yi_6b, deepseek_67b, qwen3_0_6b, gemma2_9b,
                                 deepseek_moe_16b, deepseek_v2_236b,
                                 internvl2_2b, zamba2_7b, whisper_base,
                                 rwkv6_7b)

_MODULES = (yi_6b, deepseek_67b, qwen3_0_6b, gemma2_9b, deepseek_moe_16b,
            deepseek_v2_236b, internvl2_2b, zamba2_7b, whisper_base, rwkv6_7b)

ARCHS: Dict[str, Arch] = {m.ARCH.name: m.ARCH for m in _MODULES}


def get_arch(name: str) -> Arch:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_cells():
    """All (arch, shape) dry-run cells, with skip reasons where applicable."""
    cells = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            cells.append((a.name, s.name, a.skip_shapes.get(s.name)))
    return cells


__all__ = ["Arch", "ARCHS", "SHAPES", "ShapeConfig",
           "ModelConfig", "AttentionConfig", "MLAConfig", "MoEConfig",
           "SSMConfig", "RWKVConfig", "get_arch", "list_cells"]
