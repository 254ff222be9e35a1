"""InternVL2-2B — InternViT (stub frontend) + InternLM2-1.8B backbone.
[arXiv:2404.16821; hf]

Per the assignment the modality frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (B, vision_tokens, d_model) which the model
prepends to the token sequence.
"""
from repro_torch.configs.base import (Arch, AttentionConfig, ModelConfig,
                                      FULL_ATTENTION_500K_SKIP)

_CFG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    d_ff=8192,
    vocab_size=92553,
    attn=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=128,
                         rope_theta=1_000_000.0),
    act="swiglu",
    vision_tokens=256,
)

_SMOKE = _CFG.replace(
    name="internvl2-2b-smoke", num_layers=2, d_model=64, d_ff=160,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
    vision_tokens=8,
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={"long_500k": FULL_ATTENTION_500K_SKIP},
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B",
)
