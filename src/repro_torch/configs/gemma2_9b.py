"""Gemma2-9B — local+global alternating attention, logit softcaps, sandwich
norms, GeGLU. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import (Arch, AttentionConfig, ModelConfig,
                                      FULL_ATTENTION_500K_SKIP)

_CFG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab_size=256000,
    attn=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                         rope_theta=10_000.0, window=4096,
                         pattern="local_global", attn_softcap=50.0),
    act="geglu",
    norm_eps=1e-6,
    tie_embeddings=True,
    logit_softcap=30.0,
    post_norm=True,
    embed_scale=True,
)

_SMOKE = _CFG.replace(
    name="gemma2-9b-smoke", num_layers=2, d_model=64, d_ff=160,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                         window=16, pattern="local_global",
                         attn_softcap=50.0),
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={"long_500k": FULL_ATTENTION_500K_SKIP},
    source="arXiv:2408.00118; hf:google/gemma-2-9b",
)
