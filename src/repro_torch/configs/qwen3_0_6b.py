"""Qwen3-0.6B — dense GQA LM with qk-norm, tied embeddings. [hf:Qwen/Qwen3-0.6B]"""
from repro_torch.configs.base import (Arch, AttentionConfig, ModelConfig,
                                      FULL_ATTENTION_500K_SKIP)

_CFG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    d_ff=3072,
    vocab_size=151936,
    attn=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=128,
                         qk_norm=True, rope_theta=1_000_000.0),
    act="swiglu",
    norm_eps=1e-6,
    tie_embeddings=True,
)

_SMOKE = _CFG.replace(
    name="qwen3-0.6b-smoke", num_layers=2, d_model=64, d_ff=160,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32,
                         qk_norm=True, rope_theta=1_000_000.0),
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={"long_500k": FULL_ATTENTION_500K_SKIP},
    source="hf:Qwen/Qwen3-0.6B (family ref hf:Qwen/Qwen3-8B)",
)
