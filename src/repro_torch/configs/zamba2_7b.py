"""Zamba2-7B — Mamba2 backbone with shared (weight-tied) attention blocks
interleaved. [arXiv:2411.15242]

81 Mamba2 layers; one shared transformer block (attention + MLP, weights
shared across applications) applied after every ``attn_every`` = 6 Mamba2
layers (13 applications; the trailing 3 layers are pure Mamba2).
Sub-quadratic family: runs ``long_500k``.
"""
from repro_torch.configs.base import (Arch, AttentionConfig, ModelConfig,
                                      SSMConfig)

_CFG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab_size=32000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=112,
                         rope_theta=10_000.0),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4),
    act="geglu",
    attn_every=6,
)

_SMOKE = _CFG.replace(
    name="zamba2-7b-smoke", num_layers=7, d_model=64, d_ff=160,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    attn_every=3,
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={},
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-7B (unverified tier)",
)
