"""Whisper-base — encoder-decoder with conv frontend (STUB).
[arXiv:2212.04356]

Per the assignment the conv/mel frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (B, 1500, d_model) for the encoder. Decoder
positions are sinusoidal (the real model uses 448 learned positions; the
substitution lets 32k-cache decode shapes lower structurally — see DESIGN.md).
"""
from repro_torch.configs.base import (Arch, AttentionConfig, ModelConfig,
                                      FULL_ATTENTION_500K_SKIP)

_CFG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,                 # decoder layers
    encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    d_ff=2048,
    vocab_size=51865,
    attn=AttentionConfig(num_heads=8, num_kv_heads=8, head_dim=64,
                         rope_theta=0.0),   # sinusoidal abs positions, no rope
    act="gelu",
    norm_eps=1e-5,
    tie_embeddings=True,
)

_SMOKE = _CFG.replace(
    name="whisper-base-smoke", num_layers=2, encoder_layers=2, encoder_seq=30,
    d_model=64, d_ff=160, vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16,
                         rope_theta=0.0),
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={"long_500k": FULL_ATTENTION_500K_SKIP},
    source="arXiv:2212.04356; hf:openai/whisper-base (unverified tier)",
)
