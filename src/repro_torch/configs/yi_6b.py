"""Yi-6B — llama-architecture dense GQA LM. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import (Arch, AttentionConfig, ModelConfig,
                                      FULL_ATTENTION_500K_SKIP)

_CFG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=11008,
    vocab_size=64000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=4, head_dim=128,
                         rope_theta=5_000_000.0),
    act="swiglu",
)

_SMOKE = _CFG.replace(
    name="yi-6b-smoke", num_layers=2, d_model=64, d_ff=160, vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16,
                         rope_theta=5_000_000.0),
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={"long_500k": FULL_ATTENTION_500K_SKIP},
    source="arXiv:2403.04652; hf:01-ai/Yi-6B",
)
