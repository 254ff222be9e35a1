"""DeepSeek-67B — llama-architecture dense GQA LM. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import (Arch, AttentionConfig, ModelConfig,
                                      FULL_ATTENTION_500K_SKIP)

_CFG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    d_ff=22016,
    vocab_size=102400,
    attn=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128,
                         rope_theta=10_000.0),
    act="swiglu",
)

_SMOKE = _CFG.replace(
    name="deepseek-67b-smoke", num_layers=3, d_model=64, d_ff=160,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={"long_500k": FULL_ATTENTION_500K_SKIP},
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base",
)
