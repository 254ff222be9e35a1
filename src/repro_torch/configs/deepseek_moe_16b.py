"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6, first
layer dense. [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import (Arch, AttentionConfig, ModelConfig,
                                      MoEConfig, FULL_ATTENTION_500K_SKIP)

_CFG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    d_ff=1408,                    # routed-expert width (per assignment)
    vocab_size=102400,
    attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128,
                         rope_theta=10_000.0),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                  first_dense_layers=1, dense_d_ff=10944),
    act="swiglu",
)

_SMOKE = _CFG.replace(
    name="deepseek-moe-16b-smoke", num_layers=3, d_model=64, d_ff=48,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=48, num_shared=1,
                  first_dense_layers=1, dense_d_ff=160, group_size=32),
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={"long_500k": FULL_ATTENTION_500K_SKIP},
    source="arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
)
