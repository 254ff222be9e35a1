"""DeepSeek-V2-236B — MLA (kv_lora=512) + fine-grained MoE: 2 shared + 160
routed top-6, first layer dense. [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import (Arch, AttentionConfig, MLAConfig,
                                      ModelConfig, MoEConfig,
                                      FULL_ATTENTION_500K_SKIP)

_CFG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    d_ff=1536,                    # routed-expert width (per assignment)
    vocab_size=102400,
    attn=AttentionConfig(num_heads=128, num_kv_heads=128, head_dim=128,
                         rope_theta=10_000.0),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536, num_shared=2,
                  first_dense_layers=1, dense_d_ff=12288),
    act="swiglu",
)

_SMOKE = _CFG.replace(
    name="deepseek-v2-236b-smoke", num_layers=3, d_model=64, d_ff=48,
    vocab_size=512,
    attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=32),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                  nope_head_dim=32, v_head_dim=32),
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=48, num_shared=1,
                  first_dense_layers=1, dense_d_ff=160, group_size=32),
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={"long_500k": FULL_ATTENTION_500K_SKIP},
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2",
)
