"""RWKV6-7B "Finch" — attention-free, data-dependent decay linear attention.
[arXiv:2404.05892; hf]

Sub-quadratic family: runs ``long_500k``.
"""
from repro_torch.configs.base import (Arch, ModelConfig, RWKVConfig)

_CFG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    act="relu2",                 # RWKV channel-mix uses squared ReLU
)

_SMOKE = _CFG.replace(
    name="rwkv6-7b-smoke", num_layers=2, d_model=64, d_ff=160, vocab_size=512,
    rwkv=RWKVConfig(head_dim=16, decay_lora=16, mix_lora=8, chunk=16),
)

ARCH = Arch(
    config=_CFG,
    smoke=_SMOKE,
    skip_shapes={},
    source="arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b",
)
