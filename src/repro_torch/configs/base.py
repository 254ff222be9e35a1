"""Config dataclasses for architectures, input shapes, and runtime options.

Every assigned architecture gets one module in ``repro.configs`` exporting an
:class:`Arch` with (i) the exact public full-size config and (ii) a reduced
``smoke`` config of the same family for CPU tests. The full configs are only
ever exercised structurally (``jax.eval_shape`` / dry-run lowering).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Optional, Tuple


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None            # local-attention window (gemma2)
    pattern: str = "global"                 # "global" | "local_global"
    attn_softcap: Optional[float] = None    # gemma2: 50.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    # leading dense layers (DeepSeek first_k_dense_replace)
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    router_aux_weight: float = 1e-3
    group_size: int = 256                   # tokens per dispatch group
    dispatch: str = "einsum"                # "einsum" (GShard) | "scatter" (opt)


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 mixer (zamba2)."""
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 "Finch" mixer: data-dependent decay via LoRA."""
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    # vector-decay GLA materializes (c, c, K) pairwise decays per chunk:
    # HBM traffic scales with c, so keep chunks small (§Perf C3)
    chunk: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | hybrid | ssm | encdec
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttentionConfig] = None
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    act: str = "swiglu"                     # swiglu | geglu | relu2
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    post_norm: bool = False                 # gemma2 sandwich norms
    embed_scale: bool = False               # gemma2 sqrt(d) embedding scale
    # hybrid (zamba2): shared attention block applied every `attn_every`
    # ssm layers (weights shared across applications).
    attn_every: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # vlm: number of precomputed vision-patch embeddings prepended
    vision_tokens: int = 0
    dtype: str = "bfloat16"
    remat: str = "dots"                     # none | dots | full
    # decode attention over a sequence-sharded cache via shard_map
    # (flash-decode); beyond-paper perf option, see EXPERIMENTS.md §Perf
    flash_decode: bool = False
    # max decode length the cache is allocated for; set per-shape at lowering
    max_seq: int = 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True if sequence mixing cost is sub-quadratic in seq_len."""
        return self.family in ("ssm", "hybrid")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                   # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


@dataclass(frozen=True)
class Arch:
    """An assigned architecture: exact config + reduced smoke variant."""
    config: ModelConfig
    smoke: ModelConfig
    # shape-name -> reason, for cells that are skipped by design
    skip_shapes: Mapping[str, str] = field(default_factory=dict)
    source: str = ""

    @property
    def name(self) -> str:
        return self.config.name

    def supported_shapes(self) -> Tuple[str, ...]:
        return tuple(s for s in SHAPES if s not in self.skip_shapes)


FULL_ATTENTION_500K_SKIP = (
    "long_500k needs sub-quadratic sequence mixing; this arch uses full "
    "(quadratic) attention in at least some layers (see DESIGN.md §4)"
)
