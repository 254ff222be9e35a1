"""The port's models: ``DecoderLM`` (dense and MoE), the hybrid
``ZambaLM`` (Mamba2 + shared attention) and RWKV6's ``RWKVLM``, as
``nn.Module``s."""
from repro_torch.models.model import build_model

__all__ = ["build_model"]
