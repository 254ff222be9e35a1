"""The port's models: ``DecoderLM`` (dense, MoE and VLM), the hybrid
``ZambaLM`` (Mamba2 + shared attention), RWKV6's ``RWKVLM`` and the
encoder-decoder ``EncDecLM``, as ``nn.Module``s."""
from repro_torch.models.model import build_model, param_count

__all__ = ["build_model", "param_count"]
