"""The serving slice's models: the dense ``DecoderLM`` and the hybrid
``ZambaLM`` (Mamba2 + shared attention), as ``nn.Module``s."""
from repro_torch.models.model import build_model

__all__ = ["build_model"]
