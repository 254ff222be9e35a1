"""The trainer's synthetic token pipeline (numpy; the counterpart of
``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, DataLoader, batch_at

__all__ = ["DataConfig", "DataLoader", "batch_at"]
