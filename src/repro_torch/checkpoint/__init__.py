"""Checkpoints with an atomic commit (the counterpart of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
