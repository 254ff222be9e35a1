"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Without a
card and without an explicit ``"cpu"`` they raise: they never fall back.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
