"""Step functions of the server: the counterpart of ``repro.training``'s
``make_prefill_step`` and ``make_serve_step``. ``make_train_step`` waits for
the training slice (ROADMAP.md queue 1, item 9). Both steps run under
``torch.inference_mode``."""
from __future__ import annotations

import torch


def make_prefill_step(model, max_seq: int):
    def prefill_step(batch):
        with torch.inference_mode():
            return model.prefill(batch, max_seq)

    return prefill_step


def make_serve_step(model):
    def serve_step(cache, token, pos: int):
        with torch.inference_mode():
            return model.decode_step(cache, token, pos)

    return serve_step
