"""Step functions of the trainer and the server: the counterpart of
``repro.training``.

``make_train_step`` is the trainer's step: the model's loss, its gradients
(through kernels #4 and #5 on the card, whose backward recomputes their
plain versions), an optional int8 round trip of the gradients with error
feedback, and one AdamW update. The model's parameters are the trained
parameters, updated in place. ``make_prefill_step`` and
``make_serve_step`` run under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.compression import init_error_feedback, roundtrip


def init_train_state(model, opt_cfg: AdamWConfig, *, compress: bool = False):
    """``{"opt": AdamW state}``, and ``"ef"`` (zero error feedback) with
    ``compress``."""
    params = dict(model.named_parameters())
    state = {"opt": init_opt_state(params, opt_cfg)}
    if compress:
        state["ef"] = init_error_feedback(params)
    return state


def make_train_step(model, opt_cfg: AdamWConfig, *, compress: bool = False):
    """``train_step(state, batch) -> (new state, metrics)``: ``state`` as
    ``init_train_state`` makes it (with ``compress``, the gradients go
    through ``compression.roundtrip`` and ``state["ef"]`` carries the
    residual); the metrics are the model's (``xent``, ``accuracy``,
    ``tokens``, ...), AdamW's ``grad_norm`` and ``lr``, and ``loss``, all
    detached scalars."""
    params = dict(model.named_parameters())

    def train_step(state, batch):
        loss, metrics = model.loss(batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        new = dict(state)
        if compress:
            grads, new["ef"] = roundtrip(grads, state["ef"])
        new_p, new["opt"], om = adamw_update(params, grads, state["opt"],
                                             opt_cfg)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_p[k])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        metrics["loss"] = loss.detach()
        return new, metrics

    return train_step


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
