"""AdamW with float32 moments, global-norm clipping and decoupled weight
decay: the counterpart of ``repro.optim.adamw``, as plain functions on
dicts of tensors (``{name: tensor}``, a model's named parameters).

It is not ``torch.optim.AdamW``, which keeps its moments in the
parameter's type and has no clipping, schedule or per-ndim decay. The
state is a dict, ``{"m": {...}, "v": {...}, "step": int32 scalar}`` (and
``"master"`` with ``master=True``), which ``checkpoint.save`` writes as it
is. ``master=False`` keeps no float32 master copy: bf16 parameters are
updated with float32 arithmetic and rounded back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

f32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    master: bool = False


def schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``peak_lr``, then a cosine down to ``min_lr_ratio``
    of it over ``decay_steps``. ``step``: a tensor; float32 result."""
    step = step.to(f32)
    warm = cfg.peak_lr * torch.clamp(step / max(cfg.warmup_steps, 1),
                                     max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params, cfg: AdamWConfig):
    """Zero float32 moments of each parameter and step 0."""
    dev = next(iter(params.values())).device

    def zeros():
        return {k: torch.zeros(p.shape, dtype=f32, device=p.device)
                for k, p in params.items()}

    state = {"m": zeros(), "v": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.master:
        state["master"] = {k: p.detach().to(f32).clone()
                           for k, p in params.items()}
    return state


def global_norm(tree):
    """sqrt of the sum of squares of every leaf of a dict, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(f32)))
                          for x in tree.values()))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step. ``params`` and ``grads``: dicts of tensors with the
    same keys. Returns (new params, each in its parameter's type; new
    state; {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    t = step.to(f32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=t.device), t)
    new_p, new_m, new_v, new_mw = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(f32) * clip
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        base = state["master"][k] if cfg.master else p.to(f32)
        step_vec = mhat / (torch.sqrt(vhat) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0
        new = base - lr * (step_vec + decay * base)
        new_p[k] = new.to(p.dtype)
        new_m[k], new_v[k] = m, v
        if cfg.master:
            new_mw[k] = new
    new_state = {"m": new_m, "v": new_v, "step": step}
    if cfg.master:
        new_state["master"] = new_mw
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
