"""Spatial flexibility: the greedy day-ahead pre-shift of flexible budgets
across clusters (the paper's planned next step, §V).

Port of ``repro.core.spatial`` for the main path: the budget shift s is the
exact linear minimizer of the carbon price over {sum_c s = 0} ∩ [lo, ub]
(``solver.minimize_linear``), and the temporal VCC solve runs on the shifted
budgets. Each rollout is one row of n clusters. A cluster may export at most
``mobility * tau_c`` and import at most ``min(mobility * tau_c,
headroom_c)``; mobility 0 returns tau exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import solver
from repro_torch.core.vcc import VCCProblem


def carbon_price(p: VCCProblem) -> torch.Tensor:
    """(..., n) marginal kgCO2e of one CPU-day at each cluster:
    mean_h eta * pi."""
    return (p.eta * p.pi).mean(-1)


def shift_bounds(p: VCCProblem, mobility) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Per-cluster (lo, ub) of the daily shift (negative = export).
    ``mobility``: per-rollout, shape (...)."""
    mob = torch.as_tensor(mobility, dtype=torch.float32,
                          device=p.tau.device)[..., None]
    room_h = torch.clamp(p.capacity[..., None] / p.ratio - p.u_if, min=0.0)
    headroom = torch.clamp(room_h.sum(-1) - p.tau, min=0.0)
    return -mob * p.tau, torch.minimum(mob * p.tau, headroom)


def spatial_shift(p: VCCProblem, *, mobility=0.3):
    """Greedy pre-shift: returns (tau_shifted (..., n), carbon_price)."""
    price = carbon_price(p)
    lo, ub = shift_bounds(p, mobility)
    shift = solver.minimize_linear(price, lo, ub)
    return torch.clamp(p.tau + shift, min=0.0), price
