"""SLO-violation detection and its feedback (paper §III-B2): a frozen copy of
the program's ``core/slo.py`` without what the day does not use. If a
cluster's daily reservation demand crowds its VCC budget two days in a row,
shaping pauses for ``pause_days``; while paused the streak is frozen. A day
is violated when unmet flexible work exceeds ``rel_tol`` of its
arrivals.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SLOConfig:
    margin: float = 1.0           # demand/VCC ratio considered "crowded"
    pause_days: int = 7
    rel_tol: float = 1e-3


def update(state, cfg: SLOConfig, daily_reservations, vcc_budget,
           flexible_unmet, arrived):
    """One end-of-day update over (..., n) tensors. Returns (new_state,
    shaping allowed for the NEXT day, bool); the counters keep their
    integer type."""
    paused = state["pause_left"] > 0
    crowded = daily_reservations >= cfg.margin * vcc_budget
    streak = torch.where(paused, state["crowded_streak"],
                         torch.where(crowded, state["crowded_streak"] + 1, 0))
    trigger = (~paused) & (streak >= 2)
    pause = torch.where(trigger, cfg.pause_days,
                        torch.clamp(state["pause_left"] - 1, min=0))
    violated = flexible_unmet > cfg.rel_tol * arrived
    new = {
        "crowded_streak": torch.where(trigger, 0, streak),
        "pause_left": pause,
        "violation_days": state["violation_days"]
        + violated.to(state["violation_days"].dtype),
        "observed_days": state["observed_days"] + 1,
    }
    return new, pause == 0


def ratios(cfg: SLOConfig, daily_reservations, vcc_budget, flexible_unmet,
           arrived):
    """Each test's quantity over its threshold, less 1, over (..., n):
    crowded where the first is >= 0, violated where the second is > 0. How
    far from 0 a cluster lies says how much rounding it takes to flip."""
    crowded = daily_reservations / torch.clamp(cfg.margin * vcc_budget,
                                               min=1e-30) - 1.0
    violated = flexible_unmet / torch.clamp(cfg.rel_tol * arrived,
                                            min=1e-30) - 1.0
    return crowded, violated
