"""SLO-violation detection + feedback loop (paper §III-B2).

Port of ``repro.core.slo``. If a cluster's daily reservation demand crowds
its VCC budget two days in a row, shaping pauses for ``pause_days`` so the
forecasters re-adapt. While paused the crowded streak is frozen. A day is
violated when unmet flexible work exceeds ``rel_tol`` of its arrivals.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SLOConfig:
    margin: float = 1.0           # demand/VCC ratio considered "crowded"
    pause_days: int = 7
    rel_tol: float = 1e-3


def init_state(n_clusters: int, device=None):
    """A fleet's zeroed SLO state: four (n_clusters,) int32 counters."""
    return {k: torch.zeros((n_clusters,), dtype=torch.int32, device=device)
            for k in ("crowded_streak", "pause_left", "violation_days",
                      "observed_days")}


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


def violation_rate(state):
    return state["violation_days"] / torch.clamp(state["observed_days"],
                                                 min=1)
