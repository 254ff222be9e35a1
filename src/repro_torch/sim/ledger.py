"""Emissions ledger for batched rollouts (port of ``repro.sim.ledger``).

Per-cluster cumulative kgCO2e, kWh, peak power, delayed CPU-hours and
flexible-work completion, for the shaped run and the unshaped
counterfactual advanced beside it. Leaves are (B, n); ``days`` is (B,).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

f32 = torch.float32


class DayMetrics(NamedTuple):
    """Per-cluster reductions of one simulated day (all (B, n))."""
    carbon_kg: torch.Tensor
    kwh: torch.Tensor
    peak_kw: torch.Tensor
    served: torch.Tensor
    arrived: torch.Tensor
    unmet: torch.Tensor
    queue_end: torch.Tensor
    cf_carbon_kg: torch.Tensor
    cf_kwh: torch.Tensor
    cf_peak_kw: torch.Tensor
    cf_served: torch.Tensor
    cf_queue_end: torch.Tensor


class Ledger(NamedTuple):
    """Cumulative per-cluster totals over a rollout."""
    days: torch.Tensor
    carbon_kg: torch.Tensor
    kwh: torch.Tensor
    peak_kw: torch.Tensor          # running max over days
    served: torch.Tensor
    arrived: torch.Tensor
    unmet: torch.Tensor
    delayed_cpu_h: torch.Tensor    # sum of nightly carried queue
    cf_carbon_kg: torch.Tensor
    cf_kwh: torch.Tensor
    cf_peak_kw: torch.Tensor
    cf_served: torch.Tensor
    cf_delayed_cpu_h: torch.Tensor


def init_ledger(batch: int, n_clusters: int, device=None) -> Ledger:
    z = torch.zeros((batch, n_clusters), dtype=f32, device=device)
    return Ledger(torch.zeros((batch,), dtype=f32, device=device),
                  *([z] * (len(Ledger._fields) - 1)))


def ledger_update(led: Ledger, m: DayMetrics) -> Ledger:
    return Ledger(
        days=led.days + 1.0,
        carbon_kg=led.carbon_kg + m.carbon_kg,
        kwh=led.kwh + m.kwh,
        peak_kw=torch.maximum(led.peak_kw, m.peak_kw),
        served=led.served + m.served,
        arrived=led.arrived + m.arrived,
        unmet=led.unmet + m.unmet,
        delayed_cpu_h=led.delayed_cpu_h + m.queue_end,
        cf_carbon_kg=led.cf_carbon_kg + m.cf_carbon_kg,
        cf_kwh=led.cf_kwh + m.cf_kwh,
        cf_peak_kw=torch.maximum(led.cf_peak_kw, m.cf_peak_kw),
        cf_served=led.cf_served + m.cf_served,
        cf_delayed_cpu_h=led.cf_delayed_cpu_h + m.cf_queue_end,
    )


def summarize(led: Ledger, initial_backlog=0.0) -> Dict[str, torch.Tensor]:
    """Fleet-level scalars per rollout, each of shape (B,).
    ``initial_backlog``: fleet-total flexible CPU-h queued at rollout start,
    so completion stays a true fraction when that backlog drains."""
    carbon = led.carbon_kg.sum(-1)
    cf_carbon = torch.clamp(led.cf_carbon_kg.sum(-1), min=1e-9)
    kwh = led.kwh.sum(-1)
    cf_kwh = torch.clamp(led.cf_kwh.sum(-1), min=1e-9)
    peak = led.peak_kw.sum(-1)
    cf_peak = torch.clamp(led.cf_peak_kw.sum(-1), min=1e-9)
    arrived = torch.clamp(led.arrived.sum(-1), min=1e-9)
    return {
        "carbon_kg": carbon,
        "cf_carbon_kg": cf_carbon,
        "carbon_saved_pct": 100.0 * (cf_carbon - carbon) / cf_carbon,
        "kwh": kwh,
        "kwh_saved_pct": 100.0 * (cf_kwh - kwh) / cf_kwh,
        "peak_kw": peak,
        "peak_reduction_pct": 100.0 * (cf_peak - peak) / cf_peak,
        "flex_within_24h_pct": 100.0 * (1.0 - torch.clamp(
            led.unmet.sum(-1) / arrived, 0.0, 1.0)),
        "flex_completion_pct": 100.0 * torch.clamp(
            led.served.sum(-1) / (arrived + initial_backlog), 0.0, 1.0),
        "delayed_cpu_h_per_day": led.delayed_cpu_h.sum(-1)
        / torch.clamp(led.days, min=1.0),
        "mean_intensity_kg_per_kwh": carbon / torch.clamp(kwh, min=1e-9),
    }
