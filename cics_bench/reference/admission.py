"""Borg-like real-time admission under a VCC (paper §II-B, §II-C): a frozen
copy of the program's ``core/admission.py``. Inflexible work is always
admitted; flexible work is admitted from a queue only while the hour's
reservations stay under its VCC, and machine capacity caps usage. A loop
over the 24 hourly ticks, vectorised over clusters and rollouts.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def hour_sum(x):
    """Ordered left fold over the trailing 24-hour axis (the reference's
    daily totals are this fold, not a tree reduction)."""
    out = x[..., 0]
    for h in range(1, x.shape[-1]):
        out = out + x[..., h]
    return out


@dataclass
class DayResult:
    usage_flex: torch.Tensor     # (..., n, 24) flexible CPU usage
    usage_total: torch.Tensor    # (..., n, 24)
    reservations: torch.Tensor   # (..., n, 24) total reservations
    power: torch.Tensor          # (..., n, 24) kW
    carbon: torch.Tensor         # (..., n, 24) kgCO2e
    served: torch.Tensor         # (..., n) flexible CPU-h served
    arrived: torch.Tensor        # (..., n) flexible CPU-h arrived
    queue_end: torch.Tensor      # (..., n)
    unmet: torch.Tensor          # (..., n) arrivals not served in the day


def admission_tick(queue, vcc_h, uif_h, arr_h, r_h, capacity):
    """One hourly admission decision for all clusters: (queue', use_flex)."""
    flex_room_res = torch.clamp(vcc_h - uif_h * r_h, min=0.0)
    flex_room = flex_room_res / torch.clamp(r_h, min=1.0)
    flex_room = torch.minimum(flex_room,
                              torch.clamp(capacity - uif_h, min=0.0))
    demand = queue + arr_h
    use_flex = torch.minimum(demand, flex_room)
    return demand - use_flex, use_flex


def finalize_day(use_flex, queue_end, u_if, arrivals, ratio, queue0,
                 power_fn, intensity, allowance_frac: float = 0.25
                 ) -> DayResult:
    """Assemble the DayResult from realized hourly flexible usage.
    ``power_fn`` maps cluster usage (..., n, t) to power (..., n, t).
    Only backlog growth beyond ``allowance_frac * arrived`` counts as
    unmet (late arrivals may run tomorrow morning)."""
    usage_total = u_if + use_flex
    reservations = usage_total * ratio
    power = power_fn(usage_total)
    carbon = power * intensity
    arrived = hour_sum(arrivals)
    served = hour_sum(use_flex)
    allowance = allowance_frac * arrived
    unmet = torch.clamp(queue_end - queue0 - allowance, min=0.0)
    return DayResult(usage_flex=use_flex, usage_total=usage_total,
                     reservations=reservations, power=power, carbon=carbon,
                     served=served, arrived=arrived, queue_end=queue_end,
                     unmet=unmet)


def run_day(vcc, u_if, arrivals, ratio, capacity, queue0, power_fn,
            intensity, allowance_frac: float = 0.25) -> DayResult:
    """Simulate one day: vcc/u_if/arrivals/ratio/intensity (..., n, 24);
    capacity/queue0 (..., n)."""
    queue = queue0
    cols = []
    for h in range(vcc.shape[-1]):
        queue, use = admission_tick(queue, vcc[..., h], u_if[..., h],
                                    arrivals[..., h], ratio[..., h],
                                    capacity)
        cols.append(use)
    return finalize_day(torch.stack(cols, dim=-1), queue, u_if, arrivals,
                        ratio, queue0, power_fn, intensity, allowance_frac)
