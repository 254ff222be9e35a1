"""Grid simulation and day-ahead carbon-intensity forecast (paper §III-B3):
a frozen copy of the program's ``core/carbon.py`` without what the day
does not use. A multi-zone grid whose hourly intensity follows a generation
mix (solar, wind, baseload, thermal) with diurnal structure and AR(1)
weather; the forecast blends climatology and persistence with a
volatility-scaled error. Zone parameters are dicts of tensors with leading
batch axes matched by a leading batch of keys; series are (..., days, 24).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from cics_bench.reference import prng

f32 = torch.float32

# kgCO2e / kWh by source (lifecycle-ish averages)
CI_BY_SOURCE = {
    "coal": 0.95, "gas": 0.45, "solar": 0.0, "wind": 0.0,
    "hydro": 0.0, "nuclear": 0.0,
}


@dataclass(frozen=True)
class ZoneConfig:
    """A grid zone's structural mix. Fractions are of mean demand."""
    name: str = "zone"
    solar_cap: float = 0.35
    wind_cap: float = 0.25
    baseload: float = 0.30
    coal_share: float = 0.4
    weather_vol: float = 0.2
    demand_amp: float = 0.15


ZONE_FIELDS = ("solar_cap", "wind_cap", "baseload", "coal_share",
               "weather_vol", "demand_amp")


def stack_zone_params(zones, device=None) -> dict:
    """Tuple of ZoneConfig -> dict of (n_zones,) tensors."""
    return {k: torch.tensor([getattr(z, k) for z in zones], dtype=f32,
                            device=device)
            for k in ZONE_FIELDS}


def _diurnal(hours, peak_hour, width):
    d = torch.minimum(torch.abs(hours - peak_hour),
                      24 - torch.abs(hours - peak_hour))
    return torch.exp(-0.5 * (d / width) ** 2)


def _ar1(key, n: int, vol, rho: float = 0.7):
    """AR(1) daily weather states: (..., 2) keys, vol (...) -> (..., n)."""
    eps = prng.normal(key, (n,)) * vol[..., None]
    gain = torch.sqrt(torch.tensor(1 - rho ** 2, dtype=f32,
                                   device=eps.device))
    x = torch.zeros_like(eps[..., 0])
    xs = []
    for i in range(n):
        x = rho * x + gain * eps[..., i]
        xs.append(x)
    return torch.stack(xs, dim=-1)


def simulate_zone_from(key, zp: dict, days: int) -> torch.Tensor:
    """Hourly average carbon intensity from zone parameters of shape (...)
    and keys (..., 2). Returns (..., days, 24), kgCO2e/kWh."""
    hours = torch.arange(24, dtype=f32, device=key.device)
    ks = prng.split(key, 3)
    clear = torch.sigmoid(1.0 + _ar1(ks[..., 0, :], days,
                                     zp["weather_vol"] * 5))
    windy = torch.sigmoid(0.5 + _ar1(ks[..., 1, :], days,
                                     zp["weather_vol"] * 6))
    demand = 1.0 + zp["demand_amp"][..., None] * (
        0.6 * _diurnal(hours, 19.0, 3.5) + 0.4 * _diurnal(hours, 9.0, 2.5))
    solar_shape = _diurnal(hours, 12.5, 2.8)
    wind_noise = 1.0 + 0.15 * prng.normal(ks[..., 2, :], (days, 24))
    solar = zp["solar_cap"][..., None, None] * clear[..., :, None] \
        * solar_shape
    wind = zp["wind_cap"][..., None, None] * windy[..., :, None] \
        * torch.clamp(wind_noise, 0.3, 1.7)
    green = solar + wind + zp["baseload"][..., None, None]
    thermal = torch.clamp(demand[..., None, :] - green, min=0.02)
    coal = torch.clamp(zp["coal_share"], 0.0, 1.0)
    ci_thermal = (coal * CI_BY_SOURCE["coal"]
                  + (1 - coal) * CI_BY_SOURCE["gas"])
    return thermal * ci_thermal[..., None, None] / demand[..., None, :]


def forecast_day_ahead(key, history, actual_next, vol) -> torch.Tensor:
    """Day-ahead hourly forecast: blend of climatology (trailing 7-day
    mean) and persistence (yesterday), plus a volatility-scaled error.
    key (..., 2); history (..., d, 24); actual_next (..., 24); vol (...)."""
    clim = history[..., -7:, :].mean(-2)
    persist = history[..., -1, :]
    base = 0.6 * clim + 0.4 * persist
    dev = actual_next - base
    err = prng.normal(key, (24,)) * vol[..., None] * torch.abs(actual_next)
    return torch.clamp(base + 0.8 * dev + err, min=1e-3)


def default_zones(n: int) -> Tuple[ZoneConfig, ...]:
    """A spread of zones from very green/volatile to coal-heavy/stable."""
    rng = np.random.RandomState(7)
    zones = []
    for i in range(n):
        zones.append(ZoneConfig(
            name=f"zone_{i}",
            solar_cap=float(rng.uniform(0.05, 0.55)),
            wind_cap=float(rng.uniform(0.05, 0.45)),
            baseload=float(rng.uniform(0.15, 0.5)),
            coal_share=float(rng.uniform(0.05, 0.8)),
            weather_vol=float(rng.uniform(0.02, 0.45)),
            demand_amp=float(rng.uniform(0.08, 0.25)),
        ))
    return tuple(zones)
