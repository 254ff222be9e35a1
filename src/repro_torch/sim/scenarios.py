"""Declarative scenario perturbations composable onto the synthetic fleet
(port of ``repro.sim.scenarios``: the default, mobility-sweep, risk-sweep
and forecast-bust libraries).

A Scenario = a name + scalar overrides (carbon price, risk, mobility) + a
tuple of Perturbation objects, each of which edits the numpy multiplier
schedules (one row per rollout day) that the engine consumes. Composition is
pure: per-scenario randomness (which clusters an outage hits, which hours an
intraday block covers) is drawn from a generator keyed on (seed,
crc32(scenario.name)), as in the reference, so it lands where the
reference's does.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import stages
from repro_torch.sim.engine import SimConfig, SimParams

f32 = torch.float32


# ------------------------------------------------------------ perturbations

@dataclass(frozen=True)
class Perturbation:
    """Base: edits the schedule dict in place. start/length in rollout
    days; length < 0 means 'until the end of the horizon'."""
    start: int = 0
    length: int = -1

    def window(self, days: int) -> slice:
        end = days if self.length < 0 else min(self.start + self.length,
                                               days)
        return slice(min(self.start, days), end)

    def apply(self, sched: Dict[str, np.ndarray], rng: np.random.Generator,
              cfg: SimConfig) -> None:
        raise NotImplementedError


@dataclass(frozen=True)
class RenewableDrought(Perturbation):
    """Dunkelflaute: solar+wind capacity drops by `depth` in some zones."""
    depth: float = 0.7
    zones: Optional[Tuple[int, ...]] = None      # None = all zones

    def apply(self, sched, rng, cfg):
        w = self.window(sched["green_scale"].shape[0])
        zs = list(self.zones) if self.zones is not None \
            else list(range(cfg.n_zones))
        sched["green_scale"][w, zs] *= (1.0 - self.depth)


@dataclass(frozen=True)
class CoalRetirement(Perturbation):
    """Linear ramp-down of the thermal coal share, `rate` per week."""
    rate_per_week: float = 0.05

    def apply(self, sched, rng, cfg):
        w = self.window(sched["coal_scale"].shape[0])
        t = np.arange(w.stop - w.start, dtype=np.float64)
        ramp = np.clip(1.0 - self.rate_per_week * t / 7.0, 0.0, None)
        sched["coal_scale"][w] *= ramp[:, None]


@dataclass(frozen=True)
class ClusterOutage(Perturbation):
    """A fraction of clusters loses most capacity for a window."""
    frac: float = 0.25
    derate: float = 0.1          # remaining capacity fraction

    def apply(self, sched, rng, cfg):
        w = self.window(sched["cap_scale"].shape[0])
        k = max(1, int(round(self.frac * cfg.n_clusters)))
        hit = np.sort(rng.choice(cfg.n_clusters, size=k, replace=False))
        sched["cap_scale"][w, hit] *= self.derate


@dataclass(frozen=True)
class CampusDerate(Perturbation):
    """Contracted campus power limit drops (grid event / demand response)."""
    scale: float = 0.85
    campuses: Optional[Tuple[int, ...]] = None

    def apply(self, sched, rng, cfg):
        w = self.window(sched["campus_scale"].shape[0])
        cs = list(self.campuses) if self.campuses is not None \
            else list(range(cfg.n_campuses))
        sched["campus_scale"][w, cs] *= self.scale


@dataclass(frozen=True)
class DemandSurge(Perturbation):
    """Flexible-demand arrivals scale up fleetwide for a window."""
    scale: float = 1.5

    def apply(self, sched, rng, cfg):
        w = self.window(sched["arrival_scale"].shape[0])
        sched["arrival_scale"][w] *= self.scale


@dataclass(frozen=True)
class CapacitySqueeze(Perturbation):
    """Fleetwide machine-capacity derate (tight-supply regime: temporal
    shaping bounds bind, so spatially exporting work matters)."""
    scale: float = 0.75

    def apply(self, sched, rng, cfg):
        w = self.window(sched["cap_scale"].shape[0])
        sched["cap_scale"][w] *= self.scale


def _hour_channel(sched: Dict[str, np.ndarray], key: str,
                  days: int) -> np.ndarray:
    """The intraday (days, 24) multiplier channel ``key``, made at first
    use: scenarios without intraday perturbations carry none."""
    if key not in sched:
        sched[key] = np.ones((days, 24))
    return sched[key]


@dataclass(frozen=True)
class IntradayCarbonSpike(Perturbation):
    """Forecast-busting intra-day carbon spike: the ACTUAL zone intensity
    is scaled by ``scale`` for a ``hour_len``-hour block each day of the
    window, after the day-ahead forecast is drawn. ``hour_start=None``
    places the block at random each day (scenario rng)."""
    scale: float = 1.8
    hour_len: int = 8
    hour_start: Optional[int] = None

    def apply(self, sched, rng, cfg):
        days = sched["cap_scale"].shape[0]
        ch = _hour_channel(sched, "carbon_hour_scale", days)
        w = self.window(days)
        for d in range(w.start, w.stop):
            h0 = self.hour_start if self.hour_start is not None \
                else int(rng.integers(5, 24 - self.hour_len))
            ch[d, h0:min(h0 + self.hour_len, 24)] *= self.scale


@dataclass(frozen=True)
class IntradayDemandSurge(Perturbation):
    """Forecast-busting intra-day arrival surge: ACTUAL flexible arrivals
    scale by ``scale`` for a ``hour_len``-hour block each day of the window
    (a random block a day when ``hour_start=None``)."""
    scale: float = 1.7
    hour_len: int = 6
    hour_start: Optional[int] = None

    def apply(self, sched, rng, cfg):
        days = sched["cap_scale"].shape[0]
        ch = _hour_channel(sched, "arrival_hour_scale", days)
        w = self.window(days)
        for d in range(w.start, w.stop):
            h0 = self.hour_start if self.hour_start is not None \
                else int(rng.integers(5, 24 - self.hour_len))
            ch[d, h0:min(h0 + self.hour_len, 24)] *= self.scale


# ----------------------------------------------------------------- scenario

@dataclass(frozen=True)
class Scenario:
    name: str
    description: str = ""
    perturbations: Tuple[Perturbation, ...] = ()
    lambda_e: float = 0.5        # carbon price
    lambda_p: float = 0.05
    gamma: float = 0.05          # power-capping violation probability
    mobility: float = 0.0        # spatial-shift mobility (0 = paper mode)
    risk_beta: float = 1.0       # CVaR tail fraction (acts only with K > 1)


def _scenario_rng(scenario: Scenario, seed: int) -> np.random.Generator:
    tag = zlib.crc32(scenario.name.encode("utf-8"))
    return np.random.default_rng((int(seed) << 32) ^ tag)


def build_params(cfg: SimConfig, scenario: Scenario, seed: int, days: int,
                 device=None) -> SimParams:
    """Compose a scenario onto the synthetic fleet -> the SimParams of ONE
    rollout (leaves without the batch axis; ``build_batch`` stacks them)."""
    dev = _device.resolve(device)
    n, m, z = cfg.n_clusters, cfg.n_campuses, cfg.n_zones
    sp = stages.synth_params(seed, n, cfg.pds_per_cluster, z, device=dev)
    sched = {
        "green_scale": np.ones((days, z)),
        "coal_scale": np.ones((days, z)),
        "cap_scale": np.ones((days, n)),
        "arrival_scale": np.ones((days, n)),
        "campus_scale": np.ones((days, m)),
    }
    rng = _scenario_rng(scenario, seed)
    for p in scenario.perturbations:
        p.apply(sched, rng, cfg)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)

    return SimParams(
        key=sp["key"], truth=sp["truth"], pd_idle=sp["pd_idle"],
        pd_slope=sp["pd_slope"], pd_curve=sp["pd_curve"], lam=sp["lam"],
        zone=sp["zone"], lambda_e=t(scenario.lambda_e),
        lambda_p=t(scenario.lambda_p), gamma=t(scenario.gamma),
        mobility=t(scenario.mobility), risk_beta=t(scenario.risk_beta),
        **{k: t(v) for k, v in sched.items()})


def build_batch(cfg: SimConfig, scenarios: Sequence[Scenario],
                seeds: Sequence[int], days: int, device=None) -> SimParams:
    """Stack (scenario x seed) SimParams along a new leading axis, scenario
    major: batch index b = i_scenario * len(seeds) + i_seed. If any rollout
    carries an intraday hour channel, the rollouts without it get the
    neutral all-ones channel (actuals times exactly 1.0)."""
    all_params = [build_params(cfg, sc, seed, days, device=device)
                  for sc in scenarios for seed in seeds]
    for field in ("arrival_hour_scale", "carbon_hour_scale"):
        have = [getattr(p, field) for p in all_params
                if getattr(p, field) is not None]
        if have:
            ones = torch.ones_like(have[0])
            all_params = [p if getattr(p, field) is not None
                          else p._replace(**{field: ones})
                          for p in all_params]
    return stages.zip_tensors(torch.stack, all_params)


# ------------------------------------------------------------------ library

def default_library(days: int = 14) -> List[Scenario]:
    """The standing scenario sweep (11 scenarios)."""
    half = max(days // 2, 1)
    return [
        Scenario("baseline",
                 "nominal grid, nominal fleet"),
        Scenario("renewable_drought",
                 "70% solar+wind drop across all zones, second half",
                 (RenewableDrought(start=half, depth=0.7),)),
        Scenario("coal_retirement",
                 "coal share ramps down 10%/week from day 0",
                 (CoalRetirement(rate_per_week=0.10),)),
        Scenario("cluster_outage",
                 "25% of clusters derated to 10% capacity mid-horizon",
                 (ClusterOutage(start=half, length=max(days // 4, 1),
                                frac=0.25),)),
        Scenario("campus_derate",
                 "all campus power contracts cut 15%",
                 (CampusDerate(scale=0.85),)),
        Scenario("demand_surge",
                 "flexible arrivals x1.6 in the second half",
                 (DemandSurge(start=half, scale=1.6),)),
        Scenario("high_carbon_price",
                 "lambda_e x4: aggressive shaping",
                 lambda_e=2.0),
        Scenario("low_risk_tolerance",
                 "gamma 0.01: conservative power capping",
                 gamma=0.01),
        Scenario("spatial_mobility",
                 "30% of flexible work location-flexible (beyond-paper)",
                 mobility=0.3),
        Scenario("peak_shaver",
                 "peak-power-optimal pricing (lambda_p >> lambda_e): the "
                 "'War of the Efficiencies' counterpoint",
                 lambda_e=0.02, lambda_p=0.5),
        Scenario("perfect_storm",
                 "drought + outage + surge, compounded",
                 (RenewableDrought(start=half, depth=0.6),
                  ClusterOutage(start=half, length=max(days // 4, 1),
                                frac=0.2),
                  DemandSurge(start=half, scale=1.4))),
    ]


MOBILITY_SWEEP = (0.0, 0.1, 0.3, 0.6)


def mobility_sweep_library(days: int = 14,
                           mobilities: Sequence[float] = MOBILITY_SWEEP
                           ) -> List[Scenario]:
    """The spatial-mobility sweep (the joint spatio-temporal path):
    mobility swept as data under a zone-0 renewable drought, a fleetwide
    demand surge and a capacity squeeze, the supply-tight regime where
    exporting work (not only delaying it) saves carbon. mobility 0 is the
    temporal-only control row. Run with ``SimConfig(joint_spatial=True)``
    and against the same batch under ``joint_spatial=False``
    (``report.mobility_sweep_rows``)."""
    return [
        Scenario(f"mobility{int(round(100 * m)):03d}",
                 f"{m:.0%} of flexible work location-flexible under a "
                 "zone-0 drought + surge + capacity squeeze",
                 (RenewableDrought(depth=0.8, zones=(0,)),
                  DemandSurge(scale=1.3),
                  CapacitySqueeze(scale=0.75)),
                 lambda_e=1.0, lambda_p=0.02, mobility=m)
        for m in mobilities
    ]


def forecast_bust_library(days: int = 6) -> List[Scenario]:
    """Forecast-busting scenarios for intra-day MPC recourse
    (``SimConfig(mpc=True)``): the day-ahead plan is issued against clean
    forecasts, then the ACTUAL intensity or arrivals are hit by randomly
    placed intra-day blocks the planner never saw. Compare the closed loop
    against the open loop on the same batch (``report.mpc_recourse_rows``)."""
    return [
        Scenario("intraday_carbon_spike",
                 "unforecasted x1.8 intensity block, 8h/day, random hours",
                 (IntradayCarbonSpike(scale=1.8, hour_len=8),),
                 lambda_e=1.0),
        Scenario("intraday_demand_surge",
                 "unforecasted x1.7 arrival block, 6h/day, random hours",
                 (IntradayDemandSurge(scale=1.7, hour_len=6),),
                 lambda_e=1.0),
        Scenario("intraday_perfect_storm",
                 "carbon spike + arrival surge, independently placed",
                 (IntradayCarbonSpike(scale=1.6, hour_len=8),
                  IntradayDemandSurge(scale=1.5, hour_len=6)),
                 lambda_e=1.0),
    ]


RISK_BETAS = (0.5, 0.9, 0.99)
RISK_MEMBERS = (1, 8, 32)


def risk_sweep_library(days: int = 14,
                       betas: Sequence[float] = RISK_BETAS
                       ) -> List[Scenario]:
    """The risk sweep: CVaR tail fraction beta swept as data under a
    forecast-hostile backdrop (drought + demand surge in the second half).
    Pair it with ``SimConfig(n_members=K)`` for each K in ``RISK_MEMBERS``
    (K = 1 makes every beta the same point-forecast path)."""
    half = max(days // 2, 1)
    backdrop = (RenewableDrought(start=half, depth=0.6),
                DemandSurge(start=half, scale=1.4))
    return [
        Scenario(f"risk_beta{int(round(100 * b)):02d}",
                 f"CVaR beta={b}: optimize the worst {b:.0%} of forecast "
                 "members under drought + surge",
                 backdrop, lambda_e=1.0, risk_beta=b)
        for b in betas
    ]
