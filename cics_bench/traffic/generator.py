"""The benchmark's traffic generator: scenario libraries read as data, and
the (scenario x seed) batch of fleet parameters built from them.

A traffic file ``traffic/<name>.json`` holds ``days`` (the horizon the
schedules cover), ``seeds_per_scenario`` and ``scenarios``: each a name,
optional scalar overrides (``lambda_e``, ``lambda_p``, ``gamma``,
``mobility``, ``risk_beta``) and a list of perturbations, each a ``kind``
with its parameters. This is a frozen copy of the scenario engine the
program ships (its libraries written out as data at a 7-day horizon, its
perturbations and ``build_params``), so the traffic stays what it was
whatever later changes to the program do.

The fleets are drawn from the run's seed: ``seeds_per_scenario`` uint32
fleet seeds, shared by every scenario, batch index ``i_scenario *
seeds_per_scenario + i_seed``. Each fleet's latent clusters, PD curves and
random key come from its seed through the threefry stream, in one batched
call on the device; each scenario's own draws (which clusters an outage
hits) from a numpy generator keyed on (fleet seed, crc32(name)).
"""
from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from cics_bench.reference import carbon, prng

f32 = torch.float32
HERE = Path(__file__).resolve().parent
SCALARS = {"lambda_e": 0.5, "lambda_p": 0.05, "gamma": 0.05,
           "mobility": 0.0, "risk_beta": 1.0}
SCHEDULES = ("green_scale", "coal_scale", "cap_scale", "arrival_scale",
             "campus_scale")
HOUR_CHANNELS = ("arrival_hour_scale", "carbon_hour_scale")


def load(name: str) -> Dict:
    """The traffic file ``traffic/<name>.json``."""
    return json.loads((HERE / f"{name}.json").read_text())


# ------------------------------------------------------------ perturbations

def _window(p: Dict, days: int) -> slice:
    start, length = int(p.get("start", 0)), int(p.get("length", -1))
    end = days if length < 0 else min(start + length, days)
    return slice(min(start, days), end)


def _hour_channel(sched, key: str, days: int):
    if key not in sched:
        sched[key] = np.ones((days, 24))
    return sched[key]


def _intraday(sched, p, rng, key, scale, hour_len):
    days = sched["cap_scale"].shape[0]
    ch = _hour_channel(sched, key, days)
    scale = p.get("scale", scale)
    hour_len = int(p.get("hour_len", hour_len))
    w = _window(p, days)
    for d in range(w.start, w.stop):
        h0 = p.get("hour_start")
        h0 = int(rng.integers(5, 24 - hour_len)) if h0 is None else int(h0)
        ch[d, h0:min(h0 + hour_len, 24)] *= scale


def apply(p: Dict, sched: Dict[str, np.ndarray], rng, dims: Dict) -> None:
    """Edit the schedules ``sched`` (one row a rollout day) in place by the
    perturbation ``p``."""
    kind = p["kind"]
    days = sched["cap_scale"].shape[0]
    w = _window(p, days)
    if kind == "RenewableDrought":
        zs = p.get("zones")
        zs = list(range(dims["n_zones"])) if zs is None else list(zs)
        sched["green_scale"][w, zs] *= (1.0 - p.get("depth", 0.7))
    elif kind == "CoalRetirement":
        t = np.arange(w.stop - w.start, dtype=np.float64)
        ramp = np.clip(1.0 - p.get("rate_per_week", 0.05) * t / 7.0, 0.0,
                       None)
        sched["coal_scale"][w] *= ramp[:, None]
    elif kind == "ClusterOutage":
        n = dims["n_clusters"]
        k = max(1, int(round(p.get("frac", 0.25) * n)))
        hit = np.sort(rng.choice(n, size=k, replace=False))
        sched["cap_scale"][w, hit] *= p.get("derate", 0.1)
    elif kind == "CampusDerate":
        cs = p.get("campuses")
        cs = list(range(dims["n_campuses"])) if cs is None else list(cs)
        sched["campus_scale"][w, cs] *= p.get("scale", 0.85)
    elif kind == "DemandSurge":
        sched["arrival_scale"][w] *= p.get("scale", 1.5)
    elif kind == "CapacitySqueeze":
        sched["cap_scale"][w] *= p.get("scale", 0.75)
    elif kind == "IntradayCarbonSpike":
        _intraday(sched, p, rng, "carbon_hour_scale", 1.8, 8)
    elif kind == "IntradayDemandSurge":
        _intraday(sched, p, rng, "arrival_hour_scale", 1.7, 6)
    else:
        raise ValueError(f"unknown perturbation kind {kind!r}")


# ----------------------------------------------------------------- fleets

def fleet_seeds(seed: int, count: int) -> List[int]:
    """``count`` uint32 fleet seeds drawn from the run's seed."""
    rng = np.random.default_rng(int(seed))
    return [int(s) for s in rng.integers(0, 2 ** 32, size=count,
                                         dtype=np.uint64)]


def _cluster_truth(key, n: int):
    ks = prng.split(key, 10)

    def u(i):
        return prng.uniform(ks[..., i, :], (n,))

    capacity = torch.exp(prng.normal(ks[..., 0, :], (n,)) * 0.4 + 2.3)
    flex_share = torch.clamp(0.08 + 0.5 * u(1), 0.05, 0.6)
    return {"capacity": capacity, "flex_share": flex_share,
            "base_if": capacity * (0.35 + 0.2 * u(2)),
            "diurnal_amp": 0.15 + 0.2 * u(3),
            "peak_hour": 8.0 + 10.0 * u(4),
            "weekly_amp": 0.05 + 0.1 * u(5),
            "noise": 0.02 + 0.06 * u(6),
            "arr_level": capacity * flex_share * (0.5 + 0.4 * u(7)),
            "ratio_a": 1.15 + 0.3 * u(8),
            "ratio_b": -0.05 - 0.08 * u(9)}


def synth(seeds: Sequence[int], dims: Dict, device) -> Dict:
    """The array-only fleet parameters of each seed, batched: latent
    cluster truth, PD power-curve truth, PD usage fractions, zone
    parameters and the rollout key, leaves (B, ...)."""
    for s in seeds:
        if not 0 <= int(s) < 2 ** 32:
            raise ValueError(f"fleet seed must be a uint32, got {s}")
    key = torch.tensor([[0, int(s)] for s in seeds], dtype=torch.int64,
                       device=device)
    ks = prng.split(key, 8)
    n, npds, z = dims["n_clusters"], dims["pds_per_cluster"], dims["n_zones"]
    npd = n * npds
    B = len(seeds)
    zone = carbon.stack_zone_params(carbon.default_zones(z), device)
    return {
        "key": prng.fold_in(key, 17),
        "truth": _cluster_truth(ks[:, 0], n),
        "pd_idle": 60.0 + 40.0 * prng.uniform(ks[:, 1], (npd,)),
        "pd_slope": 250.0 + 150.0 * prng.uniform(ks[:, 2], (npd,)),
        "pd_curve": 0.8 + 0.5 * prng.uniform(ks[:, 3], (npd,)),
        "lam": torch.softmax(prng.normal(ks[:, 4], (n, npds)), dim=-1),
        "zone": {k: v.expand(B, z).contiguous() for k, v in zone.items()},
    }


def build_batch(traffic: Dict, dims: Dict, seed: int, device) -> Dict:
    """The cell's (scenario x seed) batch of fleet parameters from the
    traffic file's data and the run's seed: a dict of tensors, leaves
    (B, ...), the per-day schedules (B, days, k)."""
    days = int(traffic["days"])
    seeds = fleet_seeds(seed, int(traffic["seeds_per_scenario"]))
    scenarios = traffic["scenarios"]
    per_fleet = synth(seeds, dims, device)
    B = len(scenarios) * len(seeds)
    index = torch.arange(B, device=device) % len(seeds)
    out = {k: (v[index] if isinstance(v, torch.Tensor)
               else {kk: vv[index] for kk, vv in v.items()})
           for k, v in per_fleet.items()}
    shapes = {"green_scale": dims["n_zones"], "coal_scale": dims["n_zones"],
              "cap_scale": dims["n_clusters"],
              "arrival_scale": dims["n_clusters"],
              "campus_scale": dims["n_campuses"]}
    scheds, scalars = [], {k: [] for k in SCALARS}
    for sc in scenarios:
        unknown = set(sc) - {"name", "perturbations", *SCALARS}
        if unknown:
            raise ValueError(f"scenario {sc['name']}: unknown keys "
                             f"{sorted(unknown)}")
        tag = zlib.crc32(sc["name"].encode("utf-8"))
        for s in seeds:
            sched = {k: np.ones((days, w)) for k, w in shapes.items()}
            rng = np.random.default_rng((int(s) << 32) ^ tag)
            for p in sc.get("perturbations", ()):
                apply(p, sched, rng, dims)
            scheds.append(sched)
            for k, v in SCALARS.items():
                scalars[k].append(float(sc.get(k, v)))

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    for k in SCHEDULES:
        out[k] = t(np.stack([s[k] for s in scheds]))
    for k in HOUR_CHANNELS:
        if any(k in s for s in scheds):
            out[k] = t(np.stack([s.get(k, np.ones((days, 24)))
                                 for s in scheds]))
    for k in SCALARS:
        out[k] = t(scalars[k])
    return out


def fleet_labels(traffic: Dict, seed: int) -> List[str]:
    """Each rollout's "scenario/fleet seed" label, in batch order."""
    seeds = fleet_seeds(seed, int(traffic["seeds_per_scenario"]))
    return [f"{sc['name']}/{s}" for sc in traffic["scenarios"]
            for s in seeds]
