"""Batched fleet rollout engine over the staged core (port of
``repro.sim.engine``).

* ``SimConfig``        — static shapes + solver knobs; everything dynamic
  (prices, risk, weather, outages) lives in ``SimParams`` tensors.
* ``make_init(cfg)``   — burn-in -> ``SimState``.
* ``make_rollout``     — a loop of the day step over days, carrying the
  emissions ledger and the unshaped counterfactual.
* ``rollout_batch``    — init + rollout of a (scenario x seed) batch on one
  device, the batch a leading tensor axis.
* ``rollout_batch_sharded`` — the batch split into equal slices over
  devices (the reference's 1-D mesh), each slice run by ``rollout_batch``
  on its device, the results joined on the first device.
* ``rollout_sequential`` — the per-rollout reference: each rollout of the
  batch driven alone (batch of one), stacked.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import device as _device
from repro_torch import spans
from repro_torch.core import stages
from repro_torch.core.stages import SimParams, SimState, StepOut  # noqa: F401
from repro_torch.core.stages import hour_sum as _hsum
from repro_torch.sim.ledger import DayMetrics, init_ledger, ledger_update


@dataclass(frozen=True)
class SimConfig:
    """Static structure (shapes + solver knobs). ``streaming``: the O(1)
    streaming prediction carry (state independent of ``hist_days``; not
    with ``n_members > 1``); ``mpc``: intra-day MPC recourse, hourly
    warm-started suffix re-solves (``core.mpc``); ``telemetry``: the
    rollout's traj also holds the days' ``sim.telemetry.DayTelemetry``
    records under ``"telemetry"``, leaves (B, days, ...)."""
    n_clusters: int = 16
    n_campuses: int = 4
    n_zones: int = 4
    pds_per_cluster: int = 2
    hist_days: int = 35
    slo_margin: float = 1.0
    slo_pause_days: int = 7
    joint_spatial: bool = False
    n_members: int = 1
    streaming: bool = False
    telemetry: bool = False
    mpc: bool = False
    slo_allowance: float = 0.25

    def stage_config(self) -> stages.StageConfig:
        return stages.StageConfig(slo_margin=self.slo_margin,
                                  slo_pause_days=self.slo_pause_days,
                                  joint_spatial=self.joint_spatial,
                                  n_members=self.n_members,
                                  streaming=self.streaming,
                                  telemetry=self.telemetry,
                                  mpc=self.mpc,
                                  slo_allowance=self.slo_allowance)


def _metrics(res, cf) -> DayMetrics:
    return DayMetrics(
        carbon_kg=_hsum(res.carbon), kwh=_hsum(res.power),
        peak_kw=res.power.amax(-1), served=res.served,
        arrived=res.arrived, unmet=res.unmet, queue_end=res.queue_end,
        cf_carbon_kg=_hsum(cf.carbon), cf_kwh=_hsum(cf.power),
        cf_peak_kw=cf.power.amax(-1), cf_served=cf.served,
        cf_queue_end=cf.queue_end)


def make_day_step(cfg: SimConfig):
    """The staged CICS day: step(params, state, xs) -> (state', StepOut)."""
    return stages.make_day_step(cfg.stage_config())


def make_init(cfg: SimConfig, device=None):
    """init(params) -> burned-in SimState on ``device`` (default cuda)."""
    return stages.make_init(cfg.n_clusters, cfg.n_campuses, cfg.n_zones,
                            cfg.hist_days, device=device,
                            streaming=cfg.streaming)


def day_xs(params: SimParams, d: int):
    """Day ``d``'s scenario-schedule slices, each (B, k); the intraday
    hour channels (B, 24) only when the params carry them."""
    xs = {"green_scale": params.green_scale[:, d],
          "coal_scale": params.coal_scale[:, d],
          "cap_scale": params.cap_scale[:, d],
          "arrival_scale": params.arrival_scale[:, d],
          "campus_scale": params.campus_scale[:, d]}
    for k in ("arrival_hour_scale", "carbon_hour_scale"):
        if getattr(params, k) is not None:
            xs[k] = getattr(params, k)[:, d]
    return xs


def make_rollout(cfg: SimConfig, days: int, on_day=None):
    """rollout(params, state) -> (state', Ledger, traj dict of (B, days)).
    With ``cfg.telemetry`` the traj also holds ``"telemetry"``: the days'
    records stacked on axis 1, leaves (B, days, ...); otherwise its keys
    are the five totals alone. ``on_day(d, state, StepOut)``, if given,
    sees the state after every day and its output, after the day's ledger
    update; it is first called with ``d = -1`` and ``None`` for the state
    the rollout starts from.

    Spans (``repro_torch.spans``): ``rollout`` a call; ``day`` the day
    step, the day's metrics and its ledger update, not ``on_day``;
    ``ledger`` the ledger update alone."""
    step = make_day_step(cfg)

    def rollout(params: SimParams, state: SimState):
        with spans.span("rollout"):
            horizon = params.cap_scale.shape[1]
            if horizon < days:
                raise ValueError(
                    f"params schedules cover {horizon} days but the rollout "
                    f"asks for {days}; rebuild with build_batch(..., "
                    f"days>={days})")
            if on_day is not None:
                on_day(-1, state, None)
            B = params.key.shape[0]
            ledger = init_ledger(B, cfg.n_clusters, device=params.key.device)
            traj = {k: [] for k in ("carbon_kg", "cf_carbon_kg", "kwh",
                                    "peak_kw", "queue")}
            records = []
            for d in range(days):
                with spans.span("day"):
                    state, out = step(params, state, day_xs(params, d))
                    m = _metrics(out.res, out.cf)
                    with spans.span("ledger"):
                        ledger = ledger_update(ledger, m)
                    traj["carbon_kg"].append(_hsum(m.carbon_kg))
                    traj["cf_carbon_kg"].append(_hsum(m.cf_carbon_kg))
                    traj["kwh"].append(_hsum(m.kwh))
                    traj["peak_kw"].append(_hsum(m.peak_kw))
                    traj["queue"].append(_hsum(m.queue_end))
                    if cfg.telemetry:
                        records.append(out.telemetry)
                if on_day is not None:
                    on_day(d, state, out)
            traj = {k: torch.stack(v, dim=1) for k, v in traj.items()}
            if cfg.telemetry:
                traj["telemetry"] = stages.zip_tensors(
                    lambda ts: torch.stack(ts, dim=1), records)
            return state, ledger, traj

    return rollout


def rollout_batch(cfg: SimConfig, days: int, device=None, on_day=None):
    """run(params) -> (state, Ledger, traj): burn-in + rollout of the whole
    (scenario x seed) batch on ``device`` (default cuda)."""
    dev = _device.resolve(device)
    init = make_init(cfg, device=dev)
    roll = make_rollout(cfg, days, on_day=on_day)

    def run(params: SimParams):
        params = stages.map_tensors(lambda t: t.to(dev), params)
        return roll(params, init(params))

    return run


def rollout_batch_sharded(cfg: SimConfig, days: int, devices=None):
    """``rollout_batch`` with the (scenario x seed) batch split into equal
    slices over ``devices`` (default: every CUDA card,
    ``torch.cuda.device_count()`` of them). Each slice runs its burn-in and
    rollout on its device; the results are concatenated on the first one.
    Rollouts do not interact and the port's numerics are batch-invariant,
    so the result is ``rollout_batch``'s bit for bit. A device may repeat
    (``("cpu", "cpu")`` splits the batch in two on the CPU). The slices run
    one after another from the host.

    The batch must divide by the number of devices: pad it (repeat a seed)
    or pass fewer devices otherwise."""
    if devices is None:
        _device.resolve(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_device.resolve(d) for d in devices]
    runs = [rollout_batch(cfg, days, device=d) for d in devs]

    def run(params: SimParams):
        b = params.key.shape[0]
        if b % len(devs):
            raise ValueError(
                f"batch of {b} rollouts does not divide across the "
                f"{len(devs)} devices; pad the (scenario x seed) batch or "
                "pass fewer devices")
        m = b // len(devs)
        outs = [r(stages.map_tensors(lambda t, i=i: t[i * m:(i + 1) * m],
                                     params)) for i, r in enumerate(runs)]
        return stages.zip_tensors(
            lambda ts: torch.cat([t.to(devs[0]) for t in ts], dim=0), outs)

    return run


def rollout_sequential(cfg: SimConfig, days: int, params: SimParams,
                       device=None):
    """Per-rollout reference: run each rollout of the batch alone (batch
    of one) and stack the results along the batch axis."""
    run = rollout_batch(cfg, days, device=device)
    outs = [run(stages.map_tensors(lambda t: t[b:b + 1], params))
            for b in range(params.key.shape[0])]
    return stages.zip_tensors(lambda ts: torch.cat(ts, dim=0), outs)
