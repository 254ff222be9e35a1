"""Legacy fleet API: a mutable ``FleetState`` stepped one day at a time
(port of ``repro.core.fleet``).

The day cycle itself lives in ``core/stages.py``; this module owns no
pipeline math. It keeps the reference's surface, a ``FleetState`` whose
leaves are one fleet's, unbatched (n, ...), with a ``record`` dict of the
day's products, as thin adapters over the batched stages (a batch of one):

* ``init_fleet``: synthesizes the fleet (the ``stages.synth_params`` leaves
  the scenarios use) and burns in ``hist_days`` days (``stages.make_init``);
* ``day_cycle``: views the FleetState as (SimParams, SimState) with a batch
  axis of one (``sim_params`` / ``sim_state``), runs the same day step as
  ``sim.engine`` with neutral all-ones scenario slices (``stages.ones_xs``),
  and writes the new state back (``_writeback``);
* ``power_model_from_history`` / ``make_power_fn`` / ``day_forecasts`` /
  ``carbon_forecast_next`` / ``build_problem`` / ``_observe_day``: the
  per-stage adapters of custom day loops.

Because both paths run the same step, ``day_cycle`` and the engine's day
step agree bit for bit from the same state. Entry points run on ``"cuda"``
unless ``device="cpu"`` is passed; the state's tensors stay on its device.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import carbon, power, prng, slo, stages, stats, vcc

f32 = torch.float32
HIST_DAYS = 91            # 13 weeks of rolling history (default burn-in)

# the staged core's synthesis and problem assembly, under the names the
# reference's fleet module re-exports them by
cluster_truth = stages.cluster_truth
build_problem_arrays = stages.build_problem_arrays


@dataclass(frozen=True)
class FleetConfig:
    n_clusters: int = 48
    n_campuses: int = 6
    n_zones: int = 6
    pds_per_cluster: int = 4
    gamma: float = 0.05           # power-capping violation prob
    lambda_e: float = 0.08
    lambda_p: float = 0.05
    seed: int = 0
    hist_days: int = HIST_DAYS
    streaming: bool = False       # True = the O(1) streaming prediction
    #                               carry (FleetState.pred; the hist_*
    #                               windows become zero-length stubs)
    telemetry: bool = False       # True = day_cycle records the day's
    #                               sim.telemetry DayTelemetry under
    #                               record["telemetry"]
    mpc: bool = False             # True = intra-day MPC recourse (hourly
    #                               suffix re-solves, core.mpc)
    slo: slo.SLOConfig = field(default_factory=slo.SLOConfig)


@dataclass
class FleetState:
    cfg: FleetConfig
    day: int
    key: torch.Tensor                # (2,) rollout key (engine convention)
    # static cluster structure
    capacity: torch.Tensor           # (n,)
    campus: torch.Tensor             # (n,) int64
    zmap: torch.Tensor               # (n,) int64 zone of cluster
    zone_of_campus: np.ndarray       # (n_campuses,)
    campus_limit: torch.Tensor       # (n_campuses,) kW
    u_pow_cap: torch.Tensor          # (n,)
    # latent truth for synthesis
    truth: Dict[str, torch.Tensor]
    pd_truth: power.PDTruth
    lam: torch.Tensor                # (n, pds) usage fractions
    zone: Dict[str, torch.Tensor]    # grid-mix params, (zones,)
    # rolling history (oldest first)
    hist_uif: torch.Tensor           # (n, HIST, 24)
    hist_flex_daily: torch.Tensor    # (n, HIST)
    hist_res_daily: torch.Tensor     # (n, HIST)
    hist_usage: torch.Tensor         # (n, HIST, 24) total usage
    hist_res: torch.Tensor           # (n, HIST, 24) total reservations
    hist_tr_pred: torch.Tensor       # (n, HIST) past T_R predictions
    hist_uif_pred: torch.Tensor      # (n, HIST, 24) past U_IF predictions
    carbon_hist: torch.Tensor        # (zones, HIST, 24)
    queue: torch.Tensor              # (n,)
    cf_queue: torch.Tensor           # (n,) unshaped-counterfactual backlog
    slo_state: Dict[str, torch.Tensor]
    shaping_allowed: torch.Tensor    # (n,) bool
    zones: Tuple[carbon.ZoneConfig, ...] = ()
    pred: Optional[stats.PredictorState] = None   # streaming-mode carry


def _stage_cfg(cfg: FleetConfig) -> stages.StageConfig:
    return stages.StageConfig(slo_margin=cfg.slo.margin,
                              slo_pause_days=cfg.slo.pause_days,
                              streaming=cfg.streaming,
                              telemetry=cfg.telemetry,
                              mpc=cfg.mpc)


@functools.lru_cache(maxsize=None)
def _day_step(cfg: stages.StageConfig):
    """One day step a StageConfig, shared by every fleet of that config."""
    return stages.make_day_step(cfg)


# ----------------------------------------- FleetState <-> batch-of-one views

def _batch(x):
    return stages.map_tensors(lambda t: t[None], x)


def _unbatch(x):
    """Strip the batch axis of one from a tensor, dict, NamedTuple or
    dataclass of tensors (the day's products)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _unbatch(getattr(x, f.name))
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    if isinstance(x, dict):
        return {k: _unbatch(v) for k, v in x.items()}
    return stages.map_tensors(lambda t: t[0], x)


def _pd_truth(pdt: power.PDTruth) -> power.PDTruth:
    return power.PDTruth(idle_kw=pdt.idle_kw[None],
                         slope_kw=pdt.slope_kw[None], curve=pdt.curve[None])


def sim_params(state: FleetState) -> stages.SimParams:
    """View a FleetState as the engine's SimParams with a batch axis of one
    (neutral one-day schedules: the legacy path runs nominal operation)."""
    cfg = state.cfg
    dev = state.capacity.device

    def scalar(v):
        return torch.full((1,), v, dtype=f32, device=dev)

    def ones(k):
        return torch.ones((1, 1, k), dtype=f32, device=dev)

    pdt = _pd_truth(state.pd_truth)
    return stages.SimParams(
        key=state.key[None], truth=_batch(state.truth),
        pd_idle=pdt.idle_kw, pd_slope=pdt.slope_kw, pd_curve=pdt.curve,
        lam=state.lam[None], zone=_batch(state.zone),
        lambda_e=scalar(cfg.lambda_e), lambda_p=scalar(cfg.lambda_p),
        gamma=scalar(cfg.gamma), mobility=scalar(0.0),
        risk_beta=scalar(1.0),
        green_scale=ones(cfg.n_zones), coal_scale=ones(cfg.n_zones),
        cap_scale=ones(cfg.n_clusters), arrival_scale=ones(cfg.n_clusters),
        campus_scale=ones(cfg.n_campuses))


def sim_state(state: FleetState) -> stages.SimState:
    """View a FleetState as the engine's SimState with a batch axis of
    one."""
    dev = state.capacity.device
    return stages.SimState(
        day=torch.tensor([state.day], dtype=torch.int64, device=dev),
        campus=state.campus[None], zmap=state.zmap[None],
        campus_limit=state.campus_limit[None],
        u_pow_cap=state.u_pow_cap[None],
        hist_uif=state.hist_uif[None],
        hist_flex_daily=state.hist_flex_daily[None],
        hist_res_daily=state.hist_res_daily[None],
        hist_usage=state.hist_usage[None], hist_res=state.hist_res[None],
        hist_tr_pred=state.hist_tr_pred[None],
        hist_uif_pred=state.hist_uif_pred[None],
        carbon_hist=state.carbon_hist[None],
        queue=state.queue[None], cf_queue=state.cf_queue[None],
        crowded_streak=state.slo_state["crowded_streak"][None],
        pause_left=state.slo_state["pause_left"][None],
        violation_days=state.slo_state["violation_days"][None],
        observed_days=state.slo_state["observed_days"][None],
        shaping_allowed=state.shaping_allowed[None],
        pred=None if state.pred is None else _batch(state.pred))


def _writeback(state: FleetState, s: stages.SimState) -> FleetState:
    """Write a batch-of-one SimState back into the FleetState."""
    s = _unbatch(s)
    state.day = int(s.day)
    state.campus_limit = s.campus_limit
    state.hist_uif = s.hist_uif
    state.hist_flex_daily = s.hist_flex_daily
    state.hist_res_daily = s.hist_res_daily
    state.hist_usage = s.hist_usage
    state.hist_res = s.hist_res
    state.hist_tr_pred = s.hist_tr_pred
    state.hist_uif_pred = s.hist_uif_pred
    state.carbon_hist = s.carbon_hist
    state.queue = s.queue
    state.cf_queue = s.cf_queue
    state.slo_state = {"crowded_streak": s.crowded_streak,
                       "pause_left": s.pause_left,
                       "violation_days": s.violation_days,
                       "observed_days": s.observed_days}
    state.shaping_allowed = s.shaping_allowed
    state.pred = s.pred
    return state


# --------------------------------------------------------------- synthesis

def init_fleet(cfg: FleetConfig, device=None) -> FleetState:
    """Synthesize and burn in a fleet on ``device`` (default ``"cuda"``):
    ``cfg.hist_days`` unshaped days through ``stages.make_init``."""
    dev = _device.resolve(device)
    n, m, z, H = cfg.n_clusters, cfg.n_campuses, cfg.n_zones, cfg.hist_days
    sp = stages.synth_params(cfg.seed, n, cfg.pds_per_cluster, z, device=dev)
    pdt = power.PDTruth(idle_kw=sp["pd_idle"], slope_kw=sp["pd_slope"],
                        curve=sp["pd_curve"])
    zone_of_campus = np.arange(m) % z

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cap = sp["truth"]["capacity"]
    state = FleetState(
        cfg=cfg, day=0, key=sp["key"], capacity=cap,
        campus=torch.as_tensor(np.arange(n) % m, dtype=torch.int64,
                               device=dev),
        zmap=torch.as_tensor(zone_of_campus[np.arange(n) % m],
                             dtype=torch.int64, device=dev),
        zone_of_campus=zone_of_campus, campus_limit=zeros(m),
        u_pow_cap=cap * 0.95, truth=sp["truth"], pd_truth=pdt,
        lam=sp["lam"], zone=sp["zone"],
        hist_uif=zeros(n, H, 24), hist_flex_daily=zeros(n, H),
        hist_res_daily=zeros(n, H), hist_usage=zeros(n, H, 24),
        hist_res=zeros(n, H, 24), hist_tr_pred=zeros(n, H),
        hist_uif_pred=zeros(n, H, 24), carbon_hist=zeros(z, H, 24),
        queue=zeros(n), cf_queue=zeros(n),
        slo_state={k: zeros(n, dtype=torch.int64) for k in (
            "crowded_streak", "pause_left", "violation_days",
            "observed_days")},
        shaping_allowed=torch.ones((n,), dtype=torch.bool, device=dev),
        zones=carbon.default_zones(z))
    init = stages.make_init(n, m, z, H, device=dev, streaming=cfg.streaming)
    return _writeback(state, init(sim_params(state)))


# ---------------------------------------------------- per-stage adapters

def _day_key(state: FleetState, day) -> torch.Tensor:
    return prng.fold_in(state.key, day)


def power_model_from_history(hist_usage, lam, capacity, pd_truth, key):
    """``stages.power_stage`` on one fleet: returns cluster power and slope
    closures over (n, t) usage and the fitted (coef, breaks)."""
    model = stages.power_stage(hist_usage[None], lam[None], capacity[None],
                               _pd_truth(pd_truth), key[None])

    def cluster_power_fn(u_cluster):
        return stages.model_power(model, u_cluster[None])[0]

    def cluster_slope_fn(u_cluster):
        return stages.model_slope(model, u_cluster[None])[0]

    return cluster_power_fn, cluster_slope_fn, (model.coef[0],
                                                model.breaks[0])


def make_power_fn(state: FleetState):
    """Cluster power from PD piecewise models fit on recent history (the
    streaming usage ring holds the same 28-day window: the same fit)."""
    hist = state.pred.usage_ring if state.cfg.streaming else state.hist_usage
    return power_model_from_history(
        hist, state.lam, state.truth["capacity"], state.pd_truth,
        prng.fold_in(_day_key(state, state.day), 1))


def day_forecasts_arrays(hist_uif, hist_flex_daily, hist_res_daily,
                         hist_usage, hist_res, hist_tr_pred, hist_uif_pred,
                         day, gamma):
    """``stages.forecast_stage`` on one fleet's windows (n, H[, 24]).
    ``day`` keeps the reference's signature; the rescan forecast reads
    none."""
    dev = hist_uif.device
    fc = stages.forecast_stage(
        *_batch((hist_uif, hist_flex_daily, hist_res_daily, hist_usage,
                 hist_res, hist_tr_pred, hist_uif_pred)),
        torch.full((1,), gamma, dtype=f32, device=dev))
    return _unbatch(fc)


def day_forecasts(state: FleetState):
    """The next day's forecast dict (the O(1) streaming forecast when the
    fleet is configured for it)."""
    if state.cfg.streaming:
        dev = state.capacity.device
        return _unbatch(stages.forecast_stage_streaming(
            _batch(state.pred),
            torch.tensor([state.day], dtype=torch.int64, device=dev),
            torch.full((1,), state.cfg.gamma, dtype=f32, device=dev)))
    return day_forecasts_arrays(
        state.hist_uif, state.hist_flex_daily, state.hist_res_daily,
        state.hist_usage, state.hist_res, state.hist_tr_pred,
        state.hist_uif_pred, state.day, state.cfg.gamma)


def _carbon_actual_forecast(state: FleetState, day):
    """The day's (actual, forecast) zone intensity (zones, 24)."""
    ones = torch.ones((1, state.carbon_hist.shape[0]), dtype=f32,
                      device=state.carbon_hist.device)
    act_z, fc_z = stages.carbon_stage(
        _batch(state.zone), state.carbon_hist[None],
        prng.fold_in(_day_key(state, day), 4)[None], ones, ones)
    return act_z[0], fc_z[0]


def carbon_forecast_next(state: FleetState, day):
    """Actual and day-ahead forecast intensity of the day: per zone, then
    per cluster."""
    act_z, fc_z = _carbon_actual_forecast(state, day)
    return act_z, fc_z, act_z[state.zmap], fc_z[state.zmap]


def build_problem(state: FleetState, fc, eta_fc, power_fn, slope_fn
                  ) -> vcc.VCCProblem:
    """The fleetwide VCC problem of one fleet (unbatched)."""
    dev = state.capacity.device
    return stages.build_problem_arrays(
        fc, eta_fc, power_fn, slope_fn, state.queue, state.u_pow_cap,
        state.capacity, state.campus, state.campus_limit,
        torch.tensor(state.cfg.lambda_e, dtype=f32, device=dev),
        torch.tensor(state.cfg.lambda_p, dtype=f32, device=dev))


def _roll(hist, new):
    return stages.roll(hist[None], new[None])[0]


def _observe_day(state: FleetState, day, shaped: bool,
                 vcc_curve=None, treat_mask=None, collect=False):
    """Run one actual day (optionally under a VCC) and roll the histories.

    Adapter over ``stages.observe_stage`` for custom day loops (a randomized
    treatment over ``treat_mask``); ``day_cycle`` runs the full step
    instead. Rescan fleets only: these loops roll the ``hist_*`` windows,
    which a streaming fleet no longer carries."""
    cfg = state.cfg
    if cfg.streaming:
        raise NotImplementedError(
            "_observe_day drives the rescan history windows; run custom "
            "day loops on a FleetConfig(streaming=False) fleet (day_cycle "
            "itself supports streaming)")
    n = cfg.n_clusters
    dev = state.capacity.device
    day_key = _day_key(state, day)
    power_fn, _, _ = power_model_from_history(
        state.hist_usage, state.lam, state.truth["capacity"],
        state.pd_truth, prng.fold_in(day_key, 1))
    unshaped = (state.capacity[:, None] * 10.0).expand(n, 24)
    if vcc_curve is None:
        vcc_curve = unshaped
    if treat_mask is not None:
        vcc_curve = torch.where(treat_mask[:, None], vcc_curve, unshaped)
    # actual carbon for the day (the draw of carbon_forecast_next)
    act_z, _ = _carbon_actual_forecast(state, day)
    intensity = act_z[state.zmap]
    res, cf, u_if, _ = stages.observe_stage(
        _batch(state.truth),
        torch.tensor([int(day)], dtype=torch.int64, device=dev),
        day_key[None], vcc_curve[None], state.capacity[None],
        torch.ones((1, n), dtype=f32, device=dev), state.queue[None],
        state.cf_queue[None], lambda u: power_fn(u[0])[None],
        intensity[None])
    res, cf, u_if = _unbatch(res), _unbatch(cf), u_if[0]
    state.hist_uif = _roll(state.hist_uif, u_if)
    state.hist_flex_daily = _roll(state.hist_flex_daily, res.served)
    state.hist_res_daily = _roll(state.hist_res_daily,
                                 stages.hour_sum(res.reservations))
    state.hist_usage = _roll(state.hist_usage, res.usage_total)
    state.hist_res = _roll(state.hist_res, res.reservations)
    state.carbon_hist = _roll(state.carbon_hist, act_z)
    state.queue = res.queue_end
    state.cf_queue = cf.queue_end
    state.day = int(day) + 1
    if collect:
        return state, res, intensity
    return state


def day_cycle(state: FleetState, record: Optional[dict] = None
              ) -> FleetState:
    """One full CICS day: forecast -> optimize -> shape -> observe.

    Runs the engine's day step (one a StageConfig, cached) on the fleet as
    a batch of one with neutral scenario slices, then writes back into the
    mutable FleetState. ``record`` (if given) receives the day's products,
    unbatched: fc, sol, vcc, result, cf_result, intensity, problem, and
    telemetry (the ``DayTelemetry``, None without ``cfg.telemetry``)."""
    cfg = state.cfg
    step = _day_step(_stage_cfg(cfg))
    xs = stages.ones_xs(1, cfg.n_clusters, cfg.n_campuses, cfg.n_zones,
                        device=state.capacity.device)
    new_state, out = step(sim_params(state), sim_state(state), xs)
    state = _writeback(state, new_state)
    if record is not None:
        record.update(_unbatch(dict(
            fc=out.fc, sol=out.sol, vcc=out.vcc_curve, result=out.res,
            cf_result=out.cf, intensity=out.eta_act, problem=out.prob,
            telemetry=out.telemetry)))
    return state
