"""The staged CICS day cycle, paper mode (port of ``repro.core.stages``).

Every simulated day is the same pipeline (paper Fig. 4/5):

  carbon_stage    — scenario-perturbed grid simulation + day-ahead
                    intensity forecast per zone
  power_stage     — refit PD piecewise-linear power models on history
  forecast_stage  — day-ahead U_IF(h), T_UF(d), T_R(d), R(h), trailing
                    error quantiles -> Theta, alpha (eq. 3); with
                    ``streaming`` from the O(1) ``stats.PredictorState``
                    carry instead of the history windows
  optimize_stage  — greedy spatial pre-shift, then the fleetwide VCC solve
                    (eq. 4) through the fused PGD kernel; or the joint
                    spatio-temporal solve (``joint_spatial``); with
                    ``n_members > 1`` the solve at the placed budgets is a
                    CVaR over K forecast members (``core.risk``) at
                    ``SimParams.risk_beta``
  (SLO gate)      — paused clusters get VCC = machine capacity
  observe_stage   — Borg-like admission on ACTUAL load, shaped + unshaped
                    counterfactual; with ``mpc`` the hourly recourse loop
                    (``core.mpc``) re-plans the remaining hours as they
                    realize
  slo_stage       — violation detection + shaping-pause feedback
  (telemetry)     — with ``telemetry``, the day's ``sim.telemetry``
                    ``DayTelemetry`` record in ``StepOut.telemetry``

The port runs every ``StageConfig`` of the reference: rescan or streaming
forecasting, the open or the closed (MPC) loop, with or without the joint
spatial solve, (rescan only) forecast ensembles, and telemetry on any of
them.

Batching: every leaf of ``SimParams`` and ``SimState`` carries a leading
(scenario x seed) batch axis B, in place of the reference's ``vmap``; the
rolling history windows are (B, n, H[, 24]) and ``roll`` shifts axis 2.
Per-rollout scalars (day, prices, gamma, mobility) have shape (B,), so the
rollouts of a batch may sit on different days.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import device as _device
from repro_torch import spans
from repro_torch.core import (admission, carbon, forecast, mpc, power,
                              prng, risk, slo, solver, spatial, stats, vcc)

if TYPE_CHECKING:
    from repro_torch.sim.telemetry import DayTelemetry

f32 = torch.float32
hour_sum = admission.hour_sum


def map_tensors(fn, tree):
    """Apply ``fn`` to every tensor of a NamedTuple / dict / list tree."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def zip_tensors(fn, trees):
    """Apply ``fn`` to each list of corresponding tensors of equally
    structured trees (stacking rollouts into a batch, and back)."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(list(trees))
    if isinstance(first, dict):
        return {k: zip_tensors(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(zip_tensors(fn, list(v)) for v in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(zip_tensors(fn, list(v)) for v in zip(*trees))
    return first


def _col(x, k: int = 1):
    """Append ``k`` unit axes: per-rollout (B,) -> (B, 1[, 1])."""
    return x.reshape(x.shape + (1,) * k)


def take(x, idx):
    """Batched ``x[idx]`` along axis 1: x (B, z, ...), idx (B, n) ->
    (B, n, ...)."""
    view = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, view.expand(idx.shape + x.shape[2:]))


# ------------------------------------------------------------- fleet synth

def cluster_truth(key, n: int):
    """Latent per-cluster load-generating processes. key (..., 2)."""
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


def _weekly_cos(day):
    return torch.cos(2 * torch.pi * (day % 7).to(f32) / 7.0)


def sample_inflexible(key, truth, day):
    """Actual inflexible hourly usage for one day: (B, n, 24).
    key (B, 2); truth leaves (B, n); day (B,)."""
    hours = torch.arange(24, dtype=f32, device=key.device)
    gap = torch.abs(hours - truth["peak_hour"][..., None])
    d = torch.minimum(gap, 24 - gap)
    diurnal = 1.0 + truth["diurnal_amp"][..., None] * torch.exp(
        -0.5 * (d / 4.0) ** 2)
    weekly = 1.0 + truth["weekly_amp"][..., None] * _col(_weekly_cos(day), 2)
    eps = 1.0 + truth["noise"][..., None] * prng.normal(
        key, (truth["base_if"].shape[-1], 24))
    return truth["base_if"][..., None] * diurnal * weekly * eps


def sample_arrivals(key, truth, day):
    """Flexible CPU-hour arrivals per hour: (B, n, 24)."""
    hours = torch.arange(24, dtype=f32, device=key.device)
    prof = 0.6 + 0.8 * torch.exp(-0.5 * ((hours - 11.0) / 5.0) ** 2)
    weekly = 1.0 + 0.5 * truth["weekly_amp"][..., None] \
        * _col(_weekly_cos(day), 2)
    eps = 1.0 + 2.5 * truth["noise"][..., None] * prng.normal(
        key, (truth["arr_level"].shape[-1], 24))
    return torch.clamp(truth["arr_level"][..., None] * prof * weekly * eps
                       / 24.0 * 24.0 / prof.sum() * 24.0, min=0.0)


def true_ratio(truth, usage):
    return torch.clamp(truth["ratio_a"][..., None]
                       + truth["ratio_b"][..., None]
                       * torch.log(torch.clamp(usage, min=1e-6)), 1.05, 3.0)


def synth_params(seed: int, n_clusters: int, pds_per_cluster: int,
                 n_zones: int, device=None) -> Dict[str, object]:
    """The array-only fleet parameters of one rollout (latent truth, PD
    power-curve truth, PD usage fractions, zone params, rollout key), from
    the same random stream as the reference."""
    key = prng.PRNGKey(seed, device)
    ks = prng.split(key, 8)
    n, npds = n_clusters, pds_per_cluster
    npd = n * npds
    return {
        "key": prng.fold_in(key, 17),
        "truth": cluster_truth(ks[0], n),
        "pd_idle": 60.0 + 40.0 * prng.uniform(ks[1], (npd,)),
        "pd_slope": 250.0 + 150.0 * prng.uniform(ks[2], (npd,)),
        "pd_curve": 0.8 + 0.5 * prng.uniform(ks[3], (npd,)),
        "lam": torch.softmax(prng.normal(ks[4], (n, npds)), dim=1),
        "zone": carbon.stack_zone_params(carbon.default_zones(n_zones),
                                         device),
    }


# ------------------------------------------------------------ state tuples

class SimParams(NamedTuple):
    """Per-rollout day-cycle parameters, batch axis B first."""
    key: torch.Tensor                 # (B, 2) int64 threefry key words
    truth: Dict[str, torch.Tensor]    # latent cluster processes, (B, n)
    pd_idle: torch.Tensor             # (B, n*pds)
    pd_slope: torch.Tensor            # (B, n*pds)
    pd_curve: torch.Tensor            # (B, n*pds)
    lam: torch.Tensor                 # (B, n, pds) PD usage fractions
    zone: Dict[str, torch.Tensor]     # grid-mix params, (B, z)
    lambda_e: torch.Tensor            # (B,) carbon price
    lambda_p: torch.Tensor            # (B,) peak-power price
    gamma: torch.Tensor               # (B,) power-capping violation prob
    mobility: torch.Tensor            # (B,) spatial-shift mobility
    risk_beta: torch.Tensor           # (B,) CVaR tail fraction (acts at K > 1)
    green_scale: torch.Tensor         # (B, days, z) solar+wind multiplier
    coal_scale: torch.Tensor          # (B, days, z) coal-share multiplier
    cap_scale: torch.Tensor           # (B, days, n) capacity multiplier
    arrival_scale: torch.Tensor       # (B, days, n) flexible-demand mult.
    campus_scale: torch.Tensor        # (B, days, m) campus limit scale
    # intraday forecast-busting channels (the scenarios' Intraday*
    # perturbations): hourly multipliers on the ACTUALS, applied after the
    # day-ahead forecasts are drawn; None = no channel
    arrival_hour_scale: Optional[torch.Tensor] = None   # (B, days, 24)
    carbon_hour_scale: Optional[torch.Tensor] = None    # (B, days, 24)


class SimState(NamedTuple):
    """Day-cycle state (the rollout carry), batch axis B first.

    Rescan mode carries the seven rolling history windows (H days, oldest
    first) and ``pred=None``. Streaming mode carries the
    ``stats.PredictorState`` in ``pred``; the ``hist_*`` leaves are then
    zero-length stubs (B, n, 0[, 24]), never read, and ``carbon_hist``
    keeps the trailing 7 days that the carbon forecast reads."""
    day: torch.Tensor                 # (B,) int64
    campus: torch.Tensor              # (B, n) int64
    zmap: torch.Tensor                # (B, n) int64 zone of cluster
    campus_limit: torch.Tensor        # (B, m) kW
    u_pow_cap: torch.Tensor           # (B, n)
    hist_uif: torch.Tensor            # (B, n, H, 24)
    hist_flex_daily: torch.Tensor     # (B, n, H)
    hist_res_daily: torch.Tensor      # (B, n, H)
    hist_usage: torch.Tensor          # (B, n, H, 24)
    hist_res: torch.Tensor            # (B, n, H, 24)
    hist_tr_pred: torch.Tensor        # (B, n, H)
    hist_uif_pred: torch.Tensor       # (B, n, H, 24)
    carbon_hist: torch.Tensor         # (B, z, H, 24)
    queue: torch.Tensor               # (B, n) shaped-run backlog
    cf_queue: torch.Tensor            # (B, n) counterfactual backlog
    crowded_streak: torch.Tensor      # (B, n) int64
    pause_left: torch.Tensor          # (B, n) int64
    violation_days: torch.Tensor      # (B, n) int64
    observed_days: torch.Tensor       # (B, n) int64
    shaping_allowed: torch.Tensor     # (B, n) bool
    pred: Optional[stats.PredictorState] = None   # streaming carry


class StepOut(NamedTuple):
    """Everything one day produces beyond the carried state."""
    res: admission.DayResult          # shaped admission result
    cf: admission.DayResult           # unshaped counterfactual result
    sol: vcc.VCCSolution
    vcc_curve: torch.Tensor           # (B, n, 24) post-SLO-gate VCC (with
    #                                   ``mpc`` the hour-by-hour ENFORCED
    #                                   curve, not the 00:00 plan)
    fc: Dict[str, torch.Tensor]       # forecast dict
    prob: vcc.VCCProblem              # problem actually optimized
    eta_act: torch.Tensor             # (B, n, 24) actual intensity
    best: Optional[spatial.BestOf] = None  # joint solve's call (joint only)
    recourse: Optional[mpc.MPCDiag] = None  # recourse diagnostics (mpc only)
    telemetry: Optional[DayTelemetry] = None  # the day's record
    #                                   (``sim.telemetry``; telemetry only)


@dataclass(frozen=True)
class StageConfig:
    """Knobs of the staged day cycle. ``streaming``: the O(1)
    ``stats.PredictorState`` carry instead of the history rescans (not with
    ``n_members > 1``); ``mpc``: the hourly recourse loop of ``core.mpc``;
    ``telemetry``: the day's ``sim.telemetry.DayTelemetry`` record in
    ``StepOut.telemetry`` (the state and the other outputs unchanged)."""
    slo_margin: float = 1.0
    slo_pause_days: int = 7
    joint_spatial: bool = False
    n_members: int = 1
    streaming: bool = False
    telemetry: bool = False
    mpc: bool = False
    slo_allowance: float = 0.25


def pd_truth(params: SimParams) -> power.PDTruth:
    return power.PDTruth(idle_kw=params.pd_idle, slope_kw=params.pd_slope,
                         curve=params.pd_curve)


def roll(hist, new):
    """Drop the oldest day, append ``new``: hist (B, n, H[, 24]), new
    (B, n[, 24])."""
    return torch.cat([hist[:, :, 1:], new[:, :, None]], dim=2)


# ----------------------------------------------------------------- stages

def carbon_stage(zone, carbon_hist, key, green_scale, coal_scale):
    """One day of actual zone intensity and its day-ahead forecast.
    zone leaves (B, z); carbon_hist (B, z, H, 24); key (B, 2); scales
    (B, z). Returns (act_z, fc_z), each (B, z, 24)."""
    z = carbon_hist.shape[1]
    zp = dict(zone)
    zp["solar_cap"] = zp["solar_cap"] * green_scale
    zp["wind_cap"] = zp["wind_cap"] * green_scale
    zp["coal_share"] = zp["coal_share"] * coal_scale
    keys = prng.split(key, 2 * z)
    act_z = carbon.simulate_zone_from(keys[:, :z], zp, 1)[..., 0, :]
    fc_z = carbon.forecast_day_ahead(keys[:, z:], carbon_hist, act_z,
                                     zp["weather_vol"] * 0.15)
    return act_z, fc_z


class PowerModel(NamedTuple):
    """Fitted cluster power model (the power_stage output)."""
    coef: torch.Tensor      # (B, n*pds, K+2) piecewise-linear coefficients
    breaks: torch.Tensor    # (B, n*pds, K) hinge locations
    lam: torch.Tensor       # (B, n, pds) PD usage fractions
    cap_pd: torch.Tensor    # (B, n*pds) cluster capacity per PD row


def power_stage(hist_usage, lam, capacity, pdt: power.PDTruth, key
                ) -> PowerModel:
    """Fit PD piecewise power models on the last 28 days of cluster usage.
    hist_usage (B, n, H, 24); lam (B, n, pds); capacity (B, n)."""
    B, n, npd = lam.shape
    u_cl = hist_usage[:, :, -28:].reshape(B, n, -1)
    u_pd = (lam[..., None] * u_cl[:, :, None, :]).reshape(B, n * npd, -1)
    cap_pd = capacity[..., None].expand(B, n, npd).reshape(B, n * npd)
    u_norm = u_pd / torch.clamp(cap_pd[..., None], min=1e-6)
    p_pd = power.simulate_pd_power(key, pdt, u_norm)
    coef, breaks = power.fit_pd_model(u_norm, p_pd)
    return PowerModel(coef=coef, breaks=breaks, lam=lam, cap_pd=cap_pd)


def _pd_usage(m: PowerModel, u_cluster):
    """Normalized PD usage for cluster usage (B, n, t) -> (B, n*pds, t)."""
    B, n, npd = m.lam.shape
    u_pd = (m.lam[..., None] * u_cluster[:, :, None, :]).reshape(
        B, n * npd, -1)
    return u_pd / torch.clamp(m.cap_pd[..., None], min=1e-6)


def model_power(m: PowerModel, u_cluster):
    """Cluster power at cluster CPU usage: (B, n, t) -> (B, n, t) kW."""
    B, n, npd = m.lam.shape
    p = power.pd_power(m.coef, m.breaks, _pd_usage(m, u_cluster))
    return p.reshape(B, n, npd, -1).sum(2)


def model_slope(m: PowerModel, u_cluster):
    """Local cluster slope d kW / d cluster-CPU: (B, n, t) -> (B, n, t)."""
    B, n, npd = m.lam.shape
    s = power.pd_slope(m.coef, m.breaks, _pd_usage(m, u_cluster))
    s = s / torch.clamp(m.cap_pd[..., None], min=1e-6)
    return (s.reshape(B, n, npd, -1) * m.lam[..., None]).sum(2)


def forecast_stage(hist_uif, hist_flex_daily, hist_res_daily, hist_usage,
                   hist_res, hist_tr_pred, hist_uif_pred, gamma):
    """Next-day forecasting pipeline from the rolling history windows
    (B, n, H[, 24]); gamma (B,). Returns the forecast dict."""
    B, n = hist_uif.shape[:2]
    uif_pred = forecast.forecast_inflexible(hist_uif)
    tuf_pred = forecast.forecast_daily_total(hist_flex_daily)
    tr_pred = forecast.forecast_daily_total(hist_res_daily)
    ra, rb = forecast.fit_ratio_model(
        hist_usage[:, :, -28:].reshape(B, n, -1),
        hist_res[:, :, -28:].reshape(B, n, -1))
    eps97 = forecast.relative_error_quantile(
        hist_tr_pred[..., -90:], hist_res_daily[..., -90:], 0.97)
    theta = forecast.theta_requirement(tr_pred, eps97)
    alpha = forecast.alpha_inflation(theta, uif_pred, tuf_pred, ra, rb)
    # (1-gamma) hourly inflexible quantile from trailing prediction errors
    epsq = forecast.relative_error_quantile(
        hist_uif_pred[:, :, -28:].reshape(B, n, -1),
        hist_uif[:, :, -28:].reshape(B, n, -1), _col(1 - gamma))
    uif_q = uif_pred * (1.0 + torch.clamp(epsq, 0.0, 1.0)[..., None])
    return {"uif": uif_pred, "tuf": tuf_pred, "tr": tr_pred,
            "ratio_a": ra, "ratio_b": rb, "theta": theta, "alpha": alpha,
            "uif_q": uif_q}


def forecast_stage_streaming(pred: stats.PredictorState, day, gamma):
    """O(1) counterpart of ``forecast_stage``: the same forecast dict from
    the ``stats.PredictorState`` carry. day/gamma (B,)."""
    return stats.streaming_forecast(pred, day, gamma)


def build_problem_arrays(fc, eta_fc, power_fn, slope_fn, queue, u_pow_cap,
                         capacity, campus, campus_limit, lambda_e, lambda_p
                         ) -> vcc.VCCProblem:
    """Assemble the fleetwide VCC problem (risk-aware budget, eq. 3)."""
    with spans.span("problem"):
        tau = fc["alpha"] * fc["tuf"] + queue
        u_nom = fc["uif"] + tau[..., None] / 24.0
        ratio = forecast.ratio_at(fc["ratio_a"][..., None],
                                  fc["ratio_b"][..., None], u_nom)
        return vcc.VCCProblem(
            eta=eta_fc, u_if=fc["uif"], u_if_q=fc["uif_q"], tau=tau,
            pow_nom=power_fn(u_nom), pi=slope_fn(u_nom),
            u_pow_cap=u_pow_cap, capacity=capacity, ratio=ratio,
            campus=campus, campus_limit=campus_limit, lambda_e=lambda_e,
            lambda_p=lambda_p)


def optimize_stage(fc, eta_fc, model: PowerModel, queue, u_pow_cap,
                   cap_day, campus, campus_limit, lambda_e, lambda_p,
                   mobility, *, cfg: StageConfig = StageConfig(), ens=None):
    """Fleetwide VCC optimization. Returns (prob, sol, best): ``best``
    is the joint solve's best-of call per rollout (``spatial.BestOf``),
    None without ``cfg.joint_spatial``. With ``cfg.telemetry`` a fourth
    item: the solver diagnostics of the solve that made ``sol``
    (``vcc.solve_vcc(telemetry=True)``'s channels) and ``joint_winner``
    (B,), the joint solve's call, 0.0 on the sequential path.

    * ``cfg.joint_spatial`` False: greedy spatial pre-shift (mobility 0
      leaves tau exactly), then the temporal solve;
    * True: ``spatial.solve_joint`` places the budgets and shapes them
      together, never worse than the greedy answer per rollout.

    ``ens`` (the ``risk.day_ensembles`` dict, present iff cfg.n_members >
    1) attaches the K members after the budgets are placed; the temporal
    solve then descends the soft-CVaR member tilt. Under joint_spatial the
    joint solve places the budgets on the point forecast, and the CVaR
    solve shapes them."""
    prob = build_problem_arrays(
        fc, eta_fc, lambda u: model_power(model, u),
        lambda u: model_slope(model, u), queue, u_pow_cap, cap_day, campus,
        campus_limit, lambda_e, lambda_p)
    dev = prob.eta.device
    tel = cfg.telemetry
    if cfg.joint_spatial:
        sol, tau_j, _, best, *diag = spatial.solve_joint(
            prob, mobility, device=dev, telemetry=tel)
        prob = dataclasses.replace(prob, tau=tau_j)
        if ens is not None:
            prob = risk.attach_ensemble(prob, **ens)
            sol = vcc.solve_vcc(prob, device=dev, telemetry=tel)
            if tel:
                # the CVaR solve at the shifted budgets makes the final
                # delta: report its convergence, keep the joint call
                sol, cvar = sol
                diag = [{**cvar, "joint_winner": diag[0]["joint_winner"]}]
        return (prob, sol, best, *diag)
    tau_shifted, _ = spatial.spatial_shift(prob, mobility=mobility)
    prob = dataclasses.replace(prob, tau=tau_shifted)
    if ens is not None:
        prob = risk.attach_ensemble(prob, **ens)
    if not tel:
        return prob, vcc.solve_vcc(prob, device=dev), None
    sol, diag = vcc.solve_vcc(prob, device=dev, telemetry=True)
    # the sequential path runs no joint refinement: the call reads 0.0
    diag["joint_winner"] = torch.zeros_like(prob.lambda_e)
    return prob, sol, None, diag


def sample_day_truth(truth, day, day_key, cap_day, arr_scale,
                     arr_hour_scale=None):
    """Sample the day's actual load: (u_if, arrivals, ratio_true), each
    (B, n, 24). ``arr_hour_scale`` (B, 24), if given: the intraday
    forecast-busting multiplier on the arrivals, applied to the actuals
    after the forecasts were issued."""
    u_if = sample_inflexible(prng.fold_in(day_key, 2), truth, day)
    u_if = torch.minimum(u_if, 0.98 * cap_day[..., None])   # outage derates
    arrivals = sample_arrivals(prng.fold_in(day_key, 3), truth, day)
    arrivals = arrivals * arr_scale[..., None]
    if arr_hour_scale is not None:
        arrivals = arrivals * arr_hour_scale[:, None, :]
    return u_if, arrivals, true_ratio(truth, u_if + arrivals)


def observe_stage(truth, day, day_key, vcc_curve, cap_day, arr_scale,
                  queue, cf_queue, power_fn, intensity,
                  allowance_frac: float = 0.25, arr_hour_scale=None):
    """Sample the day's true load and run shaped + counterfactual
    admission. Returns (shaped DayResult, counterfactual DayResult, u_if,
    arrivals)."""
    u_if, arrivals, ratio_true = sample_day_truth(
        truth, day, day_key, cap_day, arr_scale, arr_hour_scale)
    res = admission.run_day(vcc_curve, u_if, arrivals, ratio_true, cap_day,
                            queue, power_fn, intensity, allowance_frac)
    unshaped = (cap_day[..., None] * 10.0).expand_as(vcc_curve)
    cf = admission.run_day(unshaped, u_if, arrivals, ratio_true, cap_day,
                           cf_queue, power_fn, intensity, allowance_frac)
    return res, cf, u_if, arrivals


def observe_stage_mpc(truth, day, day_key, prob, sol, fc, gate, cap_day,
                      arr_scale, queue, cf_queue, power_fn, intensity,
                      allowance_frac: float = 0.25, arr_hour_scale=None):
    """Closed-loop counterpart of ``observe_stage``: the same sampled truth
    and unshaped counterfactual, but the shaped run is the hourly recourse
    loop (``mpc.mpc_day``) instead of admission under the 00:00 curve.
    Returns (res, cf, u_if, arrivals, enforced curve (B, n, 24),
    stats.HourAccum, mpc.MPCDiag)."""
    u_if, arrivals, ratio_true = sample_day_truth(
        truth, day, day_key, cap_day, arr_scale, arr_hour_scale)
    res, enforced, acc, diag = mpc.mpc_day(
        prob, sol, fc["tuf"], gate, cap_day, u_if, arrivals, ratio_true,
        queue, power_fn, intensity, allowance_frac=allowance_frac)
    unshaped = (cap_day[..., None] * 10.0).expand_as(enforced)
    cf = admission.run_day(unshaped, u_if, arrivals, ratio_true, cap_day,
                           cf_queue, power_fn, intensity, allowance_frac)
    return res, cf, u_if, arrivals, enforced, acc, diag


def slo_stage(slo_state, slo_cfg: slo.SLOConfig, daily_reservations,
              vcc_budget, unmet, arrived):
    """End-of-day SLO feedback: (new slo_state, shaping_allowed)."""
    return slo.update(slo_state, slo_cfg, daily_reservations, vcc_budget,
                      unmet, arrived)


# ------------------------------------------------------------- composition

def make_day_step(cfg: StageConfig):
    """One CICS day: forecast -> optimize -> shape -> observe -> SLO.

    Returns step(params, state, xs) -> (state', StepOut) where xs holds this
    day's scenario-schedule slices (B, z) / (B, n) / (B, m), and (B, 24)
    for the intraday channels when the scenarios carry them.

    Spans (``repro_torch.spans``), one a stage call: ``power``,
    ``forecast``, ``carbon``, ``ensembles`` (K > 1), ``optimize``,
    ``observe`` (around ``observe_mpc`` in the closed loop), ``slo``,
    ``carry`` (the history rolls or the predictor update, and the new
    state), ``record`` (telemetry only). The key folds, the intensity
    gathers and the SLO gate between them belong to no stage."""
    if cfg.n_members < 1:
        raise ValueError(f"n_members must be >= 1, got {cfg.n_members}")
    if cfg.streaming and cfg.n_members > 1:
        raise ValueError(
            "StageConfig.streaming=True does not support forecast "
            "ensembles (n_members > 1): risk.day_ensembles bootstraps "
            "whole days of the hist_uif_pred/hist_uif error history, "
            "which the streaming state no longer carries")
    slo_cfg = slo.SLOConfig(margin=cfg.slo_margin,
                            pause_days=cfg.slo_pause_days)

    def step(params: SimParams, state: SimState, xs: Dict[str, torch.Tensor]
             ) -> Tuple[SimState, StepOut]:
        truth = params.truth
        day_key = prng.fold_in(params.key, state.day)
        cap_day = truth["capacity"] * xs["cap_scale"]
        # power fit and load forecast; streaming: over the carry (its usage
        # ring IS the 28-day window the rescan fit slices)
        usage = state.pred.usage_ring if cfg.streaming else state.hist_usage
        with spans.span("power"):
            model = power_stage(usage, params.lam, truth["capacity"],
                                pd_truth(params), prng.fold_in(day_key, 1))
        with spans.span("forecast"):
            if cfg.streaming:
                fc = forecast_stage_streaming(state.pred, state.day,
                                              params.gamma)
            else:
                fc = forecast_stage(
                    state.hist_uif, state.hist_flex_daily,
                    state.hist_res_daily, state.hist_usage, state.hist_res,
                    state.hist_tr_pred, state.hist_uif_pred, params.gamma)
        with spans.span("carbon"):
            act_z, fc_z = carbon_stage(params.zone, state.carbon_hist,
                                       prng.fold_in(day_key, 4),
                                       xs["green_scale"], xs["coal_scale"])
        # intraday forecast-busting: the ACTUAL intensity moves after the
        # day-ahead forecast is drawn (tomorrow's forecaster sees it)
        if "carbon_hour_scale" in xs:
            act_z = act_z * xs["carbon_hour_scale"][:, None, :]
        eta_act = take(act_z, state.zmap)
        eta_fc = take(fc_z, state.zmap)
        # forecast ensembles (K > 1 only: K = 1 is the point-forecast day)
        ens = None
        if cfg.n_members > 1:
            with spans.span("ensembles"):
                ens = risk.day_ensembles(
                    prng.fold_in(day_key, 5), cfg.n_members, fc["uif"],
                    state.hist_uif_pred, state.hist_uif, fc_z,
                    state.carbon_hist, state.zmap, params.risk_beta)
        with spans.span("optimize"):
            prob, sol, best, *sdiag = optimize_stage(
                fc, eta_fc, model, state.queue,
                state.u_pow_cap * xs["cap_scale"], cap_day, state.campus,
                state.campus_limit * xs["campus_scale"], params.lambda_e,
                params.lambda_p, params.mobility, cfg=cfg, ens=ens)
        # SLO gate: paused clusters get VCC = machine capacity
        gate = state.shaping_allowed & sol.shaped
        vcc_curve = torch.where(gate[..., None], sol.vcc,
                                cap_day[..., None] * 10.0)
        # real time: admission on the ACTUAL load (+ counterfactual); with
        # mpc the hourly recourse loop, and the SLO detector sees the
        # hour-by-hour enforced curve
        arr_hs = xs.get("arrival_hour_scale")
        acc = mdiag = None
        with spans.span("observe"):
            if cfg.mpc:
                with spans.span("observe_mpc"):
                    res, cf, u_if, _, vcc_curve, acc, mdiag = \
                        observe_stage_mpc(
                            truth, state.day, day_key, prob, sol, fc, gate,
                            cap_day, xs["arrival_scale"], state.queue,
                            state.cf_queue, lambda u: model_power(model, u),
                            eta_act, allowance_frac=cfg.slo_allowance,
                            arr_hour_scale=arr_hs)
            else:
                res, cf, u_if, _ = observe_stage(
                    truth, state.day, day_key, vcc_curve, cap_day,
                    xs["arrival_scale"], state.queue, state.cf_queue,
                    lambda u: model_power(model, u), eta_act,
                    allowance_frac=cfg.slo_allowance, arr_hour_scale=arr_hs)
        with spans.span("slo"):
            slo_state = {"crowded_streak": state.crowded_streak,
                         "pause_left": state.pause_left,
                         "violation_days": state.violation_days,
                         "observed_days": state.observed_days}
            new_slo, allowed = slo_stage(slo_state, slo_cfg,
                                         hour_sum(res.reservations),
                                         hour_sum(vcc_curve), res.unmet,
                                         res.arrived)
        with spans.span("carry"):
            if cfg.streaming:
                # absorb the day into the carry (errors pair same-day with
                # the forecast issued above); with mpc through the
                # hour-grain chain
                if cfg.mpc:
                    pred = stats.hour_finalize(state.pred, acc, fc,
                                               state.day, params.gamma)
                else:
                    pred = stats.predictor_update(
                        state.pred, fc, state.day, params.gamma, u_if,
                        res.served, hour_sum(res.reservations),
                        res.usage_total, res.reservations)
                carry = dict(pred=pred)
            else:
                carry = dict(
                    hist_uif=roll(state.hist_uif, u_if),
                    hist_flex_daily=roll(state.hist_flex_daily, res.served),
                    hist_res_daily=roll(state.hist_res_daily,
                                        hour_sum(res.reservations)),
                    hist_usage=roll(state.hist_usage, res.usage_total),
                    hist_res=roll(state.hist_res, res.reservations),
                    hist_tr_pred=roll(state.hist_tr_pred, fc["tr"]),
                    hist_uif_pred=roll(state.hist_uif_pred, fc["uif"]))
            new_state = state._replace(
                day=state.day + 1,
                carbon_hist=roll(state.carbon_hist, act_z),
                queue=res.queue_end,
                cf_queue=cf.queue_end,
                shaping_allowed=allowed,
                **new_slo, **carry,
            )
        telem = None
        if cfg.telemetry:
            # the record observes the day: it reads the stage products
            # above and feeds nothing back
            from repro_torch.sim import telemetry as _telemetry
            with spans.span("record"):
                if cfg.streaming:
                    trail = {"uif": state.pred.uif_day_ring,
                             "tuf": state.pred.flex_ring,
                             "tr": state.pred.res_ring}
                else:
                    trail = {"uif": hour_sum(state.hist_uif[:, :, -7:]),
                             "tuf": state.hist_flex_daily[:, :, -7:],
                             "tr": state.hist_res_daily[:, :, -7:]}
                telem = _telemetry.day_telemetry(
                    sdiag[0], fc, res, u_if, vcc_curve,
                    pause_left=new_slo["pause_left"], shaped=sol.shaped,
                    trail=trail, recourse=mdiag)
        return new_state, StepOut(res=res, cf=cf, sol=sol,
                                  vcc_curve=vcc_curve, fc=fc, prob=prob,
                                  eta_act=eta_act, best=best,
                                  recourse=mdiag, telemetry=telem)

    return step


def ones_xs(B: int, n_clusters: int, n_campuses: int, n_zones: int,
            device=None) -> Dict[str, torch.Tensor]:
    """Neutral (nominal-operation) scenario slices of one day for B
    rollouts, on ``device`` (default ``"cuda"``)."""
    dev = _device.resolve(device)

    def ones(k):
        return torch.ones((B, k), dtype=f32, device=dev)

    return {"green_scale": ones(n_zones), "coal_scale": ones(n_zones),
            "cap_scale": ones(n_clusters), "arrival_scale": ones(n_clusters),
            "campus_scale": ones(n_campuses)}


# ------------------------------------------------------------ init/burn-in

def _proxy_power(u):
    return 100.0 + 300.0 * u


def burnin_step(params: SimParams, state: SimState) -> SimState:
    """One unshaped day with the cheap linear power proxy (history fill)."""
    day_key = prng.fold_in(params.key, state.day)
    cap = params.truth["capacity"]
    ones_z = torch.ones_like(params.zone["solar_cap"])
    act_z, _ = carbon_stage(params.zone, state.carbon_hist,
                            prng.fold_in(day_key, 4), ones_z, ones_z)
    unshaped = (cap[..., None] * 10.0).expand(cap.shape + (24,))
    res, _, u_if, _ = observe_stage(
        params.truth, state.day, day_key, unshaped, cap,
        torch.ones_like(cap), state.queue, state.queue, _proxy_power,
        take(act_z, state.zmap))
    return state._replace(
        day=state.day + 1,
        hist_uif=roll(state.hist_uif, u_if),
        hist_flex_daily=roll(state.hist_flex_daily, res.served),
        hist_res_daily=roll(state.hist_res_daily,
                            hour_sum(res.reservations)),
        hist_usage=roll(state.hist_usage, res.usage_total),
        hist_res=roll(state.hist_res, res.reservations),
        carbon_hist=roll(state.carbon_hist, act_z),
        queue=res.queue_end,
        cf_queue=res.queue_end,
    )


def make_init(n_clusters: int, n_campuses: int, n_zones: int,
              hist_days: int, device=None, streaming: bool = False):
    """init(params) -> burned-in SimState on ``device`` (default
    ``"cuda"``): ``hist_days`` unshaped burn-in days fill the history
    windows, then the campus contracts are set to 97% of the fitted-model
    campus peak over the last week.

    With ``streaming`` every estimator of the streaming carry is then
    warm-started from the burned-in windows (``stats.init_predictor``), the
    seven ``hist_*`` windows drop to zero-length stubs and ``carbon_hist``
    to its trailing 7 days: the carried state no longer grows with
    ``hist_days``.

    Spans: ``burn_in`` a call, around ``burn_in_day`` (each burn-in day),
    ``contracts`` and, streaming, ``predictor_init``."""
    n, m, z, H = n_clusters, n_campuses, n_zones, hist_days
    if streaming and H < 7:
        raise ValueError(f"streaming init needs hist_days >= 7, got {H}")
    dev = _device.resolve(device)

    def init(params: SimParams) -> SimState:
        with spans.span("burn_in"):
            params = map_tensors(lambda t: t.to(dev), params)
            B = params.key.shape[0]
            cap = params.truth["capacity"]
            campus = (torch.arange(n, device=dev) % m).expand(B, n)
            zeros = torch.zeros((B, n), dtype=torch.int64, device=dev)

            def hist(*shape):
                return torch.zeros((B,) + shape, dtype=f32, device=dev)

            state = SimState(
                day=torch.zeros((B,), dtype=torch.int64, device=dev),
                campus=campus, zmap=campus % z, campus_limit=hist(m),
                u_pow_cap=cap * 0.95,
                hist_uif=hist(n, H, 24), hist_flex_daily=hist(n, H),
                hist_res_daily=hist(n, H), hist_usage=hist(n, H, 24),
                hist_res=hist(n, H, 24), hist_tr_pred=hist(n, H),
                hist_uif_pred=hist(n, H, 24), carbon_hist=hist(z, H, 24),
                queue=hist(n), cf_queue=hist(n), crowded_streak=zeros,
                pause_left=zeros, violation_days=zeros, observed_days=zeros,
                shaping_allowed=torch.ones((B, n), dtype=torch.bool,
                                           device=dev))
            for _ in range(H):
                with spans.span("burn_in_day"):
                    state = burnin_step(params, state)
            # zero-error prediction prior; honest quantiles build up in-horizon
            state = state._replace(hist_tr_pred=state.hist_res_daily,
                                   hist_uif_pred=state.hist_uif)
            # campus contracts: 97% of fitted-model campus peak over last week
            with spans.span("contracts"):
                model = power_stage(state.hist_usage, params.lam, cap,
                                    pd_truth(params),
                                    prng.fold_in(params.key, 999))
                upow = model_power(model, state.hist_usage[:, :, -7:].reshape(
                    B, n, -1))
                limit = solver.segment_sum(upow.amax(-1), campus, m) * 0.97
            state = state._replace(campus_limit=limit)
            if streaming:
                with spans.span("predictor_init"):
                    pred = stats.init_predictor(
                        state.hist_uif, state.hist_flex_daily,
                        state.hist_res_daily, state.hist_usage, state.hist_res,
                        state.hist_tr_pred, state.hist_uif_pred, state.day,
                        params.gamma)
                state = state._replace(
                    pred=pred,
                    # carbon_stage's forecast reads only the trailing 7 days
                    # (carbon.forecast_day_ahead): the same forecasts
                    carbon_hist=state.carbon_hist[:, :, -stats.WEEK:].clone(),
                    hist_uif=hist(n, 0, 24), hist_flex_daily=hist(n, 0),
                    hist_res_daily=hist(n, 0), hist_usage=hist(n, 0, 24),
                    hist_res=hist(n, 0, 24), hist_tr_pred=hist(n, 0),
                    hist_uif_pred=hist(n, 0, 24))
            return state

    return init
