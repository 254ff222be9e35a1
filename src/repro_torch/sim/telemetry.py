"""Fleet telemetry layer (port of ``repro.sim.telemetry``): the day's
diagnostics record, its trace export and per-stage cost attribution.

* **The record** (``DayTelemetry``, ``day_telemetry``): built inside the day
  step when ``StageConfig.telemetry=True``. The solver's convergence
  channels come from ``core.vcc.solve_vcc(telemetry=True)`` (objective and
  step trajectories over the dual-ascent rounds, conservation and dual
  residuals, the certified bisection tolerance, the CVaR tail mass, the
  joint-vs-sequential call); forecast calibration (MAPE, bias, coverage of
  the day-ahead U_IF, T_UF, T_R and Theta against the realized day, and a
  drift gauge against the trailing week) and the SLO / headroom gauges
  (hourly VCC binding share, queue age) from the observe and SLO stages.
  Every channel is elementwise or an ordered hour sum
  (``admission.hour_sum``) and keeps the cluster axis, with the batch axis
  B first. The record observes: it launches no kernel and moves nothing
  to the host, and the day's state and outputs are those of the day
  without it, bit for bit.
* **Trace export** (``telemetry_records``, ``write_jsonl``, ``read_jsonl``):
  a rollout's stacked records (B, days, ...) moved to the host once and
  flattened into one JSON record per scenario x seed x day, the cluster
  axes reduced there.
* **Stage cost attribution** (``profile_stages``, ``format_stage_table``):
  each stage timed alone (best of reps on the host clock, and on the
  card its CUDA-event time), with the FLOPs and bytes of its matmul-family
  ATen ops and its launches of kernels #1-#3 a call.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core import prng, risk, stages
from repro_torch.core.admission import hour_sum
from repro_torch.kernels.vcc_pgd import kernel as _pgd_kernel

f32 = torch.float32


# -------------------------------------------------------- metric primitives

def _trailing_mean(e, batch_dims: int):
    """The ordered ``hour_sum`` mean over the trailing axis when ``e`` has
    more than one axis past its ``batch_dims`` leading batch axes; ``e``
    itself otherwise (one value per cluster)."""
    if e.dim() - batch_dims > 1:
        return hour_sum(e) / e.shape[-1]
    return e


def mape(pred, actual, eps: float = 1e-6, batch_dims: int = 0):
    """Mean absolute percentage error |pred - actual| / |actual| over the
    trailing axis (an ordered ``hour_sum`` mean); inputs with one axis past
    their ``batch_dims`` return the per-element APE. Always >= 0."""
    e = torch.abs(pred - actual) / torch.clamp(torch.abs(actual), min=eps)
    return _trailing_mean(e, batch_dims)


def bias(pred, actual, eps: float = 1e-6, batch_dims: int = 0):
    """Signed relative error (pred - actual) / |actual|, the trailing-axis
    mean as in ``mape``. A zero-error forecast gives exactly 0.0."""
    e = (pred - actual) / torch.clamp(torch.abs(actual), min=eps)
    return _trailing_mean(e, batch_dims)


def coverage(bound, actual, batch_dims: int = 0):
    """Empirical coverage: the share of trailing-axis entries with
    ``actual <= bound`` (in [0, 1]); inputs with one axis past their
    ``batch_dims`` return the 0/1 indicator."""
    return _trailing_mean((actual <= bound).to(f32), batch_dims)


def level_drift(fc_level, trailing, eps: float = 1e-6):
    """|forecast daily level - trailing-window mean| / mean: the gauge that
    catches a streaming predictor drifting from what a rescan of the same
    window would forecast. fc_level (..., n); trailing (..., n, W)."""
    m = hour_sum(trailing) / trailing.shape[-1]
    return torch.abs(fc_level - m) / torch.clamp(torch.abs(m), min=eps)


# ------------------------------------------------------------- the record

class DayTelemetry(NamedTuple):
    """One day's diagnostics, batch axis B first. n = clusters, m =
    campuses, T = the solver's dual-ascent rounds. The cluster and campus
    axes are not reduced (the host-side consumers reduce them); a rollout
    stacks the days on axis 1: (B, days, ...)."""
    # --- solver convergence (core.vcc / core.spatial channels)
    obj_cluster_traj: torch.Tensor     # (B, T, n) nominal cost per round
    step_max_traj: torch.Tensor        # (B, T, n) max |delta step| a round
    conservation_resid: torch.Tensor   # (B, n) |sum_h delta| at the solution
    proj_nu_tol: torch.Tensor          # (B, n) certified bisection tolerance
    dual_resid: torch.Tensor           # (B, m) relative campus overshoot
    cvar_tail_mass: torch.Tensor       # (B, n) max CVaR member weight
    joint_winner: torch.Tensor         # (B,) 1.0 = joint refinement kept
    # --- forecast calibration (against the realized day)
    uif_mape: torch.Tensor             # (B, n) hourly U_IF forecast MAPE
    uif_bias: torch.Tensor             # (B, n) hourly U_IF signed rel. error
    tuf_mape: torch.Tensor             # (B, n) daily flexible-total MAPE
    tuf_bias: torch.Tensor             # (B, n)
    tr_mape: torch.Tensor              # (B, n) daily reservation-total MAPE
    tr_bias: torch.Tensor              # (B, n)
    theta_covered: torch.Tensor        # (B, n) 1.0 if realized T_R <= Theta
    uifq_coverage: torch.Tensor        # (B, n) share of hours U_IF <= quant
    fc_level_drift: torch.Tensor       # (B, n) forecast vs trailing week
    # --- SLO / headroom gauges
    vcc_binding_frac: torch.Tensor     # (B, n) share of hours at the VCC
    queue_age_days: torch.Tensor       # (B, n) backlog / daily service
    paused: torch.Tensor               # (B, n) 1.0 = SLO pause active
    shaped: torch.Tensor               # (B, n) 1.0 = cluster shaped
    # --- intra-day MPC recourse (core.mpc; zeros in the open loop)
    mpc_recourse_frac: torch.Tensor    # (B, n) share of hours re-planned
    mpc_recourse_depth: torch.Tensor   # (B, n) mean |delta change|


def day_telemetry(sdiag: Dict[str, torch.Tensor], fc, res, u_if, vcc_curve,
                  *, pause_left, shaped, trail, recourse=None
                  ) -> DayTelemetry:
    """Assemble the day's record inside the day step.

    ``sdiag``: the optimize stage's solver diagnostics; ``fc``: the
    forecast dict the day optimized against; ``res``: the shaped admission
    ``DayResult``; ``u_if``: the realized inflexible load (B, n, 24);
    ``trail``: the trailing week's daily levels {uif, tuf, tr}, each
    (B, n, 7), from the streaming rings or the history windows' tails;
    ``recourse``: the day's ``mpc.MPCDiag`` under ``mpc`` (None = the
    open loop, recorded as zeros). ``vcc_curve`` is the curve admission
    enforced (under ``mpc`` the hour-by-hour one), so
    ``vcc_binding_frac`` gauges the closed loop, not the 00:00 plan."""
    daily_res = hour_sum(res.reservations)
    if recourse is None:
        rec_frac = torch.zeros_like(daily_res)
        rec_depth = torch.zeros_like(daily_res)
    else:
        rec_frac = recourse.recourse_frac
        rec_depth = recourse.recourse_depth
    drift = torch.maximum(
        torch.maximum(level_drift(hour_sum(fc["uif"]), trail["uif"]),
                      level_drift(fc["tuf"], trail["tuf"])),
        level_drift(fc["tr"], trail["tr"]))
    return DayTelemetry(
        obj_cluster_traj=sdiag["obj_cluster_traj"],
        step_max_traj=sdiag["step_max_traj"],
        conservation_resid=sdiag["conservation_resid"],
        proj_nu_tol=sdiag["proj_nu_tol"],
        dual_resid=sdiag["dual_resid"],
        cvar_tail_mass=sdiag["cvar_tail_mass"],
        joint_winner=sdiag["joint_winner"],
        uif_mape=mape(fc["uif"], u_if, batch_dims=1),
        uif_bias=bias(fc["uif"], u_if, batch_dims=1),
        tuf_mape=mape(fc["tuf"], res.served, batch_dims=1),
        tuf_bias=bias(fc["tuf"], res.served, batch_dims=1),
        tr_mape=mape(fc["tr"], daily_res, batch_dims=1),
        tr_bias=bias(fc["tr"], daily_res, batch_dims=1),
        theta_covered=(daily_res <= fc["theta"]).to(f32),
        uifq_coverage=coverage(fc["uif_q"], u_if, batch_dims=1),
        fc_level_drift=drift,
        # an hour is "binding" when reservations reach the VCC (within
        # 0.1%: admission saturates at the curve, never above it)
        vcc_binding_frac=coverage(res.reservations, 0.999 * vcc_curve,
                                  batch_dims=1),
        queue_age_days=res.queue_end / torch.clamp(res.served, min=1e-6),
        paused=(pause_left > 0).to(f32),
        shaped=shaped.to(f32),
        mpc_recourse_frac=rec_frac,
        mpc_recourse_depth=rec_depth)


# ---------------------------------------------------------- trace export

# one JSON record per scenario x seed x day; cluster/campus axes reduced on
# the host (fleet mean for calibration rates, max for residuals and ages)
TRACE_FIELDS = (
    "scenario", "seed", "day",
    "obj_first", "obj_final", "obj_decrease_pct", "step_final",
    "conservation_max", "proj_tol_max", "dual_max", "cvar_tail_max",
    "joint_winner",
    "uif_mape", "uif_bias", "tuf_mape", "tuf_bias", "tr_mape", "tr_bias",
    "theta_coverage", "uifq_coverage", "fc_level_drift",
    "vcc_binding_frac", "queue_age_max", "paused_frac", "shaped_frac",
    "mpc_recourse_frac", "mpc_recourse_depth",
)


def telemetry_records(tel: DayTelemetry, scenario_names: Sequence[str],
                      n_seeds: int) -> List[Dict[str, object]]:
    """Flatten a rollout's stacked records (leaves (scenario x seed, days,
    ...), scenario-major, as ``scenarios.build_batch`` lays the batch out)
    into TRACE_FIELDS records. Each leaf moves to the host once; the rest
    is numpy in float64."""
    t = stages.map_tensors(
        lambda a: a.detach().cpu().numpy().astype(np.float64), tel)
    batch, days = t.uif_mape.shape[:2]
    if batch != len(scenario_names) * n_seeds:
        raise ValueError(
            f"telemetry batch of {batch} rollouts != {len(scenario_names)} "
            f"scenarios x {n_seeds} seeds")
    records = []
    for b in range(batch):
        scen = scenario_names[b // n_seeds]
        seed = b % n_seeds
        for d in range(days):
            obj_first = float(t.obj_cluster_traj[b, d, 0].sum())
            obj_final = float(t.obj_cluster_traj[b, d, -1].sum())
            records.append({
                "scenario": scen, "seed": seed, "day": d,
                "obj_first": obj_first, "obj_final": obj_final,
                "obj_decrease_pct": 100.0 * (obj_first - obj_final)
                / max(abs(obj_first), 1e-9),
                "step_final": float(t.step_max_traj[b, d, -1].max()),
                "conservation_max": float(t.conservation_resid[b, d].max()),
                "proj_tol_max": float(t.proj_nu_tol[b, d].max()),
                "dual_max": float(t.dual_resid[b, d].max()),
                "cvar_tail_max": float(t.cvar_tail_mass[b, d].max()),
                "joint_winner": float(t.joint_winner[b, d]),
                "uif_mape": float(t.uif_mape[b, d].mean()),
                "uif_bias": float(t.uif_bias[b, d].mean()),
                "tuf_mape": float(t.tuf_mape[b, d].mean()),
                "tuf_bias": float(t.tuf_bias[b, d].mean()),
                "tr_mape": float(t.tr_mape[b, d].mean()),
                "tr_bias": float(t.tr_bias[b, d].mean()),
                "theta_coverage": float(t.theta_covered[b, d].mean()),
                "uifq_coverage": float(t.uifq_coverage[b, d].mean()),
                "fc_level_drift": float(t.fc_level_drift[b, d].max()),
                "vcc_binding_frac": float(t.vcc_binding_frac[b, d].mean()),
                "queue_age_max": float(t.queue_age_days[b, d].max()),
                "paused_frac": float(t.paused[b, d].mean()),
                "shaped_frac": float(t.shaped[b, d].mean()),
                "mpc_recourse_frac": float(
                    t.mpc_recourse_frac[b, d].mean()),
                "mpc_recourse_depth": float(
                    t.mpc_recourse_depth[b, d].mean()),
            })
    return records


def write_jsonl(path, records: Sequence[Dict[str, object]]) -> None:
    """One JSON object a line."""
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")


def read_jsonl(path) -> List[Dict[str, object]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# --------------------------------------------------- stage cost attribution

class DotCounter(TorchDispatchMode):
    """Counts the matmul-family ATen ops a call dispatches: their FLOPs by
    ``torch.utils.flop_counter``'s formulas (``flop_registry``, the table
    ``FlopCounterMode`` counts with) and their operand and result bytes.
    ``FlopCounterMode`` itself re-dispatches every other op through its
    decomposition, about 10x a CPU day step's time; this mode runs every
    other op as it is."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
            tensors = []
            stages.map_tensors(tensors.append, (list(args), out))
            self.nbytes += sum(t.numel() * t.element_size()
                               for t in tensors)
        return out


def _launches():
    """Launches of kernels #1, #2 and #3 so far."""
    return (_pgd_kernel.pgd_epoch_cuda.launches,
            _pgd_kernel.pgd_epoch_ens_cuda.launches,
            _pgd_kernel.joint_step_cuda.launches)


def _time_stage(fn, args, reps: int, on_card: bool):
    """One row's numbers for ``fn(*args)``: a first call under the counter
    (the warm-up; its dot FLOPs and bytes, and the launches it made), then
    the best of ``reps`` calls on the host clock (synchronized on the card)
    and on CUDA events."""
    before = _launches()
    with DotCounter() as dots:
        fn(*args)
    launches = tuple(a - b for a, b in zip(_launches(), before))
    wall = dev = float("inf")
    for _ in range(reps):
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn(*args)
        if on_card:
            end.record()
            torch.cuda.synchronize()
            dev = min(dev, start.elapsed_time(end))
        wall = min(wall, time.perf_counter() - t0)
    return {"wall_ms": wall * 1e3, "device_ms": dev if on_card else None,
            "dot_flops": dots.flops, "dot_bytes": dots.nbytes,
            "launches": launches}


def profile_stages(cfg: stages.StageConfig, params, state,
                   reps: int = 3) -> List[Dict[str, object]]:
    """Attribute the day cycle's cost to its stages at the shapes of
    ``(params, state)`` (a burned-in ``SimState``), on their device.

    Returns rows {stage, wall_ms, pct, dot_flops, dot_bytes, device_ms,
    launches} for power_fit, forecast (the streaming forecast for a
    streaming state), carbon, optimize, observe, and a last ``day_step``
    row for the whole step (its ``pct`` against the same stage sum).
    ``wall_ms`` is the best of ``reps`` on the host clock, synchronized
    before each start and stop on the card; ``device_ms`` the best CUDA-
    event time of the same calls (None on the CPU); ``pct`` a share of the
    summed stage wall times; ``dot_flops`` and ``dot_bytes`` the matmul-
    family FLOPs and bytes of one call (``DotCounter``); ``launches`` the
    call's launches of kernels #1, #2 and #3."""
    dev = state.queue.device
    on_card = dev.type == "cuda"
    B, n = state.queue.shape
    m = state.campus_limit.shape[-1]
    z = state.carbon_hist.shape[1]
    xs = stages.ones_xs(B, n, m, z, device=dev)
    day_key = prng.fold_in(params.key, state.day)
    pdt = stages.pd_truth(params)
    cap = params.truth["capacity"]
    hist_usage = state.pred.usage_ring if cfg.streaming else state.hist_usage

    def power_fn(hist, key):
        return stages.power_stage(hist, params.lam, cap, pdt, key)

    if cfg.streaming:
        def forecast_fn(day, gamma):
            return stages.forecast_stage_streaming(state.pred, day, gamma)
        forecast_args = (state.day, params.gamma)
    else:
        forecast_fn = stages.forecast_stage
        forecast_args = (state.hist_uif, state.hist_flex_daily,
                         state.hist_res_daily, state.hist_usage,
                         state.hist_res, state.hist_tr_pred,
                         state.hist_uif_pred, params.gamma)

    def carbon_fn(hist, key):
        return stages.carbon_stage(params.zone, hist, key,
                                   xs["green_scale"], xs["coal_scale"])

    # the downstream stages' inputs
    model = power_fn(hist_usage, prng.fold_in(day_key, 1))
    fc = forecast_fn(*forecast_args)
    act_z, fc_z = carbon_fn(state.carbon_hist, prng.fold_in(day_key, 4))
    eta_act = stages.take(act_z, state.zmap)
    eta_fc = stages.take(fc_z, state.zmap)
    ens = None
    if cfg.n_members > 1:
        ens = risk.day_ensembles(
            prng.fold_in(day_key, 5), cfg.n_members, fc["uif"],
            state.hist_uif_pred, state.hist_uif, fc_z, state.carbon_hist,
            state.zmap, params.risk_beta)

    def optimize_fn(fcv, eta, queue, u_pow_cap, cap_day, campus_limit):
        return stages.optimize_stage(
            fcv, eta, model, queue, u_pow_cap, cap_day, state.campus,
            campus_limit, params.lambda_e, params.lambda_p, params.mobility,
            cfg=cfg, ens=ens)

    sol = optimize_fn(fc, eta_fc, state.queue, state.u_pow_cap, cap,
                      state.campus_limit)[1]
    gate = state.shaping_allowed & sol.shaped
    vcc_curve = torch.where(gate[..., None], sol.vcc, cap[..., None] * 10.0)

    def observe_fn(curve, cap_day, queue, cf_queue, eta):
        return stages.observe_stage(
            params.truth, state.day, day_key, curve, cap_day,
            xs["arrival_scale"], queue, cf_queue,
            lambda u: stages.model_power(model, u), eta)

    entries = [
        ("power_fit", power_fn, (hist_usage, prng.fold_in(day_key, 1))),
        ("forecast", forecast_fn, forecast_args),
        ("carbon", carbon_fn,
         (state.carbon_hist, prng.fold_in(day_key, 4))),
        ("optimize", optimize_fn,
         (fc, eta_fc, state.queue, state.u_pow_cap, cap,
          state.campus_limit)),
        ("observe", observe_fn,
         (vcc_curve, cap, state.queue, state.cf_queue, eta_act)),
        ("day_step", stages.make_day_step(cfg), (params, state, xs)),
    ]
    rows = [{"stage": name, **_time_stage(fn, args, reps, on_card)}
            for name, fn, args in entries]
    stage_total = sum(r["wall_ms"] for r in rows[:-1])
    for r in rows:
        r["pct"] = 100.0 * r["wall_ms"] / max(stage_total, 1e-9)
    return rows


def format_stage_table(rows: List[Dict[str, object]]) -> str:
    """Fixed-width stage-cost table; ``device_ms`` reads "-" off the card,
    ``launches`` are those of kernels #1 / #2 / #3 a call."""
    name_w = max([len("stage")] + [len(r["stage"]) for r in rows]) + 2
    out = ["stage".ljust(name_w) + "   wall_ms      pct     dot_GFLOP"
           + "    dot_MB  device_ms  launches #1/#2/#3"]
    out.append("-" * (name_w + 74))
    for r in rows:
        dev = "-" if r.get("device_ms") is None else f"{r['device_ms']:.2f}"
        launches = "/".join(str(x) for x in r.get("launches", ()))
        out.append(r["stage"].ljust(name_w)
                   + f"{r['wall_ms']:9.2f}  {r['pct']:6.1f}%  "
                   + f"{r['dot_flops'] / 1e9:12.3f}  "
                   + f"{r['dot_bytes'] / 1e6:8.2f}  {dev:>9}  "
                   + f"{launches:>17}")
    return "\n".join(out)


__all__ = [
    "DayTelemetry", "day_telemetry", "mape", "bias", "coverage",
    "level_drift", "telemetry_records", "write_jsonl", "read_jsonl",
    "profile_stages", "format_stage_table", "TRACE_FIELDS",
]
