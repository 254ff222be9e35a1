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
* **Stage cost attribution** (``stage_rows``, ``profile_stages``,
  ``profile_setup``, ``format_stage_table``): the spans of a real day, or
  of a burn-in and warm-up (``repro_torch.spans``), by path, each with its
  host and self time, its share of the whole, the launches of kernels
  #1-#3 inside it with their sizes, its solver rounds and steps and its
  kernel builds.
"""
from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import stages
from repro_torch.core.admission import hour_sum

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

# kernels #1, #2, #3 and #3's split-route shift update, by the
# ``launch.<kernel>`` counters their wrappers keep while spans record
# (kernels/vcc_pgd/kernel.py)
KERNEL_COUNTERS = ("launch.pgd_epoch", "launch.pgd_epoch_ens",
                   "launch.joint_step", "launch.s_project")


def stage_rows(rec: spans.Recorder, root="day") -> List[Dict[str, object]]:
    """One row per span path under the recorder's ``root`` spans (under
    every top-level span with ``root=None``), in tree order.

    A span's path is its ancestors' names and its own from the root down,
    so spans of one name under different parents (the rounds of a
    ``solve_vcc`` and of a ``suffix_solve``) are different rows, and a
    row's time holds its children's. Each row: ``path``
    ("day/optimize/solve_vcc"), ``stage`` (the span's name), ``depth`` (0
    at the roots), ``calls``; ``host_ms`` and ``self_ms`` (host time less
    the children's), summed over the path's spans; ``pct``, ``host_ms`` as
    a share of the roots'; and inside the path's spans, their own
    included: ``launches`` of each of ``KERNEL_COUNTERS``, ``sizes`` (each
    launch's sizes, by counter), ``rounds`` (``round`` spans), ``steps``
    (their inner steps) and ``builds`` (kernel builds: compiled, found
    built)."""
    S = rec.spans
    kids = rec.children()
    tops = [i for i, s in enumerate(S)
            if (s.parent < 0 if root is None else
                s.name == root and all(S[a].name != root
                                       for a in rec.ancestors(i)))]
    rows: Dict[tuple, Dict[str, object]] = {}
    under: Dict[tuple, List[tuple]] = {}

    def visit(i: int, chain: List[Dict[str, object]], path: tuple):
        sp = S[i]
        path = path + (sp.name,)
        r = rows.get(path)
        if r is None:
            r = rows[path] = {
                "path": "/".join(path), "stage": sp.name,
                "depth": len(path) - 1, "calls": 0, "host_ms": 0.0,
                "self_ms": 0.0, "launches": [0] * len(KERNEL_COUNTERS),
                "sizes": {}, "rounds": 0, "steps": 0, "builds": [0, 0]}
            under.setdefault(path[:-1], []).append(path)
        r["calls"] += 1
        r["host_ms"] += sp.host_ns * 1e-6
        r["self_ms"] += rec.self_ns(i, kids) * 1e-6
        chain = chain + [r]
        for a in chain:
            a["rounds"] += sp.name == "round"
            a["steps"] += sp.counts.get("steps", 0)
            a["builds"][0] += sp.counts.get("built", 0)
            a["builds"][1] += sp.counts.get("cached", 0)
            for k, key in enumerate(KERNEL_COUNTERS):
                a["launches"][k] += sp.counts.get(key, 0)
                for size in sp.sizes.get(key, ()):
                    a["sizes"].setdefault(key, []).append(size)
        for j in kids[i]:
            visit(j, chain, path)

    for i in tops:
        visit(i, [], ())
    total = sum(S[i].host_ns for i in tops) * 1e-6
    out: List[Dict[str, object]] = []

    def emit(path: tuple):
        r = rows[path]
        r["launches"], r["builds"] = tuple(r["launches"]), tuple(r["builds"])
        r["pct"] = 100.0 * r["host_ms"] / max(total, 1e-12)
        out.append(r)
        for p in under.get(path, ()):
            emit(p)

    for p in under.get((), ()):
        emit(p)
    return out


def profile_stages(cfg: stages.StageConfig, params, state
                   ) -> List[Dict[str, object]]:
    """Where one real day's host time goes, from its spans: the day step of
    ``cfg`` from ``(params, state)`` (a burned-in ``SimState``) at nominal
    scenario slices, run once under ``spans.recording()`` inside a ``day``
    span, on the state's device; ``stage_rows`` of the recording.

    A span's time is the host's: where a stage synchronises with the
    device (the power stage's blocking copies do), it holds the wait for
    the device work queued before it, its own and earlier stages'. The
    device's own time by span comes from a profiled run
    (``tools/span_probe.py``)."""
    dev = state.queue.device
    B, n = state.queue.shape
    m = state.campus_limit.shape[-1]
    z = state.carbon_hist.shape[1]
    xs = stages.ones_xs(B, n, m, z, device=dev)
    step = stages.make_day_step(cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with spans.recording() as rec:
        with spans.span("day"):
            step(params, state, xs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return stage_rows(rec)


def profile_setup(cfg, params, device=None):
    """Where a rollout's set-up goes, from its spans: ``make_init(cfg)``
    (the ``burn_in`` span: its ``burn_in_day`` spans, ``contracts``,
    streaming ``predictor_init``) and a one-day ``make_rollout`` from the
    burned-in state (a ``rollout`` span), as a benchmark warms up, run once
    under ``spans.recording()`` on ``device``. Returns (the burned-in
    state, ``stage_rows`` of every top-level span). A kernel's first
    launch in a process loads it: a ``build`` span whose ``builds`` read
    (1, 0) where nvcc compiled it and (0, 1) where ``build/`` held it."""
    from repro_torch.sim import engine
    init = engine.make_init(cfg, device=device)
    roll = engine.make_rollout(cfg, 1)
    with spans.recording() as rec:
        state = init(params)
        roll(params, state)
    if state.queue.device.type == "cuda":
        torch.cuda.synchronize(state.queue.device)
    return state, stage_rows(rec, root=None)


def format_stage_table(rows: List[Dict[str, object]]) -> str:
    """Fixed-width table of ``stage_rows``: each span indented by its
    depth, its calls, host and self ms, share of the roots, launches of
    kernels #1 / #2 / #3 / #3's shift update (``s_project``), rounds /
    steps, and kernel builds compiled / found built."""
    name_w = max([len("stage")] + [2 * r["depth"] + len(r["stage"])
                                   for r in rows]) + 2
    head = ("stage".ljust(name_w) + "calls   host_ms   self_ms"
            "     pct  #1/#2/#3/sp  rounds/steps  built/cached")
    out = [head, "-" * len(head)]
    for r in rows:
        out.append(((" " * (2 * r["depth"]) + r["stage"]).ljust(name_w)
                    + f"{r['calls']:5d} {r['host_ms']:9.2f}"
                    + f" {r['self_ms']:9.2f} {r['pct']:6.1f}%"
                    + f"  {'/'.join(str(x) for x in r['launches']):>11}"
                    + f"  {r['rounds']:>5}/{r['steps']:<6}"
                    + f"  {'/'.join(str(x) for x in r['builds']):>12}"
                    ).rstrip())
    return "\n".join(out)


__all__ = [
    "DayTelemetry", "day_telemetry", "mape", "bias", "coverage",
    "level_drift", "telemetry_records", "write_jsonl", "read_jsonl",
    "stage_rows", "profile_stages", "profile_setup", "format_stage_table",
    "TRACE_FIELDS",
]
