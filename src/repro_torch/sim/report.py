"""Reduce batched rollouts into per-scenario summary tables (port of
``repro.sim.report``: ``state_nbytes``, ``scenario_rows``, the mobility-
and risk-sweep rows, the MPC recourse rows, the telemetry rows and
``format_table``).

Input: a batched Ledger whose leading axis is scenario-major x seed-minor
(the layout ``scenarios.build_batch`` produces).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import stats
from repro_torch.sim.ledger import Ledger, summarize

COLUMNS = ("carbon_saved_pct", "peak_reduction_pct", "flex_within_24h_pct",
           "kwh_saved_pct", "delayed_cpu_h_per_day")


def state_nbytes(state, batch: int = 1) -> int:
    """Per-rollout bytes of a carried ``SimState`` (streaming or rescan);
    ``batch``: the leading (scenario x seed) extent to divide out."""
    return stats.pytree_nbytes(state) // max(batch, 1)


def scenario_rows(ledgers: Ledger, scenario_names: Sequence[str],
                  n_seeds: int, horizon_days: Optional[int] = None,
                  initial_backlog=None, state_bytes: Optional[int] = None
                  ) -> List[Dict[str, float]]:
    """Per-scenario mean +/- std (over seeds, ddof=1) of the ledger
    summaries. ``initial_backlog``: (B,) fleet-total queue at rollout
    start; ``horizon_days`` and ``state_bytes`` (per-rollout carried state,
    ``state_nbytes``) tag every row when given."""
    summaries = summarize(ledgers, 0.0 if initial_backlog is None
                          else initial_backlog)
    summaries = {k: v.detach().cpu().double().numpy()
                 for k, v in summaries.items()}
    rows = []
    for i, name in enumerate(scenario_names):
        sl = slice(i * n_seeds, (i + 1) * n_seeds)
        row: Dict[str, float] = {"scenario": name, "n_seeds": n_seeds}
        if horizon_days is not None:
            row["horizon_days"] = int(horizon_days)
        if state_bytes is not None:
            row["state_bytes"] = int(state_bytes)
        for k, v in summaries.items():
            vals = np.asarray(v[sl], dtype=np.float64)
            row[k] = float(vals.mean())
            row[k + "_std"] = float(vals.std(ddof=1)) if n_seeds > 1 else 0.0
        rows.append(row)
    return rows


RISK_COLUMNS = ("carbon_saved_pct", "flex_completion_pct",
                "flex_within_24h_pct", "delayed_cpu_h_per_day")

MOBILITY_COLUMNS = ("carbon_saved_pct", "carbon_vs_sequential_pct",
                    "peak_reduction_pct", "flex_within_24h_pct")

TELEMETRY_COLUMNS = ("obj_decrease_pct", "uif_mape", "theta_coverage",
                     "uifq_coverage", "vcc_binding_frac", "queue_age_max")


def telemetry_rows(records, scenario_names: Optional[Sequence[str]] = None
                   ) -> List[Dict[str, float]]:
    """Per-scenario mean +/- std of the telemetry trace records
    (``telemetry.telemetry_records``: one a scenario x seed x day). The std
    pools seeds and days (ddof=1 with more than one record; one record
    gives 0.0). Render with ``format_table(rows, TELEMETRY_COLUMNS)``."""
    by_scen: Dict[str, List[dict]] = {}
    for r in records:
        by_scen.setdefault(r["scenario"], []).append(r)
    names = scenario_names if scenario_names is not None else by_scen
    rows: List[Dict[str, float]] = []
    for name in names:
        rs = by_scen.get(name, [])
        if not rs:
            continue
        keys = [k for k in rs[0] if k not in ("scenario", "seed", "day")]
        row: Dict[str, float] = {"scenario": name, "n_records": len(rs)}
        for k in keys:
            vals = np.asarray([r[k] for r in rs], dtype=np.float64)
            row[k] = float(vals.mean())
            row[k + "_std"] = \
                float(vals.std(ddof=1)) if len(rs) > 1 else 0.0
        rows.append(row)
    return rows


def mobility_sweep_rows(led_joint: Ledger, led_seq: Ledger,
                        scenario_names: Sequence[str], n_seeds: int
                        ) -> List[Dict[str, float]]:
    """Rows of the mobility sweep: the ledger summaries of the joint
    (``SimConfig(joint_spatial=True)``) rollouts, plus the carbon delta
    against the sequential pre-shift rollouts of the same batch.
    ``carbon_vs_sequential_pct > 0`` means the joint solve emitted less."""
    rows = scenario_rows(led_joint, scenario_names, n_seeds)
    seq = scenario_rows(led_seq, scenario_names, n_seeds)
    for r, q in zip(rows, seq):
        base = max(abs(q["carbon_kg"]), 1e-9)
        r["carbon_vs_sequential_pct"] = \
            100.0 * (q["carbon_kg"] - r["carbon_kg"]) / base
        r["sequential_carbon_kg"] = q["carbon_kg"]
    return rows


MPC_COLUMNS = ("carbon_saved_pct", "carbon_vs_open_pct",
               "flex_within_24h_pct", "flex24h_vs_open_pp",
               "delayed_cpu_h_per_day")


def mpc_recourse_rows(led_mpc: Ledger, led_open: Ledger,
                      scenario_names: Sequence[str], n_seeds: int
                      ) -> List[Dict[str, float]]:
    """Rows of the intra-day recourse comparison: the ledger summaries of
    the closed-loop (``SimConfig(mpc=True)``) rollouts, plus deltas against
    the open-loop rollouts of the same batch. ``carbon_vs_open_pct > 0``
    means hourly recourse emitted less carbon than the 00:00 plan;
    ``flex24h_vs_open_pp`` is the within-24h flex service gain in
    percentage points."""
    rows = scenario_rows(led_mpc, scenario_names, n_seeds)
    open_rows = scenario_rows(led_open, scenario_names, n_seeds)
    for r, q in zip(rows, open_rows):
        base = max(abs(q["carbon_kg"]), 1e-9)
        r["carbon_vs_open_pct"] = \
            100.0 * (q["carbon_kg"] - r["carbon_kg"]) / base
        r["flex24h_vs_open_pp"] = \
            r["flex_within_24h_pct"] - q["flex_within_24h_pct"]
        r["open_carbon_kg"] = q["carbon_kg"]
        r["open_flex_within_24h_pct"] = q["flex_within_24h_pct"]
    return rows


def risk_sweep_rows(ledgers_by_k: Dict[int, Ledger],
                    scenario_names: Sequence[str], n_seeds: int
                    ) -> List[Dict[str, float]]:
    """Flatten a {n_members: batched Ledger} sweep (one batch per ensemble
    size K over the risk-sweep betas x seeds) into rows tagged with
    ``n_members``; render with ``format_table(rows, RISK_COLUMNS)``."""
    rows: List[Dict[str, float]] = []
    for k, led in sorted(ledgers_by_k.items()):
        for r in scenario_rows(led, scenario_names, n_seeds):
            r["n_members"] = k
            rows.append(r)
    return rows


def format_table(rows: List[Dict[str, float]],
                 columns: Sequence[str] = COLUMNS) -> str:
    """Fixed-width ASCII table: one line per scenario."""
    name_w = max([len("scenario")] + [len(r["scenario"]) for r in rows]) + 2
    headers = {"carbon_saved_pct": "carbonSaved%",
               "carbon_vs_sequential_pct": "vsSeq%",
               "carbon_vs_open_pct": "vsOpen%",
               "flex24h_vs_open_pp": "flex24hΔpp",
               "peak_reduction_pct": "peakRed%",
               "flex_within_24h_pct": "flex<24h%",
               "flex_completion_pct": "flexDone%",
               "kwh_saved_pct": "kwhSaved%",
               "delayed_cpu_h_per_day": "delayedCPUh/d",
               "obj_decrease_pct": "objDec%",
               "uif_mape": "uifMAPE",
               "theta_coverage": "thetaCov",
               "uifq_coverage": "uifQCov",
               "vcc_binding_frac": "vccBind",
               "queue_age_max": "queueAge"}
    cols = [headers.get(c, c) for c in columns]
    widths = [max(len(c), 12) for c in cols]
    out = ["scenario".ljust(name_w)
           + "  ".join(c.rjust(w) for c, w in zip(cols, widths))]
    out.append("-" * (name_w + sum(widths) + 2 * (len(cols) - 1)))
    for r in rows:
        cells = []
        for c, w in zip(columns, widths):
            std = r.get(c + "_std", 0.0)
            cells.append(f"{r[c]:+.2f}±{std:.2f}".rjust(w))
        out.append(r["scenario"].ljust(name_w) + "  ".join(cells))
    return "\n".join(out)
