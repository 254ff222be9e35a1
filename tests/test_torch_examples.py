"""The five examples of ``examples_torch/`` on the CPU, against the JAX
package where they compute something of their own.

* Fig 12's randomized controlled experiment (``fleet_week.
  fig12_controlled_experiment``) at 4 clusters and 3 days against the
  same experiment built here from ``repro.core.fleet``, ``vcc`` and
  ``slo`` step by step as ``benchmarks/fleet_bench.py`` runs it: the
  treated and control means within 1e-3 relative, the drop within 0.15
  percentage points, the counts equal and equal to the numpy coin's draws.
  Single cluster-days are not compared: the PD power fit is
  ill-conditioned in float32 (ROADMAP.md §3) and moves them by up to 2e-2.
* ``train_carbon_aware``'s parameter count (``models.param_count``)
  against ``repro.models.param_specs`` of the same config.
* Each example's ``main([... "--device", "cpu"])`` end to end at a smoke
  size: finite output, and the original's table columns and row names
  (the scenario tables' rows against the JAX package's libraries); the
  default library run once, with --telemetry --trace, its trace read back
  and its table equal to the sharded sweep's (without telemetry);
  and ``main()`` without ``--device`` raising without CUDA.

    PYTHONPATH=src python -m pytest -q tests/test_torch_examples.py
"""
import importlib
import math
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import fleet as JF, slo as jslo, vcc as jvcc
from repro.models import param_specs
from repro.sim import report as jreport, scenarios as jscen

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

EXAMPLES = ("quickstart", "fleet_week", "scenario_sweep", "serve_shaped",
            "train_carbon_aware")
MEAN_RTOL = 1e-3          # Fig 12's treated and control means
DROP_ATOL_PP = 0.15       # Fig 12's drop, percentage points
SWEEP = ["--days", "2", "--seeds", "1", "--clusters", "4", "--hist", "14",
         "--device", "cpu"]


def example(name):
    return importlib.import_module(f"examples_torch.{name}")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_fig12(n_clusters, days, seed=5):
    """``benchmarks/fleet_bench.py``'s ``fig12_controlled_experiment``
    step by step on the JAX package; returns the per-cluster-day values of
    the treated and of the control clusters."""
    cfg = JF.FleetConfig(n_clusters=n_clusters, n_campuses=4, n_zones=4,
                         lambda_e=0.8, seed=seed)
    st = JF.init_fleet(cfg)
    rng = np.random.RandomState(0)
    treated, control = [], []
    for _ in range(days):
        treat = jnp.asarray(rng.rand(n_clusters) < 0.5)
        power_fn, slope_fn, _ = JF.make_power_fn(st)
        fc = JF.day_forecasts(st)
        _, _, _, eta_fc = JF.carbon_forecast_next(st, st.day)
        prob = JF.build_problem(st, fc, eta_fc, power_fn, slope_fn)
        sol = jvcc.solve_vcc(prob)
        gate = st.shaping_allowed & sol.shaped & treat
        vcc_curve = jnp.where(gate[:, None], sol.vcc,
                              st.capacity[:, None] * 10.0)
        st.hist_tr_pred = jnp.concatenate(
            [st.hist_tr_pred[:, 1:], fc["tr"][:, None]], axis=1)
        st.hist_uif_pred = jnp.concatenate(
            [st.hist_uif_pred[:, 1:], fc["uif"][:, None]], axis=1)
        st, res, intensity = JF._observe_day(st, st.day, True, vcc_curve,
                                             collect=True)
        new_slo, allowed = jslo.update(st.slo_state, cfg.slo,
                                       res.reservations.sum(1),
                                       vcc_curve.sum(1), res.unmet,
                                       res.arrived)
        st.slo_state, st.shaping_allowed = new_slo, allowed
        p = np.asarray(res.power)
        e = np.asarray(intensity)
        pn = p / p.mean(axis=1, keepdims=True)
        dirty = e >= np.quantile(e, 0.75, axis=1, keepdims=True)
        for c in range(n_clusters):
            val = pn[c][dirty[c]].mean()
            (treated if bool(treat[c]) else control).append(val)
    return treated, control


def parse_fig12(rows):
    """(drop %, treated mean, control mean, n treated, n control) of the
    experiment's one row."""
    (name, drop, derived), = rows
    assert name == "fig12_peak_carbon_power_drop_pct"
    m = re.search(r"treated=([-\d.]+) control=([-\d.]+) n=\((\d+),(\d+)\)",
                  derived)
    return drop, float(m[1]), float(m[2]), int(m[3]), int(m[4])


def drop_pct(treated, control):
    t, c = np.mean(treated), np.mean(control)
    return t, c, (c - t) / c * 100.0


@pytest.fixture(scope="module")
def fig12():
    fw = example("fleet_week")
    port = fw.fig12_cluster_days(n_clusters=4, days=3, device="cpu")
    return port, jax_fig12(4, 3)


def test_fig12_matches_the_jax_package(fig12):
    (pt, pc), (jt, jc) = fig12
    t, c, drop = drop_pct(pt, pc)
    jt_mean, jc_mean, jdrop = drop_pct(jt, jc)
    print(f"\nfig12 port: drop {drop:.6f}% treated {t:.6f} control "
          f"{c:.6f}; JAX: drop {jdrop:.6f}% treated {jt_mean:.6f} control "
          f"{jc_mean:.6f}")
    assert (len(pt), len(pc)) == (len(jt), len(jc))
    assert abs(t - jt_mean) <= MEAN_RTOL * abs(jt_mean)
    assert abs(c - jc_mean) <= MEAN_RTOL * abs(jc_mean)
    assert abs(drop - jdrop) <= DROP_ATOL_PP


def test_fig12_treats_the_numpy_draws(fig12):
    (pt, pc), _ = fig12
    rng = np.random.RandomState(0)
    treated = sum(int((rng.rand(4) < 0.5).sum()) for _ in range(3))
    assert (len(pt), len(pc)) == (treated, 12 - treated)


def test_param_count_matches_param_specs():
    from repro_torch.models import param_count
    cfg = example("train_carbon_aware").config_100m()
    jarch = jget_arch("qwen3-0.6b")
    jcfg = jarch.config.replace(
        name="qwen3-100m", num_layers=12, d_model=512, d_ff=1536,
        vocab_size=32768, dtype="float32", remat="none",
        attn=jarch.config.attn.__class__(num_heads=8, num_kv_heads=4,
                                         head_dim=64, qk_norm=True,
                                         rope_theta=1e6))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(param_specs(jcfg)))
    assert param_count(cfg) == want


def finite(x):
    return all(math.isfinite(v) for v in x)


def test_quickstart_on_cpu(capsys):
    out = example("quickstart").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert f"{'h':>3} {'carbon':>7} {'VCC':>7} {'flex':>6} {'inflex':>7}" \
        in text
    assert [h[0] for h in out["hours"]] == list(range(24))
    assert finite([v for h in out["hours"] for v in h[1:]])
    assert 1 <= out["shaped"] <= 8 and finite(
        [out["corr"], out["served"], out["arrived"]])
    assert f"cluster {out['cluster']} — hourly view" in text


def test_fleet_week_on_cpu(capsys):
    out = example("fleet_week").main(["--days", "2", "--clusters", "4",
                                      "--device", "cpu"])
    text = capsys.readouterr().out
    drop, t, c, nt, nc = parse_fig12(out["fig12"])
    assert finite([drop, t, c]) and nt + nc == 2 * 4
    assert [d["day"] for d in out["week"]] == [0, 1]
    assert all(0 <= d["shaped"] <= 4 and finite(
        [d["served"], d["carbon"], d["queue"]]) for d in out["week"])
    assert 0.0 <= out["slo_violation_rate"] <= 1.0
    assert "full-shaping week (all clusters treated):" in text
    assert "SLO violation rate:" in text


def check_rows(rows, names, columns):
    assert [r["scenario"] for r in rows] == names
    for r in rows:
        assert finite([r[k] for k in columns])
        if "flex_within_24h_pct" in columns:
            assert 0.0 <= r["flex_within_24h_pct"] <= 100.0


@pytest.fixture(scope="module")
def default_sweep(tmp_path_factory):
    """The default library's one rollout, with --telemetry --trace: the
    telemetry is bit for bit neutral, so its table is the default mode's
    (the sharded test holds that, against a run without telemetry).
    Returns the example's output and the trace's path."""
    trace = tmp_path_factory.mktemp("sweep") / "trace.jsonl"
    out = example("scenario_sweep").main(SWEEP + ["--telemetry", "--trace",
                                                  str(trace)])
    return out, trace


def test_scenario_sweep_default_on_cpu(default_sweep):
    out, _ = default_sweep
    names = [s.name for s in jscen.default_library(2)]
    check_rows(out["rows"], names, jreport.COLUMNS)


def test_scenario_sweep_sharded_equals_unsharded(default_sweep):
    out = example("scenario_sweep").main(SWEEP + ["--sharded"])
    assert out["rows"] == default_sweep[0]["rows"]


def test_scenario_sweep_risk_on_cpu():
    out = example("scenario_sweep").main(SWEEP + ["--risk"])
    names = [s.name for s in jscen.risk_sweep_library(2)]
    want = [f"K={k:<3d} {n}" for k in jscen.RISK_MEMBERS for n in names]
    check_rows(out["rows"], want, jreport.RISK_COLUMNS)


def test_scenario_sweep_spatial_on_cpu():
    out = example("scenario_sweep").main(SWEEP + ["--spatial"])
    names = [s.name for s in jscen.mobility_sweep_library(2)]
    check_rows(out["rows"], names, jreport.MOBILITY_COLUMNS)


def test_scenario_sweep_telemetry_trace_on_cpu(default_sweep):
    from repro_torch.sim import read_jsonl
    out, trace = default_sweep
    names = [s.name for s in jscen.default_library(2)]
    check_rows(out["rows"], names, jreport.COLUMNS)
    check_rows(out["telemetry_rows"], names, jreport.TELEMETRY_COLUMNS)
    back = read_jsonl(trace)
    assert len(back) == len(out["records"]) == len(names) * 1 * 2
    for got, want in zip(back, out["records"]):
        assert got.keys() == want.keys()
        assert got["scenario"] == want["scenario"]


def test_serve_shaped_on_cpu(capsys):
    from repro_torch.launch.train import CarbonGate
    res = example("serve_shaped").main(["--device", "cpu"])
    text = capsys.readouterr().out
    gate = CarbonGate()
    assert res.batches == [gate.admitted(r, 4) for r in range(4)]
    assert [tuple(t.shape) for t in res.tokens] == [(b, 17)
                                                   for b in res.batches]
    assert finite(res.prefill_ms + res.decode_ms)
    assert "admitted batch=" in text


def test_train_carbon_aware_on_cpu(tmp_path, capsys):
    from repro_torch.checkpoint import latest_step
    losses = example("train_carbon_aware").main(
        ["--steps", "3", "--batch", "2", "--seq", "32",
         "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    assert len(losses) == 3 and finite(losses) and losses[-1] < losses[0]
    assert "model: qwen3-100m, 54.5M params" in text
    assert latest_step(tmp_path) == 3


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_raise_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example(name).main([])
