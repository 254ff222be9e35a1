"""The telemetry layer's pieces, the port against the JAX package
(``repro.sim.telemetry``, ``repro.core.vcc`` / ``spatial`` with
``telemetry=True``), on the CPU.

Tolerances:
- the four primitives on seeded inputs: 1e-6 relative (the same float32
  arithmetic; XLA may fuse a division into a multiply);
- ``solve_vcc(telemetry=True)`` on the synthetic problem, K = 1 at
  contended campus limits (the duals move) and K = 4 at uncontended ones
  (as test_torch_risk holds the ensemble solve: at contended limits a
  1e-7 relative change of pow_nom moves the K = 4 solution's delta by
  ~0.45 in either package, ROADMAP §3); no PD fit here, so tight: the
  objective trajectory and
  the bisection tolerance (a bracket width over delta's range) rtol 1e-4,
  the solve's own (test_torch_risk), the step trajectory atol 2e-4 (a
  difference of two deltas, each within ``solve_vcc``'s 1e-4 of
  test_torch_solver_vcc), the dual residual atol 1e-4, the conservation
  residual below 1e-5 in both, the CVaR tail mass rtol 1e-4; the solution
  is the ``telemetry=False`` solution bit for bit;
- ``solve_joint(telemetry=True)`` at mobility 0.3: ``joint_winner``
  exactly, the channels as above;
- the host functions (``telemetry_records``, JSONL, ``telemetry_rows``,
  ``format_table``) given the same records: equal output, exactly.

The port's own contract: a batch's telemetry rollout equals its rollouts
run alone (``rollout_sequential``), bit for bit. That test and the stage
profiler's run the day with each PGD epoch cut to 2 steps (``short_epochs``:
neither batching nor the span-based stage rows depend on the step count;
the full day takes ~4 s a call on a CPU).

``-s`` prints the measured gaps:

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_telemetry.py
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.core import risk as jrisk
from repro.core import spatial as jspatial
from repro.core import vcc as jvcc
from repro.sim import telemetry as jtel
from repro_torch import convert
from repro_torch import sim as tsim
from repro_torch.core import risk, solver, spatial, stages, vcc
from repro_torch.sim import telemetry as tel

H = 24
CHANNELS = ("obj_cluster_traj", "step_max_traj", "conservation_resid",
            "proj_nu_tol", "dual_resid", "cvar_tail_mass")


def _gap(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max())


# --------------------------------------------------------------- primitives

def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    actual = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    pred = (actual * rng.uniform(0.8, 1.2, shape)).astype(np.float32)
    pred.flat[::7] = actual.flat[::7]        # some exact forecasts
    return pred, actual


@pytest.mark.parametrize("name", ("mape", "bias", "coverage"))
@pytest.mark.parametrize("shape", ((6,), (6, H)))
def test_primitive_matches_reference(name, shape):
    """One cluster axis (per-element) and an hour axis (the ordered
    mean), unbatched; then a batch of 3 with ``batch_dims=1`` equals the
    reference on each rollout."""
    pred, actual = _inputs(len(shape), (3,) + shape)
    fn, jfn = getattr(tel, name), getattr(jtel, name)
    got = fn(torch.as_tensor(pred[0]), torch.as_tensor(actual[0])).numpy()
    want = np.asarray(jfn(jnp.asarray(pred[0]), jnp.asarray(actual[0])))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    both = fn(torch.as_tensor(pred), torch.as_tensor(actual), batch_dims=1)
    for b in range(3):
        alone = fn(torch.as_tensor(pred[b]), torch.as_tensor(actual[b]))
        assert torch.equal(both[b], alone)
        np.testing.assert_allclose(
            both[b].numpy(), np.asarray(jfn(jnp.asarray(pred[b]),
                                            jnp.asarray(actual[b]))),
            rtol=1e-6, atol=0)
    if name != "coverage":           # a zero-error forecast gives exactly 0
        zero = fn(torch.as_tensor(actual[0]), torch.as_tensor(actual[0]))
        assert not zero.any()


def test_level_drift_matches_reference():
    rng = np.random.default_rng(4)
    level = rng.uniform(5.0, 9.0, (3, 6)).astype(np.float32)
    trail = rng.uniform(5.0, 9.0, (3, 6, 7)).astype(np.float32)
    got = tel.level_drift(torch.as_tensor(level), torch.as_tensor(trail))
    for b in range(3):
        want = np.asarray(jtel.level_drift(jnp.asarray(level[b]),
                                           jnp.asarray(trail[b])))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-6, atol=0)
    # at the trailing mean the drift is 0 (up to the mean's rounding)
    at_mean = tel.level_drift(torch.as_tensor(trail).mean(-1),
                              torch.as_tensor(trail))
    assert float(at_mean.max()) < 1e-6


# ------------------------------------------------------- solver diagnostics

def _problem(jp):
    return convert.problem_from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}, "cpu")


def _members(jp, K, seed=0, vol=0.5):
    """K whole-day intensity members around the point forecast (member 0
    the forecast itself) and per-member load noise."""
    rng = np.random.default_rng(seed)
    prof = (1.0 + vol * rng.normal(size=(K, 1, H))).astype(np.float32)
    prof[0] = 1.0
    eta_ens = np.clip(np.asarray(jp.eta)[None] * prof, 1e-4, None)
    uif = np.asarray(jp.u_if)
    uif_ens = (uif[None] * (1 + 0.1 * rng.normal(size=(K,) + uif.shape))
               ).astype(np.float32)
    uif_ens[0] = uif
    return eta_ens.astype(np.float32), uif_ens


def _close_channels(diag, jdiag, label):
    gaps = {k: _gap(diag[k].numpy(), jdiag[k]) for k in CHANNELS}
    print(label, " ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    for k in CHANNELS:
        assert diag[k].shape == tuple(jdiag[k].shape), k
    np.testing.assert_allclose(diag["obj_cluster_traj"].numpy(),
                               np.asarray(jdiag["obj_cluster_traj"]),
                               rtol=1e-4)
    np.testing.assert_allclose(diag["proj_nu_tol"].numpy(),
                               np.asarray(jdiag["proj_nu_tol"]), rtol=1e-4)
    np.testing.assert_allclose(diag["step_max_traj"].numpy(),
                               np.asarray(jdiag["step_max_traj"]), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(diag["dual_resid"].numpy(),
                               np.asarray(jdiag["dual_resid"]), rtol=0,
                               atol=1e-4)
    assert float(diag["conservation_resid"].max()) < 1e-5
    assert float(np.asarray(jdiag["conservation_resid"]).max()) < 1e-5
    np.testing.assert_allclose(diag["cvar_tail_mass"].numpy(),
                               np.asarray(jdiag["cvar_tail_mass"]),
                               rtol=1e-4)


@pytest.mark.parametrize("K", (1, 4))
def test_solve_vcc_telemetry_matches_reference(K):
    """K = 1 at contended campus limits (the duals and the dual residual
    move); K = 4 forecast members at uncontended ones."""
    jp = jvcc.synthetic_problem(n=10, seed=11, n_campuses=3)
    if K == 1:
        jp = dataclasses.replace(jp, campus_limit=jnp.full((3,), 1800.0))
    p = _problem(jp)
    if K > 1:
        eta_ens, uif_ens = _members(jp, K)
        jp = jrisk.attach_ensemble(jp, jnp.asarray(eta_ens),
                                   jnp.asarray(uif_ens), 0.5)
        p = risk.attach_ensemble(p, torch.as_tensor(eta_ens),
                                 torch.as_tensor(uif_ens), 0.5)
    kw = dict(outer_iters=8, inner_iters=40)
    jsol, jdiag = jvcc.solve_vcc(jp, use_pallas=False, telemetry=True, **kw)
    sol, diag = vcc.solve_vcc(p, device="cpu", telemetry=True, **kw)
    plain = vcc.solve_vcc(p, device="cpu", **kw)
    for f in ("delta", "y", "vcc", "shaped", "mu", "objective"):
        assert torch.equal(getattr(sol, f), getattr(plain, f)), f
    assert diag["obj_cluster_traj"].shape == (8, 10)
    assert (float(diag["dual_resid"].max()) > 0) == (K == 1)
    if K > 1:
        tail = diag["cvar_tail_mass"]
        assert float(tail.min()) >= 1.0 / K - 1e-6 and float(tail.max()) <= 1
    else:
        assert torch.equal(diag["cvar_tail_mass"], torch.ones(10))
    _close_channels(diag, jdiag, f"K={K}")


def test_contended_ensemble_solve_is_rounding_sensitive_in_both_packages():
    """Why K = 4 is held at uncontended limits: at contended ones the two
    packages' solutions lie more than 10x the solve's 1e-4 apart (8
    rounds x 40 steps), and a 1e-7 relative change of pow_nom moves each
    package's own solution at least half as far."""
    jp = dataclasses.replace(jvcc.synthetic_problem(n=10, seed=11,
                                                    n_campuses=3),
                             campus_limit=jnp.full((3,), 1800.0))
    eta_ens, uif_ens = _members(jp, 4)
    jq = jrisk.attach_ensemble(jp, jnp.asarray(eta_ens),
                               jnp.asarray(uif_ens), 0.5)
    tq = risk.attach_ensemble(_problem(jp), torch.as_tensor(eta_ens),
                              torch.as_tensor(uif_ens), 0.5)
    kw = dict(outer_iters=8, inner_iters=40)
    want = np.asarray(jvcc.solve_vcc(jq, use_pallas=False, **kw).delta)
    got = vcc.solve_vcc(tq, device="cpu", **kw).delta.numpy()
    moved = vcc.solve_vcc(dataclasses.replace(
        tq, pow_nom=tq.pow_nom * (1 + 1e-7)), device="cpu", **kw).delta
    jmoved = jvcc.solve_vcc(dataclasses.replace(
        jq, pow_nom=jq.pow_nom * (1 + 1e-7)), use_pallas=False, **kw).delta
    between = _gap(got, want)
    port_moved, ref_moved = _gap(moved.numpy(), got), _gap(jmoved, want)
    print(f"contended K = 4: port vs reference {between:.3e}; pow_nom x "
          f"(1 + 1e-7) moves the port {port_moved:.3e}, the reference "
          f"{ref_moved:.3e}")
    assert between > 1e-3
    assert min(port_moved, ref_moved) > 0.5 * between


def test_solve_vcc_telemetry_batch_equals_each_problem():
    """A batch of two problems: the channels, with the rounds axis after
    the batch axis, equal each problem's alone bit for bit."""
    probs = [_problem(dataclasses.replace(
        jvcc.synthetic_problem(n=6, seed=s, n_campuses=2),
        campus_limit=jnp.full((2,), 1500.0))) for s in (1, 2)]
    batch = vcc.VCCProblem(**{
        f: torch.stack([getattr(q, f) for q in probs])
        for f in vcc.VCCProblem.__dataclass_fields__
        if f not in ("drop_limit", *convert.ENSEMBLE)},
        drop_limit=probs[0].drop_limit)
    kw = dict(outer_iters=3, inner_iters=10, device="cpu", telemetry=True)
    _, both = vcc.solve_vcc(batch, **kw)
    assert both["obj_cluster_traj"].shape == (2, 3, 6)
    for b, q in enumerate(probs):
        _, alone = vcc.solve_vcc(q, **kw)
        for k in CHANNELS:
            assert torch.equal(both[k][b], alone[k]), k


def test_solve_joint_telemetry_matches_reference():
    """Mobility 0.3 on the zonal problem: the call, the warm start's
    trajectories and the final point's residuals; the solution is the
    ``telemetry=False`` one bit for bit. The mobility-0 shortcut reports
    a 0.0 call."""
    jp = jvcc.synthetic_zonal_problem(n=8, seed=3)
    p = _problem(jp)
    kw = dict(outer_iters=6, inner_iters=40, joint_outer=3)
    jsol, jtau, js, jdiag = jspatial.solve_joint(jp, 0.3, use_pallas=False,
                                                 telemetry=True, **kw)
    sol, tau, s, best, diag = spatial.solve_joint(p, 0.3, device="cpu",
                                                  telemetry=True, **kw)
    plain = spatial.solve_joint(p, 0.3, device="cpu", **kw)
    for f in ("delta", "y", "vcc", "mu", "objective"):
        assert torch.equal(getattr(sol, f), getattr(plain[0], f)), f
    assert torch.equal(s, plain[2]) and torch.equal(best.take, plain[3].take)
    print("joint_winner port", diag["joint_winner"].item(), "reference",
          float(jdiag["joint_winner"]))
    assert diag["joint_winner"].dtype == torch.float32
    assert diag["joint_winner"].item() == float(jdiag["joint_winner"])
    assert diag["joint_winner"].item() == float(best.take)
    _close_channels(diag, jdiag, "joint 0.3")
    *_, diag0 = spatial.solve_joint(p, 0.0, device="cpu", telemetry=True,
                                    outer_iters=2, inner_iters=5)
    assert diag0["joint_winner"].item() == 0.0
    assert set(diag0) == set(diag) == set(jdiag)


# ------------------------------------------------------------ host export

def _random_record(B, days, n=5, m=2, T=4, seed=0):
    """A stacked record (B, days, ...) of seeded values: the same arrays
    for both packages."""
    rng = np.random.default_rng(seed)
    shapes = {"obj_cluster_traj": (T, n), "step_max_traj": (T, n),
              "dual_resid": (m,), "joint_winner": ()}
    leaves = {}
    for f in tel.DayTelemetry._fields:
        x = rng.uniform(0.0, 2.0, (B, days) + shapes.get(f, (n,)))
        if f in ("paused", "shaped", "theta_covered", "joint_winner"):
            x = (x > 1.0)
        leaves[f] = x.astype(np.float32)
    return leaves


def test_trace_export_matches_reference(tmp_path):
    names, seeds, days = ["alpha", "beta_scenario"], 2, 3
    leaves = _random_record(len(names) * seeds, days)
    recs = tsim.telemetry_records(
        tel.DayTelemetry(**{k: torch.as_tensor(v) for k, v in
                            leaves.items()}), names, seeds)
    jrecs = jtel.telemetry_records(
        jtel.DayTelemetry(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        names, seeds)
    assert recs == jrecs
    assert len(recs) == len(names) * seeds * days
    assert all(tuple(r) == tsim.TRACE_FIELDS for r in recs)
    assert tsim.TRACE_FIELDS == jtel.TRACE_FIELDS
    assert tel.DayTelemetry._fields == jtel.DayTelemetry._fields
    path, jpath = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    tsim.write_jsonl(path, recs)
    jtel.write_jsonl(jpath, jrecs)
    assert path.read_text() == jpath.read_text()
    back = tsim.read_jsonl(path)
    assert back == json.loads(json.dumps(recs)) == jtel.read_jsonl(jpath)
    rows = tsim.telemetry_rows(back)
    assert rows == jsim.telemetry_rows(back)
    assert rows[0]["n_records"] == seeds * days
    assert tsim.telemetry_rows(back, ["beta_scenario", "missing"]) == \
        jsim.telemetry_rows(back, ["beta_scenario", "missing"])
    assert tsim.TELEMETRY_COLUMNS == jsim.TELEMETRY_COLUMNS
    table = tsim.format_table(rows, tsim.TELEMETRY_COLUMNS)
    assert table == jsim.format_table(rows, jsim.TELEMETRY_COLUMNS)
    assert "thetaCov" in table and "vccBind" in table
    with pytest.raises(ValueError):
        tsim.telemetry_records(tel.DayTelemetry(**{
            k: torch.as_tensor(v) for k, v in leaves.items()}), names[:1],
            seeds)


# ---------------------------------------------- rollouts, stage profiler

@pytest.fixture
def short_epochs(monkeypatch):
    """Every PGD epoch of the day cut to 2 steps."""
    epochs = solver.pgd_epochs

    def short(prob, delta, mu, lo, ub, lr_eff, temp, iters):
        return epochs(prob, delta, mu, lo, ub, lr_eff, temp, min(iters, 2))

    monkeypatch.setattr(solver, "pgd_epochs", short)


@pytest.mark.parametrize("kw", (dict(), dict(streaming=True, mpc=True)),
                         ids=("default", "closed"))
def test_batched_telemetry_equals_per_rollout(short_epochs, kw):
    """A batch of three rollouts over two days against each driven alone:
    state, ledger and traj, the records included, bit for bit."""
    cfg = tsim.SimConfig(n_clusters=4, n_campuses=2, n_zones=2,
                         hist_days=10, telemetry=True, **kw)
    lib = tsim.default_library(2)[:3] if not kw \
        else tsim.forecast_bust_library(2)
    params = tsim.build_batch(cfg, lib, [5], 2, device="cpu")
    got = tsim.rollout_batch(cfg, 2, device="cpu")(params)
    want = tsim.rollout_sequential(cfg, 2, params, device="cpu")
    assert set(got[2]) == set(want[2]) == {
        "carbon_kg", "cf_carbon_kg", "kwh", "peak_kw", "queue", "telemetry"}
    assert got[2]["telemetry"].uif_mape.shape == (3, 2, 4)
    a_all, b_all = [], []
    stages.map_tensors(a_all.append, got)
    stages.map_tensors(b_all.append, want)
    assert len(a_all) == len(b_all)
    for a, b in zip(a_all, b_all):
        assert torch.equal(a, b)


def test_profile_stages_rows_on_the_cpu(short_epochs):
    """The span-based rows of one real paper day: the day's row first at
    100%, then each stage span under it and the optimize stage's problem,
    shift, solve and rounds; the stage shares and the day's self share sum
    to 100%; no launches of kernels #1-#3 on the CPU; the table renders."""
    cfg = tsim.SimConfig(n_clusters=4, n_campuses=2, n_zones=2,
                         hist_days=14)
    params = tsim.build_batch(cfg, tsim.default_library(2)[:1], [0], 2,
                              device="cpu")
    state = tsim.make_init(cfg, device="cpu")(params)
    rows = tsim.profile_stages(cfg.stage_config(), params, state)
    assert [r["stage"] for r in rows] == [
        "day", "power", "forecast", "carbon", "optimize", "problem",
        "shift", "solve_vcc", "round", "observe", "slo", "carry"]
    assert rows[8]["path"] == "day/optimize/solve_vcc/round"
    for r in rows:
        assert {"path", "stage", "depth", "calls", "host_ms", "self_ms",
                "pct", "launches", "sizes", "rounds", "steps",
                "builds"} == set(r)
        assert r["host_ms"] > 0.0 and 0.0 <= r["self_ms"] <= r["host_ms"]
        assert r["launches"] == (0, 0, 0, 0) and r["sizes"] == {}
    by = {r["stage"]: r for r in rows}
    assert by["round"]["calls"] == 20 and by["solve_vcc"]["rounds"] == 20
    assert by["solve_vcc"]["steps"] == 20 * 2
    stage_pct = sum(r["pct"] for r in rows if r["depth"] == 1) \
        + 100.0 * by["day"]["self_ms"] / by["day"]["host_ms"]
    assert abs(stage_pct - 100.0) < 1e-6
    table = tsim.format_stage_table(rows)
    assert "optimize" in table and "host_ms" in table
    assert "#1/#2/#3/sp" in table
    print(table)


def test_profile_stages_reads_the_streaming_forecast(monkeypatch,
                                                     short_epochs):
    """A streaming state's day runs ``forecast_stage_streaming`` inside
    its ``forecast`` span (the rescan windows are zero-length stubs there;
    the rescan forecast is not called)."""
    cfg = tsim.SimConfig(n_clusters=3, n_campuses=1, n_zones=1,
                         hist_days=8, streaming=True)
    params = tsim.build_batch(cfg, [tsim.Scenario("baseline")], [1], 1,
                              device="cpu")
    state = tsim.make_init(cfg, device="cpu")(params)
    called = []
    streaming = stages.forecast_stage_streaming

    def spy(pred, day, gamma):
        called.append(day)
        return streaming(pred, day, gamma)

    def rescan(*args):
        raise AssertionError("the rescan forecast ran on a streaming state")

    monkeypatch.setattr(stages, "forecast_stage_streaming", spy)
    monkeypatch.setattr(stages, "forecast_stage", rescan)
    rows = tsim.profile_stages(cfg.stage_config(), params, state)
    assert [r["stage"] for r in rows][:3] == ["day", "power", "forecast"]
    assert len(called) == 1 and called[0] is state.day
    assert rows[2]["calls"] == 1 and rows[2]["host_ms"] > 0.0
