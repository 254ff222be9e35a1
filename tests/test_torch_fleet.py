"""The legacy fleet API (``core/fleet.py``) of the port, with telemetry.

* Against the live JAX ``repro.core.fleet``: ``init_fleet`` and two
  ``day_cycle``s with ``FleetConfig(telemetry=True)`` at 4 clusters, 2
  campuses, 2 zones, hist_days=14, at the rollout tests' tolerances
  (tests/test_torch_rollout.py): the burned-in windows and campus limits
  rtol 1e-3 of max|ref|, the queues and the histories of realized usage
  atol 5e-2 x max|ref|, the day's carbon and kWh totals rtol 1e-3; the
  record's trace line by tests/test_torch_telemetry_rollout.py's classes
  (the default day step's telemetry against JAX). ``_observe_day`` (the
  custom day loops' day: power fit, carbon, admission, rolled windows) on
  the burned-in fleet: the day's totals and windows rtol 1e-3, its
  intensity 1e-5 x max|ref|.
* Against the port's engine, bit for bit: ``init_fleet`` is the engine's
  burn-in of the same fleet, and a ``day_cycle`` is the engine's day step
  from the same state (rescan and streaming), as tests/test_stages_parity.py
  and tests/test_streaming.py hold the reference's; the same day with
  telemetry off equals it but for the record; the adapters of custom day
  loops (``make_power_fn``, ``day_forecasts``, ``carbon_forecast_next``,
  ``build_problem``) rebuild the day's forecasts and problem. (The eager
  JAX adapters take ~5 s each on a CPU, so only ``_observe_day`` is held
  against them.)

``-s`` prints the measured gaps:

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_fleet.py
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import fleet as jfleet
from repro.sim import telemetry as jtel
from repro_torch import sim as tsim
from repro_torch.core import fleet, stages
from repro_torch.sim import engine
from test_torch_telemetry_rollout import check_trace

KW = dict(n_clusters=4, n_campuses=2, n_zones=2, pds_per_cluster=2,
          hist_days=14)
RECORD_KEYS = {"fc", "sol", "vcc", "result", "cf_result", "intensity",
               "problem", "telemetry"}
WINDOWS = ("hist_uif", "hist_flex_daily", "hist_res_daily", "hist_tr_pred",
           "hist_uif_pred", "carbon_hist", "campus_limit")
REALIZED = ("queue", "cf_queue", "hist_usage", "hist_res")


def _gap(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _leaves(tree):
    out = []
    stages.map_tensors(out.append, tree)
    return out


def _stacked(record):
    """A day's unbatched JAX record as a (1, 1, ...) rollout trace."""
    return jax.tree.map(lambda x: np.asarray(x)[None, None], record)


@pytest.fixture(scope="module")
def jax_fleet():
    state = jfleet.init_fleet(jfleet.FleetConfig(**KW, telemetry=True))
    init = dataclasses.replace(state)
    records = []
    for _ in range(2):
        rec = {}
        state = jfleet.day_cycle(state, rec)
        records.append(rec)
    return init, state, records


@pytest.fixture(scope="module")
def port_fleet():
    cfg = fleet.FleetConfig(**KW, telemetry=True)
    state = fleet.init_fleet(cfg, device="cpu")
    init = dataclasses.replace(state)
    records = []
    for _ in range(2):
        rec = {}
        state = fleet.day_cycle(state, rec)
        records.append(rec)
    return init, state, records


def _engine(streaming=False, telemetry=True):
    """The engine's side: the same fleet as a one-rollout batch of a
    scenario with the FleetConfig's prices, and its burned-in state."""
    cfg = tsim.SimConfig(**KW, streaming=streaming, telemetry=telemetry)
    params = tsim.build_batch(
        cfg, [tsim.Scenario("fleet_parity", lambda_e=0.08, lambda_p=0.05,
                            gamma=0.05)], [0], 2, device="cpu")
    return cfg, params, tsim.make_init(cfg, device="cpu")(params)


def test_fleet_matches_live_reference(jax_fleet, port_fleet):
    (jinit, js, jrecs), (tinit, ts, trecs) = jax_fleet, port_fleet
    assert ts.day == js.day == KW["hist_days"] + 2
    for when, t, j in (("init", tinit, jinit), ("day 2", ts, js)):
        for k in WINDOWS + REALIZED:
            want = np.asarray(getattr(j, k))
            got = getattr(t, k).numpy()
            assert got.shape == want.shape, k
            print(f"{when:6s} {k:16s} {_gap(got, want):.3e}")
            tol = 1e-3 if k in WINDOWS else 5e-2
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(
                np.abs(want).max(), 1e-30), err_msg=f"{when} {k}")
    names = ["fleet"]
    for d, (trec, jrec) in enumerate(zip(trecs, jrecs)):
        assert set(trec) == set(jrec) == RECORD_KEYS
        for k in ("carbon", "power"):
            np.testing.assert_allclose(
                stages.hour_sum(getattr(trec["result"], k)).numpy(),
                np.asarray(getattr(jrec["result"], k)).sum(-1), rtol=1e-3,
                err_msg=f"day {d} {k}")
        recs = tsim.telemetry_records(tsim.DayTelemetry(
            *(x[None, None] for x in trec["telemetry"])), names, 1)
        jrecs_d = jtel.telemetry_records(_stacked(jrec["telemetry"]), names,
                                         1)
        check_trace(recs, jrecs_d, KW["n_clusters"],
                    float(trec["sol"].delta.abs().max()),
                    np.asarray([-np.inf]), f"day {d}")


def test_observe_day_matches_live_reference(jax_fleet, port_fleet):
    """One observed day (``_observe_day``, a treated half of the clusters
    under a VCC) on the burned-in fleets."""
    js, ts = dataclasses.replace(jax_fleet[0]), dataclasses.replace(
        port_fleet[0])
    mask = torch.tensor([True, False, True, False])
    curve = ts.capacity[:, None] * torch.linspace(0.8, 1.2, 24)
    day = ts.day
    ts, res, inten = fleet._observe_day(ts, day, True, vcc_curve=curve,
                                        treat_mask=mask, collect=True)
    js, jres, jinten = jfleet._observe_day(
        js, day, True, vcc_curve=np.asarray(curve), treat_mask=mask.numpy(),
        collect=True)
    assert ts.day == js.day == day + 1
    np.testing.assert_allclose(inten.numpy(), np.asarray(jinten), rtol=0,
                               atol=1e-5 * float(np.abs(jinten).max()))
    for k in ("carbon", "power", "reservations"):
        got = stages.hour_sum(getattr(res, k)).numpy()
        want = np.asarray(getattr(jres, k)).sum(-1)
        print(f"_observe_day {k:14s} {_gap(got, want):.3e}")
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=k)
    for k in ("hist_uif", "carbon_hist", "hist_res_daily", "hist_usage"):
        want = np.asarray(getattr(js, k))
        np.testing.assert_allclose(getattr(ts, k).numpy(), want, rtol=0,
                                   atol=1e-3 * float(np.abs(want).max()),
                                   err_msg=k)
    np.testing.assert_allclose(ts.queue.numpy(), np.asarray(js.queue),
                               rtol=0, atol=5e-2 * float(np.abs(
                                   np.asarray(js.queue)).max()))


def test_stage_adapters_rebuild_the_day(port_fleet):
    """On the burned-in fleet, the adapters give the day cycle's own
    forecasts, intensity and problem, bit for bit (mobility 0 leaves the
    budgets as they are)."""
    ts, rec = dataclasses.replace(port_fleet[0]), port_fleet[2][0]
    pf, sf, _ = fleet.make_power_fn(ts)
    fc = fleet.day_forecasts(ts)
    for k in rec["fc"]:
        assert torch.equal(fc[k], rec["fc"][k]), k
    act, fcz, eta_act, eta_fc = fleet.carbon_forecast_next(ts, ts.day)
    assert torch.equal(eta_act, rec["intensity"])
    p = fleet.build_problem(ts, fc, eta_fc, pf, sf)
    for f in dataclasses.fields(p):
        a, b = getattr(p, f.name), getattr(rec["problem"], f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), f.name
    assert act.shape == fcz.shape == (KW["n_zones"], 24)


def _same_day(rec, out, label):
    """A day_cycle's record against the engine's StepOut, bit for bit."""
    want = _leaves((out.fc, out.sol.__dict__, out.vcc_curve,
                    out.res.__dict__, out.cf.__dict__, out.eta_act,
                    out.telemetry))
    got = _leaves((rec["fc"], rec["sol"].__dict__, rec["vcc"],
                   rec["result"].__dict__, rec["cf_result"].__dict__,
                   rec["intensity"], rec["telemetry"]))
    assert len(got) == len(want) > 30, label
    for a, b in zip(got, want):
        assert torch.equal(a, b[0]), label


def test_day_cycle_is_the_engine_day_step(port_fleet):
    """The fleet's burn-in and first day are the engine's, bit for bit
    (record and state); the engine's day with telemetry off equals it but
    for the record."""
    tinit, _, trecs = port_fleet
    cfg, params, state = _engine()
    for k in WINDOWS + REALIZED:
        assert torch.equal(getattr(tinit, k), getattr(state, k)[0]), k
    new, out = tsim.make_day_step(cfg)(params, state,
                                       engine.day_xs(params, 0))
    _same_day(trecs[0], out, "day 0")
    off = dataclasses.replace(cfg, telemetry=False)
    new_off, out_off = tsim.make_day_step(off)(params, state,
                                               engine.day_xs(params, 0))
    assert out_off.telemetry is None
    for a, b in zip(_leaves((new_off, out_off)),
                    _leaves((new, out._replace(telemetry=None)))):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def streaming_fleet():
    cfg = fleet.FleetConfig(**KW, streaming=True, telemetry=True)
    return fleet.init_fleet(cfg, device="cpu")


def test_streaming_day_cycle_is_the_engine_day_step(streaming_fleet):
    st = dataclasses.replace(streaming_fleet)
    cfg, params, state = _engine(streaming=True)
    assert st.pred is not None and st.hist_uif.shape[1] == 0
    for a, b in zip(_leaves(st.pred), _leaves(state.pred)):
        assert torch.equal(a, b[0])
    rec = {}
    st = fleet.day_cycle(st, rec)
    new, out = tsim.make_day_step(cfg)(params, state,
                                       engine.day_xs(params, 0))
    _same_day(rec, out, "streaming day 0")
    for a, b in zip(_leaves(st.pred), _leaves(new.pred)):
        assert torch.equal(a, b[0])
    assert torch.equal(st.queue, new.queue[0])
    assert st.day == int(new.day[0])


def test_observe_day_refuses_a_streaming_fleet(streaming_fleet):
    """As the reference's: custom day loops roll the rescan windows."""
    with pytest.raises(NotImplementedError, match="rescan"):
        fleet._observe_day(streaming_fleet, streaming_fleet.day, True)


def test_record_keys_and_shapes(port_fleet):
    """The record's keys are the reference's; its products are one
    fleet's, unbatched, and the telemetry record a day's (n, ...)."""
    _, ts, trecs = port_fleet
    rec = trecs[-1]
    assert set(rec) == RECORD_KEYS
    n = KW["n_clusters"]
    assert rec["vcc"].shape == (n, 24) and rec["sol"].delta.shape == (n, 24)
    assert rec["result"].carbon.shape == (n, 24)
    assert rec["problem"].tau.shape == (n,) and rec["fc"]["tuf"].shape == (n,)
    t = rec["telemetry"]
    assert t.obj_cluster_traj.shape == (20, n)
    assert t.dual_resid.shape == (KW["n_campuses"],)
    assert t.joint_winner.shape == () and float(t.joint_winner) == 0.0
    assert ts.queue.shape == (n,) and ts.hist_uif.shape == (n, 14, 24)
    assert isinstance(ts.day, int)


def test_init_fleet_defaults_to_cuda():
    """An entry point: the card unless ``device="cpu"``; without one it
    raises, never falling back."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.init_fleet(fleet.FleetConfig(n_clusters=3, n_campuses=1,
                                           n_zones=1, hist_days=8))
