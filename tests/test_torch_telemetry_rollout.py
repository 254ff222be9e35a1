"""The telemetry record through rollouts: the port's ``make_rollout`` with
``telemetry=True`` on the CPU against the live JAX ``rollout_batch``, at 4
clusters, 2 campuses, 2 zones, hist_days=14, 2 scenarios x seeds [0, 1],
one day, on the streaming closed loop (``streaming=True, mpc=True``) and
the risk-aware joint day (``joint_spatial=True, n_members=2``). The default
day step's record against JAX, over two days, is tests/test_torch_fleet.py's
(the reference's ``fleet.day_cycle`` runs its engine's day step); each
JAX configuration costs ~12 s of XLA compilation on a CPU.

The host-reduced ``TRACE_FIELDS`` of ``telemetry_records`` are compared by
class, the tolerances of the rollout tests (tests/test_torch_rollout.py):
- rates, 1e-3 x the field's max|ref|: the objective, the U_IF
  calibration, the bisection tolerance, the CVaR tail;
- what passes the admission clips as queues do, 5e-2 x max|ref|: queue
  ages, the T_UF and T_R calibration and the drift gauge (against the
  realized, admitted flexible work and reservations, and their trailing
  week), the objective's decrease (a
  difference of near-equal sums) and the recourse depth (the suffix
  re-solves amplify a step's rounding, ROADMAP §3);
- the dual residual, a relative campus overshoot that is 0 where the
  campus duals converged: within 1e-3 absolute (the final peaks move by
  ~1e-3 with the PD fit, ROADMAP §3);
- the last round's step, a difference of two deltas: 2e-2 x max|delta| of
  the day's solution (the PD fit moves single clusters' deltas by up to
  2e-2 of max|delta| a day, ROADMAP §3);
- the conservation residual, rounding noise: below 1e-5 in both;
- the 0/1 gauges as fractions, each flip of one cluster (theta, paused,
  shaped) or one cluster-hour (U_IF quantile coverage, VCC binding,
  recourse) counted: at most 2 flips a field over the 4 records;
- ``joint_winner``: equal, except where the port's best-of margin is a tie
  (|margin| <= 1e-5), where rounding decides the call (ROADMAP §3).

The port's own contract, bit for bit: telemetry observes (the day with
telemetry on equals the day with it off, state and every output, with
each PGD epoch cut to 2 steps, ``short_epochs``; the default day's is
tests/test_torch_fleet.py's, and a batch's records equal to its rollouts'
alone tests/test_torch_telemetry.py's). ``-s`` prints the measured gaps:

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_telemetry_rollout.py
"""
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.sim import telemetry as jtel
from repro_torch import sim as tsim
from repro_torch.core import stages
from repro_torch.sim import engine
from test_torch_telemetry import short_epochs  # noqa: F401 (a fixture)

KW = dict(n_clusters=4, n_campuses=2, n_zones=2, pds_per_cluster=2,
          hist_days=14)
DAYS = 1
SEEDS = [0, 1]
PATHS = {"closed": dict(streaming=True, mpc=True),
         "slice": dict(joint_spatial=True, n_members=2)}
RATE = ("obj_first", "obj_final", "uif_mape", "uif_bias", "proj_tol_max",
        "cvar_tail_max")
ADMITTED = ("queue_age_max", "tuf_mape", "tuf_bias", "tr_mape", "tr_bias",
            "fc_level_drift", "obj_decrease_pct", "mpc_recourse_depth")
# 0/1 gauges: the number of 0/1 entries a record's value averages
GAUGES = {"theta_coverage": 1, "paused_frac": 1, "shaped_frac": 1,
          "uifq_coverage": 24, "vcc_binding_frac": 24,
          "mpc_recourse_frac": 24}
MAX_FLIPS = 2
TIE_TOL = 1e-5


def _library(m, path):
    if path == "closed":
        return m.forecast_bust_library(DAYS)[:2]
    return m.mobility_sweep_library(DAYS, (0.0, 0.3))


def _leaves(tree):
    out = []
    stages.map_tensors(out.append, tree)
    return out


@pytest.fixture(scope="module")
def runs():
    """Both packages' telemetry rollouts of each path, made once; the port's
    burned-in state, its first day and its best-of calls kept."""
    out = {}
    for path, kw in PATHS.items():
        jcfg = jsim.SimConfig(**KW, **kw, telemetry=True)
        tcfg = tsim.SimConfig(**KW, **kw, telemetry=True)
        jb = jsim.build_batch(jcfg, _library(jsim, path), SEEDS, DAYS)
        _, _, jt = jsim.rollout_batch(jcfg, DAYS)(jb)
        params = tsim.build_batch(tcfg, _library(tsim, path), SEEDS, DAYS,
                                  device="cpu")
        state0 = tsim.make_init(tcfg, device="cpu")(params)
        first, outs = {}, []

        def on_day(d, state, step_out):
            if d == 0:
                first["state"], first["out"] = state, step_out
            if step_out is not None:
                outs.append(step_out)

        got = tsim.make_rollout(tcfg, DAYS, on_day=on_day)(params, state0)
        names = [s.name for s in _library(tsim, path)]
        out[path] = dict(
            cfg=tcfg, params=params, state0=state0, got=got, first=first,
            outs=outs, names=names,
            recs=tsim.telemetry_records(got[2]["telemetry"], names,
                                        len(SEEDS)),
            jrecs=jtel.telemetry_records(jt["telemetry"], names,
                                         len(SEEDS)))
    return out


def check_trace(recs, jrecs, n, delta_max, margin, label):
    """Hold the port's trace records against the reference's by the
    classes above; ``margin``: the port's best-of margin of each record
    (-inf where no joint point was formed)."""
    assert len(recs) == len(jrecs)
    for a, b in zip(recs, jrecs):
        assert tuple(a) == tsim.TRACE_FIELDS
        assert (a["scenario"], a["seed"], a["day"]) == \
            (b["scenario"], b["seed"], b["day"])

    def col(rs, f):
        return np.asarray([x[f] for x in rs], np.float64)

    for f in tsim.TRACE_FIELDS[3:]:
        got, want = col(recs, f), col(jrecs, f)
        gap = np.abs(got - want).max()
        scale = max(np.abs(want).max(), 1e-30)
        print(f"{label:8s} {f:20s} gap {gap:.3e} of max|ref| {scale:.3e}")
        if f in RATE:
            assert gap <= 1e-3 * scale, f
        elif f in ADMITTED:
            assert gap <= 5e-2 * scale, f
        elif f == "step_final":
            assert gap <= 2e-2 * delta_max, f
        elif f == "dual_max":
            assert gap <= 1e-3, f
        elif f == "conservation_max":
            assert got.max() < 1e-5 and want.max() < 1e-5
        elif f in GAUGES:
            flips = np.rint(np.abs(got - want) * n * GAUGES[f]).sum()
            print(f"{label:8s} {f:20s} flips {int(flips)}")
            assert flips <= MAX_FLIPS, f
        else:
            assert f == "joint_winner", f
    # the best-of call: equal but where the port's margin is a tie
    differ = col(recs, "joint_winner") != col(jrecs, "joint_winner")
    print(f"{label:8s} joint_winner port {col(recs, 'joint_winner')} "
          f"reference {col(jrecs, 'joint_winner')} margins {margin}")
    assert (np.abs(margin[differ]) <= TIE_TOL).all()


@pytest.mark.parametrize("path", list(PATHS))
def test_trace_matches_live_reference(runs, path):
    r = runs[path]
    B = len(r["names"]) * len(SEEDS)
    assert len(r["recs"]) == B * DAYS
    margin = torch.stack([o.best.margin if o.best is not None
                          else torch.full((B,), -torch.inf)
                          for o in r["outs"]], 1).reshape(-1).numpy()
    delta_max = max(float(o.sol.delta.abs().max()) for o in r["outs"])
    check_trace(r["recs"], r["jrecs"], KW["n_clusters"], delta_max, margin,
                path)
    winners = np.asarray([x["joint_winner"] for x in r["recs"]])
    assert winners.any() == (path == "slice")


@pytest.mark.parametrize("path", list(PATHS))
def test_record_ranges_and_links(runs, path):
    """The gauges' ranges (as tests/test_telemetry.py holds the
    reference's); ``joint_winner`` is ``StepOut.best.take``, the recourse
    gauges ``StepOut.recourse``; the leaves are (B, days, ...)."""
    r = runs[path]
    t = r["got"][2]["telemetry"]
    B = len(r["names"]) * len(SEEDS)
    for name, leaf in t._asdict().items():
        assert leaf.shape[:2] == (B, DAYS), name
        assert torch.isfinite(leaf).all(), name
    assert t.obj_cluster_traj.shape[2:] == (20, KW["n_clusters"])
    for leaf in (t.uifq_coverage, t.vcc_binding_frac, t.theta_covered,
                 t.paused, t.shaped, t.mpc_recourse_frac):
        assert (leaf >= 0).all() and (leaf <= 1).all()
    for leaf in (t.uif_mape, t.tuf_mape, t.tr_mape, t.queue_age_days,
                 t.fc_level_drift, t.proj_nu_tol, t.dual_resid,
                 t.cvar_tail_mass, t.mpc_recourse_depth):
        assert (leaf >= 0).all()
    assert ((t.joint_winner == 0) | (t.joint_winner == 1)).all()
    for d, o in enumerate(r["outs"]):
        take = torch.zeros(B, dtype=torch.bool) if o.best is None \
            else o.best.take
        assert torch.equal(t.joint_winner[:, d], take.to(torch.float32))
        if path == "closed":
            assert torch.equal(t.mpc_recourse_frac[:, d],
                               o.recourse.recourse_frac)
            assert torch.equal(t.mpc_recourse_depth[:, d],
                               o.recourse.recourse_depth)
        else:
            assert not t.mpc_recourse_frac[:, d].any()
    if path == "slice":     # the CVaR tail over 2 members lies in [1/2, 1]
        assert (t.cvar_tail_mass >= 0.5 - 1e-6).all()
    else:
        assert (t.cvar_tail_mass == 1).all()


@pytest.mark.parametrize("path", list(PATHS))
def test_telemetry_on_equals_off(runs, path, short_epochs):
    """The first day from the same burned-in state with telemetry on and
    off: the new state and every output but the record, bit for bit."""
    import dataclasses
    r = runs[path]
    xs = engine.day_xs(r["params"], 0)
    days = {}
    for tel in (True, False):
        cfg = dataclasses.replace(r["cfg"], telemetry=tel)
        days[tel] = tsim.make_day_step(cfg)(r["params"], r["state0"], xs)
    (new, out), (on_state, on_out) = days[False], days[True]
    assert out.telemetry is None and on_out.telemetry is not None
    got = _leaves((new, out))
    want = _leaves((on_state, on_out._replace(telemetry=None)))
    assert len(got) == len(want) > 20
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for field in stages.StepOut._fields:
        assert (getattr(out, field) is None) == \
            (getattr(on_out, field) is None or field == "telemetry"), field
