"""Exit gate of the streaming + MPC slice: the port's ``rollout_batch`` on
the CPU against the live JAX ``rollout_batch`` at golden size (8 clusters,
2 campuses, 2 zones, hist_days=14), over ``forecast_bust_library(3)[:2]``
x seeds [0, 1] x 3 days, under ``streaming=True`` (the open loop) and
``streaming=True, mpc=True`` (the closed loop).

Tolerances are tests/test_torch_rollout.py's: ledger carbon, kWh, the
counterfactual, served and arrived to rtol 1e-3; queues and delayed
CPU-hours to atol 5e-2 x max|ref|. Every leaf of the streaming carry to
atol 1e-2 x its max|ref| (measured: 3.1e-3 at most, the usage ring): after
three days it holds realized hourly usage, which passes the admission
clips as the queues do. The test prints the measured gaps:

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_streaming_rollout.py

The port's own contract here: the streaming state is strictly smaller
than the rescan state (the others are in ``test_torch_streaming_batch.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.core import stats as jstats
from repro_torch import sim as tsim
from repro_torch.core import stages, stats

KW = dict(n_clusters=8, n_campuses=2, n_zones=2, pds_per_cluster=2,
          hist_days=14)
DAYS = 3
SEEDS = [0, 1]
RTOL_KEYS = ("carbon_kg", "kwh", "cf_carbon_kg", "cf_kwh", "served",
             "arrived", "cf_served")
ATOL_KEYS = ("delayed_cpu_h", "cf_delayed_cpu_h")
LOOPS = {"open": dict(streaming=True), "closed": dict(streaming=True,
                                                      mpc=True)}
CARRY_TOL = 1e-2      # the streaming carry, of max|ref| (see above)


def _leaves(tree):
    out = []
    stages.map_tensors(out.append, tree)
    return out


def gap(a, b):
    a = a.numpy().astype(np.float64) if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def runs():
    """Both packages' rollouts of the batch, for each loop, made once."""
    out = {}
    for loop, kw in LOOPS.items():
        jcfg = jsim.SimConfig(**KW, **kw)
        tcfg = tsim.SimConfig(**KW, **kw)
        jb = jsim.build_batch(jcfg, jsim.forecast_bust_library(DAYS)[:2],
                              SEEDS, DAYS)
        tb = tsim.build_batch(tcfg, tsim.forecast_bust_library(DAYS)[:2],
                              SEEDS, DAYS, device="cpu")
        out[loop] = (jsim.rollout_batch(jcfg, DAYS)(jb),
                     tsim.rollout_batch(tcfg, DAYS, device="cpu")(tb))
    return out


@pytest.mark.parametrize("loop", list(LOOPS))
def test_golden_rollout_matches_live_reference(runs, loop):
    (js, jl, jt), (ts, tl, tt) = runs[loop]
    gaps = {f"ledger_{k}": gap(getattr(tl, k), getattr(jl, k))
            for k in jl._fields}
    gaps.update({f"traj_{k}": gap(tt[k], jt[k]) for k in jt})
    gaps.update({f"state_{k}": gap(getattr(ts, k), getattr(js, k))
                 for k in ("queue", "cf_queue", "carbon_hist")})
    for (name, g), w in zip(ts.pred._asdict().items(), js.pred):
        for f, gl, wl in zip(getattr(g, "_fields", ("",)), _leaves(g),
                             jax.tree_util.tree_leaves(w)):
            gaps[f"pred_{name}{'.' + f if f else ''}"] = gap(gl, wl)
    for k, v in gaps.items():
        print(f"{loop:6s} {k:32s} {v:.3e}")

    for k in RTOL_KEYS:
        np.testing.assert_allclose(getattr(tl, k).numpy(),
                                   np.asarray(getattr(jl, k)), rtol=1e-3,
                                   err_msg=k)
    for k in ATOL_KEYS:
        ref = np.asarray(getattr(jl, k))
        np.testing.assert_allclose(getattr(tl, k).numpy(), ref, rtol=0,
                                   atol=5e-2 * np.abs(ref).max(), err_msg=k)
    for k in ("queue", "cf_queue"):
        ref = np.asarray(getattr(js, k))
        np.testing.assert_allclose(getattr(ts, k).numpy(), ref, rtol=0,
                                   atol=5e-2 * np.abs(ref).max(), err_msg=k)
    for k in ("carbon_kg", "cf_carbon_kg", "kwh"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-3, err_msg=f"traj {k}")
    np.testing.assert_allclose(ts.carbon_hist.numpy(),
                               np.asarray(js.carbon_hist), rtol=1e-3)
    assert ts.hist_uif.shape == tuple(js.hist_uif.shape)
    for name, v in gaps.items():
        if name.startswith("pred_"):
            assert v <= CARRY_TOL, (name, v)


def test_recourse_rows_match_reference(runs):
    """``mpc_recourse_rows`` of the closed against the open loop."""
    (_, jl, _), (_, tl, _) = runs["closed"]
    (_, jl_open, _), (_, tl_open, _) = runs["open"]
    names = [s.name for s in tsim.forecast_bust_library(DAYS)[:2]]
    trows = tsim.mpc_recourse_rows(tl, tl_open, names, len(SEEDS))
    jrows = jsim.mpc_recourse_rows(jl, jl_open, names, len(SEEDS))
    for tr, jr in zip(trows, jrows):
        for c in ("carbon_saved_pct", "carbon_vs_open_pct",
                  "flex24h_vs_open_pp"):
            assert abs(tr[c] - jr[c]) <= 1e-2, (tr["scenario"], c)
    assert tsim.format_table(trows, tsim.MPC_COLUMNS).splitlines()[0] \
        == jsim.format_table(jrows, jsim.MPC_COLUMNS).splitlines()[0]


def test_streaming_state_is_smaller_than_the_rescan_state(runs):
    """The streaming carry replaces the seven history windows and most of
    carbon_hist: strictly fewer bytes a rollout; the carry's bytes are the
    reference's (its leaves are float32 in both)."""
    (js, _, _), (ts, _, _) = runs["open"]
    cfg = tsim.SimConfig(**KW)
    params = tsim.build_batch(cfg, [tsim.Scenario("baseline")], [0], 1,
                              device="cpu")
    rescan = tsim.make_init(cfg, device="cpu")(params)
    B = len(SEEDS) * 2
    assert stats.predictor_nbytes(ts.pred) // B \
        < stats.replaced_hist_nbytes(rescan)
    assert tsim.state_nbytes(ts, B) < tsim.state_nbytes(rescan)
    assert stats.predictor_nbytes(ts.pred) == jstats.predictor_nbytes(
        js.pred)
