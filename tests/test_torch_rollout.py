"""Exit gate of the paper-mode slice: the port's ``rollout_batch`` on the
CPU against the live JAX ``rollout_batch``, in the golden configuration of
tests/test_golden_trace.py (8 clusters, 2 campuses, 2 zones, hist_days=14;
2 scenarios x 2 seeds x 3 days).

Tolerances: ledger carbon, kWh and the counterfactual, served and arrived
to rtol 1e-3; queues and delayed CPU-hours to atol 5e-2 x max|ref|.
Admission clips and SLO thresholds amplify float32 rounding (the
reference itself moves by ~1e-4, 1e-2 and 4e-2 on these between jax
versions). The test prints the measured gaps:

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_rollout.py
"""
import numpy as np

from repro import sim as jsim
from repro_torch import sim as tsim

KW = dict(n_clusters=8, n_campuses=2, n_zones=2, pds_per_cluster=2,
          hist_days=14)
DAYS = 3
SEEDS = [0, 1]
RTOL_KEYS = ("carbon_kg", "kwh", "cf_carbon_kg", "cf_kwh", "served",
             "arrived", "cf_served")
ATOL_KEYS = ("delayed_cpu_h", "cf_delayed_cpu_h")


def _scenarios(m):
    return [m.Scenario("baseline", "nominal grid, nominal fleet"),
            m.Scenario("high_carbon_price", "lambda_e x4", lambda_e=2.0)]


def rollouts():
    jcfg, tcfg = jsim.SimConfig(**KW), tsim.SimConfig(**KW)
    jb = jsim.build_batch(jcfg, _scenarios(jsim), SEEDS, DAYS)
    want = jsim.rollout_batch(jcfg, DAYS)(jb)
    tb = tsim.build_batch(tcfg, _scenarios(tsim), SEEDS, DAYS, device="cpu")
    got = tsim.rollout_batch(tcfg, DAYS, device="cpu")(tb)
    return got, want


def gaps(got, want):
    """Largest |port - reference| over the largest |reference|, per key."""
    (ts, tl, tt), (js, jl, jt) = got, want
    pairs = {f"ledger_{k}": (getattr(tl, k), getattr(jl, k))
             for k in jl._fields}
    pairs.update({f"traj_{k}": (tt[k], jt[k]) for k in jt})
    pairs.update({f"state_{k}": (getattr(ts, k), getattr(js, k))
                  for k in ("queue", "cf_queue", "hist_flex_daily",
                            "hist_res_daily", "carbon_hist")})
    out = {}
    for k, (a, b) in pairs.items():
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        out[k] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    return out


def test_golden_rollout_matches_live_reference():
    got, want = rollouts()
    for key, gap in gaps(got, want).items():
        print(f"{key:28s} {gap:.3e}")
    (ts, tl, tt), (js, jl, jt) = got, want
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
    np.testing.assert_allclose(tt["queue"].numpy(), np.asarray(jt["queue"]),
                               rtol=0, atol=5e-2 * np.abs(jt["queue"]).max())
    for k in ("carbon_kg", "cf_carbon_kg", "kwh"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-3, err_msg=f"traj {k}")
    # the per-scenario report rows agree too
    names = [s.name for s in _scenarios(tsim)]
    trows = tsim.scenario_rows(tl, names, len(SEEDS))
    jrows = jsim.scenario_rows(jl, names, len(SEEDS))
    for tr, jr in zip(trows, jrows):
        for c in ("carbon_saved_pct", "kwh_saved_pct", "peak_reduction_pct"):
            assert abs(tr[c] - jr[c]) <= 1e-2, (tr["scenario"], c)
    assert tsim.format_table(trows).splitlines()[0] == \
        jsim.format_table(jrows).splitlines()[0]


def test_batched_rollout_equals_per_rollout_reference():
    """The port's own contract: a batch equals its rollouts run alone, to
    1e-6 of each quantity's scale (same torch arithmetic, other batch
    extents)."""
    cfg = tsim.SimConfig(n_clusters=5, n_campuses=2, n_zones=2,
                         hist_days=14)
    scen = [tsim.Scenario("baseline"),
            tsim.Scenario("spatial_mobility", mobility=0.3)]
    params = tsim.build_batch(cfg, scen, [3], 2, device="cpu")
    got = tsim.rollout_batch(cfg, 2, device="cpu")(params)
    want = tsim.rollout_sequential(cfg, 2, params, device="cpu")
    for g, w in zip((got[0], got[1], list(got[2].values())),
                    (want[0], want[1], list(want[2].values()))):
        for a, b in zip(g, w):
            if b is None:                  # the rescan state carries no pred
                assert a is None
            elif b.dtype.is_floating_point:
                np.testing.assert_allclose(
                    a.numpy(), b.numpy(), rtol=0,
                    atol=1e-6 * max(b.abs().max().item(), 1.0))
            else:
                assert (a == b).all()

