"""Exit gate of the risk-aware joint spatio-temporal slice: the port's
``rollout_batch`` under ``SimConfig(joint_spatial=True, n_members=2)`` on
the CPU against the live JAX ``rollout_batch``, over the mobility sweep
(mobility 0 and 0.3) and the risk sweep (beta 0.5, 0.9, 0.99).

The best-of verdict of the joint solve (``take``, one per rollout and day,
the day step's ``StepOut.best.take``) is compared first: where it differed, the two rollouts would follow
different plans. The reference reports it as the telemetry channel
``joint_winner``; its telemetry run is the same day with diagnostics.

Tolerances, those of the golden rollout (tests/test_torch_rollout.py):
ledger carbon, kWh and served rtol 1e-3; queues and delayed CPU-hours atol
5e-2 x max|ref|. The test prints the measured gaps:

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_risk_joint_rollout.py
"""
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro_torch import sim as tsim

KW = dict(n_clusters=6, n_campuses=2, n_zones=2, pds_per_cluster=2,
          hist_days=14, joint_spatial=True, n_members=2)
DAYS = 2
SEEDS = [0]
RTOL_KEYS = ("carbon_kg", "kwh", "cf_carbon_kg", "cf_kwh", "served",
             "arrived", "cf_served")
ATOL_KEYS = ("delayed_cpu_h", "cf_delayed_cpu_h")


def _scenarios(m):
    return m.mobility_sweep_library(DAYS, (0.0, 0.3)) \
        + m.risk_sweep_library(DAYS)


@pytest.fixture(scope="module")
def runs():
    takes = []

    def on_day(d, state, out):
        if out is not None:
            takes.append(out.best.take)

    tcfg = tsim.SimConfig(**KW)
    tb = tsim.build_batch(tcfg, _scenarios(tsim), SEEDS, DAYS, device="cpu")
    got = tsim.rollout_batch(tcfg, DAYS, device="cpu", on_day=on_day)(tb)
    jb = jsim.build_batch(jsim.SimConfig(**KW), _scenarios(jsim), SEEDS,
                          DAYS)
    want = jsim.rollout_batch(jsim.SimConfig(**KW), DAYS)(jb)
    _, _, jtraj = jsim.rollout_batch(jsim.SimConfig(**KW, telemetry=True),
                                     DAYS)(jb)
    return {"got": got, "want": want,
            "take": torch.stack(takes, dim=1).numpy(),
            "jtake": np.asarray(jtraj["telemetry"].joint_winner) > 0.5}


def test_slice_rollout_matches_live_reference(runs):
    (ts, tl, tt), (js, jl, jt) = runs["got"], runs["want"]
    print("take (rollout x day), port:", runs["take"].astype(int).tolist(),
          "reference:", runs["jtake"].astype(int).tolist())
    np.testing.assert_array_equal(runs["take"], runs["jtake"])
    assert runs["take"].any()          # the joint refinement was kept
    for k in jl._fields:
        a = getattr(tl, k).numpy().astype(np.float64)
        b = np.asarray(getattr(jl, k), np.float64)
        print(f"ledger_{k:22s} "
              f"{np.abs(a - b).max() / max(np.abs(b).max(), 1e-30):.3e}")
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


def _sub(led, rows):
    return type(led)(*(x[rows] for x in led))


def test_sweep_rows_match_reference_on_its_ledgers(runs):
    """The mobility- and risk-sweep rows of the port, on the reference's
    own ledgers, are the reference's rows."""
    _, jl, _ = runs["want"]
    tl = tsim.Ledger(*(torch.tensor(np.asarray(x)) for x in jl))
    mob = [s.name for s in tsim.mobility_sweep_library(DAYS, (0.0, 0.3))]
    rsk = [s.name for s in tsim.risk_sweep_library(DAYS)]
    n = len(SEEDS)
    # the mobility-0 rollouts stand in for the sequential ledger
    seq = [0] * n * len(mob)
    pairs = (
        (tsim.mobility_sweep_rows(_sub(tl, slice(0, 2 * n)),
                                  _sub(tl, seq), mob, n),
         jsim.mobility_sweep_rows(_sub(jl, slice(0, 2 * n)),
                                  _sub(jl, np.asarray(seq)), mob, n),
         tsim.MOBILITY_COLUMNS),
        (tsim.risk_sweep_rows({2: _sub(tl, slice(2 * n, None))}, rsk, n),
         jsim.risk_sweep_rows({2: _sub(jl, slice(2 * n, None))}, rsk, n),
         tsim.RISK_COLUMNS))
    for trows, jrows, cols in pairs:
        assert [r["scenario"] for r in trows] == [r["scenario"] for r in
                                                  jrows]
        for tr, jr in zip(trows, jrows):
            assert set(tr) == set(jr)
            for c in tr:
                if isinstance(jr[c], float):
                    assert abs(tr[c] - jr[c]) <= 1e-4 * max(1.0, abs(jr[c])),\
                        (tr["scenario"], c)
        assert tsim.format_table(trows, cols).splitlines()[0] == \
            jsim.format_table(jrows, cols).splitlines()[0]


def test_batched_slice_rollout_equals_per_rollout_reference():
    """The port's own contract, on the slice: a batch equals its rollouts
    run alone, to 1e-6 of each quantity's scale."""
    cfg = tsim.SimConfig(n_clusters=4, n_campuses=2, n_zones=2,
                         hist_days=14, joint_spatial=True, n_members=3)
    scen = tsim.mobility_sweep_library(2, (0.3,)) \
        + tsim.risk_sweep_library(2, (0.5,))
    params = tsim.build_batch(cfg, scen, [2], 1, device="cpu")
    got = tsim.rollout_batch(cfg, 1, device="cpu")(params)
    want = tsim.rollout_sequential(cfg, 1, params, device="cpu")
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
