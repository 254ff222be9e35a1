"""The streaming + MPC slice's own contracts, split from
``test_torch_streaming_rollout.py`` so that the test runner's workers can
take the two files apart: a closed-loop batch equals its rollouts run alone
to 1e-6 of each quantity's scale; ``build_batch`` over a mixed library
gives the reference's hour channels exactly; seven days of history fail in
both packages.
"""
import numpy as np
import pytest

from repro import sim as jsim
from repro.core import stats as jstats
from repro_torch import sim as tsim
from repro_torch.core import stages

KW = dict(n_clusters=8, n_campuses=2, n_zones=2, pds_per_cluster=2,
          hist_days=14)
SEEDS = [0, 1]


def _leaves(tree):
    out = []
    stages.map_tensors(out.append, tree)
    return out


def test_closed_loop_batch_equals_its_rollouts_alone():
    """The port's own contract for the closed loop: a batch equals its
    rollouts run alone, to 1e-6 of each quantity's scale."""
    cfg = tsim.SimConfig(n_clusters=5, n_campuses=2, n_zones=2,
                         hist_days=8, streaming=True, mpc=True)
    lib = tsim.forecast_bust_library(1)
    params = tsim.build_batch(cfg, [lib[0], lib[2]], [3], 1, device="cpu")
    got = tsim.rollout_batch(cfg, 1, device="cpu")(params)
    want = tsim.rollout_sequential(cfg, 1, params, device="cpu")
    a_all, b_all = _leaves(got), _leaves(want)
    assert len(a_all) == len(b_all)
    for a, b in zip(a_all, b_all):
        assert a.shape == b.shape
        if b.dtype.is_floating_point:
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=1e-6 * max(b.abs().max().item() if b.numel() else 0,
                                1.0))
        else:
            assert (a == b).all()


def test_intraday_channels_match_reference_exactly():
    """build_batch over a mixed library: the scenario rng places the
    blocks on the reference's hours, and rollouts without a channel get
    the neutral all-ones one."""
    days = 5
    jcfg, tcfg = jsim.SimConfig(**KW), tsim.SimConfig(**KW)
    scen_j = jsim.forecast_bust_library(days) + [jsim.Scenario("baseline")]
    scen_t = tsim.forecast_bust_library(days) + [tsim.Scenario("baseline")]
    jb = jsim.build_batch(jcfg, scen_j, SEEDS, days)
    tb = tsim.build_batch(tcfg, scen_t, SEEDS, days, device="cpu")
    for k in ("arrival_hour_scale", "carbon_hour_scale"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)))
        assert getattr(tb, k).shape == (len(scen_t) * len(SEEDS), days, 24)
    one = tsim.build_batch(tcfg, scen_t[:1], SEEDS, days, device="cpu")
    assert one.arrival_hour_scale is None
    assert one.carbon_hour_scale is not None


def test_seven_days_of_history_fail_in_both_packages():
    """The reference refuses ``hist_days < 7`` for streaming, but its
    deviation corrector needs 8 days (the trailing 8 against 8 fold
    columns), so 7 fails with a shape error in both packages: the
    reference's ``init_predictor`` on 7 days of history, and the port's
    ``make_init``, which keeps the reference's check and its failure
    (ROADMAP §3)."""
    rng = np.random.default_rng(0)
    n, H = 3, 7
    hourly = rng.uniform(0.5, 1.5, (n, H, 24)).astype(np.float32)
    daily = rng.uniform(5.0, 10.0, (n, H)).astype(np.float32)
    with pytest.raises(TypeError, match="broadcast"):
        jstats.init_predictor(hourly, daily, daily, hourly, hourly, daily,
                              hourly, np.int32(H), np.float32(0.05))
    kw = dict(n_clusters=4, n_campuses=2, n_zones=2, hist_days=H,
              streaming=True)
    tcfg = tsim.SimConfig(**kw)
    tp = tsim.build_batch(tcfg, [tsim.Scenario("baseline")], [0], 1,
                          device="cpu")
    with pytest.raises(RuntimeError, match="size of tensor"):
        tsim.make_init(tcfg, device="cpu")(tp)
