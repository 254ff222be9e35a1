"""The port's ``make_day_step`` and ``make_init`` against the reference's
refusals, and each ported ``StageConfig`` flag building and running one day
at 4 clusters on the CPU; the entry points' default device. (Split from
``test_torch_stages.py`` so that the test runner's workers can take the
two files apart.)
"""
import pytest
import torch

from repro_torch import sim as tsim
from repro_torch.core import stages, vcc
from repro_torch.sim import engine as tengine

SMALL = dict(n_clusters=4, n_campuses=2, n_zones=2, pds_per_cluster=2,
             hist_days=14)


@pytest.mark.parametrize("flag, refusal", [
    (dict(joint_spatial=True, mpc=True), None),
    (dict(n_members=4, telemetry=True), None),
    (dict(streaming=True), None),
    (dict(telemetry=True), None),
    (dict(mpc=True), None),
    (dict(streaming=True, n_members=4), ValueError),
    (dict(streaming=True, hist_days=6), ValueError)],
    ids=[f"flag{i}" for i in range(7)])
def test_make_day_step_refuses_unported_flags(flag, refusal):
    """The reference's own refusals hold (streaming with n_members > 1 in
    make_day_step, streaming with hist_days < 7 in make_init). Streaming,
    MPC and telemetry are ported: alone, and beside the joint spatial solve
    or forecast ensembles, they build and run one day at 4 clusters on the
    CPU (with telemetry, the day's record in ``StepOut.telemetry``)."""
    cfg = tsim.SimConfig(**{**SMALL, **flag})
    stages.make_day_step(stages.StageConfig(joint_spatial=True, n_members=4))
    if refusal is not None:
        with pytest.raises(refusal):
            tsim.make_day_step(cfg)
            tsim.make_init(cfg, device="cpu")
        return
    params = tsim.build_batch(cfg, tsim.forecast_bust_library(1)[:1], [0],
                              1, device="cpu")
    state = tsim.make_init(cfg, device="cpu")(params)
    assert (state.pred is not None) == cfg.streaming
    new, out = tsim.make_day_step(cfg)(params, state,
                                       tengine.day_xs(params, 0))
    assert (out.recourse is not None) == cfg.mpc
    assert (out.telemetry is not None) == cfg.telemetry
    assert int(new.day[0]) == SMALL["hist_days"] + 1
    for name, x in (("carbon", out.res.carbon), ("queue", new.queue),
                    ("vcc", out.vcc_curve)):
        assert torch.isfinite(x).all(), name


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        stages.make_init(4, 2, 2, 14)
    with pytest.raises(RuntimeError, match="CUDA"):
        vcc.synthetic_problem()
