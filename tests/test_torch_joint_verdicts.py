"""The joint day step's best-of verdicts against the reference beyond toy
size (split from ``test_torch_joint.py`` so that the test runner's workers
can take the two files apart): equal on every rollout-day, each margin with
its call's sign.
"""
import numpy as np
import torch


def test_best_of_verdicts_match_reference_beyond_toy_size():
    """At 32 clusters (four times the golden fleet), over the mobility
    sweep, the day step's best-of calls (``StepOut.best``) equal the
    reference's ``joint_winner`` on every rollout-day, and each call's
    margin has the call's sign. ``-s`` prints the calls and margins."""
    from repro import sim as jsim
    from repro_torch import sim as tsim
    kw = dict(n_clusters=32, n_campuses=4, n_zones=2, pds_per_cluster=2,
              hist_days=14, joint_spatial=True, n_members=2)
    days, bests = 2, []

    def on_day(d, state, out):
        if out is not None:
            bests.append(out.best)

    tcfg = tsim.SimConfig(**kw)
    params = tsim.build_batch(tcfg, tsim.mobility_sweep_library(days), [0],
                              days, device="cpu")
    tsim.rollout_batch(tcfg, days, device="cpu", on_day=on_day)(params)
    take = torch.stack([b.take for b in bests], 1)
    margin = torch.stack([b.margin for b in bests], 1)
    jb = jsim.build_batch(jsim.SimConfig(**kw),
                          jsim.mobility_sweep_library(days), [0], days)
    _, _, jt = jsim.rollout_batch(jsim.SimConfig(**kw, telemetry=True),
                                  days)(jb)
    jtake = np.asarray(jt["telemetry"].joint_winner) > 0.5
    print("take (rollout x day), port:", take.int().tolist(), "reference:",
          jtake.astype(int).tolist(), "margins:", margin.tolist())
    np.testing.assert_array_equal(take.numpy(), jtake)
    assert torch.equal(take, margin >= 0)
