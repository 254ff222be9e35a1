"""``sim.rollout_batch_sharded``: the (scenario x seed) batch split into
equal slices over devices, each slice's burn-in and rollout run by
``rollout_batch`` on its device, the results joined on the first device.

On the CPU the split is two slices on one device (``devices=("cpu",
"cpu")``), over the golden configuration of tests/test_golden_trace.py
(8 clusters, 2 campuses, 2 zones, hist_days=14; 2 scenarios x 2 seeds, a
batch of 4), for one shaped day after the 14-day burn-in (a shaped day's
plain CPU solve takes seconds, and three runs are needed). Tolerance:
none. The port's numerics are batch-invariant (ordered hour folds and
campus sums, no product whose order depends on the batch), so every
state, ledger and traj tensor equals ``rollout_batch``'s bit for bit.
``rollout_batch`` itself is held against the JAX package by
tests/test_torch_rollout.py.
"""
import pytest
import torch

from repro_torch import sim
from repro_torch.core import stages

CFG = sim.SimConfig(n_clusters=8, n_campuses=2, n_zones=2, pds_per_cluster=2,
                    hist_days=14)
DAYS = 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seeds=(0, 1)):
    scenarios = [sim.Scenario("baseline", "nominal grid, nominal fleet"),
                 sim.Scenario("high_carbon_price", "lambda_e x4",
                              lambda_e=2.0)]
    return sim.build_batch(CFG, scenarios, list(seeds), DAYS, device="cpu")


def _leaves(tree):
    out = []
    stages.map_tensors(out.append, tree)
    return out


def test_two_shards_equal_rollout_batch_bit_for_bit():
    params = _params()
    want = sim.rollout_batch(CFG, DAYS, device="cpu")(params)
    got = sim.rollout_batch_sharded(CFG, DAYS, devices=("cpu", "cpu"))(
        params)
    assert type(got[0]) is type(want[0]) and set(got[2]) == set(want[2])
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b) == 38
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)
    assert got[1].carbon_kg.shape[0] == 4


def test_a_batch_that_does_not_divide_raises():
    params = _params(seeds=(0,))               # a batch of 2
    with pytest.raises(ValueError, match="divide"):
        sim.rollout_batch_sharded(CFG, DAYS, devices=("cpu",) * 3)(params)
    odd = stages.map_tensors(lambda t: t[:1], params)
    with pytest.raises(ValueError, match="divide"):
        sim.rollout_batch_sharded(CFG, DAYS, devices=("cpu", "cpu"))(odd)


def test_default_devices_are_the_cards(monkeypatch):
    """With no ``devices`` the batch is split over the CUDA cards; without
    one it raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim.rollout_batch_sharded(CFG, DAYS)
