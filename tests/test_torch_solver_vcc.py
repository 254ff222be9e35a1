"""The port's solver layer and VCC solve against the JAX package.

Tolerances: ``minimize_linear`` is a cumulative sum over sorted budgets;
XLA's cumsum adds in another order than torch's, so atol 1e-5 (values of
order 1). ``solve_vcc`` runs 20 x 80 PGD steps whose hour sums are taken
in another order than XLA's: delta, vcc and mu match to rtol 1e-4 and atol
1e-4. A batch of problems equals its per-problem solves to 1e-6 (same torch
arithmetic). The campus sums (``segment_sum``) are held bit for bit: against
``jax.ops.segment_sum`` (a sequential scatter-add on the CPU), and batched
against per rollout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as jsolver
from repro.core import vcc as jvcc
from repro_torch import convert
from repro_torch.core import solver, vcc


def _problem(p):
    return convert.problem_from_numpy(
        {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}, "cpu")


def test_minimize_linear_matches_greedy_and_jax():
    rng = np.random.default_rng(0)
    n, k = 16, 24
    cost = rng.normal(size=(n, k)).astype(np.float32)
    cost[3, ::2] = cost[3, 0]                  # ties: the sort is stable
    lo = -rng.uniform(0, 1, (n, k)).astype(np.float32)
    ub = rng.uniform(0, 2, (n, k)).astype(np.float32)
    lo[5] = ub[5] = 0.0                        # collapsed row
    got = solver.minimize_linear(torch.as_tensor(cost), torch.as_tensor(lo),
                                 torch.as_tensor(ub)).numpy()
    want = np.asarray(jsolver.minimize_linear(jnp.asarray(cost),
                                              jnp.asarray(lo),
                                              jnp.asarray(ub)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for r in range(n):
        greedy = jvcc.greedy_linear_reference(cost[r], lo[r], ub[r])
        assert np.dot(cost[r], got[r]) <= np.dot(cost[r], greedy) + 1e-4
    assert (got[5] == 0).all()


def test_synthetic_problem_matches_reference():
    want = jvcc.synthetic_problem()
    got = vcc.synthetic_problem(device="cpu")
    for f in ("eta", "u_if", "u_if_q", "tau", "pow_nom"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6)


def test_bounds_power_objective_match_reference():
    jp = jvcc.synthetic_problem(n=10, seed=3)
    p = _problem(jp)
    jlo, jub, jok = jvcc.delta_bounds(jp)
    lo, ub, ok = vcc.delta_bounds(p)
    np.testing.assert_allclose(ub.numpy(), np.asarray(jub), rtol=1e-6)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    d = np.random.default_rng(1).normal(size=(10, 24)).astype(np.float32)
    mu = np.float32([0.2, 0.7])
    np.testing.assert_allclose(
        vcc.cluster_power(p, torch.as_tensor(d)).numpy(),
        np.asarray(jvcc.cluster_power(jp, jnp.asarray(d))), rtol=1e-6)
    np.testing.assert_allclose(
        vcc.objective(p, torch.as_tensor(d), torch.as_tensor(mu)).item(),
        float(jvcc.objective(jp, jnp.asarray(d), jnp.asarray(mu))),
        rtol=1e-5)


def test_solve_vcc_matches_reference():
    jp = jvcc.synthetic_problem()
    want = jvcc.solve_vcc(jp)
    got = vcc.solve_vcc(_problem(jp), device="cpu")
    for f in ("delta", "vcc", "mu", "y"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.shaped.numpy(),
                                  np.asarray(want.shaped))


def _contended(seed, lambda_e):
    """A problem whose campus contracts bind, so the duals move."""
    jp = jvcc.synthetic_problem(n=12, seed=seed, n_campuses=3)
    jp = dataclasses.replace(jp, campus_limit=jnp.full((3,), 2000.0),
                             lambda_e=lambda_e)
    return jp, _problem(jp)


def test_contended_solve_and_batch_equal_per_problem():
    pairs = [_contended(11, 0.1), _contended(12, 2.0)]
    jp, p = pairs[0]
    want = jvcc.solve_vcc(jp, outer_iters=6, inner_iters=20)
    one = vcc.solve_vcc(p, outer_iters=6, inner_iters=20, device="cpu")
    assert float(np.asarray(want.mu).max()) > 0
    np.testing.assert_allclose(one.mu.numpy(), np.asarray(want.mu),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(one.delta.numpy(), np.asarray(want.delta),
                               rtol=1e-4, atol=1e-4)
    batch = vcc.VCCProblem(**{
        f: torch.stack([getattr(q, f) for _, q in pairs])
        for f in vcc.VCCProblem.__dataclass_fields__ if f not in ("drop_limit", *convert.ENSEMBLE)},
        drop_limit=p.drop_limit)
    both = vcc.solve_vcc(batch, outer_iters=6, inner_iters=20, device="cpu")
    for b, (_, q) in enumerate(pairs):
        alone = vcc.solve_vcc(q, outer_iters=6, inner_iters=20,
                              device="cpu")
        for f in ("delta", "vcc", "mu", "objective"):
            np.testing.assert_allclose(getattr(both, f)[b].numpy(),
                                       getattr(alone, f).numpy(),
                                       rtol=0, atol=1e-6 * max(
                                           1.0, getattr(alone, f).abs()
                                           .max().item()))


def test_segment_sum_keeps_rollouts_apart():
    y = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    campus = torch.tensor([[0, 1, 2, 0, 1, 2]] * 2)
    got = solver.segment_sum(y, campus, 3)
    np.testing.assert_array_equal(got.numpy(), [[3, 5, 7], [15, 17, 19]])


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _campus_case(shape, m, seed, empty=None):
    """Data spanning six decades and campus ids of uneven sizes (ids
    drawn with skewed weights), campus ``empty`` left without clusters."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.2, 3.0, m)
    if empty is not None:
        w[empty] = 0.0
    ids = rng.choice(m, size=shape, p=w / w.sum())
    data = (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)
    return data, ids


@pytest.mark.parametrize("shape,m,empty", [
    ((37,), 5, None),            # one problem, uneven campuses
    ((3, 29), 6, 2),             # a batch, campus 2 empty
    ((2, 3, 17), 4, 0),          # two batch dims, campus 0 empty
    ((4, 64), 64, None)])        # about one cluster a campus, some empty
def test_segment_sum_matches_jax_segment_sum_bitwise(shape, m, empty):
    """Each campus adds its clusters in ascending order from zero: the
    reference's sequential scatter-add on the CPU, bit for bit."""
    data, ids = _campus_case(shape, m, sum(shape) + m, empty)
    got = solver.segment_sum(torch.as_tensor(data), torch.as_tensor(ids), m)
    flat_d, flat_i = data.reshape(-1, shape[-1]), ids.reshape(-1, shape[-1])
    want = np.stack([np.asarray(jax.ops.segment_sum(
        jnp.asarray(d), jnp.asarray(i), m)) for d, i in zip(flat_d, flat_i)])
    assert got.shape == shape[:-1] + (m,)
    np.testing.assert_array_equal(_bits(got.numpy().reshape(-1, m)),
                                  _bits(want))


def test_segment_sum_batched_equals_per_rollout_bitwise():
    """A rollout's sums do not depend on the batch beside it: a batch whose
    rollouts have their largest campus at other sizes (so the batch pads
    each to the largest) equals each rollout summed alone, and ids shared
    by the batch (one (n,) row, broadcast) equal the same ids per row."""
    m, n = 5, 41
    data, _ = _campus_case((3, n), m, 11)
    ids = np.stack([_campus_case((n,), m, s, empty)[1]
                    for s, empty in ((1, None), (2, 3), (3, 0))])
    batched = solver.segment_sum(torch.as_tensor(data),
                                 torch.as_tensor(ids), m)
    for b in range(3):
        alone = solver.segment_sum(torch.as_tensor(data[b]),
                                   torch.as_tensor(ids[b]), m)
        np.testing.assert_array_equal(_bits(batched[b]), _bits(alone))
    shared = torch.as_tensor(ids[0])
    np.testing.assert_array_equal(
        _bits(solver.segment_sum(torch.as_tensor(data), shared, m)),
        _bits(solver.segment_sum(torch.as_tensor(data),
                                 shared.expand(3, n).clone(), m)))


def test_campus_layout_is_built_once_per_ids_tensor(monkeypatch):
    """The layout (the one host copy of the ids) is built on the first sum
    over a campus-id tensor and reused by later sums and by views of the
    same tensor; an in-place change of the ids builds it anew; out-of-range
    ids are dropped, as ``jax.ops.segment_sum`` drops them."""
    builds = []
    real = solver._build_layout
    monkeypatch.setattr(solver, "_build_layout",
                        lambda ids, num: builds.append(1) or real(ids, num))
    base = torch.tensor([0, 2, 1, 2, 0, 2])
    ids = base.expand(3, 6)
    y = torch.arange(18, dtype=torch.float32).reshape(3, 6)
    for _ in range(3):
        solver.segment_sum(y, ids, 3)
    solver.segment_sum(y, base.expand(3, 6), 3)
    assert len(builds) == 1
    base[1] = 7                         # out of range: dropped
    got = solver.segment_sum(y, ids, 3)
    assert len(builds) == 2
    np.testing.assert_array_equal(got[0].numpy(), [4.0, 2.0, 8.0])


def test_solve_vcc_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        vcc.solve_vcc(vcc.synthetic_problem(device="cpu"))
