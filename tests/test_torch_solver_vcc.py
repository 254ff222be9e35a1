"""The port's solver layer and VCC solve against the JAX package.

Tolerances: ``minimize_linear`` is a cumulative sum over sorted budgets;
XLA's cumsum adds in another order than torch's, so atol 1e-5 (values of
order 1). ``solve_vcc`` runs 20 x 80 PGD steps whose hour sums are taken
in another order than XLA's: delta, vcc and mu match to rtol 1e-4 and atol
1e-4. A batch of problems equals its per-problem solves to 1e-6 (same torch
arithmetic, campus sums offset per rollout).
"""
import dataclasses

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


def test_solve_vcc_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        vcc.solve_vcc(vcc.synthetic_problem(device="cpu"))
