"""The rest of ``core/`` against the JAX package: half-life calibration,
the carbon and power helpers, the SLO state, the softmax peak, the
batched solves and the zonal problem, on inputs made with numpy from a seed
(random keys come from jax and are handed to both).

Tolerances: the walk-forward MAPE surface within 1e-5 relative, and the
calibrated pair equal (a float32 surface is no closer: both packages sit
up to 2-4e-6 relative from a float64 evaluation of the same formulas, and
5.1e-6 apart at most on these seeds); the carbon and power helpers rtol
1e-5 with a floor of 1e-6 x the largest value (the class of
``test_torch_pipelines.py``: the same float32 formulas, sums in another
order); the SLO counters, the greedy
oracle and the zonal problem exactly (its normal draws within the 2 ulp of
``prng.normal``, rtol 1e-6); the batched solves as the solver
tests hold their unbatched forms: delta, VCC, mu rtol 1e-4 and atol 1e-4,
s and tau atol 1e-4 x max tau, after the best-of verdicts agree; the greedy
pre-shift atol 1e-5 x max tau (a cumulative sum in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import carbon as jcarbon
from repro.core import forecast as jfc
from repro.core import power as jpower
from repro.core import slo as jslo
from repro.core import solver as jsolver
from repro.core import spatial as jspatial
from repro.core import vcc as jvcc
from repro_torch import convert
from repro_torch.core import carbon, forecast, power, slo, solver, spatial, vcc


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return convert.tensor(x)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy().astype(np.float64) if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    floor = 1e-6 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


# ------------------------------------------------------------ forecast

def _history(days=42, seed=0):
    """tests/test_power_forecast.py's ``_history``: a daily profile with a
    weekly cycle and 3% noise."""
    rng = np.random.RandomState(seed)
    hours = np.arange(24)
    prof = 1 + 0.3 * np.exp(-0.5 * ((hours - 14) / 4.0) ** 2)
    hist = [5.0 * prof * (1 + 0.1 * np.cos(2 * np.pi * (d % 7) / 7))
            * (1 + 0.03 * rng.randn(24)) for d in range(days)]
    return np.stack(hist).astype(np.float32)


@pytest.fixture(scope="module")
def jax_surface():
    """The reference's grid evaluation, compiled once for every seed."""
    g = len(forecast.GRID)
    garr = jnp.asarray(forecast.GRID, jnp.float32)
    hms, hfs = jnp.repeat(garr, g), jnp.tile(garr, g)
    run = jax.jit(jax.vmap(jfc._walk_forward_mape, in_axes=(None, 0, 0)))
    return lambda hist: np.asarray(run(jnp.asarray(hist), hms, hfs))


@pytest.mark.parametrize("seed", (0, 3, 7))
def test_calibrate_half_lives_matches_reference(jax_surface, seed):
    """The MAPE surface over the 6 x 6 grid, the pair of
    ``calibrate_half_lives`` (the reference's own, vectorized) and the
    port's parity loop."""
    hist = _history(seed=seed)
    want = jax_surface(hist)
    g = len(forecast.GRID)
    garr = torch.tensor(forecast.GRID)
    got = forecast._walk_forward_mape(T(hist), garr.repeat_interleave(g),
                                      garr.repeat(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    i = int(np.argmin(want))            # the reference's row-major pick
    pair = (forecast.GRID[i // g], forecast.GRID[i % g])
    if seed == 0:                       # it compiles its grid each call
        assert pair == jfc.calibrate_half_lives(jnp.asarray(hist))
    assert forecast.calibrate_half_lives(T(hist)) == pair
    assert forecast.calibrate_half_lives_loop(T(hist)) == pair
    # one pair as Python floats: the surface's entry
    assert abs(float(forecast._walk_forward_mape(T(hist), *pair))
               - want[i]) <= 1e-5 * want[i]


# --------------------------------------------------- carbon, power, slo

def test_carbon_helpers_match_reference():
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    zones = jcarbon.default_zones(3)
    _close(carbon.simulate_zone(T(keys[1]), carbon.default_zones(3)[1], 5),
           jax.jit(lambda k: jcarbon.simulate_zone(k, zones[1], 5))(keys[1]))
    zps = jcarbon.stack_zone_params(zones)
    _close(carbon.simulate_zones_from(T(keys), {k: T(v) for k, v in
                                                zps.items()}, 5),
           jax.jit(lambda k, z: jcarbon.simulate_zones_from(k, z, 5))(
               keys, zps))
    rng = np.random.default_rng(2)
    fc = rng.uniform(0.05, 0.8, (4, 24)).astype(np.float32)
    act = rng.uniform(0.05, 0.8, (4, 24)).astype(np.float32)
    act[1, 3] = 0.0                           # the 1e-6 clip
    _close(carbon.mape(T(fc[0]), T(act[0])), jcarbon.mape(fc[0], act[0]))
    _close(carbon.mape(T(fc), T(act)), jax.vmap(jcarbon.mape)(fc, act))


def test_power_helpers_match_reference():
    rng = np.random.default_rng(3)
    cpu = rng.uniform(0.05, 0.95, (6, 96)).astype(np.float32)
    pw = (80 + 300 * cpu ** 1.1 * (1 + 0.02 * rng.normal(size=cpu.shape))
          ).astype(np.float32)
    coef, breaks = jpower.fit_pd_models(jnp.asarray(cpu), jnp.asarray(pw))
    _close(power.daily_mape(T(coef), T(breaks), T(cpu), T(pw)),
           jpower.daily_mape_b(coef, breaks, cpu, pw))
    usage = rng.uniform(0.0, 2.0, (3, 4, 50)).astype(np.float32)
    usage[0, :, 7] = 0.0                      # an idle hour: the 1e-9 clip
    _close(power.usage_fractions(T(usage)),
           jax.vmap(jpower.usage_fractions)(usage))


def test_reexported_and_batched_names_match_reference():
    """The reference's module-level names: its vmaps over PDs (the port's
    functions take the batch axes themselves; the batched ``daily_mape``
    is held against ``daily_mape_b`` above), ``vcc.project_conservation``
    and the fleet module's re-exports of the staged core."""
    from repro_torch.core import fleet, stages
    assert power.fit_pd_models is power.fit_pd_model
    assert power.pd_power_b is power.pd_power
    assert power.pd_slope_b is power.pd_slope
    assert power.daily_mape_b is power.daily_mape
    assert vcc.project_conservation is solver.project_conservation
    assert fleet.cluster_truth is stages.cluster_truth
    assert fleet.build_problem_arrays is stages.build_problem_arrays


def test_slo_init_state_and_updates_match_reference():
    n = 9
    jst, st = jslo.init_state(n), slo.init_state(n)
    assert set(st) == set(jst)
    for k in jst:
        assert st[k].dtype == torch.int32 and jst[k].dtype == jnp.int32
        assert st[k].shape == (n,) and not st[k].any()
    cfg, jcfg = slo.SLOConfig(pause_days=3), jslo.SLOConfig(pause_days=3)
    rng = np.random.default_rng(4)
    for day in range(8):
        res = rng.uniform(0.5, 1.5, n).astype(np.float32)
        budget = np.ones(n, np.float32)
        unmet = rng.uniform(0, 1, n).astype(np.float32) * (day % 2)
        arrived = np.full(n, 10.0, np.float32)
        jst, jok = jslo.update(jst, jcfg, res, budget, unmet, arrived)
        st, ok = slo.update(st, cfg, *map(T, (res, budget, unmet,
                                                arrived)))
        for k in jst:
            assert st[k].dtype == torch.int32, k
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_smooth_peak_matches_reference():
    rng = np.random.default_rng(5)
    pow_h = rng.uniform(300, 700, (3, 7, 24)).astype(np.float32)
    temps = np.asarray([5.0, 10.0, 20.0], np.float32)
    y, w = solver.smooth_peak(T(pow_h), T(temps))
    jy, jw = jax.vmap(jsolver.smooth_peak)(pow_h, temps)
    _close(y, jy)
    _close(w, jw)
    y1, w1 = solver.smooth_peak(T(pow_h[1]), 10.0)
    _close(y1, jsolver.smooth_peak(pow_h[1], 10.0)[0])
    assert torch.equal(y1, y[1]) and torch.equal(w1, w[1])


# ------------------------------------------------------------------ vcc

def test_greedy_oracle_and_zonal_problem_match_reference():
    rng = np.random.default_rng(6)
    for r in range(5):
        c = rng.normal(size=24).astype(np.float32)
        lo = -rng.uniform(0, 1, 24).astype(np.float32)
        ub = rng.uniform(0, 2, 24).astype(np.float32)
        got = vcc.greedy_linear_reference(c, lo, ub)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(
            got, jvcc.greedy_linear_reference(c, lo, ub))
        # torch inputs give the same answer
        np.testing.assert_array_equal(
            got, vcc.greedy_linear_reference(*map(torch.tensor, (c, lo, ub))))
    n, seed = 12, 3
    want = jvcc.synthetic_zonal_problem(n, seed=seed)
    got = vcc.synthetic_zonal_problem(n, seed=seed, device="cpu")
    base = vcc.synthetic_problem(n, seed=seed, device="cpu")
    scale = torch.tensor([2.2 if c % 2 == 0 else 0.5 for c in range(n)])
    assert torch.equal(got.eta, base.eta * scale[:, None])
    assert torch.equal(got.capacity, base.capacity * 0.85)
    for f in ("tau", "pi", "u_pow_cap", "capacity", "ratio", "campus",
              "campus_limit", "lambda_e", "lambda_p"):
        g = getattr(got, f).numpy()     # the reference's weak floats
        np.testing.assert_array_equal(            # as float32
            g, np.asarray(getattr(want, f)).astype(g.dtype), f)
    for f in ("eta", "u_if", "u_if_q", "pow_nom"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert got.drop_limit == want.drop_limit


B, N = 3, 12
SHORT = dict(inner_iters=10, outer_iters=3)
MOBILITY = (0.1, 0.3, 0.6)


def _stacked(seeds=(3, 4, 5)):
    jps = [jvcc.synthetic_zonal_problem(N, seed=s) for s in seeds]
    jp = jax.tree.map(lambda *xs: jnp.stack(xs), *jps)
    p = convert.problem_from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}, "cpu")
    return jp, p


def _close_solution(sol, jsol, fields=("delta", "vcc", "mu", "y")):
    np.testing.assert_array_equal(sol.shaped.numpy(), np.asarray(jsol.shaped))
    for f in fields:
        np.testing.assert_allclose(getattr(sol, f).numpy(),
                                   np.asarray(getattr(jsol, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)
    np.testing.assert_allclose(sol.objective.numpy(),
                               np.asarray(jsol.objective), rtol=1e-4)


@pytest.mark.parametrize("solve", ("solve_vcc", "spatial_shift",
                                   "solve_joint"))
def test_batched_solves_match_reference(solve):
    """n = 12 clusters, a batch of 3 zonal problems, short epochs; the
    mobility one per rollout (a scalar too for the pre-shift)."""
    jp, p = _stacked()
    scale = float(p.tau.abs().max())
    mob = np.asarray(MOBILITY, np.float32)
    if solve == "solve_vcc":
        jsol = jax.jit(lambda q: jvcc.solve_vcc_batched(q, **SHORT))(jp)
        sol = vcc.solve_vcc_batched(p, device="cpu", **SHORT)
        _close_solution(sol, jsol)
    elif solve == "spatial_shift":
        for m, jm in ((T(mob), jnp.asarray(mob)), (0.3, 0.3)):
            tau, price = spatial.spatial_shift_batched(p, mobility=m)
            jtau, jprice = jspatial.spatial_shift_batched(jp, mobility=jm)
            np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), rtol=0,
                                       atol=1e-5 * scale)
            _close(price, jprice)
    else:
        sol, tau, s, best = spatial.solve_joint_batched(
            p, T(mob), device="cpu", joint_outer=2, **SHORT)
        jsol, jtau, js, diag = jax.jit(
            lambda q, m: jspatial.solve_joint_batched(
                q, m, joint_outer=2, telemetry=True, **SHORT))(
                    jp, jnp.asarray(mob))
        np.testing.assert_array_equal(best.take.numpy(),
                                      np.asarray(diag["joint_winner"]) > 0)
        for got, want in ((s, js), (tau, jtau)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4 * scale)
        _close_solution(sol, jsol)
        assert s.abs().max() > 0                 # budgets moved
        # a scalar mobility is the same joint path for every rollout
        sol0 = spatial.solve_joint_batched(p, 0.0, device="cpu",
                                           joint_outer=2, **SHORT)
        assert sol0[2].shape == (B, N) and not sol0[2].any()
