"""Intra-day MPC recourse (``repro_torch.core.mpc``) and the suffix re-solve
(``vcc.suffix_bounds`` / ``vcc.solve_vcc_suffix``) against the JAX
package, on the CPU, on ``vcc.synthetic_problem`` and days drawn from
``np.random.default_rng``.

Tolerances:

* the suffix re-solve: delta within 1e-4 (the epochs' tolerance); the
  elapsed columns and the infeasible rows are ``delta_committed`` exactly,
  in both packages;
* ``mpc_day``: the enforced curve and the ``DayResult`` to rtol 1e-3 (with
  a floor of 1e-3 x the largest value for entries that cross zero); the
  queues to atol 5e-2 x max, as tests/test_torch_rollout.py holds them;
* the triggers are ``>`` tests that amplify rounding: the hours on which a
  cluster re-plans must agree exactly, except on clusters where some
  hour's trigger signal lies within 1e-4 (relative) of its threshold; the
  test prints how many cluster-hours lie that close.

The port's own contract (``tests/test_mpc.py`` holds it of JAX): with the
gate closed the closed loop is the open loop, bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admission as jadmission
from repro.core import mpc as jmpc
from repro.core import vcc as jvcc
from repro_torch import convert
from repro_torch.core import admission, mpc, vcc

N = 8


def _problem(p):
    return convert.problem_from_numpy(
        {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}, "cpu")


def _t(x):
    return torch.tensor(np.asarray(x))


def _power(u):
    return 100.0 + 300.0 * u


@pytest.fixture(scope="module")
def plan():
    """The reference's day-ahead problem and its solution, and a committed
    prefix: the plan jittered inside the day-ahead box, with cluster 0's
    prefix spent past any suffix's reach (+24 an hour)."""
    jp = jvcc.synthetic_problem(N, seed=3, n_campuses=2)
    jsol = jvcc.solve_vcc(jp, use_pallas=False)
    lo, ub, _ = jvcc.delta_bounds(jp)
    jitter = np.random.default_rng(0).uniform(-0.3, 0.3, (N, 24))
    committed = np.array(jnp.clip(jsol.delta + jitter, lo, ub), np.float32)
    committed[0, :12] = 24.0
    return jp, jsol, committed


@pytest.mark.parametrize("hour", [0, 5, 12, 23, 24])
def test_suffix_solve_matches_reference(plan, hour):
    jp, jsol, committed = plan
    want = jvcc.solve_vcc_suffix(jp, jnp.asarray(committed), jsol.mu, hour,
                                 use_pallas=False)
    tp = _problem(jp)
    lo, ub, feas = vcc.suffix_bounds(tp, _t(committed), hour)
    jlo, jub, jfeas = jvcc.suffix_bounds(jp, jnp.asarray(committed), hour)
    np.testing.assert_array_equal(feas.numpy(), np.asarray(jfeas))
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=1e-6)
    np.testing.assert_allclose(ub.numpy(), np.asarray(jub), rtol=1e-6)
    got = vcc.solve_vcc_suffix(tp, _t(committed), _t(jsol.mu), hour,
                               device="cpu")
    np.testing.assert_array_equal(got.shaped.numpy(), np.asarray(want.shaped))
    d, jd = got.delta.numpy(), np.asarray(want.delta)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-4)
    # elapsed columns and infeasible rows are the committed ones, exactly
    for delta in (d, jd):
        np.testing.assert_array_equal(delta[:, :hour], committed[:, :hour])
        np.testing.assert_array_equal(delta[~np.asarray(jfeas)],
                                      committed[~np.asarray(jfeas)])
    if 1 <= hour <= 12:
        assert not jfeas[0]          # cluster 0's prefix cannot conserve
        np.testing.assert_allclose(got.vcc[0].numpy(),
                                   float(jp.capacity[0]), rtol=1e-6)
    feas_np = feas.numpy()
    np.testing.assert_allclose(d[feas_np].sum(-1), 0.0, atol=5e-4)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu),
                               rtol=1e-4, atol=1e-6)


def _day(p, seed):
    """A realized day around the forecasts of ``p`` (numpy, (n, 24)), with
    an unforecast x1.8 intensity block and a x1.6 arrival block."""
    rng = np.random.default_rng(seed)
    shape = np.asarray(p.u_if).shape
    u_if = np.asarray(p.u_if) * (1 + 0.06 * rng.normal(size=shape))
    arrivals = 0.12 + 0.1 * rng.uniform(size=shape)
    arrivals[:, 14:19] *= 1.6
    ratio = np.full(shape, 1.3)
    intensity = np.asarray(p.eta) * (1 + 0.05 * rng.normal(size=shape))
    intensity[:, 9:17] *= 1.8
    return [a.astype(np.float32) for a in (u_if, arrivals, ratio, intensity)]


def _signals(p, tuf, u_if, arrivals, intensity):
    """The reference's trigger signals over thresholds, (n, 24) each: they
    depend on the day's inputs only, not on the loop's state."""
    fc_uif, fc_eta = np.asarray(p.u_if), np.asarray(p.eta)
    elapsed = np.arange(1, 25, dtype=np.float32)
    mape = np.cumsum(np.abs(fc_uif - u_if) / np.clip(np.abs(u_if), 1e-6,
                                                     None), -1) / elapsed
    r_eta = np.abs(intensity / np.clip(fc_eta, 1e-6, None) - 1.0)
    q_extra = np.clip(np.cumsum(arrivals, -1) - elapsed / 24.0
                      * tuf[:, None], 0.0, None)
    surge = jmpc.SURGE_TRIGGER * np.clip(np.asarray(p.tau), 1e-6, None)
    return [(mape, jmpc.MAPE_TRIGGER), (r_eta, jmpc.ETA_TRIGGER),
            (q_extra, surge[:, None])]


def test_mpc_day_matches_reference():
    jp = jvcc.synthetic_problem(N, seed=11, n_campuses=2)
    jsol = jvcc.solve_vcc(jp, use_pallas=False)
    u_if, arrivals, ratio, intensity = _day(jp, seed=1)
    tuf = np.asarray(jp.tau) * 0.8
    gate = np.asarray(jsol.shaped).copy()
    gate[1] = False                                 # a paused cluster
    queue0 = np.linspace(0.0, 0.4, N).astype(np.float32)
    jres, jvcc_real, jacc, jdiag = jmpc.mpc_day(
        jp, jsol, jnp.asarray(tuf), jnp.asarray(gate), jp.capacity,
        *map(jnp.asarray, (u_if, arrivals, ratio, queue0)), _power,
        jnp.asarray(intensity), use_pallas=False)
    tsol = vcc.VCCSolution(*(_t(getattr(jsol, f)) for f in
                             ("delta", "y", "vcc", "shaped", "mu",
                              "objective")))
    tp = _problem(jp)
    res, enforced, acc, diag = mpc.mpc_day(
        tp, tsol, _t(tuf), _t(gate), tp.capacity,
        *map(_t, (u_if, arrivals, ratio, queue0)), _power, _t(intensity))

    # the triggers: accepted hours agree, but where a signal is knife-edge
    near = np.zeros((N, 24), bool)
    for sig, thr in _signals(jp, tuf, u_if, arrivals, intensity):
        near |= np.abs(sig - thr) <= 1e-4 * np.abs(thr)
    print(f"cluster-hours within 1e-4 of a trigger threshold: "
          f"{int(near.sum())} of {near.size}")
    keep = ~near.any(-1)
    np.testing.assert_array_equal(diag.recourse_frac.numpy()[keep],
                                  np.asarray(jdiag.recourse_frac)[keep])
    assert float(np.asarray(jdiag.recourse_frac).max()) > 0.0
    np.testing.assert_allclose(diag.recourse_depth.numpy()[keep],
                               np.asarray(jdiag.recourse_depth)[keep],
                               rtol=1e-3, atol=1e-4)

    def near_enough(got, want, what, rtol=1e-3, floor=1e-3):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy()[keep], want[keep], rtol=rtol,
            atol=floor * max(float(np.abs(want).max()), 1e-30), err_msg=what)

    near_enough(enforced, jvcc_real, "enforced curve")
    for f in ("usage_flex", "usage_total", "reservations", "power", "carbon",
              "served", "arrived"):
        near_enough(getattr(res, f), getattr(jres, f), f)
    for f in ("queue_end", "unmet"):
        near_enough(getattr(res, f), getattr(jres, f), f, rtol=0,
                    floor=5e-2)
    assert acc.hour == 24 and int(jacc.hour) == 24
    near_enough(acc.use_flex, jacc.use_flex, "acc.use_flex")
    # hour 0 is enforced from the 00:00 plan
    plan0 = mpc.gated_curve(tp, tsol.delta, tp.tau, _t(gate), tp.capacity)
    np.testing.assert_allclose(enforced[:, 0].numpy(), plan0[:, 0].numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        plan0.numpy(), np.asarray(jmpc.gated_curve(
            jp, jsol.delta, jp.tau, jnp.asarray(gate), jp.capacity)),
        rtol=1e-6)


def test_mpc_day_gate_closed_is_the_open_loop_bitwise():
    """No cluster may shape: every hour enforces the unshaped 10x-capacity
    curve and no re-solve is accepted, so the day is ``admission.run_day``
    on that curve, bit for bit."""
    tp = vcc.synthetic_problem(6, seed=7, device="cpu")
    sol = vcc.solve_vcc(tp, device="cpu")
    u_if, arrivals, ratio, intensity = map(_t, _day(tp, seed=2))
    gate = torch.zeros(6, dtype=torch.bool)
    queue0 = torch.linspace(0.0, 0.4, 6)
    res, enforced, acc, diag = mpc.mpc_day(
        tp, sol, tp.tau, gate, tp.capacity, u_if, arrivals, ratio, queue0,
        _power, intensity)
    open_curve = (tp.capacity[:, None] * 10.0).expand(6, 24)
    want = admission.run_day(open_curve, u_if, arrivals, ratio, tp.capacity,
                             queue0, _power, intensity)
    for f in admission.DayResult.__dataclass_fields__:
        assert torch.equal(getattr(res, f), getattr(want, f)), f
    assert torch.equal(enforced, open_curve)
    assert float(diag.recourse_frac.max()) == 0.0
    assert acc.hour == 24
    assert torch.equal(acc.flex_daily, res.served)
    # and the reference's open loop agrees with the port's
    jres = jadmission.run_day(jnp.asarray(open_curve.numpy()),
                              *(jnp.asarray(x.numpy()) for x in
                                (u_if, arrivals, ratio, tp.capacity,
                                 queue0)), _power,
                              jnp.asarray(intensity.numpy()))
    np.testing.assert_allclose(res.carbon.numpy(), np.asarray(jres.carbon),
                               rtol=1e-5)


def test_mpc_day_replans_on_an_intensity_spike():
    """A 2.5x realized intensity trips the eta trigger: shaped clusters
    re-plan and the enforced curve leaves the 00:00 plan after hour 0."""
    tp = vcc.synthetic_problem(6, seed=11, device="cpu")
    sol = vcc.solve_vcc(tp, device="cpu")
    gate = sol.shaped
    assert bool(gate.any())
    res, enforced, acc, diag = mpc.mpc_day(
        tp, sol, tp.tau, gate, tp.capacity, tp.u_if,
        torch.full((6, 24), 0.1), tp.ratio, torch.zeros(6), _power,
        tp.eta * 2.5)
    g = gate.numpy()
    assert float(diag.recourse_frac.numpy()[g].max()) > 0.0
    assert float(diag.recourse_depth.numpy()[g].max()) > 0.0
    plan0 = mpc.gated_curve(tp, sol.delta, tp.tau, gate, tp.capacity)
    assert (enforced - plan0).abs().numpy()[g].max() > 1e-4
    np.testing.assert_allclose(enforced[:, 0].numpy(), plan0[:, 0].numpy(),
                               rtol=1e-6)
