"""Day-cycle pipelines: one parity case per ported function of carbon,
power, forecast, admission, slo and spatial, on shared inputs made with
numpy from a seed (random keys come from jax and are handed to both).

Tolerance: rtol 1e-5, with an absolute floor of 1e-6 x the largest
reference value for entries that cross zero. Both sides run the same
float32 formulas; XLA and torch differ in the order of their sums and in
the last bit of exp/log/pow.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admission as jadm
from repro.core import carbon as jcarbon
from repro.core import forecast as jfc
from repro.core import power as jpower
from repro.core import slo as jslo
from repro.core import spatial as jspatial
from repro.core import vcc as jvcc
from repro_torch import convert
from repro_torch.core import (admission, carbon, forecast, power, slo,
                              spatial)

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def T(x):
    return convert.tensor(x)


def _keys(seed, n):
    k = jax.random.split(jax.random.PRNGKey(seed), n)
    return k, T(k)


def _hourly(rng, n=5, days=35):
    """Positive hourly load with a diurnal and a weekly pattern."""
    h = np.arange(24)
    d = np.arange(days)
    base = rng.uniform(2, 8, (n, 1, 1))
    shape = 1 + 0.3 * np.sin(2 * np.pi * (h - 6) / 24)[None, None]
    week = 1 + 0.1 * np.cos(2 * np.pi * d / 7)[None, :, None]
    noise = 1 + 0.05 * rng.normal(size=(n, days, 24))
    return (base * shape * week * noise).astype(np.float32)


# ------------------------------------------------------------------ carbon

@case
def carbon_zone_params(rng):
    zones = jcarbon.default_zones(5)
    tz = carbon.default_zones(5)
    assert [z.name for z in zones] == [z.name for z in tz]
    js, ts = jcarbon.stack_zone_params(zones), carbon.stack_zone_params(tz)
    one = jcarbon.zone_params(zones[2]), carbon.zone_params(tz[2])
    return [(ts[k], js[k]) for k in jcarbon.ZONE_FIELDS] + \
        [(one[1][k], one[0][k]) for k in jcarbon.ZONE_FIELDS]


@case
def carbon_simulate_zone_from(rng):
    jk, tk = _keys(3, 4)
    zps = jcarbon.stack_zone_params(jcarbon.default_zones(4))
    want = jax.vmap(lambda k, p: jcarbon.simulate_zone_from(k, p, 6))(jk,
                                                                     zps)
    got = carbon.simulate_zone_from(tk, {k: T(v) for k, v in zps.items()}, 6)
    return [(got, want)]


@case
def carbon_forecast_day_ahead(rng):
    jk, tk = _keys(4, 3)
    hist = rng.uniform(0.1, 0.6, (3, 9, 24)).astype(np.float32)
    act = rng.uniform(0.1, 0.6, (3, 24)).astype(np.float32)
    vol = rng.uniform(0.0, 0.07, 3).astype(np.float32)
    want = jax.vmap(jcarbon.forecast_day_ahead)(jk, hist, act, vol)
    return [(carbon.forecast_day_ahead(tk, T(hist), T(act), T(vol)), want)]


# ------------------------------------------------------------------- power

def _pd_series(rng, pds=6, t=96):
    cpu = rng.uniform(0.05, 0.95, (pds, t)).astype(np.float32)
    truth = dict(idle_kw=rng.uniform(60, 100, pds).astype(np.float32),
                 slope_kw=rng.uniform(250, 400, pds).astype(np.float32),
                 curve=rng.uniform(0.8, 1.3, pds).astype(np.float32))
    return cpu, truth


@case
def power_simulate_pd_power(rng):
    cpu, truth = _pd_series(rng)
    jk = jax.random.PRNGKey(9)
    want = jpower.simulate_pd_power(jk, jpower.PDTruth(**truth),
                                    jnp.asarray(cpu))
    got = power.simulate_pd_power(
        T(jk), power.PDTruth(**{k: T(v) for k, v in truth.items()}), T(cpu))
    return [(got, want)]


@case
def power_solve_spd(rng):
    m = rng.normal(size=(7, 5, 8)).astype(np.float32)
    A = (m @ m.transpose(0, 2, 1) + np.eye(5, dtype=np.float32))
    b = rng.normal(size=(7, 5)).astype(np.float32)
    want = jax.vmap(jpower._solve_spd)(A, b)
    return [(power._solve_spd(T(A), T(b)), want)]


def _fitted(rng):
    cpu, truth = _pd_series(rng)
    pw = truth["idle_kw"][:, None] + truth["slope_kw"][:, None] * \
        cpu ** truth["curve"][:, None]
    pw = (pw * (1 + 0.01 * rng.normal(size=pw.shape))).astype(np.float32)
    return cpu, pw


def test_fit_pd_model_matches_reference():
    """The hinge basis is nearly collinear (the normal equations have a
    condition number of about 5e3), so in float32 the coefficients are
    fixed only to about 1e-4 of their size, on either side. Checked: the
    breaks (rtol 1e-5), the fitted power (rtol 1e-4), and that the port's
    coefficients are as close to the float64 least-squares solution as
    the reference's are (within twice its distance)."""
    rng = np.random.default_rng(7)
    cpu, pw = _fitted(rng)
    jc, jb = jpower.fit_pd_models(jnp.asarray(cpu), jnp.asarray(pw))
    tc, tb = power.fit_pd_model(T(cpu), T(pw))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5)
    np.testing.assert_allclose(power.pd_power(tc, tb, T(cpu)).numpy(),
                               np.asarray(jpower.pd_power_b(jc, jb, cpu)),
                               rtol=1e-4)
    for r in range(cpu.shape[0]):
        u = cpu[r].astype(np.float64)
        X = np.stack([np.ones_like(u), u] + [
            np.maximum(u - b, 0.0) for b in np.asarray(jb)[r]], -1)
        x64 = np.linalg.solve(X.T @ X + 1e-4 * np.eye(5), X.T @ pw[r])
        ref_gap = np.abs(np.asarray(jc)[r] - x64).max()
        assert np.abs(tc.numpy()[r] - x64).max() <= 2 * ref_gap + 1e-3


@case
def power_pd_power_and_slope(rng):
    cpu, pw = _fitted(rng)
    jc, jb = jpower.fit_pd_models(jnp.asarray(cpu), jnp.asarray(pw))
    u = rng.uniform(0, 1, (6, 13)).astype(np.float32)
    tc, tb = T(jc), T(jb)
    return [(power.pd_power(tc, tb, T(u)), jpower.pd_power_b(jc, jb, u)),
            (power.pd_slope(tc, tb, T(u)), jpower.pd_slope_b(jc, jb, u))]


@case
def power_cluster_power_and_slope(rng):
    cpu, pw = _fitted(rng)
    jc, jb = jpower.fit_pd_models(jnp.asarray(cpu), jnp.asarray(pw))
    lam = np.float32([0.2, 0.1, 0.3, 0.15, 0.15, 0.1])
    u = rng.uniform(0.1, 1.5, 9).astype(np.float32)
    tc, tb = T(jc), T(jb)
    return [(power.cluster_power(tc, tb, T(lam), T(u)),
             jpower.cluster_power(jc, jb, lam, u)),
            (power.cluster_slope(tc, tb, T(lam), T(u)),
             jpower.cluster_slope(jc, jb, lam, u))]


# ---------------------------------------------------------------- forecast

@case
def forecast_ewma(rng):
    x = rng.uniform(0, 5, (9, 4)).astype(np.float32)
    return [(forecast.ewma_alpha(0.5), jfc.ewma_alpha(0.5)),
            (forecast.ewma_alpha(4.0), jfc.ewma_alpha(4.0)),
            (forecast.ewma(T(x), 0.5, dim=0), jfc.ewma(x, 0.5)),
            (forecast.ewma(T(x.T), 4.0, dim=-1), jfc.ewma(x, 4.0))]


@case
def forecast_weekly_and_factor_forecasts(rng):
    hourly = _hourly(rng)
    daily = hourly.mean(-1)
    return [(forecast.weekly_mean_forecast(T(daily)),
             jax.vmap(jfc.weekly_mean_forecast)(daily)),
            (forecast.hourly_factor_forecast(T(hourly)),
             jax.vmap(jfc.hourly_factor_forecast)(hourly)),
            (forecast.daily_factor_forecast(T(daily)),
             jax.vmap(jfc.daily_factor_forecast)(daily))]


@case
def forecast_deviation_coef(rng):
    a = rng.normal(size=(5, 8)).astype(np.float32)
    w = rng.normal(size=(5, 8)).astype(np.float32)
    return [(forecast.deviation_coef(T(a), T(w)),
             jax.vmap(jfc.deviation_coef)(a, w))]


@case
def forecast_inflexible_and_daily_total(rng):
    hourly = _hourly(rng, days=35)
    daily = hourly.sum(-1)
    dow = jnp.asarray(3)
    return [(forecast.forecast_inflexible(T(hourly)),
             jax.vmap(lambda h: jfc.forecast_inflexible(h, dow))(hourly)),
            (forecast.forecast_daily_total(T(daily)),
             jax.vmap(lambda d: jfc.forecast_daily_total(d, dow))(daily))]


@case
def forecast_ratio_model(rng):
    usage = rng.uniform(0.5, 9, (5, 120)).astype(np.float32)
    res = (usage * rng.uniform(1.1, 1.6, (5, 120))).astype(np.float32)
    ja, jb = jax.vmap(jfc.fit_ratio_model)(usage, res)
    ta, tb = forecast.fit_ratio_model(T(usage), T(res))
    return [(ta, ja), (tb, jb),
            (forecast.ratio_at(ta[:, None], tb[:, None], T(usage)),
             jfc.ratio_at(ja[:, None], jb[:, None], usage))]


@case
def forecast_error_quantiles(rng):
    pred = rng.uniform(1, 5, (5, 90)).astype(np.float32)
    act = (pred * (1 + 0.1 * rng.normal(size=(5, 90)))).astype(np.float32)
    q = np.float32([0.95, 0.99, 0.9, 0.97, 0.5])
    return [(forecast.relative_error_quantile(T(pred), T(act), 0.97),
             jax.vmap(lambda p, a: jfc.relative_error_quantile(p, a, 0.97))(
                 pred, act)),
            (forecast.relative_error_quantile(T(pred), T(act), T(q)),
             jax.vmap(jfc.relative_error_quantile)(pred, act, q)),
            (forecast.quantile(T(act), T(np.float32([0.25, 0.5, 0.75]))),
             jnp.quantile(act, jnp.float32([0.25, 0.5, 0.75]), axis=1).T)]


@case
def forecast_theta_alpha(rng):
    tr = rng.uniform(50, 90, 5).astype(np.float32)
    eps = rng.normal(0, 0.5, 5).astype(np.float32)
    uif = rng.uniform(1, 3, (5, 24)).astype(np.float32)
    tuf = rng.uniform(5, 20, 5).astype(np.float32)
    ra = rng.uniform(1.1, 1.4, 5).astype(np.float32)
    rb = -rng.uniform(0.05, 0.1, 5).astype(np.float32)
    theta = jfc.theta_requirement(tr, eps)
    tt = forecast.theta_requirement(T(tr), T(eps))
    return [(tt, theta),
            (forecast.alpha_inflation(tt, T(uif), T(tuf), T(ra), T(rb)),
             jax.vmap(jfc.alpha_inflation)(theta, uif, tuf, ra, rb))]


# --------------------------------------------------------------- admission

def _day(rng, n=6):
    u_if = rng.uniform(2, 5, (n, 24)).astype(np.float32)
    arr = rng.uniform(0, 3, (n, 24)).astype(np.float32)
    ratio = rng.uniform(1.05, 1.6, (n, 24)).astype(np.float32)
    vcc_c = rng.uniform(4, 12, (n, 24)).astype(np.float32)
    cap = rng.uniform(8, 12, n).astype(np.float32)
    q0 = rng.uniform(0, 4, n).astype(np.float32)
    inten = rng.uniform(0.1, 0.6, (n, 24)).astype(np.float32)
    return u_if, arr, ratio, vcc_c, cap, q0, inten


@case
def admission_hour_sum_and_tick(rng):
    u_if, arr, ratio, vcc_c, cap, q0, _ = _day(rng)
    jq, ju = jadm.admission_tick(q0, vcc_c[:, 3], u_if[:, 3], arr[:, 3],
                                 ratio[:, 3], cap)
    tq, tu = admission.admission_tick(T(q0), T(vcc_c[:, 3]), T(u_if[:, 3]),
                                      T(arr[:, 3]), T(ratio[:, 3]), T(cap))
    return [(admission.hour_sum(T(u_if)), jadm.hour_sum(u_if)),
            (tq, jq), (tu, ju)]


def _res_pairs(got, want):
    return [(getattr(got, f), getattr(want, f))
            for f in ("usage_flex", "usage_total", "reservations", "power",
                      "carbon", "served", "arrived", "queue_end", "unmet")]


@case
def admission_run_and_finalize_day(rng):
    u_if, arr, ratio, vcc_c, cap, q0, inten = _day(rng)
    want = jadm.run_day(vcc_c, u_if, arr, ratio, cap, q0,
                        lambda u: 100.0 + 300.0 * u, inten, 0.25)
    got = admission.run_day(T(vcc_c), T(u_if), T(arr), T(ratio), T(cap),
                            T(q0), lambda u: 100.0 + 300.0 * u, T(inten),
                            0.25)
    use = rng.uniform(0, 2, (6, 24)).astype(np.float32)
    qe = rng.uniform(0, 6, 6).astype(np.float32)
    jf = jadm.finalize_day(use, qe, u_if, arr, ratio, q0,
                           lambda u: 90.0 + 250.0 * u, inten, 0.3)
    tf = admission.finalize_day(T(use), T(qe), T(u_if), T(arr), T(ratio),
                                T(q0), lambda u: 90.0 + 250.0 * u, T(inten),
                                0.3)
    return _res_pairs(got, want) + _res_pairs(tf, jf)


# --------------------------------------------------------------------- slo

@case
def slo_update_and_rate(rng):
    n = 12
    st = {"crowded_streak": rng.integers(0, 3, n).astype(np.int32),
          "pause_left": rng.integers(0, 3, n).astype(np.int32),
          "violation_days": rng.integers(0, 4, n).astype(np.int32),
          "observed_days": rng.integers(0, 9, n).astype(np.int32)}
    res = rng.uniform(50, 100, n).astype(np.float32)
    bud = rng.uniform(50, 100, n).astype(np.float32)
    unmet = np.where(rng.uniform(size=n) < 0.5, 0.0,
                     rng.uniform(0, 1, n)).astype(np.float32)
    arrived = rng.uniform(10, 30, n).astype(np.float32)
    cfg = jslo.SLOConfig()
    jn, ja = jslo.update(st, cfg, res, bud, unmet, arrived)
    tn, ta = slo.update({k: T(v) for k, v in st.items()}, slo.SLOConfig(),
                        T(res), T(bud), T(unmet), T(arrived))
    return [(tn[k], jn[k]) for k in jn] + [
        (ta, ja), (slo.violation_rate(tn), jslo.violation_rate(jn))]


# ----------------------------------------------------------------- spatial

@case
def spatial_price_bounds_shift(rng):
    jp = jvcc.synthetic_zonal_problem(n=12)
    p = convert.problem_from_numpy(
        {k: getattr(jp, k) for k in vars(jp)}, "cpu")
    out = [(spatial.carbon_price(p), jspatial.carbon_price(jp))]
    for mob in (0.0, 0.3):
        jlo, jub = jspatial.shift_bounds(jp, mob)
        tlo, tub = spatial.shift_bounds(p, mob)
        jt, _ = jspatial.spatial_shift(jp, mobility=mob)
        tt, _ = spatial.spatial_shift(p, mobility=mob)
        out += [(tlo, jlo), (tub, jub), (tt, jt)]
    tt0, _ = spatial.spatial_shift(p, mobility=0.0)
    assert torch.equal(tt0, p.tau)          # mobility 0 returns tau exactly
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for got, want in CASES[name](rng):
        want = np.asarray(want)
        got = got.numpy() if isinstance(got, torch.Tensor) else \
            np.asarray(got)
        assert got.shape == want.shape, (got.shape, want.shape)
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want)
        else:
            floor = 1e-6 * max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor)
