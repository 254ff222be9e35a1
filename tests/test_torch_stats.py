"""The streaming prediction layer (``repro_torch.core.stats``) against the
JAX package's ``repro.core.stats``, on the CPU.

Inputs come from ``np.random.default_rng`` or from the JAX package's own
burned-in rescan state (``make_init``), carried across with ``convert``.
Tolerances:

* the primitives (EW / deviation moments, rings, the decay): rtol 1e-6;

and, for entries that cross zero (sums that cancel), an absolute floor of
1e-6 x the largest reference value: XLA and torch order a reduction's
adds differently.
* ``init_predictor``, leaf by leaf: EWMA levels and rings rtol 1e-5; the
  ratio moments rtol 1e-4 (sums of 28 x 24 logs); the corrector moments
  rtol 1e-4 with an absolute floor of 1e-4 x their largest value: they
  are deviations (and sums of their products) ~1/40 the size of the
  levels they are differences of, so the levels' few-ulp gaps (~1e-6 of
  a level) grow ~40x in them;
* ``streaming_forecast``: the eight keys rtol 1e-4, theta / alpha / uif_q
  rtol 1e-3 (alpha solves eq. 3 through a clip); ``predictor_update``'s
  carry rtol 1e-5 (the gamma ring's hour quantile and the ratio moments
  1e-4).

The port's own contracts are bitwise: 24 ``hour_update`` calls and
``hour_finalize`` equal ``predictor_update``; the streaming power fit is
the rescan fit; at the hand-off the streaming forecast's EWMA components
are the rescan forecast's; a batch whose rollouts sit on different days
equals its rollouts run alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.core import stats as jstats
from repro_torch import convert
from repro_torch.core import stages, stats

CFG = jsim.SimConfig(n_clusters=8, n_campuses=2, n_zones=2,
                     pds_per_cluster=2, hist_days=14)
SCENARIOS = [jsim.Scenario("baseline"),
             jsim.Scenario("low_risk_tolerance", gamma=0.01)]
DAY_SHIFT = np.array([0, 3])      # the two rollouts sit on different days
HIST = ("hist_uif", "hist_flex_daily", "hist_res_daily", "hist_usage",
        "hist_res", "hist_tr_pred", "hist_uif_pred")
LOOSE = {"ratio", "gamma_err_ring"}   # rtol 1e-4 (see above)
DEV = {"uif_dev", "flex_dev", "res_dev"}   # rtol 1e-4, floor 1e-4 x max


def tol(name):
    """(rtol, absolute floor as a fraction of max|ref|) of a carry leaf."""
    top = name.split(".")[0]
    if top in DEV:
        return 1e-4, 1e-4
    return (1e-4 if top in LOOSE else 1e-5), 1e-6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def close(got, want, rtol, atol_frac=1e-6, what=""):
    want = np.asarray(want)
    got = _np(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = atol_frac * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def leaves(pred, prefix=""):
    """(name, leaf) pairs of a PredictorState, moments flattened."""
    for name, v in zip(pred._fields, pred):
        if hasattr(v, "_fields"):
            yield from leaves(v, f"{prefix}{name}.")
        else:
            yield prefix + name, v


@pytest.fixture(scope="module")
def ref():
    """A burned-in JAX rescan state (B = 2, 8 clusters, 14 days) with the
    rollouts on different days, its streaming carry from the reference,
    and their conversions."""
    jp = jsim.build_batch(CFG, SCENARIOS, [0], 3)
    js = jax.jit(jax.vmap(jsim.make_init(CFG)))(jp)
    js = js._replace(day=js.day + jnp.asarray(DAY_SHIFT, jnp.int32))
    jpred = jax.vmap(jstats.init_predictor)(
        *(getattr(js, k) for k in HIST), js.day, jp.gamma)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp)._asdict(),
                                   "cpu")
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js)._asdict(),
                                  "cpu")
    return {"jp": jp, "js": js, "jpred": jpred, "tp": tp, "ts": ts,
            "tpred": convert.predictor_from_numpy(
                jax.tree.map(np.asarray, jpred), "cpu")}


# -------------------------------------------------------------- primitives

def _rng_xy(seed, shape=(6, 40)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    y = (0.5 + 1.5 * x + 0.3 * rng.normal(size=shape)).astype(np.float32)
    return x, y


def test_ew_moments_match_reference():
    x, y = _rng_xy(0)
    x2, y2 = _rng_xy(1, (6, 24))
    rho = stats.decay_from_half_life(stats.RATIO_HL_DAYS)
    close(rho, jstats.decay_from_half_life(stats.RATIO_HL_DAYS), 1e-6,
          what="rho")
    jm = jstats.ew_update(jstats.ew_init(x, y), x2, y2,
                          jstats.decay_from_half_life(stats.RATIO_HL_DAYS))
    tm = stats.ew_update(stats.ew_init(torch.tensor(x), torch.tensor(y)),
                         torch.tensor(x2), torch.tensor(y2), rho)
    for f in jm._fields:
        close(getattr(tm, f), getattr(jm, f), 1e-6, what=f)
    for a, b, what in zip(stats.ew_linfit(tm), jstats.ew_linfit(jm), "ab"):
        close(a, b, 1e-6, what=what)


def test_dev_moments_match_reference():
    dev = np.random.default_rng(2).normal(size=(6, 8)).astype(np.float32)
    today = np.random.default_rng(3).normal(size=6).astype(np.float32)
    rho = stats.decay_from_half_life(stats.DEV_HL_DAYS)
    jm = jstats.dev_update(jstats.dev_init(dev), today,
                           jstats.decay_from_half_life(stats.DEV_HL_DAYS))
    tm = stats.dev_update(stats.dev_init(torch.tensor(dev)),
                          torch.tensor(today), rho)
    for f in jm._fields:
        close(getattr(tm, f), getattr(jm, f), 1e-6, what=f)
    close(stats.dev_coef(tm), jstats.dev_coef(jm), 1e-6, what="coef")


@pytest.mark.parametrize("hl", [stats.WMEAN_HL_DAYS, stats.DEV_HL_DAYS,
                                stats.RATIO_HL_DAYS, 0.0])
def test_decay_from_half_life_matches_reference(hl):
    close(stats.decay_from_half_life(hl), jstats.decay_from_half_life(hl),
          1e-6, what=str(hl))


def test_rings_match_reference():
    rng = np.random.default_rng(4)
    ring = rng.normal(size=(2, 5, 28)).astype(np.float32)
    x = rng.normal(size=(2, 5)).astype(np.float32)
    q = np.array([0.95, 0.99], np.float32)
    got = stats.ring_push(torch.tensor(ring), torch.tensor(x))
    for b in range(2):
        want = jstats.ring_push(ring[b], x[b])
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        close(stats.ring_quantile(got, torch.tensor(q))[b],
              jstats.ring_quantile(want, q[b]), 1e-6,
              what="per-rollout q")
        close(stats.ring_quantile(got, 0.97)[b],
              jstats.ring_quantile(want, 0.97), 1e-6, what="q 0.97")
    usage = rng.normal(size=(2, 5, 28, 24)).astype(np.float32)
    new = rng.normal(size=(2, 5, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        stats.ring_push(torch.tensor(usage), torch.tensor(new))[1].numpy(),
        np.asarray(jstats.ring_push(usage[1], new[1])))


# --------------------------------------------------- init, forecast, update

def test_init_predictor_matches_reference(ref):
    ts, tp = ref["ts"], ref["tp"]
    got = stats.init_predictor(*(getattr(ts, k) for k in HIST), ts.day,
                               tp.gamma)
    for (name, g), (_, w) in zip(leaves(got), leaves(ref["jpred"])):
        close(g, w, *tol(name), what=name)


def test_streaming_forecast_matches_reference(ref):
    jfc = jax.vmap(jstats.streaming_forecast)(ref["jpred"], ref["js"].day,
                                              ref["jp"].gamma)
    tfc = stats.streaming_forecast(ref["tpred"], ref["ts"].day,
                                   ref["tp"].gamma)
    assert set(tfc) == set(jfc)
    for k in jfc:
        close(tfc[k], jfc[k], 1e-3 if k in ("theta", "alpha", "uif_q")
              else 1e-4, what=k)


def _actuals(fc, seed=5):
    """One observed day near the forecast: (u_if, flex_daily, res_daily,
    usage_total, reservations) as numpy, (B, n[, 24])."""
    rng = np.random.default_rng(seed)
    uif = np.asarray(fc["uif"])
    u_if = uif * (1 + 0.1 * rng.normal(size=uif.shape))
    flex_h = np.abs(0.2 + 0.1 * rng.normal(size=uif.shape))
    usage = u_if + flex_h
    resv = usage * (1.2 + 0.1 * rng.uniform(size=uif.shape))
    out = (u_if, flex_h.sum(-1), resv.sum(-1), usage, resv)
    return tuple(a.astype(np.float32) for a in out)


def test_predictor_update_matches_reference(ref):
    jpred, js, jp = ref["jpred"], ref["js"], ref["jp"]
    jfc = jax.vmap(jstats.streaming_forecast)(jpred, js.day, jp.gamma)
    obs = _actuals(jfc)
    want = jax.vmap(jstats.predictor_update)(jpred, jfc, js.day, jp.gamma,
                                             *obs)
    # both sides absorb the day against the same (the reference's) forecast
    tfc = {k: torch.tensor(np.asarray(v)) for k, v in jfc.items()}
    got = stats.predictor_update(ref["tpred"], tfc, ref["ts"].day,
                                 ref["tp"].gamma,
                                 *(torch.tensor(a) for a in obs))
    for (name, g), (_, w) in zip(leaves(got), leaves(want)):
        close(g, w, *tol(name), what=name)


# ------------------------------------------------------- the port's own

def test_hour_chain_equals_daily_update_bitwise(ref):
    """24 hour_update calls and hour_finalize equal predictor_update on
    the assembled arrays, bit for bit (the reference's own contract)."""
    pred, ts, tp = ref["tpred"], ref["ts"], ref["tp"]
    fc = stats.streaming_forecast(pred, ts.day, tp.gamma)
    rng = np.random.default_rng(6)
    shape = fc["uif"].shape
    u_if = torch.tensor(rng.uniform(0.01, 2.0, shape), dtype=torch.float32)
    use_flex = torch.tensor(rng.uniform(0.0, 1.0, shape), dtype=torch.float32)
    ratio = torch.tensor(rng.uniform(1.0, 2.0, shape), dtype=torch.float32)
    acc = stats.hour_accum_init(shape[:-1])
    for h in range(24):
        acc = stats.hour_update(acc, h, u_if[..., h], use_flex[..., h],
                                ratio[..., h])
    assert acc.hour == 24
    chained = stats.hour_finalize(pred, acc, fc, ts.day, tp.gamma)
    usage = u_if + use_flex
    res = usage * ratio
    batch = stats.predictor_update(pred, fc, ts.day, tp.gamma, u_if,
                                   stages.hour_sum(use_flex),
                                   stages.hour_sum(res), usage, res)
    for (name, a), (_, b) in zip(leaves(chained), leaves(batch)):
        assert torch.equal(a, b), name


def test_handoff_power_fit_and_forecast_equal_the_rescan(ref):
    """The usage ring IS the rescan fit's 28-day window: the PD fits agree
    bit for bit. At the hand-off the streaming forecast equals the port's
    rescan forecast bit for bit on uif / tuf / tr / theta, and to 1e-3 on
    the ratio terms (moment form against centered least squares)."""
    ts, tp = ref["ts"], ref["tp"]
    pred = stats.init_predictor(*(getattr(ts, k) for k in HIST), ts.day,
                                tp.gamma)
    key = stages.prng.fold_in(stages.prng.fold_in(tp.key, ts.day), 1)
    fits = [stages.power_stage(u, tp.lam, tp.truth["capacity"],
                               stages.pd_truth(tp), key)
            for u in (ts.hist_usage, pred.usage_ring)]
    assert torch.equal(fits[0].coef, fits[1].coef)
    assert torch.equal(fits[0].breaks, fits[1].breaks)
    fc_r = stages.forecast_stage(*(getattr(ts, k) for k in HIST), tp.gamma)
    fc_s = stats.streaming_forecast(pred, ts.day, tp.gamma)
    for k in ("uif", "tuf", "tr", "theta"):
        assert torch.equal(fc_r[k], fc_s[k]), k
    for k in ("ratio_a", "ratio_b", "alpha", "uif_q"):
        np.testing.assert_allclose(fc_s[k].numpy(), fc_r[k].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


def _flat(tree):
    out = []
    stages.map_tensors(out.append, tree)
    return out


def test_rollouts_on_different_days_equal_their_runs_alone(ref):
    """Each rollout of the batch reads and writes its own weekday slots:
    init, forecast and update of the two-rollout batch (days differ by 3)
    equal those of each rollout alone, bit for bit."""
    ts, tp = ref["ts"], ref["tp"]
    assert ts.day[0] != ts.day[1]
    obs = [torch.tensor(a) for a in _actuals(
        {"uif": np.ones((2, CFG.n_clusters, 24), np.float32)}, seed=7)]

    def run(s, gamma, obs):
        pred = stats.init_predictor(*(getattr(s, k) for k in HIST), s.day,
                                    gamma)
        fc = stats.streaming_forecast(pred, s.day, gamma)
        return pred, fc, stats.predictor_update(pred, fc, s.day, gamma,
                                                *obs)

    both = _flat(run(ts, tp.gamma, obs))
    for b in range(2):
        def one(t):
            return t[b:b + 1]
        alone = _flat(run(stages.map_tensors(one, ts), one(tp.gamma),
                          [one(a) for a in obs]))
        assert len(alone) == len(both)
        for x, y in zip(both, alone):
            assert torch.equal(one(x), y)


def test_streaming_carry_is_smaller_than_the_windows(ref):
    ts, pred = ref["ts"], ref["tpred"]
    assert stats.predictor_nbytes(pred) < stats.replaced_hist_nbytes(ts)
    assert stats.predictor_nbytes(pred) == jstats.predictor_nbytes(
        ref["jpred"])
