"""The default (paper-mode) day: each stage and one whole ``make_day_step``
of the port against the JAX package, on a ``SimState`` made by the JAX
``make_init`` and carried across with ``convert``.

Tolerance for each stage on the reference's own inputs: rtol 1e-4, with
an absolute floor of 1e-4 x the largest reference value for entries that
cross zero (queues, deviations). The stages chain float32 reductions that
XLA and torch order differently; the fitted PD power curves are compared
through the power they predict, since their coefficients are
ill-conditioned (see test_torch_pipelines). The whole-day tests state
their own tolerances and why. A batched step equals the per-rollout steps
to 1e-6 (the same torch arithmetic on different batch extents).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.core import power as jpower
from repro.core import stages as jstages
from repro.core import vcc as jvcc
from repro_torch import convert
from repro_torch.core import stages, vcc

CFG = jsim.SimConfig(n_clusters=8, n_campuses=2, n_zones=3,
                     pds_per_cluster=2, hist_days=35)
SCENARIOS = [jsim.Scenario("high_carbon_price", "lambda_e x4", lambda_e=2.0),
             jsim.Scenario("spatial_mobility", "mobility 0.3", mobility=0.3)]
SEEDS = (0, 1)
DAYS = 2


def _np(tree):
    tree = jax.tree.map(np.asarray, tree)
    return tree._asdict() if hasattr(tree, "_asdict") else tree


def close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        floor = 1e-4 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=floor,
                                   err_msg=what)


@pytest.fixture(scope="module")
def ref():
    """JAX params and burned-in state, plus their conversions."""
    jp = jsim.build_batch(CFG, SCENARIOS, list(SEEDS), DAYS)
    js = jax.jit(jax.vmap(jsim.make_init(CFG)))(jp)
    return {"jp": jp, "js": js,
            "tp": convert.params_from_numpy(_np(jp), "cpu"),
            "ts": convert.state_from_numpy(_np(js), "cpu")}


def _xs(jp, d=0):
    return {k: getattr(jp, k)[:, d] for k in
            ("green_scale", "coal_scale", "cap_scale", "arrival_scale",
             "campus_scale")}


def _model(jm):
    return stages.PowerModel(*(convert.tensor(np.asarray(x)) for x in jm))


def test_make_init_matches_reference(ref):
    init = stages.make_init(CFG.n_clusters, CFG.n_campuses, CFG.n_zones,
                            CFG.hist_days, device="cpu")
    got = init(ref["tp"])
    for name, want in _np(ref["js"]).items():
        if want is not None:
            close(getattr(got, name), want, name)


def test_stages_match_reference(ref):
    jp, js, tp, ts = ref["jp"], ref["js"], ref["tp"], ref["ts"]
    xs = _xs(jp)
    txs = {k: convert.tensor(np.asarray(v)) for k, v in xs.items()}
    day_key = jax.vmap(jax.random.fold_in)(jp.key, js.day)
    tkey = stages.prng.fold_in(tp.key, ts.day)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(day_key))

    # carbon
    ck = jax.vmap(lambda k: jax.random.fold_in(k, 4))(day_key)
    jact, jfc_z = jax.vmap(jstages.carbon_stage)(
        jp.zone, js.carbon_hist, ck, xs["green_scale"], xs["coal_scale"])
    tact, tfc_z = stages.carbon_stage(
        tp.zone, ts.carbon_hist, stages.prng.fold_in(tkey, 4),
        txs["green_scale"], txs["coal_scale"])
    close(tact, jact, "act_z")
    close(tfc_z, jfc_z, "fc_z")

    # forecast
    jfc = jax.vmap(jstages.forecast_stage)(
        js.hist_uif, js.hist_flex_daily, js.hist_res_daily, js.hist_usage,
        js.hist_res, js.hist_tr_pred, js.hist_uif_pred, js.day, jp.gamma)
    tfc = stages.forecast_stage(
        ts.hist_uif, ts.hist_flex_daily, ts.hist_res_daily, ts.hist_usage,
        ts.hist_res, ts.hist_tr_pred, ts.hist_uif_pred, tp.gamma)
    for k in jfc:
        close(tfc[k], jfc[k], f"fc[{k}]")

    # power: the fitted model, compared through the power it predicts
    pk = jax.vmap(lambda k: jax.random.fold_in(k, 1))(day_key)
    jm = jax.vmap(lambda hu, lam, cap, i, s, c, k: jstages.power_stage(
        hu, lam, cap, jpower.PDTruth(i, s, c), k))(
        js.hist_usage, jp.lam, jp.truth["capacity"], jp.pd_idle,
        jp.pd_slope, jp.pd_curve, pk)
    tm = stages.power_stage(ts.hist_usage, tp.lam, tp.truth["capacity"],
                            stages.pd_truth(tp), stages.prng.fold_in(tkey, 1))
    close(tm.breaks, jm.breaks, "breaks")
    u = ts.hist_usage[:, :, -1]
    close(stages.model_power(tm, u), stages.model_power(_model(jm), u),
          "model_power")
    # the slope is a sum of hinge coefficients, each fixed by float32 only
    # to ~1e-4 of its size: rtol 2e-3 (measured gap 8e-4)
    np.testing.assert_allclose(stages.model_slope(tm, u).numpy(),
                               stages.model_slope(_model(jm), u).numpy(),
                               rtol=2e-3)

    # optimize (spatial pre-shift + VCC solve) on the reference's inputs
    cap_day = jp.truth["capacity"] * xs["cap_scale"]
    eta_fc = jax.vmap(lambda f, z: f[z])(jfc_z, js.zmap)
    scfg = jstages.StageConfig()
    jprob, jsol, _ = jax.vmap(
        lambda *a: jstages.optimize_stage(scfg, *a))(
        jfc, eta_fc, jm, js.queue, js.u_pow_cap * xs["cap_scale"], cap_day,
        js.campus, js.campus_limit * xs["campus_scale"], jp.lambda_e,
        jp.lambda_p, jp.mobility)
    tprob, tsol, _ = stages.optimize_stage(
        {k: convert.tensor(np.asarray(v)) for k, v in jfc.items()},
        convert.tensor(np.asarray(eta_fc)), _model(jm), ts.queue,
        ts.u_pow_cap * txs["cap_scale"], tp.truth["capacity"]
        * txs["cap_scale"], ts.campus, ts.campus_limit * txs["campus_scale"],
        tp.lambda_e, tp.lambda_p, tp.mobility)
    for f in ("tau", "pow_nom", "pi", "ratio"):
        close(getattr(tprob, f), getattr(jprob, f), f"prob.{f}")
    for f in ("delta", "vcc", "y", "mu", "shaped", "objective"):
        close(getattr(tsol, f), getattr(jsol, f), f"sol.{f}")

    # observe (shaped + counterfactual admission) on the reference's curve
    vcc_curve = jsol.vcc
    jres, jcf, _, _ = jax.vmap(
        lambda tr, d, k, v, c, a, q, cq, m, it: jstages.observe_stage(
            tr, d, k, v, c, a, q, cq,
            lambda uu: jstages.model_power(m, uu), it))(
        jp.truth, js.day, day_key, vcc_curve, cap_day, xs["arrival_scale"],
        js.queue, js.cf_queue, jm, jax.vmap(lambda f, z: f[z])(jact, js.zmap))
    tmod = _model(jm)
    tres, tcf, _, _ = stages.observe_stage(
        tp.truth, ts.day, tkey, convert.tensor(np.asarray(vcc_curve)),
        tp.truth["capacity"] * txs["cap_scale"], txs["arrival_scale"],
        ts.queue, ts.cf_queue, lambda uu: stages.model_power(tmod, uu),
        convert.tensor(np.asarray(jax.vmap(lambda f, z: f[z])(jact,
                                                              js.zmap))))
    for f in dataclasses.fields(tres):
        close(getattr(tres, f.name), getattr(jres, f.name), f"res.{f.name}")
        close(getattr(tcf, f.name), getattr(jcf, f.name), f"cf.{f.name}")

    # slo feedback
    jslo = {k: getattr(js, k) for k in ("crowded_streak", "pause_left",
                                        "violation_days", "observed_days")}
    jnew, jallowed = jstages.slo_stage(
        jslo, jstages.slo.SLOConfig(), jstages.hour_sum(jres.reservations),
        jstages.hour_sum(vcc_curve), jres.unmet, jres.arrived)
    tnew, tallowed = stages.slo_stage(
        {k: getattr(ts, k) for k in jslo}, stages.slo.SLOConfig(),
        stages.hour_sum(convert.tensor(np.asarray(jres.reservations))),
        stages.hour_sum(convert.tensor(np.asarray(vcc_curve))),
        convert.tensor(np.asarray(jres.unmet)),
        convert.tensor(np.asarray(jres.arrived)))
    for k in jnew:
        close(tnew[k], jnew[k], f"slo.{k}")
    close(tallowed, jallowed, "shaping_allowed")


def _jax_model(jp, js):
    day_key = jax.vmap(jax.random.fold_in)(jp.key, js.day)
    pk = jax.vmap(lambda k: jax.random.fold_in(k, 1))(day_key)
    return jax.vmap(lambda hu, lam, cap, i, s, c, k: jstages.power_stage(
        hu, lam, cap, jpower.PDTruth(i, s, c), k))(
        js.hist_usage, jp.lam, jp.truth["capacity"], jp.pd_idle,
        jp.pd_slope, jp.pd_curve, pk)


@pytest.fixture(scope="module")
def day(ref):
    jp, js = ref["jp"], ref["js"]
    jstep = jax.jit(jax.vmap(jstages.make_day_step(jstages.StageConfig())))
    jnew, jout = jstep(jp, js, _xs(jp))
    xs = {k: convert.tensor(np.asarray(v)) for k, v in _xs(jp).items()}
    return jnew, jout, xs


def test_day_step_matches_reference(ref, day, monkeypatch):
    """Whole day, with the reference's fitted PD power curves handed to
    the port (their coefficients are ill-conditioned in float32 and are
    held against the reference through their predictions above; the
    VCC solution is sensitive to the slopes they give).

    One known exception: the greedy spatial pre-shift (mobility > 0)
    fills an importing cluster exactly to its headroom, which puts
    sum_h ub at 0 and leaves the solver's feasibility test
    ``sum_h ub >= 0`` to rounding. Such knife-edge clusters of the
    reference's own problem (|sum_h ub| <= 1e-5 x 24 max|ub|) may flip
    between shaped and unshaped; every other cluster must agree.

    Tolerance: rtol 1e-4 everywhere, with an absolute floor of 1e-3 x the
    largest reference value. Inside a whole day the solve takes the
    port's own forecasts (1e-5 apart from the reference's) and its 1,600
    steps of an unconverged softmax-peak descent move delta by ~100x that
    (measured: 7e-4 of max|delta|, 2e-4 of the VCC and the shaped
    power)."""
    jp, js, tp, ts = ref["jp"], ref["js"], ref["tp"], ref["ts"]
    jnew, jout, xs = day
    model = _model(_jax_model(jp, js))
    monkeypatch.setattr(stages, "power_stage", lambda *a, **k: model)
    tnew, tout = stages.make_day_step(stages.StageConfig())(tp, ts, xs)
    keep = _not_knife_edge(jp, jout)

    for name, want in _np(jnew).items():
        if want is not None:
            _check(getattr(tnew, name), want, keep, f"state.{name}")
    for f in ("delta", "vcc", "mu", "shaped"):
        _check(getattr(tout.sol, f), getattr(jout.sol, f), keep, f"sol.{f}")
    for f in ("carbon", "power", "served", "queue_end", "unmet"):
        _check(getattr(tout.res, f), getattr(jout.res, f), keep, f"res.{f}")
        _check(getattr(tout.cf, f), getattr(jout.cf, f), keep, f"cf.{f}")
    _check(tout.vcc_curve, jout.vcc_curve, keep, "vcc_curve")


def _not_knife_edge(jp, jout):
    """(B, n) mask of clusters whose feasibility is not decided by
    rounding in the reference's problem (see above)."""
    _, jub, _ = jax.vmap(jvcc.delta_bounds)(jout.prob)
    jub = np.asarray(jub)
    edge = np.abs(jub.sum(-1)) <= 1e-5 * 24 * np.abs(jub).max(-1)
    assert not edge[np.asarray(jp.mobility) == 0].any()
    assert edge.sum() <= 2
    return ~edge


def _check(got, want, keep, what, floor=1e-3):
    want = np.asarray(want)
    got = got.numpy()
    if want.ndim >= 2 and want.shape[1] == CFG.n_clusters:
        got, want = got[keep], want[keep]
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(
            got, want, rtol=1e-4, atol=floor * max(float(np.abs(want).max()),
                                                   1e-30), err_msg=what)


def test_day_step_with_own_power_fit_matches_reference(ref, day):
    """The unmodified port day. Everything upstream of the solve (the
    forecasts, the grid, the sampled truth and the unshaped
    counterfactual) to rtol 1e-4; the shaped day's fleet totals per
    rollout, over the clusters that are not knife-edge, to rtol 1e-3,
    the end-to-end tolerance of test_torch_rollout. (The port's own PD
    fit gives slopes up to ~1e-3 apart from the reference's, which moves
    single clusters' deviations by up to 2e-2 of max|delta|.)"""
    jp, tp, ts = ref["jp"], ref["tp"], ref["ts"]
    jnew, jout, xs = day
    tnew, tout = stages.make_day_step(stages.StageConfig())(tp, ts, xs)
    keep = _not_knife_edge(jp, jout)
    for k in jout.fc:
        close(tout.fc[k], jout.fc[k], f"fc[{k}]")
    close(tnew.carbon_hist, jnew.carbon_hist, "carbon_hist")
    close(tnew.hist_uif, jnew.hist_uif, "hist_uif")
    close(tout.eta_act, jout.eta_act, "eta_act")
    for f in ("carbon", "power", "served", "queue_end"):
        close(getattr(tout.cf, f), getattr(jout.cf, f), f"cf.{f}")
    for f in ("carbon", "power", "usage_total", "served"):
        got = getattr(tout.res, f).numpy()
        want = np.asarray(getattr(jout.res, f))
        if want.ndim == 3:
            got, want = got.sum(-1), want.sum(-1)
        np.testing.assert_allclose((got * keep).sum(1), (want * keep).sum(1),
                                   rtol=1e-3, err_msg=f)


def test_batched_step_equals_per_rollout_steps(ref):
    tp, ts = ref["tp"], ref["ts"]
    step = stages.make_day_step(stages.StageConfig())
    xs = {k: convert.tensor(np.asarray(v)) for k, v in _xs(ref["jp"]).items()}
    new, out = step(tp, ts, xs)
    for b in range(ts.day.shape[0]):
        def one(t):
            return t[b:b + 1]
        nb, ob = step(stages.map_tensors(one, tp), stages.map_tensors(one, ts),
                      {k: one(v) for k, v in xs.items()})
        for name in new._fields:
            if getattr(nb, name) is None:  # the rescan state carries no pred
                assert getattr(new, name) is None, name
                continue
            want, got = getattr(nb, name), getattr(new, name)[b:b + 1]
            if want.dtype.is_floating_point:
                np.testing.assert_allclose(
                    got.numpy(), want.numpy(), rtol=0,
                    atol=1e-6 * max(want.abs().max().item(), 1.0),
                    err_msg=name)
            else:
                assert torch.equal(got, want), name
        np.testing.assert_allclose(out.sol.delta[b:b + 1].numpy(),
                                   ob.sol.delta.numpy(), rtol=0, atol=1e-6)
