"""Forecast ensembles and the CVaR ensemble epoch: the port against the
JAX package (``repro.core.risk``, the jnp oracle and the Pallas kernel in
its interpreter), and the degenerate-ensemble contracts of the port.

Tolerances: ``prng.randint`` and the sampled members are bitwise. CVaR
values rtol 1e-5 (sums over members in another order). The ensemble epoch
atol 1e-5 on delta, as the plain epoch in test_torch_vcc_pgd (the same
float32 arithmetic; member and hour sums in another order than XLA's). The
ensemble solve (20 x 80 steps) rtol 1e-4 and atol 1e-4, as ``solve_vcc``
in test_torch_solver_vcc. K identical members are exact in the port: the
member reduction is anchored on member 0, so every deviation is 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import risk as jrisk
from repro.core import vcc as jvcc
from repro.kernels.vcc_pgd import kernel as jkernel
from repro.kernels.vcc_pgd import ref as jref
from repro_torch import convert
from repro_torch.core import prng, risk, solver, vcc
from repro_torch.kernels.vcc_pgd import kernel, ops, ref

H = 24
ATOL = 1e-5


# ----------------------------------------------------------------- randint

@pytest.mark.parametrize("span", (13, 34, 1, 2, 1000, 2**20 + 3))
def test_randint_bitwise_over_batched_keys(span):
    seeds = np.array([0, 1, 7, 123456, 2**31 + 5], np.uint32)
    jkeys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(s), 5))(
        jnp.asarray(seeds))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (9,), 0, span))(jkeys))
    got = prng.randint(convert.tensor(np.asarray(jkeys)), (9,), 0, span)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < span
    # an offset range is the same draw shifted
    shifted = prng.randint(convert.tensor(np.asarray(jkeys)), (9,), -4,
                           span - 4)
    np.testing.assert_array_equal(shifted.numpy(), want - 4)


# -------------------------------------------------------------------- CVaR

@pytest.mark.parametrize("beta", (0.05, 0.3, 0.9, 1.0))
def test_cvar_and_soft_cvar_match_reference(beta):
    x = np.random.default_rng(0).normal(size=(8, 5)).astype(np.float32)
    for fn, jfn in ((risk.cvar, jrisk.cvar),
                    (risk.soft_cvar, jrisk.soft_cvar)):
        want = np.asarray(jfn(jnp.asarray(x), beta, axis=0))
        np.testing.assert_allclose(fn(torch.as_tensor(x), beta, axis=0)
                                   .numpy(), want, rtol=1e-5, atol=1e-6)
    # per-row tails along the last axis: what vmap gives in the reference
    betas = np.float32([0.2, 0.5, 0.9, 1.0, 0.05])
    for fn, jfn in ((risk.cvar, jrisk.cvar),
                    (risk.soft_cvar, jrisk.soft_cvar)):
        want = np.asarray(jax.vmap(lambda r, b: jfn(r, b, axis=0))(
            jnp.asarray(x.T), jnp.asarray(betas)))
        got = fn(torch.as_tensor(x.T), torch.as_tensor(betas), axis=-1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    mean, mx = x.mean(0), x.max(0)
    soft = risk.soft_cvar(torch.as_tensor(x), beta, axis=0).numpy()
    assert (soft >= mean - 1e-5).all() and (soft <= mx + 1e-5).all()


# ---------------------------------------------- the ensemble epoch (plain)

def ens_rows(n, K, seed):
    """A bounded CVaR epoch problem in the kernel layout (numpy float32):
    K members of intensity and nominal power around a point forecast;
    every fifth row has its box collapsed to {0}."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(size=shape).astype(np.float32)

    pi = 150 + 250 * u(n, H)
    eta = 0.1 + 0.6 * u(n, H)
    eta_e = np.clip(eta[None] * (1 + 0.4 * (u(K, 1, H) - 0.5)), 1e-4, None)
    pow_nom = 300 + 400 * u(n, H)
    pow_e = pow_nom[None] + 30 * (u(K, n, H) - 0.5)
    eta_e[0], pow_e[0] = eta, pow_nom
    tau24 = 0.05 + 0.3 * u(n, 1)
    price = 0.05 + 0.5 * u(n, 1)
    lam = 0.02 + 2.0 * u(n, 1)
    dead = (np.arange(n) % 5 == 0)[:, None]
    lo = np.where(dead, 0.0, -0.8).astype(np.float32) * np.ones((n, H),
                                                              np.float32)
    ub = np.where(dead, 0.0, 0.1 + 2.9 * u(n, H)).astype(np.float32)
    lr = (0.5 / (pi.max(1, keepdims=True) * tau24
                 * (lam * eta.max(1, keepdims=True) + price))
          ).astype(np.float32)
    arrays = dict(delta=np.zeros((n, H), np.float32), eta_e=eta_e.astype(
        np.float32), pi=pi, pow_e=pow_e.astype(np.float32), tau24=tau24,
        price=price, lo=lo, ub=ub, lr=lr)
    return arrays, np.float32(0.02 * pow_nom.mean())


ORDER = ("delta", "eta_e", "pi", "pow_e", "tau24", "price", "lo", "ub", "lr")


def _feasible(d, lo, ub):
    assert np.abs(d.sum(-1)).max() <= 1e-4 * max(np.abs(ub).max(), 1.0)
    assert (d >= lo - 1e-6).all() and (d <= ub + 1e-6).all()


@pytest.mark.parametrize("K", (1, 3, 8, 32))
def test_ens_epoch_matches_jnp_oracle(K):
    a, temp = ens_rows(45, K, K)
    lam, beta = np.float32(0.7), 0.5
    want = np.asarray(jref.pgd_epoch_ens_ref(
        *(jnp.asarray(a[k]) for k in ORDER), temp=temp, lambda_e=lam,
        risk_s=jref.cvar_sharpness(beta), iters=12))
    # the port takes the per-rollout scalars as per-row columns
    col = torch.ones(45, 1)
    got = ref.pgd_epoch_ens_ref(
        *(torch.as_tensor(a[k]) for k in ORDER), temp=float(temp) * col,
        lambda_e=float(lam) * col, risk_s=ref.cvar_sharpness(beta) * col,
        iters=12).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _feasible(got, a["lo"], a["ub"])


@pytest.mark.parametrize("K,rows", ((3, 70), (8, 45)))
def test_ens_epoch_matches_pallas_interpreter(K, rows):
    # 70 rows leave a remainder tile of the TPU kernel's 64
    a, temp = ens_rows(rows, K, 10 + K)
    risk_s = float(jref.cvar_sharpness(0.9))
    want = np.asarray(jkernel.pgd_epoch_ens_pallas(
        *(jnp.asarray(a[k]) for k in ORDER), temp=temp, lambda_e=0.7,
        risk_s=risk_s, iters=6, interpret=True))
    got = ref.pgd_epoch_ens_ref(
        *(torch.as_tensor(a[k]) for k in ORDER), temp=float(temp),
        lambda_e=0.7, risk_s=risk_s, iters=6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_member_costs_and_weights_match_reference():
    a, temp = ens_rows(20, 8, 3)
    d = np.random.default_rng(4).uniform(-0.5, 0.5, (20, H)).astype(
        np.float32)
    jc, _, jw = jref.member_costs(jnp.asarray(d), jnp.asarray(a["eta_e"]),
                                  jnp.asarray(a["pi"]),
                                  jnp.asarray(a["pow_e"]),
                                  jnp.asarray(a["tau24"]),
                                  jnp.asarray(a["price"]), temp, 0.7)
    tc, _, tw = ref.member_costs(torch.as_tensor(d),
                                 torch.as_tensor(a["eta_e"]),
                                 torch.as_tensor(a["pi"]),
                                 torch.as_tensor(a["pow_e"]),
                                 torch.as_tensor(a["tau24"]),
                                 torch.as_tensor(a["price"]), float(temp),
                                 0.7)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)
    for beta in (0.5, 0.99, 1.0):
        s = jref.cvar_sharpness(beta)
        np.testing.assert_allclose(
            ref.cvar_member_weights(tc, ref.cvar_sharpness(beta)).numpy(),
            np.asarray(jref.cvar_member_weights(jc, s)), rtol=1e-4,
            atol=1e-6)


@pytest.mark.parametrize("K", (1, 3, 8, 32))
def test_identical_members_step_is_the_single_member_step(K):
    a, temp = ens_rows(45, 1, 5)
    args = {k: torch.as_tensor(v) for k, v in a.items()}
    d = torch.as_tensor(np.random.default_rng(6).uniform(
        -0.3, 0.3, (45, H)).astype(np.float32))
    single = ref.pgd_step_arrays(d, args["eta_e"][0], args["pi"],
                                 args["pow_e"][0], args["tau24"],
                                 args["price"], args["lo"], args["ub"],
                                 args["lr"], float(temp), 0.7)
    ens = ref.pgd_step_ens_arrays(
        d, args["eta_e"].expand(K, 45, H), args["pi"],
        args["pow_e"].expand(K, 45, H), args["tau24"], args["price"],
        args["lo"], args["ub"], args["lr"], float(temp), 0.7,
        ref.cvar_sharpness(0.5))
    assert torch.equal(ens, single)


# ------------------------------------------------------------ the problem

def _perturbed(jp, K, seed=0, vol=0.5):
    """K whole-day intensity members around the point forecast (member 0
    the forecast itself) and per-member load noise."""
    rng = np.random.default_rng(seed)
    prof = (1.0 + vol * rng.normal(size=(K, 1, H))).astype(np.float32)
    prof[0] = 1.0
    eta_ens = np.clip(np.asarray(jp.eta)[None] * prof, 1e-4, None)
    uif = np.asarray(jp.u_if)
    uif_ens = (uif[None] * (1 + 0.1 * rng.normal(size=(K,) + uif.shape))
               ).astype(np.float32)
    uif_ens[0] = uif
    return eta_ens.astype(np.float32), uif_ens


def _attach(jp, K, beta, seed=0):
    eta_ens, uif_ens = _perturbed(jp, K, seed)
    jpe = jrisk.attach_ensemble(jp, jnp.asarray(eta_ens),
                                jnp.asarray(uif_ens), beta)
    p = convert.problem_from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}, "cpu")
    pe = risk.attach_ensemble(p, torch.as_tensor(eta_ens),
                              torch.as_tensor(uif_ens), beta)
    return jpe, pe


def test_attach_ensemble_and_objectives_match_reference():
    jpe, pe = _attach(jvcc.synthetic_problem(n=10, seed=3), 8, 0.5)
    np.testing.assert_allclose(pe.pow_nom_ens.numpy(),
                               np.asarray(jpe.pow_nom_ens), rtol=1e-6)
    d = np.random.default_rng(2).uniform(-0.4, 0.4, (10, H)).astype(
        np.float32)
    mu = np.float32([0.1, 0.4])
    args = (jnp.asarray(d), jnp.asarray(mu))
    targs = (torch.as_tensor(d), torch.as_tensor(mu))
    np.testing.assert_allclose(
        risk.member_objectives(pe, *targs).numpy(),
        np.asarray(jrisk.member_objectives(jpe, *args)), rtol=1e-5)
    for fn, jfn in ((risk.soft_cvar_objective, jrisk.soft_cvar_objective),
                    (risk.cvar_objective, jrisk.cvar_objective),
                    (vcc.objective, jvcc.objective)):
        np.testing.assert_allclose(fn(pe, *targs).item(),
                                   float(jfn(jpe, *args)), rtol=1e-5)
    # member 0 is the point forecast: its cost is the nominal objective
    np.testing.assert_allclose(
        risk.member_objectives(pe, *targs)[0].item(),
        vcc.objective(pe, *targs, risk=False).item(), rtol=1e-5)


def test_solve_vcc_with_ensemble_matches_reference():
    jpe, pe = _attach(jvcc.synthetic_problem(), 8, 0.5)
    want = jvcc.solve_vcc(jpe)
    got = vcc.solve_vcc(pe, device="cpu")
    for f in ("delta", "vcc", "mu", "y"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(got.shaped.numpy(), np.asarray(want.shaped))
    np.testing.assert_allclose(got.objective.item(), float(want.objective),
                               rtol=1e-4)


def test_k1_ensemble_solve_is_the_plain_solve():
    jp = jvcc.synthetic_problem(n=8, seed=1)
    _, pe = _attach(jp, 1, 0.5)
    plain = dataclasses.replace(pe, eta_ens=None, pow_nom_ens=None,
                                risk_beta=None)
    a = vcc.solve_vcc(pe, outer_iters=4, inner_iters=20, device="cpu")
    b = vcc.solve_vcc(plain, outer_iters=4, inner_iters=20, device="cpu")
    for f in ("delta", "vcc", "mu", "y", "objective"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_identical_members_epoch_is_the_plain_epoch():
    p = vcc.synthetic_problem(n=9, seed=2, device="cpu")
    pe = risk.attach_ensemble(p, p.eta.expand(4, 9, H),
                              p.u_if.expand(4, 9, H), 0.5)
    lo, ub, ok = vcc.delta_bounds(p)
    lo, ub = torch.where(ok[..., None], lo, 0.0), torch.where(
        ok[..., None], ub, 0.0)
    lr = solver.scaled_lr(0.5, p.pi, p.tau, p.eta, p.lambda_e, p.lambda_p)
    temp = solver.peak_temperature(p.pow_nom, 0.02)
    mu = torch.zeros(2)
    args = (torch.zeros_like(p.eta), mu, lo, ub, lr, temp, 15)
    assert torch.equal(ops.pgd_epoch(pe, *args), ops.pgd_epoch(p, *args))


def test_ensemble_dispatch_keeps_per_rollout_risk():
    """A batch of two ensemble problems with different risk_beta equals
    the per-problem epochs: risk_s is a per-row operand."""
    jp = jvcc.synthetic_problem(n=7, seed=4)
    probs = [_attach(jp, 5, beta, seed=1)[1] for beta in (0.3, 1.0)]
    batch = vcc.VCCProblem(**{
        f: torch.stack([getattr(q, f) for q in probs])
        for f in vcc.VCCProblem.__dataclass_fields__ if f != "drop_limit"},
        drop_limit=probs[0].drop_limit)

    def epoch(q):
        lo, ub, ok = vcc.delta_bounds(q)
        lo, ub = torch.where(ok[..., None], lo, 0.0), torch.where(
            ok[..., None], ub, 0.0)
        lr = solver.scaled_lr(0.5, q.pi, q.tau, q.eta, q.lambda_e,
                              q.lambda_p)
        temp = solver.peak_temperature(q.pow_nom, 0.02)
        return ops.pgd_epoch(q, torch.zeros_like(q.eta),
                             torch.full(q.campus_limit.shape, 0.2), lo, ub,
                             lr, temp, 20)

    before = kernel.pgd_epoch_ens_cuda.launches
    got = epoch(batch)
    assert kernel.pgd_epoch_ens_cuda.launches == before   # CPU -> plain
    for b, q in enumerate(probs):
        np.testing.assert_allclose(got[b].numpy(), epoch(q).numpy(),
                                   rtol=0, atol=1e-6)
    assert not torch.allclose(got[0], got[1])


def test_risk_averse_solve_improves_soft_cvar():
    """Descending the soft-CVaR tilt (weakly) beats the risk-neutral
    solution on that objective, for every sweep beta."""
    jp = jvcc.synthetic_problem()
    p = convert.problem_from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}, "cpu")
    kw = dict(outer_iters=8, inner_iters=40, device="cpu")
    neutral = vcc.solve_vcc(p, **kw)
    for beta in (0.5, 0.9, 0.99):
        pe = _attach(jp, 8, beta)[1]
        sr = vcc.solve_vcc(pe, **kw)
        got = risk.soft_cvar_objective(pe, sr.delta, sr.mu).item()
        base = risk.soft_cvar_objective(pe, neutral.delta, neutral.mu).item()
        assert got <= base + 1e-3 * abs(base), (beta, got, base)


def test_kernel_refuses_cpu_tensors_and_counts_its_work():
    a, temp = ens_rows(9, 3, 1)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    t["eta_e"], t["pow_e"] = t["eta_e"][None], t["pow_e"][None]
    col = torch.full((9, 1), float(temp))
    before = kernel.pgd_epoch_ens_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.pgd_epoch_ens_cuda(*(t[k] for k in ORDER), col, col, col,
                                  iters=2)
    assert kernel.pgd_epoch_ens_cuda.launches == before
    assert kernel.ens_epoch_bytes(14336, 24, 8) == 4 * 14336 * (21 * 24 + 6)
    # more members, more work and more shuffles than the plain epoch
    assert kernel.ens_epoch_flops(100, 24, 8, 80) > \
        kernel.epoch_flops(100, 24, 80)
    assert kernel.ens_epoch_shuffles(100, 8, 80) > \
        kernel.epoch_shuffles(100, 80)


# -------------------------------------------------------------- ensembles

def _history(seed, B=2, n=5, z=3, D=10):
    rng = np.random.default_rng(seed)

    def pos(*shape, lvl=1.0, vol=0.3):
        return np.abs(lvl + vol * rng.normal(size=shape)).astype(np.float32)

    return dict(uif_pred=pos(B, n, H, vol=0.2), hist_pred=pos(B, n, D, H),
                hist_act=pos(B, n, D, H), fc_z=pos(B, z, H, lvl=0.4, vol=0.1),
                chist=pos(B, z, D, H, lvl=0.4, vol=0.1),
                zmap=np.tile(np.arange(n) % z, (B, 1)).astype(np.int32),
                beta=np.float32([0.5, 0.9]), seeds=np.uint32([3, 11])[:B])


@pytest.mark.parametrize("K", (3, 8))
def test_day_ensembles_match_reference_bitwise(K):
    h = _history(K)
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(h["seeds"]))
    want = jax.vmap(lambda k, u, hp, ha, f, c, zm, b: jrisk.day_ensembles(
        k, K, u, hp, ha, f, c, zm, b))(
        jkeys, *(jnp.asarray(h[k]) for k in (
            "uif_pred", "hist_pred", "hist_act", "fc_z", "chist", "zmap",
            "beta")))
    got = risk.day_ensembles(
        convert.tensor(np.asarray(jkeys)), K,
        *(convert.tensor(h[k]) for k in ("uif_pred", "hist_pred",
                                          "hist_act", "fc_z", "chist",
                                          "zmap", "beta")))
    for name in ("uif_ens", "eta_ens"):
        assert got[name].shape == (2, K, 5, H)
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    # member 0 is the point forecast, exactly
    np.testing.assert_array_equal(got["uif_ens"][:, 0].numpy(),
                                  h["uif_pred"])
    np.testing.assert_array_equal(
        got["eta_ens"][:, 0].numpy(),
        np.take_along_axis(h["fc_z"], h["zmap"][..., None].astype(np.int64),
                           1))
    assert (got["uif_ens"] >= 0).all() and (got["eta_ens"] > 0).all()
