"""The joint spatio-temporal solve: the port's joint step against the JAX
package's jnp oracle and its Pallas kernel (interpreter), ``solve_joint``
against the live reference, and the port's own contracts.

Tolerances: the joint step atol 1e-5 on d' and 1e-5 x max|g_s| on g_s (one
step of the same float32 arithmetic, hour sums in another order than
XLA's). ``solve_joint`` (20 x 80 temporal steps, then 8 x 25 joint steps):
delta, VCC and mu rtol 1e-4 and atol 1e-4, s and tau atol 1e-4 x max tau,
after the best-of verdict per rollout (``take``) is compared first. A
batch equals its per-problem solves to 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import spatial as jspatial
from repro.core import vcc as jvcc
from repro.kernels.vcc_pgd import kernel as jkernel
from repro.kernels.vcc_pgd import ref as jref
from repro_torch import convert
from repro_torch.core import spatial, vcc
from repro_torch.kernels.vcc_pgd import kernel, ops, ref

H = 24
DROP = 0.8


def joint_rows(n, seed):
    """One joint step's operands in the kernel layout (numpy float32):
    budgets tight enough that some rows are infeasible at tau + s, and
    every fourth row with a shift that empties its budget."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(size=shape).astype(np.float32)

    tau = 1.0 + 4.0 * u(n, 1)
    s = (tau * (u(n, 1) - 0.5)).astype(np.float32)
    s[::4] = -tau[::4]
    u_if = 0.3 + 0.3 * u(n, H)
    pi = 150 + 250 * u(n, H)
    eta = 0.1 + 0.6 * u(n, H)
    price = 0.05 + 0.5 * u(n, 1)
    lam = np.float32(0.7)
    return dict(
        d=(0.3 * (u(n, H) - 0.5)).astype(np.float32), s=s, eta=eta, pi=pi,
        pow_nom=300 + 400 * u(n, H), tau=tau, u_if=u_if,
        u_if_q=(u_if * 1.1).astype(np.float32),
        ratio=1.1 + 0.4 * u(n, H), u_pow_cap=0.75 + 0.25 * u(n, 1),
        capacity=1.0 + 0.6 * u(n, 1), price=price,
        lr_d=(0.5 / (pi.max(1, keepdims=True) * tau / 24
                     * (lam * eta.max(1, keepdims=True) + price))
              ).astype(np.float32)), lam


ORDER = ("d", "s", "eta", "pi", "pow_nom", "tau", "u_if", "u_if_q", "ratio",
         "u_pow_cap", "capacity", "price", "lr_d")


def _close_step(got, want):
    (d, g), (jd, jg) = got, want
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


def test_joint_step_matches_jnp_oracle():
    a, lam = joint_rows(45, 0)
    temp = np.float32(0.02 * a["pow_nom"].mean())
    want = jref.joint_step_arrays(*(jnp.asarray(a[k]) for k in ORDER),
                                  temp, lam, DROP)
    col = torch.ones(45, 1)
    got = ref.joint_step_arrays(*(torch.as_tensor(a[k]) for k in ORDER),
                                float(temp) * col, float(lam) * col, DROP)
    _close_step(got, want)
    # the box at tau + s: some rows collapse to {0}, the others conserve
    d2 = got[0].numpy()
    dead = np.abs(d2).max(1) == 0
    assert dead[::4].all() and not dead.all()
    assert np.abs(d2.sum(1)).max() <= 1e-4 * 24


def test_joint_step_matches_pallas_interpreter():
    a, lam = joint_rows(70, 1)      # a remainder tile of the TPU kernel's 64
    temp = np.float32(0.02 * a["pow_nom"].mean())
    want = jkernel.joint_step_pallas(*(jnp.asarray(a[k]) for k in ORDER),
                                     temp=temp, lambda_e=lam,
                                     drop_limit=DROP, interpret=True)
    got = ref.joint_step_arrays(*(torch.as_tensor(a[k]) for k in ORDER),
                                float(temp), float(lam), DROP)
    _close_step(got, want)


def test_joint_step_kernel_refuses_cpu_tensors_and_counts_its_work():
    a, lam = joint_rows(9, 2)
    t = [torch.as_tensor(a[k]) for k in ORDER]
    col = torch.ones(9, 1)
    before = kernel.joint_step_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.joint_step_cuda(*t, col, col, drop_limit=DROP)
    assert kernel.joint_step_cuda.launches == before
    assert kernel.joint_step_bytes(14336, 24) == 4 * 14336 * (8 * 24 + 9)
    assert kernel.joint_step_shuffles(10) == 10 * 5 * 58
    assert kernel.joint_step_flops(10, 24) > 0


# ---------------------------------------------------------------- problems

def _pair(jp):
    return jp, convert.problem_from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}, "cpu")


def _stack(probs):
    return vcc.VCCProblem(**{
        f: torch.stack([getattr(q, f) for q in probs])
        for f in vcc.VCCProblem.__dataclass_fields__
        if f not in ("drop_limit", *convert.ENSEMBLE)},
        drop_limit=probs[0].drop_limit)


def test_ops_joint_step_keeps_rollouts_apart():
    probs = [_pair(jvcc.synthetic_zonal_problem(n=6, seed=s))[1]
             for s in (1, 2)]
    probs[1] = dataclasses.replace(probs[1], lambda_e=torch.tensor(2.0))
    batch = _stack(probs)

    def step(q):
        d = torch.full_like(q.eta, 0.05) * torch.linspace(-1, 1, H)
        s = 0.2 * q.tau * torch.linspace(-1, 1, q.tau.shape[-1])
        lr = torch.full(q.tau.shape + (1,), 0.01)
        mu = torch.full(q.campus_limit.shape, 0.1)
        temp = 0.02 * q.pow_nom.mean(dim=(-2, -1))
        return ops.joint_step(q, d, s, mu, lr, temp)

    before = kernel.joint_step_cuda.launches
    d2, g_s = step(batch)
    assert kernel.joint_step_cuda.launches == before   # CPU -> plain
    assert d2.shape == (2, 6, H) and g_s.shape == (2, 6)
    for b, q in enumerate(probs):
        db, gb = step(q)
        np.testing.assert_allclose(d2[b].numpy(), db.numpy(), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(g_s[b].numpy(), gb.numpy(), rtol=1e-6)


def _solve_both(jp, p, mobility, jmobility, **kw):
    jsol, jtau, js, diag = jspatial.solve_joint(jp, jmobility,
                                                telemetry=True, **kw)
    sol, tau, s, best = spatial.solve_joint(p, mobility, device="cpu", **kw)
    return (sol, tau, s, best.take), (jsol, jtau, js,
                                 bool(np.asarray(diag["joint_winner"])))


def _close_joint(got, want, p):
    (sol, tau, s, take), (jsol, jtau, js, jtake) = got, want
    assert bool(take) == jtake, "best-of verdict differs"
    scale = float(p.tau.abs().max())
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_array_equal(sol.shaped.numpy(), np.asarray(jsol.shaped))
    for f in ("delta", "vcc", "mu", "y"):
        np.testing.assert_allclose(getattr(sol, f).numpy(),
                                   np.asarray(getattr(jsol, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)
    np.testing.assert_allclose(sol.objective.item(), float(jsol.objective),
                               rtol=1e-4)


def test_solve_joint_matches_reference_at_mobility_03():
    jp, p = _pair(jvcc.synthetic_zonal_problem(n=8, seed=3))
    got, want = _solve_both(jp, p, 0.3, 0.3, outer_iters=10, joint_outer=4)
    _close_joint(got, want, p)
    assert float(got[2].abs().max()) > 0            # budgets moved


def test_solve_joint_tensor_mobility_zero_pins_shift():
    """A tensor mobility runs the joint graph; at 0 the shift bounds are
    {0}, so s stays exactly 0 and tau is the problem's own."""
    jp, p = _pair(jvcc.synthetic_zonal_problem(n=8, seed=5))
    got, want = _solve_both(jp, p, torch.tensor(0.0), jnp.asarray(0.0),
                            outer_iters=10, joint_outer=4)
    _close_joint(got, want, p)
    sol, tau, s, _ = got
    assert torch.equal(s, torch.zeros_like(s))
    assert torch.equal(tau, p.tau)


def test_python_zero_mobility_is_the_temporal_solve():
    p = vcc.synthetic_problem(n=6, seed=2, device="cpu")
    sol, tau, s, best = spatial.solve_joint(p, 0.0, outer_iters=3,
                                            device="cpu")
    plain = vcc.solve_vcc(p, outer_iters=3, device="cpu")
    for f in ("delta", "vcc", "mu", "y", "objective"):
        assert torch.equal(getattr(sol, f), getattr(plain, f)), f
    assert torch.equal(tau, p.tau) and not s.any() and not best.take.any()


def _sequential(p, mobility, **kw):
    tau_sh, _ = spatial.spatial_shift(p, mobility=mobility)
    sol = vcc.solve_vcc(dataclasses.replace(p, tau=tau_sh), device="cpu",
                        **kw)
    lo_s, ub_s = spatial.shift_bounds(p, mobility)
    return sol, torch.clamp(tau_sh - p.tau, lo_s, ub_s)


def test_joint_never_worse_than_sequential_and_feasible():
    """Per rollout of a batch over three mobilities: the joint point's
    objective and carbon are no worse than the sequential warm start's,
    the shift conserves the fleet's budget within its bounds, and delta
    conserves within the box of the shifted budgets."""
    p0 = _pair(jvcc.synthetic_zonal_problem(n=10, seed=7))[1]
    mob = torch.tensor([0.1, 0.3, 0.6])
    batch = _stack([p0] * 3)
    kw = dict(outer_iters=8)
    sol, tau_j, s, best = spatial.solve_joint(batch, mob, device="cpu",
                                              joint_outer=4, **kw)
    seq, s0 = _sequential(batch, mob, **kw)
    obj_j = spatial.joint_objective(batch, sol.delta, s)
    obj_q = spatial.joint_objective(batch, seq.delta, s0)
    assert (obj_j <= obj_q + 1e-6 * obj_q.abs()).all()
    assert (spatial.joint_carbon(batch, sol.delta, s)
            <= spatial.joint_carbon(batch, seq.delta, s0) + 1e-3).all()
    assert best.take.any()                  # the refinement paid somewhere
    assert torch.equal(best.take, best.margin >= 0)
    lo_s, ub_s = spatial.shift_bounds(batch, mob)
    scale = float(batch.tau.abs().max())
    assert s.sum(-1).abs().max() <= 1e-4 * scale
    assert (s >= lo_s - 1e-5 * scale).all() and (s <= ub_s + 1e-5 * scale
                                                 ).all()
    lo, ub, feas = vcc.delta_bounds(dataclasses.replace(batch, tau=tau_j))
    d = sol.delta
    assert torch.equal(feas, sol.shaped)
    assert (d[~feas] == 0).all()
    assert d.sum(-1).abs().max() <= 1e-4 * 24
    # the last joint step projects delta onto the box of the budget before
    # its own s update, so the final box may be tighter by that one step:
    # the reference does the same (here 1.7e-3 at mobility 0.3 and 4.2e-3
    # at 0.6, in both), hence 5e-3 on the upper bound
    assert (d >= lo - 1e-5).all() and (d <= ub + 5e-3).all()


def test_batched_solve_joint_equals_per_problem():
    probs = [_pair(jvcc.synthetic_zonal_problem(n=6, seed=s))[1]
             for s in (8, 9)]
    mob = torch.tensor([0.3, 0.0])
    kw = dict(outer_iters=4, joint_outer=2, joint_inner=10, device="cpu")
    both, tau_b, s_b, best_b = spatial.solve_joint(_stack(probs), mob, **kw)
    for b, q in enumerate(probs):
        sol, tau, s, best = spatial.solve_joint(q, mob[b], **kw)
        assert bool(best_b.take[b]) == bool(best.take)
        for f in ("delta", "vcc", "mu", "objective"):
            want = getattr(sol, f)
            np.testing.assert_allclose(
                getattr(both, f)[b].numpy(), want.numpy(), rtol=0,
                atol=1e-6 * max(1.0, want.abs().max().item()), err_msg=f)
        np.testing.assert_allclose(s_b[b].numpy(), s.numpy(), rtol=0,
                                   atol=1e-6)


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
