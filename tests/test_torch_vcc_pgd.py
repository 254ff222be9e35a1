"""The fused VCC PGD epoch: the port's plain version against the JAX
package's jnp oracle and its Pallas kernel (interpreter), and the
dispatcher's routing. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_kernel_cuda.py and chip_smoke.py.

Tolerance: atol 1e-5 on delta. Both sides run the same float32 arithmetic;
sums over the 24 hours are taken in another order, and 80 steps of softmax
and 50-step bisection carry those last-bit differences (measured: a few
1e-6 at most).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vcc_pgd import kernel as jkernel
from repro.kernels.vcc_pgd import ref as jref
from repro_torch import convert
from repro_torch.core import solver, vcc
from repro_torch.kernels.vcc_pgd import kernel, ops, ref

ATOL = 1e-5
H = 24


def make_rows(n, seed):
    """A bounded epoch problem in the kernel layout (numpy float32); every
    fifth row has its box collapsed to {0}."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return rng.uniform(size=shape).astype(np.float32)

    pi = 150 + 250 * u(n, H)
    eta = 0.1 + 0.6 * u(n, H)
    tau24 = 0.05 + 0.3 * u(n, 1)
    price = 0.05 + 0.5 * u(n, 1)
    lam = 0.02 + 2.0 * u(n, 1)
    dead = (np.arange(n) % 5 == 0)[:, None]
    lo = np.where(dead, 0.0, -0.8).astype(np.float32) * np.ones((n, H),
                                                              np.float32)
    ub = np.where(dead, 0.0, 0.1 + 2.9 * u(n, H)).astype(np.float32)
    arrays = dict(
        delta=np.zeros((n, H), np.float32), eta=eta, pi=pi,
        pow_nom=300 + 400 * u(n, H), tau24=tau24, price=price, lo=lo, ub=ub,
        lr=(0.5 / (pi.max(1, keepdims=True) * tau24
                   * (lam * eta.max(1, keepdims=True) + price))
            ).astype(np.float32))
    temp = np.float32(0.02 * arrays["pow_nom"].mean())
    return arrays, temp, lam


ORDER = ("delta", "eta", "pi", "pow_nom", "tau24", "price", "lo", "ub", "lr")


def _j(a):
    return [jnp.asarray(a[k]) for k in ORDER]


def _t(a):
    return [torch.as_tensor(a[k]) for k in ORDER]


def _feasible(d, lo, ub):
    assert np.abs(d.sum(1)).max() <= 1e-4 * max(np.abs(ub).max(), 1.0)
    assert (d >= lo - 1e-6).all() and (d <= ub + 1e-6).all()


def test_project_row_matches_reference():
    rng = np.random.default_rng(0)
    a, _, _ = make_rows(45, 0)
    z = (rng.normal(size=(45, H)) * 2).astype(np.float32)
    want = np.asarray(jref.project_row(jnp.asarray(z), jnp.asarray(a["lo"]),
                                       jnp.asarray(a["ub"])))
    got = ref.project_row(torch.as_tensor(z), torch.as_tensor(a["lo"]),
                          torch.as_tensor(a["ub"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _feasible(got, a["lo"], a["ub"])
    assert (got[::5] == 0).all()      # collapsed rows project to exactly 0


@pytest.mark.parametrize("iters", (1, 80))
def test_epoch_matches_jnp_oracle(iters):
    a, temp, lam = make_rows(45, 1)
    want = np.asarray(jref.pgd_epoch_ref(
        *_j(a), temp=temp, lambda_e=jnp.asarray(lam), iters=iters))
    got = ref.pgd_epoch_ref(*_t(a), temp=float(temp),
                            lambda_e=torch.as_tensor(lam),
                            iters=iters).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _feasible(got, a["lo"], a["ub"])


def test_epoch_matches_pallas_interpreter():
    # ragged against the CUDA kernel's 8 rows per block, <= 64 rows
    a, temp, lam = make_rows(45, 2)
    lam_scalar = np.float32(0.7)
    want = np.asarray(jkernel.pgd_epoch_pallas(
        *_j(a), temp=temp, lambda_e=lam_scalar, iters=20, interpret=True))
    got = ref.pgd_epoch_ref(*_t(a), temp=float(temp),
                            lambda_e=float(lam_scalar), iters=20).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    _feasible(got, a["lo"], a["ub"])


def test_kernel_module_imports_without_cuda_and_refuses_cpu_tensors():
    a, temp, lam = make_rows(9, 3)
    args = _t(a)
    slim = torch.full((9, 1), float(temp))
    before = kernel.pgd_epoch_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel.pgd_epoch_cuda(*args, slim, torch.as_tensor(lam), iters=2)
    assert kernel.pgd_epoch_cuda.launches == before
    assert kernel.epoch_bytes(22528, 24) == 4 * 22528 * (7 * 24 + 5)


def test_epoch_counts_pin_the_layout_and_the_bound():
    """The shuffle counts follow the row-group layout that the CUDA sources
    are built with, by hand at H = 24; the operation counts (the bound's
    yardstick) stay those of the function."""
    header = (kernel.CSRC / "pgd_common.cuh").read_text()
    assert f"#define PGD_LANES {kernel.LANES}\n" in header
    assert kernel.LANES == 4
    # 8 rows a warp, 2 stages a reduction; #1 reduces 54 times a step
    # (softmax 2, bracket 2, 50 bisection sums) and twice an epoch: 13.5
    # shuffles a row and step
    assert kernel.epoch_shuffles(22528, 80) == 2816 * 2 * (80 * 54 + 2)
    assert kernel.epoch_shuffles(1001, 80) == 126 * 2 * (80 * 54 + 2)
    # #2 at K = 8: 4 K + 52 = 84 reductions a step, 21 shuffles a row
    assert kernel.ens_epoch_shuffles(14336, 8, 80) == \
        1792 * 2 * (80 * 84 + 2)
    assert kernel.epoch_flops(22528, 24, 80) == 9_740_341_248
    assert kernel.ens_epoch_flops(14336, 24, 8, 80) == 9_910_849_536


def _problem(seed, lambda_e, n=10, n_dc=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    return vcc.VCCProblem(
        eta=torch.as_tensor(rng.uniform(0.1, 0.7, (n, H)).astype(f)),
        u_if=torch.full((n, H), 0.4), u_if_q=torch.full((n, H), 0.45),
        tau=torch.as_tensor(rng.uniform(2, 5, n).astype(f)),
        pow_nom=torch.as_tensor(rng.uniform(400, 600, (n, H)).astype(f)),
        pi=torch.full((n, H), 300.0), u_pow_cap=torch.full((n,), 0.95),
        capacity=torch.full((n,), 1.3), ratio=torch.full((n, H), 1.3),
        campus=torch.arange(n) % n_dc,
        campus_limit=torch.as_tensor(rng.uniform(500, 900, n_dc).astype(f)),
        lambda_e=torch.tensor(lambda_e), lambda_p=torch.tensor(0.05),
        drop_limit=1.0)


def test_dispatcher_keeps_per_rollout_scalars():
    """A batch of two problems with different carbon prices (and so
    different temperatures and lr) must give each rollout its own epoch:
    a scalar lambda_e or temp would hand every row the first price."""
    probs = [_problem(5, 0.1), _problem(6, 2.0)]
    batch = vcc.VCCProblem(**{
        f: torch.stack([getattr(p, f) for p in probs])
        for f in vcc.VCCProblem.__dataclass_fields__ if f not in ("drop_limit", *convert.ENSEMBLE)},
        drop_limit=1.0)

    def epoch(p):
        lo, ub, ok = vcc.delta_bounds(p)
        lo = torch.where(ok[..., None], lo, 0.0)
        ub = torch.where(ok[..., None], ub, 0.0)
        mu = torch.full(p.campus_limit.shape, 0.3)
        lr = solver.scaled_lr(0.5, p.pi, p.tau, p.eta, p.lambda_e,
                              p.lambda_p)
        temp = solver.peak_temperature(p.pow_nom, 0.02)
        return ops.pgd_epoch(p, torch.zeros_like(p.eta), mu, lo, ub, lr,
                             temp, 30)

    before = kernel.pgd_epoch_cuda.launches
    got = epoch(batch)
    assert kernel.pgd_epoch_cuda.launches == before   # CPU -> plain
    for b, p in enumerate(probs):
        np.testing.assert_allclose(got[b].numpy(), epoch(p).numpy(),
                                   rtol=0, atol=1e-6)
    assert not torch.allclose(got[0], got[1])
