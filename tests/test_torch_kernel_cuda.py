"""The hand-written CUDA kernels against their plain versions, on the card.

The kernels have no CPU mode, so these tests carry the ``cuda`` marker and
skip without a card. They import neither JAX nor the JAX package, so they
also run on a machine that has only PyTorch:

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances: atol 1e-4 on delta after 80 steps of either epoch (the kernels
sum the hours, and the CVaR epoch the members, in another order than the
plain versions); one joint step 1e-5 on d' and 1e-5 x max|g_s| on g_s. The
CVaR epoch over K identical members is kernel #1 to 1e-6 (they share their
device code, so bitwise is expected).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import vcc
from repro_torch.kernels.vcc_pgd import kernel, ref

H = 24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _rows(n, seed, device):
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)

    pi, eta = 150 + 250 * u(n, H), 0.1 + 0.6 * u(n, H)
    tau24, price, lam = 0.05 + 0.3 * u(n, 1), 0.05 + 0.5 * u(n, 1), \
        0.02 + 2.0 * u(n, 1)
    dead = (torch.arange(n) % 5 == 0)[:, None]
    lo = torch.where(dead, 0.0, torch.full((n, H), -0.8))
    ub = torch.where(dead, 0.0, 0.1 + 2.9 * u(n, H))
    pow_nom = 300 + 400 * u(n, H)
    lr = 0.5 / (pi.amax(1, keepdim=True) * tau24
                * (lam * eta.amax(1, keepdim=True) + price))
    temp = 0.02 * pow_nom.mean(1, keepdim=True)
    args = [torch.zeros(n, H), eta, pi, pow_nom, tau24, price, lo, ub, lr]
    return [x.to(device) for x in args], temp.to(device), lam.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", (45, 1000))
def test_kernel_matches_plain_on_card(cuda_device, rows):
    args, temp, lam = _rows(rows, rows, cuda_device)
    got = kernel.pgd_epoch_cuda(*args, temp, lam, iters=80)
    want = ref.pgd_epoch_ref(*args, temp=temp, lambda_e=lam, iters=80)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    lo, ub = args[6], args[7]
    assert got.sum(1).abs().max().item() <= 1e-4 * ub.abs().max().item()
    assert bool(((got >= lo - 1e-6) & (got <= ub + 1e-6)).all())


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    args, temp, lam = _rows(16, 3, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        kernel.pgd_epoch_cuda(args[0].double(), *args[1:], temp, lam,
                              iters=1)
    wide = [torch.zeros(16, 33, device=cuda_device)] * 4
    with pytest.raises(ValueError, match="H <= 32"):
        kernel.pgd_epoch_cuda(*wide, *args[4:6], wide[0], wide[0], args[8],
                              temp, lam, iters=1)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.pgd_epoch_cuda(args[0].t().contiguous().t(), *args[1:], temp,
                              lam, iters=1)


@pytest.mark.cuda
def test_solve_on_card_goes_through_the_kernel(cuda_device):
    p = vcc.synthetic_problem(device="cpu")
    before = kernel.pgd_epoch_cuda.launches
    on_card = vcc.solve_vcc(p, device=cuda_device)
    assert kernel.pgd_epoch_cuda.launches == before + 20
    on_cpu = vcc.solve_vcc(p, device="cpu")
    np.testing.assert_allclose(on_card.delta.cpu().numpy(),
                               on_cpu.delta.numpy(), rtol=0, atol=1e-4)


def _members(rows, K, seed, device, B=1):
    """A CVaR epoch problem: kernel #1's rows plus K members of intensity
    and nominal power (member 0 the point forecast), stacked (B, K, n, H)
    with B * n = rows."""
    args, temp, lam = _rows(rows, seed, device)
    g = torch.Generator().manual_seed(seed + 1)
    delta, eta, pi, pow_nom = (x.cpu() for x in args[:4])
    prof = 1 + 0.4 * (torch.rand(K, 1, H, generator=g) - 0.5)
    prof[0] = 1.0
    noise = 30 * (torch.rand(K, rows, H, generator=g) - 0.5)
    noise[0] = 0.0
    n = rows // B

    def stack(x):
        return x.reshape(K, B, n, H).transpose(0, 1).contiguous().to(device)

    eta_e, pow_e = stack(eta[None] * prof), stack(pow_nom[None] + noise)
    risk_s = torch.full((rows, 1), 4.0 * (1 - 0.5) / 0.5, device=device)
    return args, eta_e, pow_e, temp, lam, risk_s


@pytest.mark.cuda
@pytest.mark.parametrize("K,rows,B", ((8, 45, 1), (3, 1000, 4), (32, 1000, 2)))
def test_ens_kernel_matches_plain_on_card(cuda_device, K, rows, B):
    args, eta_e, pow_e, temp, lam, rs = _members(rows, K, rows + K,
                                                 cuda_device, B)
    d, _, pi, _, tau24, price, lo, ub, lr = args
    before = kernel.pgd_epoch_ens_cuda.launches
    got = kernel.pgd_epoch_ens_cuda(d, eta_e, pi, pow_e, tau24, price, lo,
                                    ub, lr, temp, lam, rs, iters=80)
    assert kernel.pgd_epoch_ens_cuda.launches == before + 1
    shape = (B, rows // B)
    want = ref.pgd_epoch_ens_ref(
        *(x.reshape(*shape, x.shape[-1]) for x in (d,)), eta_e,
        *(x.reshape(*shape, x.shape[-1]) for x in (pi,)), pow_e,
        *(x.reshape(*shape, x.shape[-1]) for x in (tau24, price, lo, ub,
                                                   lr)),
        temp=temp.reshape(*shape, 1), lambda_e=lam.reshape(*shape, 1),
        risk_s=rs.reshape(*shape, 1), iters=80).reshape(rows, H)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    assert got.sum(1).abs().max().item() <= 1e-4 * ub.abs().max().item()
    assert bool(((got >= lo - 1e-6) & (got <= ub + 1e-6)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("K", (1, 8, 32))
def test_identical_members_ens_kernel_is_kernel_1(cuda_device, K):
    args, temp, lam = _rows(1000, 7, cuda_device)
    d, eta, pi, pow_nom, tau24, price, lo, ub, lr = args
    rs = torch.full((1000, 1), 4.0, device=cuda_device)
    ens = kernel.pgd_epoch_ens_cuda(
        d, eta.expand(1, K, 1000, H).contiguous(), pi,
        pow_nom.expand(1, K, 1000, H).contiguous(), tau24, price, lo, ub, lr,
        temp, lam, rs, iters=80)
    plain = kernel.pgd_epoch_cuda(*args, temp, lam, iters=80)
    torch.cuda.synchronize()
    assert (ens - plain).abs().max().item() <= 1e-6


def _joint(rows, seed, device):
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g)

    tau = 1.0 + 4.0 * u(rows, 1)
    s = tau * (u(rows, 1) - 0.5)
    s[::4] = -tau[::4]
    u_if, pi, eta = 0.3 + 0.3 * u(rows, H), 150 + 250 * u(rows, H), \
        0.1 + 0.6 * u(rows, H)
    price, lam = 0.05 + 0.5 * u(rows, 1), 0.02 + 2.0 * u(rows, 1)
    lr = 0.5 / (pi.amax(1, keepdim=True) * tau / 24
                * (lam * eta.amax(1, keepdim=True) + price))
    pow_nom = 300 + 400 * u(rows, H)
    args = [0.3 * (u(rows, H) - 0.5), s, eta, pi, pow_nom, tau, u_if,
            u_if * 1.1, 1.1 + 0.4 * u(rows, H), 0.75 + 0.25 * u(rows, 1),
            1.0 + 0.6 * u(rows, 1), price, lr,
            0.02 * pow_nom.mean(1, keepdim=True), lam]
    return [x.to(device).contiguous() for x in args]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", (45, 1000))
def test_joint_kernel_matches_plain_on_card(cuda_device, rows):
    args = _joint(rows, rows, cuda_device)
    before = kernel.joint_step_cuda.launches
    d, g = kernel.joint_step_cuda(*args, drop_limit=0.8)
    assert kernel.joint_step_cuda.launches == before + 1
    wd, wg = ref.joint_step_arrays(*args, drop_limit=0.8)
    torch.cuda.synchronize()
    assert (d - wd).abs().max().item() <= 1e-5
    assert (g - wg).abs().max().item() <= 1e-5 * wg.abs().max().item()
    assert bool((d[::4] == 0).all())          # emptied budgets: box {0}


@pytest.mark.cuda
def test_joint_solve_with_members_goes_through_the_kernels(cuda_device):
    """solve_joint and the CVaR solve after it, on the card: 20 launches
    of kernel #1 (the warm start), 8 x 25 of the joint step and 20 of the
    CVaR epoch, and the cpu run of the same problem agrees."""
    from repro_torch.core import risk, spatial
    p = vcc.synthetic_problem(n=16, seed=3, device="cpu")
    p = dataclasses.replace(p, eta=p.eta * torch.where(
        torch.arange(16) % 2 == 0, 2.2, 0.5)[:, None],
        capacity=p.capacity * 0.85)
    members = torch.stack([p.eta * (1 + 0.2 * k) for k in range(4)])
    counts = (kernel.pgd_epoch_cuda, kernel.joint_step_cuda,
              kernel.pgd_epoch_ens_cuda)
    before = [c.launches for c in counts]
    out = {}
    for dev in (cuda_device, "cpu"):
        sol, tau_j, s, _ = spatial.solve_joint(p, 0.3, device=dev)
        pe = risk.attach_ensemble(dataclasses.replace(p.to(dev), tau=tau_j),
                                  members.to(dev), p.u_if.expand(4, 16, H)
                                  .to(dev), 0.5)
        out[str(dev)] = (s, vcc.solve_vcc(pe, device=dev).delta)
    assert [c.launches - b for c, b in zip(counts, before)] == [20, 200, 20]
    (s_gpu, d_gpu), (s_cpu, d_cpu) = out["cuda"], out["cpu"]
    assert (s_gpu.cpu() - s_cpu).abs().max().item() <= 1e-3 * \
        p.tau.abs().max().item()
    assert (d_gpu.cpu() - d_cpu).abs().max().item() <= 1e-3
