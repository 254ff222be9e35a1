"""The hand-written CUDA kernel against its plain version, on the card.

The kernel has no CPU mode, so these tests carry the ``cuda`` marker and
skip without a card. They import neither JAX nor the JAX package, so they
also run on a machine that has only PyTorch:

    python3 -m pytest -q --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerance: atol 1e-4 on delta after 80 steps (the kernel contracts
multiply-adds and sums the hours in a warp-shuffle order).
"""
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
