"""Plain PyTorch version of the fused VCC projected-gradient epoch.

Mirrors ``repro.kernels.vcc_pgd.ref`` (``project_row``, ``pgd_step_arrays``,
``pgd_epoch_ref``) op for op. One epoch = ``iters`` iterations of
[linearized carbon + softmax-peak gradient -> exact bisection projection onto
{sum_h delta = 0} ∩ [lo, ub]] for a block of cluster rows.

The CPU path of ``ops.pgd_epoch`` runs this; on the card the hand-written
kernel (``kernel.py``) runs instead, and ``chip_smoke.py`` holds the two
against each other. Rows are independent; every tensor carries the row axis
second to last, so leading batch axes pass through.
"""
from __future__ import annotations

import torch


def project_row(z, lo, ub, iters: int = 50):
    """Bisection projection onto {sum_h = 0} ∩ [lo, ub], rows independent.
    z/lo/ub: (..., H). Exactly ``iters`` halvings of the bracket
    [min z - max ub, max z - min lo]."""
    a = z.amin(-1) - ub.amax(-1)
    b = z.amax(-1) - lo.amin(-1)
    for _ in range(iters):
        m = 0.5 * (a + b)
        f = torch.clamp(z - m[..., None], lo, ub).sum(-1)
        pos = f > 0
        a = torch.where(pos, m, a)
        b = torch.where(pos, b, m)
    nu = 0.5 * (a + b)
    return torch.clamp(z - nu[..., None], lo, ub)


def pgd_step_arrays(d, eta, pi, pow_nom, tau24, price, lo, ub, lr, temp,
                    lambda_e, proj_iters: int = 50):
    """One projected-gradient step in the kernel's layout.

    d/eta/pi/pow_nom/lo/ub: (..., H); tau24/price/lr: (..., 1);
    temp/lambda_e: floats or tensors that broadcast as (..., 1)."""
    pow_h = pow_nom + pi * d * tau24
    w = torch.softmax(pow_h / temp, dim=-1)
    grad = (lambda_e * eta + price * w) * pi * tau24
    return project_row(d - lr * grad, lo, ub, proj_iters)


def pgd_epoch_ref(delta, eta, pi, pow_nom, tau24, price, lo, ub, lr, *,
                  temp, lambda_e, iters: int, proj_iters: int = 50):
    """delta/eta/pi/pow_nom/lo/ub: (..., H); tau24/price/lr: (..., 1)."""
    d = delta
    for _ in range(iters):
        d = pgd_step_arrays(d, eta, pi, pow_nom, tau24, price, lo, ub, lr,
                            temp, lambda_e, proj_iters)
    return d
