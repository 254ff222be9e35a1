"""Dispatcher for the fused VCC PGD epoch.

Counterpart of ``repro.kernels.vcc_pgd.ops.pgd_epoch`` (plain problems; the
CVaR-ensemble epoch is a later slice). It lays a ``core.vcc.VCCProblem`` out
in the kernel's operands and picks the route by where the tensors lie: a
CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
version. There is no fallback from one to the other.

Batching: the problem's leading axes (the scenario x seed batch) and its
cluster axis flatten into the kernel's row axis, (B * n, H). Per-rollout
scalars (``temp``, ``lambda_e``) become per-row (rows, 1) operands, as
``pgd_epoch_pallas`` broadcasts them, so every rollout keeps its own value.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.vcc_pgd import kernel as _kernel
from repro_torch.kernels.vcc_pgd import ref as _ref


def _rows(x, shape) -> torch.Tensor:
    """Broadcast to ``shape`` (..., n, k) and flatten to (rows, k)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x.expand(shape).reshape(-1, shape[-1]).contiguous()


def pgd_epoch(prob, delta, mu, lo, ub, lr_eff, temp, iters: int,
              proj_iters: int = 50) -> torch.Tensor:
    """``iters`` fused PGD steps for a (possibly batched) VCCProblem.

    delta/lo/ub: (..., n, H); mu: (..., n_dc); lr_eff: (..., n, 1);
    temp: per-rollout, shape (...). Returns the new delta (..., n, H)."""
    shape = delta.shape
    slim = shape[:-1] + (1,)
    dev = delta.device
    price = prob.lambda_p[..., None] + torch.gather(mu, -1, prob.campus)
    args = [_rows(x, shape) for x in (delta, prob.eta, prob.pi,
                                      prob.pow_nom)]
    args += [_rows(prob.tau[..., None] / 24.0, slim),
             _rows(price[..., None], slim)]
    args += [_rows(lo, shape), _rows(ub, shape), _rows(lr_eff, slim)]
    temp = _rows(torch.as_tensor(temp, device=dev)[..., None, None], slim)
    lame = _rows(torch.as_tensor(prob.lambda_e, device=dev)[..., None, None],
                 slim)
    if dev.type == "cuda":
        out = _kernel.pgd_epoch_cuda(*args, temp, lame, iters=int(iters),
                                     proj_iters=proj_iters)
    elif dev.type == "cpu":
        out = _ref.pgd_epoch_ref(*args, temp=temp, lambda_e=lame,
                                 iters=int(iters), proj_iters=proj_iters)
    else:
        raise ValueError(f"no pgd_epoch route for device {dev}")
    return out.reshape(shape)
