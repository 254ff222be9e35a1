"""Dispatchers for the VCC PGD kernels.

Counterparts of ``repro.kernels.vcc_pgd.ops.pgd_epoch`` and ``joint_step``,
and ``joint_step_s``: the joint step with the fleet-coupled shift update
that ``repro.core.solver.joint_epochs`` runs after it (``joint_stepper``
lays a dual-ascent round's fixed operands out once for its steps).
They lay a ``core.vcc.VCCProblem`` out in the kernels' operands and pick the
route by where the tensors lie: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the plain version. There is no fallback from one to
the other.

Batching: for the kernels, the problem's leading axes (the scenario x seed
batch) and its cluster axis flatten into the row axis, (B * n, H); the
plain versions take the leading axes as they are. Per-rollout scalars
(``temp``, ``lambda_e``, ``risk_s``) become per-row (..., n, 1) operands,
as the TPU kernels broadcast them, so every rollout keeps its own value.
Ensemble member stacks (B, K, n, H) are handed over where they lie.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.vcc_pgd import kernel as _kernel
from repro_torch.kernels.vcc_pgd import ref as _ref


def _layout(delta):
    """How operands reach the route ``delta``'s device picks: (on_card,
    lay). ``lay(x, shape)`` broadcasts ``x`` to ``shape``; for the kernels
    it flattens the leading axes and the cluster axis into contiguous
    (rows, k), the plain versions take the leading axes as they are.
    A CUDA tensor goes to the kernels, a CPU tensor to the plain versions,
    anything else raises."""
    dev = delta.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no vcc_pgd route for device {dev}")
    on_card = dev.type == "cuda"

    def lay(x, shape):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev).expand(shape)
        return x.reshape(-1, shape[-1]).contiguous() if on_card else x

    return on_card, lay


def _per_rollout(lay, x, slim):
    """A per-rollout scalar of shape (...) as a per-row (..., n, 1)."""
    return lay(torch.as_tensor(x)[..., None, None], slim)


def pgd_epoch(prob, delta, mu, lo, ub, lr_eff, temp, iters: int,
              proj_iters: int = 50) -> torch.Tensor:
    """``iters`` fused PGD steps for a (possibly batched) VCCProblem.

    delta/lo/ub: (..., n, H); mu: (..., n_dc); lr_eff: (..., n, 1);
    temp: per-rollout, shape (...). Returns the new delta (..., n, H).
    A problem carrying a forecast ensemble (``prob.eta_ens`` (..., K, n, H))
    takes the CVaR ensemble epoch at its ``risk_beta``."""
    shape = delta.shape
    slim = shape[:-1] + (1,)
    on_card, lay = _layout(delta)
    price = prob.lambda_p[..., None] + torch.gather(mu, -1, prob.campus)
    d, pi, lo, ub = (lay(x, shape) for x in (delta, prob.pi, lo, ub))
    tau24, price, lr = (lay(x, slim) for x in (prob.tau[..., None] / 24.0,
                                               price[..., None], lr_eff))
    scal = dict(temp=_per_rollout(lay, temp, slim),
                lambda_e=_per_rollout(lay, prob.lambda_e, slim))
    if prob.eta_ens is None:
        eta, pow_nom = lay(prob.eta, shape), lay(prob.pow_nom, shape)
        fn = _kernel.pgd_epoch_cuda if on_card else _ref.pgd_epoch_ref
    else:
        # the member stacks go as they lie: the kernel reads them through
        # their member stride, so nothing is re-laid out per launch
        eta, pow_nom = prob.eta_ens.contiguous(), prob.pow_nom_ens.contiguous()
        if on_card:     # the kernel takes (B, K, n, H): B = 1 if unbatched
            eta, pow_nom = (x.reshape((-1,) + x.shape[-3:])
                            for x in (eta, pow_nom))
        scal["risk_s"] = _per_rollout(
            lay, _ref.cvar_sharpness(prob.risk_beta), slim)
        fn = _kernel.pgd_epoch_ens_cuda if on_card else _ref.pgd_epoch_ens_ref
    out = fn(d, eta, pi, pow_nom, tau24, price, lo, ub, lr, **scal,
             iters=int(iters), proj_iters=proj_iters)
    return out.reshape(shape)


def joint_step(prob, delta, s, mu, lr_d, temp, proj_iters: int = 50):
    """One fused joint spatio-temporal step for a (possibly batched)
    VCCProblem: temporal bounds recomputed from the shifted budget tau + s,
    the delta gradient and exact projection, and the per-cluster shift
    gradient. delta (..., n, H); s (..., n); mu (..., n_dc); lr_d
    (..., n, 1); temp per-rollout (...). Returns (delta', g_s (..., n))."""
    shape = delta.shape
    slim = shape[:-1] + (1,)
    on_card, lay = _layout(delta)
    price = prob.lambda_p[..., None] + torch.gather(mu, -1, prob.campus)
    fn = _kernel.joint_step_cuda if on_card else _ref.joint_step_arrays
    d2, g_s = fn(
        lay(delta, shape), lay(s[..., None], slim),
        *(lay(x, shape) for x in (prob.eta, prob.pi, prob.pow_nom)),
        lay(prob.tau[..., None], slim),
        *(lay(x, shape) for x in (prob.u_if, prob.u_if_q, prob.ratio)),
        *(lay(x[..., None], slim) for x in (prob.u_pow_cap, prob.capacity,
                                             price)),
        lay(lr_d, slim), _per_rollout(lay, temp, slim),
        _per_rollout(lay, prob.lambda_e, slim),
        drop_limit=float(prob.drop_limit), proj_iters=proj_iters)
    return d2.reshape(shape), g_s.reshape(shape[:-1])


def joint_stepper(prob, shape, mu, lo_s, ub_s, lr_d, lr_s, temp,
                  proj_iters: int = 50):
    """The joint step with the shift update for the steps of one
    dual-ascent round: everything fixed within the round (the price at
    ``mu``, the problem's operands in the route's layout, the per-rollout
    scalars) is laid out once. Returns ``step(delta, s) -> (delta', s')``,
    delta (..., n, H) of ``shape`` and s (..., n), on the route of
    ``prob``'s device: on the card one launch of kernel #3
    (``kernel.joint_step_s_cuda``), on the CPU ``ref.joint_step_s_arrays``.
    lo_s/ub_s (..., n); mu (..., n_dc); lr_d (..., n, 1); lr_s and temp
    per rollout (...)."""
    slim = shape[:-1] + (1,)
    on_card, lay = _layout(prob.eta)
    price = prob.lambda_p[..., None] + torch.gather(mu, -1, prob.campus)
    fixed = (
        *(lay(x, shape) for x in (prob.eta, prob.pi, prob.pow_nom)),
        lay(prob.tau[..., None], slim),
        *(lay(x, shape) for x in (prob.u_if, prob.u_if_q, prob.ratio)),
        *(lay(x[..., None], slim) for x in (prob.u_pow_cap, prob.capacity,
                                             price)),
        lay(lr_d, slim), _per_rollout(lay, temp, slim),
        _per_rollout(lay, prob.lambda_e, slim),
        lay(lo_s[..., None], slim), lay(ub_s[..., None], slim))
    lr = torch.as_tensor(lr_s)[..., None]
    kw = dict(drop_limit=float(prob.drop_limit), proj_iters=proj_iters)
    if not on_card:
        def step(d, s):
            d2, s2 = _ref.joint_step_s_arrays(d, s[..., None], *fixed, lr,
                                              **kw)
            return d2, s2[..., 0]
        return step

    n, H = shape[-2], shape[-1]
    lr = lay(lr, shape[:-2] + (1,))

    def step(d, s):
        d2, s2 = _kernel.joint_step_s_cuda(
            d.reshape(-1, H), s.reshape(-1, 1), *fixed, lr, n=n, **kw)
        return d2.reshape(shape), s2.reshape(shape[:-1])
    return step


def joint_step_s(prob, delta, s, mu, lo_s, ub_s, lr_d, lr_s, temp,
                 proj_iters: int = 50):
    """One joint step and the shift update for a (possibly batched)
    VCCProblem (``joint_stepper``'s step once). Returns (delta', s')."""
    return joint_stepper(prob, delta.shape, mu, lo_s, ub_s, lr_d, lr_s, temp,
                         proj_iters)(delta, s)
