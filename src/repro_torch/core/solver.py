"""Projected-gradient solver layer (port of ``repro.core.solver``).

* ``project_conservation`` — exact bisection projection of each row onto
  {sum = 0} ∩ [lo, ub] (the plain version lives in
  ``kernels.vcc_pgd.ref``; this is the core-layer entry point).
* ``minimize_linear`` — exact minimizer of a linear objective over the same
  polytope (sort + cumsum; the spatial pre-shift uses it).
* ``peak_temperature`` / ``scaled_lr`` — the softmax-peak temperature and
  the per-cluster learning rate.
* ``campus_dual_update`` / ``dual_ascent`` — the outer loop: rounds of
  [inner PGD epoch -> clipped ascent on the campus power couplings], with
  an optional per-round diagnostic record (``diag_fn``, the telemetry
  hook).
* ``pgd_epochs`` — the fused epoch (plain or CVaR ensemble), dispatched by
  ``kernels.vcc_pgd.ops``;
* ``joint_epochs`` — joint spatio-temporal steps: the per-cluster joint
  step and the fleet-coupled projection of the shift s, one launch of
  kernel #3's fused route a step on the card.

Every function takes optional leading batch axes (the scenario x seed batch)
before the cluster axis; a per-rollout scalar has the batch shape.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.vcc_pgd import ops as _ops
from repro_torch.kernels.vcc_pgd import ref as _pgd_ref


def project_conservation(z, lo, ub, iters: int = 50):
    """Euclidean projection of each row of ``z`` onto {sum=0} ∩ [lo, ub]
    by bisection on the shift nu."""
    return _pgd_ref.project_row(z, lo, ub, iters)


def minimize_linear(cost, lo, ub):
    """Exact row-wise minimizer of <cost, x> over {sum x = 0} ∩ [lo, ub]
    (needs lo <= 0 <= ub): start at lo and spend the budget -sum(lo) on the
    cheapest coordinates first. The sort is stable, as ``jnp.argsort`` is;
    lo = ub = 0 gives exactly 0."""
    order = torch.argsort(cost, dim=-1, stable=True)
    room = torch.gather(ub - lo, -1, order)
    budget = -lo.sum(-1, keepdim=True)
    cum = torch.cumsum(room, dim=-1)
    add = torch.minimum(torch.clamp(budget - (cum - room), min=0.0), room)
    inv = torch.argsort(order, dim=-1, stable=True)
    return lo + torch.gather(add, -1, inv)


def peak_temperature(pow_nom, temp_frac):
    """Softmax-peak temperature per rollout: a fraction of the rollout's
    mean nominal power over its own (n, H). pow_nom (..., n, H) -> (...)."""
    return temp_frac * torch.clamp(pow_nom.mean(dim=(-2, -1)), min=1e-6)


def scaled_lr(lr, pi, tau, eta, lambda_e, lambda_p):
    """Per-cluster (..., n, 1) learning rate that divides out the raw
    gradient scale pi * tau/24 * (lambda_e * eta + lambda_p).
    lambda_e/lambda_p: per-rollout, shape (...)."""
    g_scale = torch.clamp((pi * tau[..., None] / 24.0).amax(-1, keepdim=True),
                          min=1e-9)
    lam_e = torch.as_tensor(lambda_e)[..., None, None]
    lam_p = torch.as_tensor(lambda_p)[..., None, None]
    return lr / (g_scale * torch.clamp(
        lam_e * eta.amax(-1, keepdim=True) + lam_p, min=1e-9))


def segment_sum(data, ids, num: int):
    """Sum ``data`` (..., n) into ``num`` segments per leading index by
    ``ids`` (..., n). Leading indices are offset (b * num + id) into one
    flat ``index_add_``, so sums never mix rollouts."""
    lead = data.shape[:-1]
    nb = math.prod(lead)
    offs = torch.arange(nb, device=data.device)[:, None] * num
    flat = (ids.expand(data.shape).reshape(nb, -1) + offs).reshape(-1)
    out = torch.zeros(nb * num, dtype=data.dtype, device=data.device)
    out.index_add_(0, flat, data.reshape(-1))
    return out.reshape(*lead, num)


def campus_dual_update(mu, y, campus, campus_limit, rho):
    """Clipped dual ascent: mu grows where the summed cluster peaks ``y``
    exceed the campus contract. mu/campus_limit (..., m); y/campus (..., n)."""
    campus_pow = segment_sum(y, campus, campus_limit.shape[-1])
    return torch.clamp(mu + rho * (campus_pow - campus_limit)
                       / torch.clamp(campus_limit, min=1e-9), min=0.0)


def dual_ascent(inner, dual_update, x0, mu0, outer_iters: int,
                diag_fn=None):
    """``outer_iters`` rounds of [x = inner(x, mu);
    mu = dual_update(x, mu)]. ``x`` may be a tuple (the joint solve
    carries (delta, s)).

    ``diag_fn(x_prev, x_new, mu_new)`` (optional) returns one dict of
    tensors a round; the return is then ``(x, mu, ys)``, each ys leaf
    stacked along a new rounds axis right after the batch dims of ``mu0``
    (..., n_dc): a per-cluster record (..., n) becomes (..., T, n). With
    ``diag_fn=None`` the loop and its return are the two-value ones."""
    x, mu = x0, mu0
    records = []
    for _ in range(outer_iters):
        x_new = inner(x, mu)
        mu = dual_update(x_new, mu)
        if diag_fn is not None:
            records.append(diag_fn(x, x_new, mu))
        x = x_new
    if diag_fn is None:
        return x, mu
    dim = mu0.dim() - 1
    return x, mu, {k: torch.stack([r[k] for r in records], dim=dim)
                   for k in records[0]}


def pgd_epochs(prob, delta, mu, lo, ub, lr_eff, temp, iters: int):
    """``iters`` fused temporal PGD steps (gradient + exact projection):
    the hand-written kernel for CUDA tensors, the plain version on CPU."""
    return _ops.pgd_epoch(prob, delta, mu, lo, ub, lr_eff, temp, iters)


def joint_epochs(prob, delta, s, mu, lo_s, ub_s, lr_d, lr_s, temp,
                 iters: int):
    """``iters`` joint spatio-temporal steps. Each runs the per-cluster
    joint step (temporal bounds recomputed from tau + s, delta gradient and
    projection, per-cluster shift gradient g_s), then descends s and
    projects it onto {sum_c s = 0} ∩ [lo_s, ub_s], one bisection row per
    rollout over the cluster axis: one launch of kernel #3 for CUDA
    tensors, the plain version on the CPU (``ops.joint_stepper``, which
    lays the round's fixed operands out once). delta (..., n, H);
    s/lo_s/ub_s (..., n); lr_d (..., n, 1); lr_s/temp per rollout (...).
    Returns (delta, s)."""
    step = _ops.joint_stepper(prob, delta.shape, mu, lo_s, ub_s, lr_d, lr_s,
                              temp)
    d, sv = delta, s
    for _ in range(iters):
        d, sv = step(d, sv)
    return d, sv
