"""Projected-gradient solver layer (port of ``repro.core.solver``).

* ``project_conservation`` — exact bisection projection of each row onto
  {sum = 0} ∩ [lo, ub] (the plain version lives in
  ``kernels.vcc_pgd.ref``; this is the core-layer entry point).
* ``minimize_linear`` — exact minimizer of a linear objective over the same
  polytope (sort + cumsum; the spatial pre-shift uses it).
* ``smooth_peak`` / ``peak_temperature`` / ``scaled_lr`` — the softmax
  peak, its temperature and the per-cluster learning rate.
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

import weakref

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import spans
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


def smooth_peak(pow_h, temp):
    """Differentiable softmax-peak of each row and its weights: pow_h
    (..., n, H); temp a float or per rollout (...). Returns ((..., n),
    (..., n, H))."""
    t = torch.as_tensor(temp, dtype=pow_h.dtype, device=pow_h.device)
    w = torch.softmax(pow_h / t[..., None, None], dim=-1)
    return (w * pow_h).sum(-1), w


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


def _run_ranks(s):
    """Each entry's position within its run of equal values along the last
    axis of ``s`` (sorted rows)."""
    n = s.shape[-1]
    pos = np.broadcast_to(np.arange(n), s.shape)
    starts = np.diff(s, axis=-1, prepend=s[..., :1] - 1) != 0
    return pos - np.maximum.accumulate(np.where(starts, pos, 0), axis=-1)


def _build_layout(ids, num: int):
    """``campus_layout`` without the memo (one device-to-host copy)."""
    n = ids.shape[-1]
    a = ids.reshape(-1, n).cpu().numpy()
    order = np.argsort(a, axis=-1, kind="stable")   # by id, then by index
    s = np.take_along_axis(a, order, -1)
    rank = _run_ranks(s)
    keep = (s >= 0) & (s < num)                     # other ids are dropped
    k = int(rank[keep].max()) + 1 if keep.any() else 0
    index = np.full((a.shape[0], num, k), n, dtype=np.int64)
    rows = np.broadcast_to(np.arange(a.shape[0])[:, None], s.shape)
    index[rows[keep], s[keep], rank[keep]] = order[keep]
    return (torch.as_tensor(index, device=ids.device).reshape(
        ids.shape[:-1] + (num * k,)), k)


# campus layouts already built, by (root tensor id, its version, view
# geometry, num); an entry goes when its root tensor is collected
_LAYOUTS: dict = {}


def _forget(root_id: int):
    for key in [k for k in _LAYOUTS if k[0] == root_id]:
        del _LAYOUTS[key]


def campus_layout(ids, num: int):
    """The padded gather layout of the segment ids (..., n) into ``num``
    segments: (index (..., num * k), k), where row c of a leading index
    lists the positions whose id is c in ascending order, padded to the
    largest segment's k with n (a slot that reads zero). Ids outside
    [0, num) are dropped, as ``jax.ops.segment_sum`` drops them.

    Built once per ids tensor (one device-to-host copy, so one host sync)
    and memoized by the tensor's storage, view and version: the campus ids
    are static, so the dual-ascent rounds and the days that reuse them
    never sync for it.

    The memo is right only while every write to the ids bumps the root
    tensor's version counter, as torch's in-place ops do. A write that
    goes around it (through a numpy array shared by ``torch.from_numpy``,
    or through ``.data``) leaves a stale layout behind: do not change ids
    that way once they have been summed over."""
    root = ids if ids._base is None else ids._base
    key = (id(root), root._version, ids.storage_offset(), tuple(ids.shape),
           tuple(ids.stride()), ids.device, num)
    hit = _LAYOUTS.get(key)
    if hit is None:
        if not any(k[0] == id(root) for k in _LAYOUTS):
            weakref.finalize(root, _forget, id(root))
        hit = _LAYOUTS[key] = _build_layout(ids, num)
    return hit


def segment_sum(data, ids, num: int):
    """Sum ``data`` (..., n) into ``num`` segments per leading index by
    ``ids`` (..., n, broadcast to ``data``'s shape). Each segment adds its
    members in ascending index order, starting from zero, one elementwise
    add a slot of ``campus_layout``: the order of the reference's
    ``jax.ops.segment_sum`` on the CPU, bit for bit, on any device, and a
    rollout's sums do not depend on the batch beside it (the padding adds
    +0.0, which leaves every sum that starts from +0.0 unchanged). k + 2
    launches for the largest segment's k members."""
    index, k = campus_layout(ids, num)
    lead = data.shape[:-1]
    if k == 0:
        return torch.zeros(lead + (num,), dtype=data.dtype,
                           device=data.device)
    padded = F.pad(data, (0, 1))                    # the zero slot at n
    parts = torch.gather(padded, -1, index.expand(lead + (num * k,)))
    parts = parts.reshape(lead + (num, k))
    out = parts[..., 0] + 0.0                       # 0 + x, as a scatter-add
    for j in range(1, k):
        out = out + parts[..., j]
    return out


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
    ``diag_fn=None`` the loop and its return are the two-value ones.

    Each round is a ``round`` span (``repro_torch.spans``); the inner
    epochs count their ``steps`` on it."""
    x, mu = x0, mu0
    records = []
    for _ in range(outer_iters):
        with spans.span("round"):
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
    spans.count("steps", iters)
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
    spans.count("steps", iters)
    step = _ops.joint_stepper(prob, delta.shape, mu, lo_s, ub_s, lr_d, lr_s,
                              temp)
    d, sv = delta, s
    for _ in range(iters):
        d, sv = step(d, sv)
    return d, sv
