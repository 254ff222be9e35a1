"""Plain PyTorch versions of the three VCC projected-gradient kernels.

Mirrors ``repro.kernels.vcc_pgd.ref`` op for op:

* ``project_row``, ``pgd_step_arrays``, ``pgd_epoch_ref`` — the fused epoch:
  ``iters`` iterations of [linearized carbon + softmax-peak gradient ->
  exact bisection projection onto {sum_h delta = 0} ∩ [lo, ub]];
* ``cvar_sharpness``, ``member_costs``, ``cvar_member_weights``,
  ``pgd_step_ens_arrays``, ``pgd_epoch_ens_ref`` — the CVaR ensemble epoch
  over K forecast members. The member reduction is anchored on member 0,
  ``x[0] + sum_k w_k (x[k] - x[0])``, so K identical members give exactly
  the single-member step;
* ``joint_step_arrays`` — one joint spatio-temporal step: bounds recomputed
  from the shifted budget tau + s, the delta step, and the per-cluster shift
  gradient (the plain version of kernel #3's split route, with
  ``project_row`` for its shift update);
* ``joint_step_s_arrays`` — that step followed by the fleet-coupled shift
  update, one ``project_row`` row per rollout (the plain version of kernel
  #3's fused route).

The CPU path of ``ops`` runs these; on the card the hand-written kernels
(``kernel.py``) run instead, and ``chip_smoke.py`` holds the two against each
other. Rows are independent; every tensor carries the row axis second to
last, so leading batch axes pass through. Member stacks carry the member
axis just before the row axis, (..., K, n, H). A per-row scalar is a float,
a 0-d tensor, or a (..., n, 1) column.
"""
from __future__ import annotations

import torch

# softmax sharpness at risk_beta = 0.5 (costs are normalized to unit mean
# absolute deviation before the tilt, so this is dimensionless)
CVAR_SHARPNESS = 4.0


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


# ------------------------------------------------- ensemble (CVaR) variant

def cvar_sharpness(beta):
    """Soft-tilt sharpness of the CVaR tail fraction ``beta``:
    4 (1 - b) / b with b = clip(beta, 0.05, 1). beta = 1 (risk-neutral
    mean) gives 0; smaller beta concentrates on the worst member."""
    b = torch.clamp(torch.as_tensor(beta, dtype=torch.float32), 0.05, 1.0)
    return CVAR_SHARPNESS * (1.0 - b) / b


def _per_member(x):
    """A per-row scalar (float, 0-d, or a (..., n, 1) column) laid out
    against member costs (..., K, n): columns become (..., 1, n)."""
    if isinstance(x, torch.Tensor) and x.dim() >= 2:
        return x[..., None, :, 0]
    return x


def _per_member_wide(x):
    """A per-row scalar laid out against member stacks (..., K, n, H)."""
    if isinstance(x, torch.Tensor) and x.dim() >= 2:
        return x[..., None, :, :]
    return x


def member_costs(d, eta_e, pi, pow_nom_e, tau24, price, temp, lambda_e):
    """Per-(member, cluster) day cost under delta ``d``.

    eta_e/pow_nom_e: (..., K, n, H); d/pi: (..., n, H); tau24/price:
    (..., n, 1). Returns (cost (..., K, n), pow_e (..., K, n, H),
    w_peak (..., K, n, H))."""
    pow_e = pow_nom_e + (pi * d * tau24)[..., None, :, :]
    w_peak = torch.softmax(pow_e / _per_member_wide(temp), dim=-1)
    cost = _per_member(lambda_e) * (eta_e * pow_e).sum(-1) \
        + _per_member(price) * (w_peak * pow_e).sum(-1)
    return cost, pow_e, w_peak


def cvar_member_weights(cost, risk_s):
    """Soft-CVaR member weights per cluster. cost: (..., K, n); risk_s: a
    per-row scalar (0 = uniform). Logits are anchored on member 0, so
    identical members give exactly zero logits; the scale is the mean
    absolute deviation from the member mean."""
    z = cost - cost[..., :1, :]
    dev = cost - cost.mean(-2, keepdim=True)
    scale = dev.abs().mean(-2, keepdim=True) + 1e-9
    return torch.softmax(_per_member(risk_s) * z / scale, dim=-2)


def pgd_step_ens_arrays(d, eta_e, pi, pow_nom_e, tau24, price, lo, ub, lr,
                        temp, lambda_e, risk_s, proj_iters: int = 50):
    """One CVaR-aware projected-gradient step over a K-member ensemble:
    the member-weight-tilted gradient (weights held constant), anchored on
    member 0, then the same projection as ``pgd_step_arrays``."""
    cost, pow_e, w_peak = member_costs(d, eta_e, pi, pow_nom_e, tau24,
                                       price, temp, lambda_e)
    wm = cvar_member_weights(cost, risk_s)[..., None]      # (..., K, n, 1)
    eta_w = eta_e[..., 0, :, :] \
        + (wm * (eta_e - eta_e[..., :1, :, :])).sum(-3)
    w_w = w_peak[..., 0, :, :] \
        + (wm * (w_peak - w_peak[..., :1, :, :])).sum(-3)
    grad = (lambda_e * eta_w + price * w_w) * pi * tau24
    return project_row(d - lr * grad, lo, ub, proj_iters)


def pgd_epoch_ens_ref(delta, eta_e, pi, pow_nom_e, tau24, price, lo, ub,
                      lr, *, temp, lambda_e, risk_s, iters: int,
                      proj_iters: int = 50):
    """eta_e/pow_nom_e: (..., K, n, H); delta/pi/lo/ub: (..., n, H);
    tau24/price/lr: (..., n, 1); temp/lambda_e/risk_s per-row scalars."""
    d = delta
    for _ in range(iters):
        d = pgd_step_ens_arrays(d, eta_e, pi, pow_nom_e, tau24, price, lo,
                                ub, lr, temp, lambda_e, risk_s, proj_iters)
    return d


# ------------------------------------------- joint spatio-temporal variant

def joint_step_arrays(d, s, eta, pi, pow_nom, tau, u_if, u_if_q, ratio,
                      u_pow_cap, capacity, price, lr_d, temp, lambda_e,
                      drop_limit: float, proj_iters: int = 50):
    """One joint spatio-temporal step in the kernel layout.

    d/eta/pi/pow_nom/u_if/u_if_q/ratio: (..., H); s/tau/u_pow_cap/capacity/
    price/lr_d: (..., 1); temp/lambda_e: per-row scalars. The temporal
    bounds are recomputed from the shifted budget tau + s with the formulas
    of ``core.vcc.delta_bounds`` (infeasible rows collapse to {0}); the
    gradient is taken at power = pow_nom + pi (d (tau + s) + s) / 24.
    Returns (d', g_s (..., 1)); the fleet-coupled s update happens outside
    (``core.solver.joint_epochs``)."""
    tau_s = tau + s
    t24 = torch.clamp(tau_s / 24.0, min=1e-9)
    ub = torch.minimum((u_pow_cap - u_if_q) / t24 - 1.0,
                       (capacity / ratio - u_if) / t24 - 1.0)
    ub = torch.clamp(ub, -drop_limit, 24.0)
    feas = (ub.sum(-1, keepdim=True) >= 0.0) & (tau_s > 1e-6) \
        & (ub > -drop_limit + 1e-9).all(-1, keepdim=True)
    lo = torch.where(feas, torch.full_like(ub, -drop_limit), 0.0)
    ub = torch.where(feas, ub, 0.0)

    pow_h = pow_nom + pi * (d * tau_s + s) / 24.0
    w = torch.softmax(pow_h / temp, dim=-1)
    gcoef = (lambda_e * eta + price * w) * pi
    g_d = gcoef * (tau_s / 24.0)
    g_s = (gcoef * (1.0 + d)).sum(-1, keepdim=True) / 24.0
    d2 = project_row(d - lr_d * g_d, lo, ub, proj_iters)
    return d2, g_s


def joint_step_s_arrays(d, s, eta, pi, pow_nom, tau, u_if, u_if_q, ratio,
                        u_pow_cap, capacity, price, lr_d, temp, lambda_e,
                        lo_s, ub_s, lr_s, drop_limit: float,
                        proj_iters: int = 50):
    """One joint step and the shift update of ``core.solver.joint_epochs``:
    ``joint_step_arrays``, then s' = project_row(s - lr_s g_s, lo_s, ub_s)
    over the cluster axis, one row per rollout. The operands of
    ``joint_step_arrays`` with s/lo_s/ub_s (..., n, 1) columns and lr_s a
    per-rollout (..., 1). Returns (d', s' (..., n, 1))."""
    d2, g_s = joint_step_arrays(d, s, eta, pi, pow_nom, tau, u_if, u_if_q,
                                ratio, u_pow_cap, capacity, price, lr_d,
                                temp, lambda_e, drop_limit, proj_iters)
    z = s[..., 0] - lr_s * g_s[..., 0]
    return d2, project_row(z, lo_s[..., 0], ub_s[..., 0],
                           proj_iters)[..., None]
