"""Risk-aware VCC generation: forecast ensembles + CVaR-of-carbon-cost
(port of ``repro.core.risk``).

* **Ensembles.** K day-ahead realizations of (inflexible usage, carbon
  intensity) are drawn by resampling whole DAYS of the relative-error
  history the day cycle tracks (``hist_uif_pred`` against ``hist_uif`` for
  load; day-over-day changes of ``carbon_hist`` as the persistence error of
  carbon). One history day is drawn per member for the whole fleet, so
  cross-cluster correlation survives. Member 0 is the point forecast.
* **CVaR objective.** ``beta`` is the averaged worst-tail fraction:
  ``beta = 1`` is the risk-neutral mean, smaller is more risk-averse. The
  PGD epoch descends a soft tilt of per-cluster member costs (the CVaR
  ensemble kernel, ``kernels.vcc_pgd``), anchored on member 0, so K
  identical members reproduce the point-forecast step exactly.

The batch axis leads: keys are (B, 2), forecasts (B, n, 24), histories
(B, n, D, 24) and members come out (B, K, n, 24). Each rollout draws its
own member-day indices from its own key, as ``vmap`` does in the reference.
Member objectives put the member axis last, (..., K).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import prng
from repro_torch.kernels.vcc_pgd.ref import cvar_sharpness  # noqa: F401

f32 = torch.float32

# clip bounds on resampled relative errors: one historical day must not
# produce a negative or absurd realization
ERR_LO, ERR_HI = -0.9, 3.0


# ------------------------------------------------------------------- CVaR

def _along(v, axis: int):
    """A per-result value (float or tensor of the result's shape) laid
    against the reduced ``axis`` of its input."""
    return v.unsqueeze(axis) if v.dim() > 0 else v


def cvar(x: torch.Tensor, beta, axis: int = 0) -> torch.Tensor:
    """Hard CVaR: mean of the worst ``ceil(beta * K)`` outcomes along
    ``axis``. ``beta = 1`` is the mean, ``beta -> 0`` the max. ``beta`` is
    a float or a tensor of the result's shape (one tail per rollout)."""
    K = x.shape[axis]
    xs = torch.flip(torch.sort(torch.movedim(x, axis, -1), dim=-1).values,
                    dims=(-1,))
    k = torch.clamp(torch.ceil(torch.as_tensor(beta, dtype=f32,
                                               device=x.device) * K),
                    1.0, K)[..., None]
    w = (torch.arange(K, dtype=f32, device=x.device) < k).to(x.dtype) \
        / k.to(x.dtype)
    return (xs * w).sum(-1)


def soft_cvar(x: torch.Tensor, beta, axis: int = 0) -> torch.Tensor:
    """Differentiable CVaR surrogate: softmax-tilted member average with
    sharpness ``cvar_sharpness(beta)`` on mean-centred, mean-absolute-
    deviation-scaled outcomes. Equals the mean at ``beta = 1`` and lies in
    [mean(x), max(x)]."""
    s = _along(cvar_sharpness(beta).to(x.device), axis)
    z = x - x.mean(axis, keepdim=True)
    scale = z.abs().mean(axis, keepdim=True) + 1e-9
    w = torch.softmax(s * z / scale, dim=axis)
    return (w * x).sum(axis)


# ------------------------------------------------------------- ensembles

def relative_error_days(pred_hist: torch.Tensor, actual_hist: torch.Tensor
                        ) -> torch.Tensor:
    """Per-day relative-error profiles (act - pred) / |pred|:
    (..., D, 24) -> (..., D, 24)."""
    return (actual_hist - pred_hist) / torch.clamp(pred_hist.abs(), min=1e-9)


def _member_day_idx(key, n_members: int, n_days: int) -> torch.Tensor:
    """One resampled history-day index per member, shared fleetwide:
    key (B, 2) -> (B, K). Member 0 is pinned to 'no error' by the callers
    (its index is unused)."""
    return prng.randint(key, (n_members,), 0, n_days)


def _member_errors(err, idx):
    """err (B, m, D, 24) at the day indices idx (B, K), clipped, member
    axis second and member 0 set to no error: (B, K, m, 24)."""
    B, m, _, H = err.shape
    K = idx.shape[-1]
    e = torch.gather(err, 2, idx[:, None, :, None].expand(B, m, K, H))
    e = torch.clamp(e, ERR_LO, ERR_HI).transpose(1, 2)
    return torch.cat([torch.zeros_like(e[:, :1]), e[:, 1:]], dim=1)


def sample_uif_ensemble(key, uif_pred, hist_uif_pred, hist_uif,
                        n_members: int) -> torch.Tensor:
    """K realizations of next-day inflexible usage. uif_pred (B, n, 24);
    hist_* (B, n, D, 24). Returns (B, K, n, 24), member 0 the point
    forecast exactly."""
    err = relative_error_days(hist_uif_pred, hist_uif)
    e = _member_errors(err, _member_day_idx(key, n_members, err.shape[2]))
    return torch.clamp(uif_pred[:, None] * (1.0 + e), min=0.0)


def sample_eta_ensemble(key, fc_z, carbon_hist, zmap, n_members: int
                        ) -> torch.Tensor:
    """K realizations of next-day carbon intensity per cluster. fc_z
    (B, z, 24) zone forecast; carbon_hist (B, z, D, 24) actual history;
    zmap (B, n) zone of each cluster. The day-over-day relative change of
    the actual intensity stands in for the forecast error. Returns
    (B, K, n, 24), member 0 == fc_z at zmap exactly."""
    prev = carbon_hist[:, :, :-1]
    dz = (carbon_hist[:, :, 1:] - prev) / torch.clamp(prev.abs(), min=1e-9)
    e = _member_errors(dz, _member_day_idx(key, n_members, dz.shape[2]))
    eta_z = torch.clamp(fc_z[:, None] * (1.0 + e), min=1e-6)   # (B, K, z, 24)
    B, K, _, H = eta_z.shape
    idx = zmap[:, None, :, None].expand(B, K, zmap.shape[-1], H)
    return torch.gather(eta_z, 2, idx)


def day_ensembles(key, n_members: int, uif_pred, hist_uif_pred, hist_uif,
                  fc_z, carbon_hist, zmap, risk_beta) -> Dict[str, torch.Tensor]:
    """The day's forecast ensembles (the optimize stage's hook): the
    keyword arguments of ``attach_ensemble``. key (B, 2)."""
    keys = prng.split(key, 2)
    return {
        "uif_ens": sample_uif_ensemble(keys[:, 0], uif_pred, hist_uif_pred,
                                       hist_uif, n_members),
        "eta_ens": sample_eta_ensemble(keys[:, 1], fc_z, carbon_hist, zmap,
                                       n_members),
        "risk_beta": torch.as_tensor(risk_beta, dtype=f32),
    }


def attach_ensemble(prob, eta_ens, uif_ens, risk_beta):
    """Attach K members to a point-forecast VCCProblem. Member power is the
    problem's own linearization around nominal, pow_nom_k = pow_nom +
    pi * (uif_k - u_if); the bounds stay as they are (members change the
    objective, not the feasible set)."""
    pow_nom_ens = prob.pow_nom[..., None, :, :] + prob.pi[..., None, :, :] \
        * (uif_ens - prob.u_if[..., None, :, :])
    return dataclasses.replace(prob, eta_ens=eta_ens,
                               pow_nom_ens=pow_nom_ens,
                               risk_beta=torch.as_tensor(risk_beta, dtype=f32))


# ------------------------------------------------------------- objectives

def member_objectives(p, delta, mu) -> torch.Tensor:
    """Per-member total day cost of ``delta``, (..., K): carbon term plus
    the hard per-cluster peak term (eq. 4 shape)."""
    tau24 = p.tau[..., None] / 24.0
    peak_price = p.lambda_p[..., None] + torch.gather(mu, -1, p.campus)
    pow_h = p.pow_nom_ens + (p.pi * delta * tau24)[..., None, :, :]
    y = pow_h.amax(-1)                                       # (..., K, n)
    return p.lambda_e[..., None] * (p.eta_ens * pow_h).sum(dim=(-2, -1)) \
        + (peak_price[..., None, :] * y).sum(-1)


def soft_cvar_objective(p, delta, mu) -> torch.Tensor:
    """Soft CVaR of the per-member total costs at the problem's
    ``risk_beta``: shape (...)."""
    return soft_cvar(member_objectives(p, delta, mu), p.risk_beta, axis=-1)


def cvar_objective(p, delta, mu, beta=None) -> torch.Tensor:
    """Hard CVaR of the per-member total costs; ``beta`` defaults to the
    problem's ``risk_beta``."""
    b = p.risk_beta if beta is None else beta
    return cvar(member_objectives(p, delta, mu), b, axis=-1)
