"""Power-domain power models (paper §III-A).

Port of ``repro.core.power``: a PD's power is a piecewise-linear function of
its CPU usage (3 hinges, 4 segments), refit daily by ridge-regularized least
squares; the local slope maps CPU deltas to power deltas. Every function
takes leading batch axes (PDs, clusters, rollouts) before its own axes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import prng
from repro_torch.core.forecast import quantile

f32 = torch.float32
N_BREAKS = 3            # interior breakpoints -> 4 linear segments


@dataclass(frozen=True)
class PDTruth:
    """Ground-truth (simulator) PD power curve parameters, (..., pds)."""
    idle_kw: torch.Tensor
    slope_kw: torch.Tensor
    curve: torch.Tensor


def simulate_pd_power(key, truth: PDTruth, cpu, noise: float = 0.01):
    """True PD power for CPU usage series. cpu: (..., pds, t) in [0, 1];
    key: (..., 2), one per leading index."""
    base = truth.idle_kw[..., None] + truth.slope_kw[..., None] * \
        torch.pow(torch.clamp(cpu, 0.0, 1.0), truth.curve[..., None])
    eps = 1.0 + noise * prng.normal(key, cpu.shape[-2:])
    return base * eps


def _basis(u, breaks):
    """[1, u, relu(u - b_k)...] hinge basis columns. u (..., t);
    breaks (..., K)."""
    cols = [torch.ones_like(u), u]
    for k in range(breaks.shape[-1]):
        cols.append(torch.clamp(u - breaks[..., k, None], min=0.0))
    return cols


def _solve_spd(A, b):
    """Unrolled elementwise Cholesky solve of small SPD systems (K+2 = 5):
    A (..., n, n), b (..., n). Scalar ops in a fixed order."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    y = []
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y.append(s / L[i][i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def fit_pd_model(cpu, power):
    """Least-squares piecewise-linear fit, one per leading index.
    cpu, power: (..., t). Returns (coef (..., K+2), breaks (..., K))."""
    qs = torch.linspace(0.0, 1.0, N_BREAKS + 2, device=cpu.device)[1:-1]
    breaks = quantile(cpu, qs)
    X = _basis(cpu, breaks)
    k = len(X)
    eye = torch.eye(k, dtype=f32, device=cpu.device)
    # normal equations entry by entry: a reduce over t per (i, j), never a
    # (..., t, k, k) intermediate
    xtx = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i, k):
            xtx[i][j] = xtx[j][i] = (X[i] * X[j]).sum(-1)
    XtX = torch.stack([torch.stack(r, dim=-1) for r in xtx], dim=-2) \
        + 1e-4 * eye
    Xty = torch.stack([(c * power).sum(-1) for c in X], dim=-1)
    return _solve_spd(XtX, Xty), breaks


def pd_power(coef, breaks, u):
    """Predicted power at usage u (..., t): coef (..., K+2), breaks
    (..., K). Evaluated as an ordered elementwise chain."""
    p = coef[..., 0, None] + coef[..., 1, None] * u
    for k in range(breaks.shape[-1]):
        p = p + coef[..., 2 + k, None] * torch.clamp(
            u - breaks[..., k, None], min=0.0)
    return p


def pd_slope(coef, breaks, u):
    """Local slope pi(u) = d power / d usage, same layout as ``pd_power``."""
    s = coef[..., 1, None].expand_as(u)
    for k in range(breaks.shape[-1]):
        s = s + torch.where(u > breaks[..., k, None], coef[..., 2 + k, None],
                            0.0)
    return s


def daily_mape(coef, breaks, cpu, power) -> torch.Tensor:
    """MAPE of the fitted curve against measured power over the last axis:
    cpu, power (..., t) -> (...)."""
    pred = pd_power(coef, breaks, cpu)
    return (torch.abs(pred - power) / torch.clamp(power, min=1e-6)).mean(-1)


def usage_fractions(cpu_by_pd) -> torch.Tensor:
    """lambda^(PD): each PD's time-average share of its cluster's usage.
    cpu_by_pd (..., pds, t) -> (..., pds)."""
    tot = torch.clamp(cpu_by_pd.sum(-2, keepdim=True), min=1e-9)
    return (cpu_by_pd / tot).mean(-1)


# the reference's vmaps over PDs: the functions above take leading batch
# axes, so they are their own batched forms
fit_pd_models = fit_pd_model
pd_power_b = pd_power
pd_slope_b = pd_slope
daily_mape_b = daily_mape


def cluster_power(coef, breaks, lam, u_cluster):
    """Cluster power at cluster CPU u (..., t): sum over its PDs at
    u * lambda. coef (..., pds, K+2), breaks (..., pds, K), lam (..., pds)."""
    u_pd = lam[..., None] * u_cluster[..., None, :]
    return pd_power(coef, breaks, u_pd).sum(-2)


def cluster_slope(coef, breaks, lam, u_cluster):
    """pi^(c)(u) = sum_PD pi^(PD)(lambda * u) * lambda (paper eq. 1)."""
    u_pd = lam[..., None] * u_cluster[..., None, :]
    return (pd_slope(coef, breaks, u_pd) * lam[..., None]).sum(-2)
