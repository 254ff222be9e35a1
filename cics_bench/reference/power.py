"""Power-domain power models (paper §III-A): a frozen copy of the
program's ``core/power.py`` without what the day does not use. A PD's
power is a piecewise-linear function of its CPU usage (3 hinges, 4
segments), refit daily by ridge-regularised least squares (an unrolled
elementwise Cholesky solve); the local slope maps CPU deltas to power
deltas. Leading batch axes come before each function's own axes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from cics_bench.reference import prng
from cics_bench.reference.forecast import quantile

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
