"""Day-ahead load forecasting (paper §III-B1): a frozen copy of the
program's ``core/forecast.py`` without what the day does not use. Per
cluster: hourly inflexible usage U_IF(h), daily flexible usage T_UF(d),
daily reservations T_R(d) and the reservations-to-usage ratio R(h), as an
EWMA weekly mean times EWMA intra-week factors, then a previous-day
deviation corrector; trailing relative-error quantiles give Theta (eq. 2)
and the (1-gamma) inflexible quantile, eq. 3 the alpha inflation. Leading
batch axes come before the time axes: (..., days) or (..., days, 24).
"""
from __future__ import annotations

import torch

f32 = torch.float32


def quantile(x, q):
    """``jnp.quantile`` (method "linear") over the last axis. ``q`` is a
    float or a tensor whose shape broadcasts against
    ``x.shape[:-1] + (k,)``; the result has that broadcast shape."""
    srt = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    q = torch.as_tensor(q, dtype=f32, device=x.device)
    if q.dim() == 0:
        q = q[None]
    pos = q * torch.tensor(n - 1, dtype=f32, device=x.device)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    shape = torch.broadcast_shapes(x.shape[:-1] + (1,), pos.shape)
    idx_lo = torch.clamp(low, 0, n - 1).long().expand(shape)
    idx_hi = torch.clamp(high, 0, n - 1).long().expand(shape)
    lead = shape[:-1]
    srt = srt.expand(lead + (n,))
    return (torch.gather(srt, -1, idx_lo) * low_w
            + torch.gather(srt, -1, idx_hi) * high_w)


def ewma_alpha(half_life) -> torch.Tensor:
    """One-step EWMA weight for a half-life in update steps: a float, or a
    tensor of half-lives (a weight each, on its device)."""
    if isinstance(half_life, torch.Tensor):
        hl = torch.clamp(half_life.to(f32), min=1e-3)
        return 1.0 - torch.exp(torch.log(torch.tensor(
            0.5, dtype=f32, device=hl.device)) / hl)
    return 1.0 - torch.exp(torch.log(torch.tensor(0.5, dtype=f32))
                           / max(half_life, 1e-3))


def ewma_update(level, x, alpha):
    return alpha * x + (1 - alpha) * level


def ewma(x, half_life: float, dim: int = 0):
    """EWMA along ``dim`` (oldest first); returns the final level."""
    alpha = ewma_alpha(half_life).to(x.device)
    level = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        level = ewma_update(level, x.select(dim, i), alpha)
    return level


def weekly_mean_forecast(daily, half_life_weeks: float = 0.5):
    """daily (..., days) -> next week's mean level (...), trailing full
    weeks only."""
    d = daily.shape[-1]
    nw = d // 7
    weekly = daily[..., d - nw * 7:].reshape(daily.shape[:-1] + (nw, 7)
                                             ).mean(-1)
    return ewma(weekly, half_life_weeks, dim=-1)


def hourly_factor_forecast(hourly, half_life_weeks: float = 4.0):
    """hourly (..., days, 24) -> hour-of-week factors (..., 7, 24)."""
    d = hourly.shape[-2]
    nw = d // 7
    h = hourly[..., d - nw * 7:, :].reshape(hourly.shape[:-2] + (nw, 7, 24))
    wmean = torch.clamp(h.mean(dim=(-2, -1), keepdim=True), min=1e-9)
    return ewma(h / wmean, half_life_weeks, dim=-3)


def daily_factor_forecast(daily, half_life_weeks: float = 4.0):
    """daily (..., days) -> day-of-week factors (..., 7)."""
    d = daily.shape[-1]
    nw = d // 7
    dd = daily[..., d - nw * 7:].reshape(daily.shape[:-1] + (nw, 7))
    wmean = torch.clamp(dd.mean(-1, keepdim=True), min=1e-9)
    return ewma(dd / wmean, half_life_weeks, dim=-2)


def deviation_coef(actual, weekly_pred):
    """Next-day deviation ~ coef * previous-day deviation, over the last
    axis: (..., k) -> (...)."""
    dev = actual - weekly_pred
    x, y = dev[..., :-1], dev[..., 1:]
    num = (x * y).sum(-1)
    den = torch.clamp((x * x).sum(-1), min=1e-9)
    return torch.clamp(num / den, -1.0, 1.0)


# fold columns of the trailing 8 days (k = 8..1 days before the forecast
# day): column (-k) % 7 of the week fold
POS8 = [int((7 - k) % 7) for k in range(8, 0, -1)]
POS_NEXT, POS_PREV = 0, 6


def forecast_inflexible(hourly, hl_mean: float = 0.5, hl_factor: float = 4.0):
    """Next-day hourly inflexible usage: hourly (..., days, 24) ->
    (..., 24). The week fold is indexed positionally (column 0 is the
    forecast day's day-of-week, column 6 yesterday's)."""
    daily = hourly.mean(-1)
    wmean = weekly_mean_forecast(daily, hl_mean)[..., None]
    factors = hourly_factor_forecast(hourly, hl_factor)
    weekly_fc_next = wmean * factors[..., POS_NEXT, :]
    prev_pred = wmean * factors[..., POS_PREV, :]
    dev_prev = hourly[..., -1, :] - prev_pred
    coef = deviation_coef(hourly[..., -8:, :].mean(-1),
                          wmean * factors[..., POS8, :].mean(-1))
    return torch.clamp(weekly_fc_next + coef[..., None] * dev_prev, min=0.0)


def forecast_daily_total(daily, hl_mean: float = 0.5,
                         hl_factor: float = 4.0):
    """Next-day total (flexible usage or reservations): daily (..., days)
    -> (...)."""
    wmean = weekly_mean_forecast(daily, hl_mean)
    factors = daily_factor_forecast(daily, hl_factor)
    pred_next = wmean * factors[..., POS_NEXT]
    prev_pred = wmean * factors[..., POS_PREV]
    coef = deviation_coef(daily[..., -8:], wmean[..., None]
                          * factors[..., POS8])
    return torch.clamp(pred_next + coef * (daily[..., -1] - prev_pred),
                       min=0.0)


def fit_ratio_model(usage, reservations):
    """R = a + b * log(usage), least squares over the last axis."""
    r = reservations / torch.clamp(usage, min=1e-9)
    x = torch.log(torch.clamp(usage, min=1e-9))
    xm, rm = x.mean(-1, keepdim=True), r.mean(-1, keepdim=True)
    b = ((x - xm) * (r - rm)).sum(-1) / torch.clamp(
        ((x - xm) ** 2).sum(-1), min=1e-9)
    a = rm[..., 0] - b * xm[..., 0]
    return a, b


def ratio_at(a, b, usage):
    return torch.clamp(a + b * torch.log(torch.clamp(usage, min=1e-9)),
                       1.0, 10.0)


def relative_error_quantile(pred_hist, actual_hist, q):
    """q-quantile of trailing relative errors over the last axis. ``q``:
    a float or a tensor that broadcasts against the leading shape."""
    eps = (actual_hist - pred_hist) / torch.clamp(torch.abs(pred_hist),
                                                  min=1e-9)
    q = torch.as_tensor(q, dtype=f32, device=eps.device)
    return quantile(eps, q[..., None])[..., 0]


def theta_requirement(tr_pred_next, eps_q97):
    """Theta(d) = T_R-hat * (1 + eps_.97)  (paper eq. 2)."""
    return tr_pred_next * (1.0 + torch.clamp(eps_q97, 0.0, 2.0))


def alpha_inflation(theta, uif_pred, tuf_pred, ratio_a, ratio_b):
    """Solve eq. 3 for alpha: sum_h (U_IF(h) + a*T_UF/24) * R(h) = Theta,
    with R at the nominal usage. uif_pred (..., 24); the rest (...)."""
    u_nom = uif_pred + tuf_pred[..., None] / 24.0
    r = ratio_at(ratio_a[..., None], ratio_b[..., None], u_nom)
    denom = torch.clamp((tuf_pred[..., None] / 24.0 * r).sum(-1), min=1e-9)
    alpha = (theta - (uif_pred * r).sum(-1)) / denom
    return torch.clamp(alpha, 0.5, 4.0)
