"""Streaming sufficient statistics for the prediction layer (port of
``repro.core.stats``).

The rescan pipeline (``stages.forecast_stage`` / ``stages.power_stage``)
carries seven rolling history windows (B, n, H[, 24]) and rescans them every
day. ``PredictorState`` replaces them with incremental estimators whose size
does not depend on H:

* **EWMA levels**: the weekly mean (updated daily on the trailing 7-day
  mean, half-life ``WMEAN_HL_DAYS``) and the hour-of-week / day-of-week
  factor levels (each slot updated once a week at the rescan's weekly
  half-life), all through ``forecast.ewma_update``;
* **exponentially weighted regression moments**: the previous-day
  deviation corrector (through the origin, as ``forecast.deviation_coef``)
  and the ``R(h) = a + b log u`` reservations-to-usage model, with daily
  decays whose effective sample size matches the rescan windows;
* **exact rings** where a statistic needs its window: the trailing daily
  T_R errors (Theta's 97% quantile, 90 days), one (1-gamma) quantile of the
  hourly U_IF errors a day (28 days), and the 28-day usage window of the
  PD power refits (the ring IS the rescan's ``hist_usage[..., -28:, :]``,
  so the fit over it is the rescan's fit).

``init_predictor`` warm-starts every estimator from a burned-in window with
the port's own rescan functions in ``forecast_inflexible``'s op order, so the
hand-off day's streaming forecast of the EWMA components (uif, tuf, tr,
hence theta) equals the port's rescan forecast bit for bit.

``HourAccum`` is the hour-grain form of ``predictor_update`` that the MPC
recourse loop (``core.mpc``) advances one observed hour at a time:
``hour_finalize`` of 24 ``hour_update`` calls equals ``predictor_update``
on the assembled arrays bit for bit.

Batching: every leaf carries the (scenario x seed) batch axis B, then the
cluster axis n; windows come next, oldest first. ``day`` and ``gamma`` are
per rollout, shape (B,), so each rollout reads and writes its own
day-of-week slots.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from repro_torch.core import forecast

f32 = torch.float32

# rescan window sizes mirrored by the exact rings
THETA_WINDOW = 90            # eq. 2: 97%-quantile of daily T_R errors
GAMMA_WINDOW = 28            # (1-gamma) quantile of hourly U_IF errors
USAGE_WINDOW = 28            # PD power refits + breakpoint quantiles
WEEK = 7

# daily-update half-lives of the EW estimators: the weekly-mean level takes
# the rescan's 0.5-week half-life in steps of one day; the regression
# moments match the rescan windows' effective sample size (a daily decay rho
# has ESS (1+rho)/(1-rho): ESS 8 -> ~2.76 d, ESS 28 -> ~9.7 d)
WMEAN_HL_DAYS = 7.0 * 0.5
DEV_HL_DAYS = 2.76
RATIO_HL_DAYS = 9.7


def decay_from_half_life(half_life_days: float) -> torch.Tensor:
    """Per-day retention factor rho = 0.5 ** (1 / half_life), float32."""
    return torch.exp(torch.log(torch.tensor(0.5, dtype=f32))
                     / max(half_life_days, 1e-3))


def _col(x, k: int):
    """Append ``k`` unit axes: per-rollout (B,) -> (B, 1, ...)."""
    return x.reshape(x.shape + (1,) * k)


# -------------------------------------------------------------- primitives

def ring_push(ring, x):
    """Drop the oldest entry of the window axis (axis 2), append ``x``.
    ring (B, n, W[, 24]); x (B, n[, 24])."""
    return torch.cat([ring[:, :, 1:], x[:, :, None]], dim=2)


def ring_quantile(ring, q):
    """q-quantile over the window (the last axis) of ``ring`` (B, n, W):
    exact, the ring holds the raw trailing values. ``q`` is a float or
    per rollout (B,)."""
    q = torch.as_tensor(q, dtype=f32, device=ring.device)
    if q.dim():
        q = _col(q, ring.dim() - q.dim())
    return forecast.quantile(ring, q)[..., 0]


class EWMoments(NamedTuple):
    """Exponentially weighted simple-regression moments of (x, y) sample
    batches, y ~ a + b x by the normal equations. Leaves (B, n)."""
    w: torch.Tensor              # decayed sample count
    sx: torch.Tensor             # sum x
    sy: torch.Tensor             # sum y
    sxx: torch.Tensor            # sum x^2
    sxy: torch.Tensor            # sum x y


def ew_init(x, y) -> EWMoments:
    """Unweighted moments of an initial sample batch. x, y (..., t)."""
    return EWMoments(
        w=torch.full(x.shape[:-1], float(x.shape[-1]), dtype=f32,
                     device=x.device),
        sx=x.sum(-1), sy=y.sum(-1), sxx=(x * x).sum(-1),
        sxy=(x * y).sum(-1))


def ew_update(m: EWMoments, x, y, rho) -> EWMoments:
    """Decay by ``rho``, then absorb one day's sample batch. x, y (..., t)."""
    t = float(x.shape[-1])
    return EWMoments(w=rho * m.w + t, sx=rho * m.sx + x.sum(-1),
                     sy=rho * m.sy + y.sum(-1),
                     sxx=rho * m.sxx + (x * x).sum(-1),
                     sxy=rho * m.sxy + (x * y).sum(-1))


def ew_linfit(m: EWMoments):
    """(a, b) of y ~ a + b x from the moments."""
    xm = m.sx / torch.clamp(m.w, min=1e-9)
    ym = m.sy / torch.clamp(m.w, min=1e-9)
    b = (m.sxy - m.sx * ym) / torch.clamp(m.sxx - m.sx * xm, min=1e-9)
    return ym - b * xm, b


class DevMoments(NamedTuple):
    """EW moments of the previous-day deviation corrector: next-day
    deviation ~ coef * previous-day deviation, through the origin. Leaves
    (B, n)."""
    sxx: torch.Tensor
    sxy: torch.Tensor
    prev: torch.Tensor           # yesterday's deviation (today's x)


def dev_init(dev) -> DevMoments:
    """Moments of an initial deviation series dev (..., t), oldest first:
    the (dev[:-1], dev[1:]) pairs and sums of ``forecast.deviation_coef``."""
    x, y = dev[..., :-1], dev[..., 1:]
    return DevMoments(sxx=(x * x).sum(-1), sxy=(x * y).sum(-1),
                      prev=dev[..., -1])


def dev_update(m: DevMoments, dev_today, rho) -> DevMoments:
    """Decay, absorb the (yesterday, today) pair, carry today."""
    return DevMoments(sxx=rho * m.sxx + m.prev * m.prev,
                      sxy=rho * m.sxy + m.prev * dev_today, prev=dev_today)


def dev_coef(m: DevMoments):
    """clip(Sxy / Sxx, -1, 1): ``forecast.deviation_coef``'s estimate."""
    return torch.clamp(m.sxy / torch.clamp(m.sxx, min=1e-9), -1.0, 1.0)


# ---------------------------------------------------------- PredictorState

class PredictorState(NamedTuple):
    """The streaming prediction layer's whole carry: O(n) in the fleet,
    O(1) in the history length. Week rings are indexed by day of week
    (slot d % 7 holds the latest day of that weekday: together the
    trailing 7 days); error and usage rings are oldest first."""
    # inflexible hourly usage U_IF
    uif_day_ring: torch.Tensor   # (B, n, 7) trailing daily means, dow slots
    uif_prev: torch.Tensor       # (B, n, 24) yesterday's hourly actuals
    uif_wmean: torch.Tensor      # (B, n) weekly-mean EWMA level
    uif_how: torch.Tensor        # (B, n, 7, 24) hour-of-week factor levels
    uif_dev: DevMoments          # corrector moments on daily-mean devs
    # daily flexible usage T_UF
    flex_ring: torch.Tensor      # (B, n, 7)
    flex_wmean: torch.Tensor     # (B, n)
    flex_dow: torch.Tensor       # (B, n, 7) day-of-week factor levels
    flex_dev: DevMoments
    # daily total reservations T_R
    res_ring: torch.Tensor       # (B, n, 7)
    res_wmean: torch.Tensor      # (B, n)
    res_dow: torch.Tensor        # (B, n, 7)
    res_dev: DevMoments
    # reservations-to-usage ratio R(h) = a + b log u
    ratio: EWMoments
    # exact trailing-error rings (one scalar a day)
    theta_err_ring: torch.Tensor  # (B, n, <=90) daily T_R relative errors
    gamma_err_ring: torch.Tensor  # (B, n, <=28) daily (1-gamma) U_IF error q
    # exact usage window of the PD power refits
    usage_ring: torch.Tensor     # (B, n, <=28, 24)


def pytree_nbytes(tree) -> int:
    """Total bytes of the tensors of a NamedTuple / dict / list tree."""
    from repro_torch.core import stages
    sizes = []
    stages.map_tensors(lambda t: sizes.append(t.numel() * t.element_size()),
                       tree)
    return int(sum(sizes))


def predictor_nbytes(pred: PredictorState) -> int:
    """Total bytes of the streaming carry."""
    return pytree_nbytes(pred)


HIST_FIELDS = ("hist_uif", "hist_flex_daily", "hist_res_daily", "hist_usage",
               "hist_res", "hist_tr_pred", "hist_uif_pred")


def replaced_hist_nbytes(state) -> int:
    """Bytes of the seven rescan history windows ``PredictorState``
    replaces (``hist_*`` of a rescan ``SimState``)."""
    return pytree_nbytes([getattr(state, k) for k in HIST_FIELDS])


# ------------------------------------------------------------ init/forecast

def _week_index(x, idx):
    """Gather along the week axis (axis 2) with a per-rollout index:
    x (B, n, 7[, 24]), idx (B, k) -> (B, n, k[, 24])."""
    B, k = idx.shape
    view = idx.reshape((B, 1, k) + (1,) * (x.dim() - 3))
    return torch.gather(x, 2, view.expand(x.shape[:2] + (k,) + x.shape[3:]))


def _at(x, dow):
    """``x[:, dow]`` of the reference per rollout: (B, n, 7[, 24]) and
    dow (B,) -> (B, n[, 24])."""
    return _week_index(x, dow[:, None])[:, :, 0]


def _put(x, dow, val):
    """``x.at[:, dow].set(val)`` per rollout: a new (B, n, 7[, 24])."""
    idx = dow.reshape((-1, 1, 1) + (1,) * (x.dim() - 3))
    return x.scatter(2, idx.expand(x.shape[:2] + (1,) + x.shape[3:]),
                     val[:, :, None])


def _dow_slots(day, k: int):
    """Day-of-week slots (B, k) of the trailing ``k`` days (oldest first)
    when ``day`` (B,) is today (the next day to simulate)."""
    return (day[:, None] - k + torch.arange(k, device=day.device)) % WEEK


def _dow_ring(daily_hist, day):
    """Scatter the trailing 7 daily values into their dow slots:
    (B, n, H) -> (B, n, 7)."""
    last = daily_hist[..., -WEEK:]
    slots = _dow_slots(day, WEEK)[:, None, :].expand(last.shape)
    return torch.zeros_like(last).scatter(2, slots, last)


def _dev_init_hourly(hourly_hist) -> DevMoments:
    """Corrector moments from an hourly window (B, n, H, 24), with the
    weekly level and factors recomputed as ``forecast_inflexible`` does
    (same functions, same positional fold columns ``forecast.POS8``), so
    the hand-off coefficient is the rescan's bit for bit."""
    wm = forecast.weekly_mean_forecast(hourly_hist.mean(-1))[..., None]
    fa = forecast.hourly_factor_forecast(hourly_hist)
    dev = hourly_hist[..., -8:, :].mean(-1) \
        - wm * fa[..., forecast.POS8, :].mean(-1)
    return dev_init(dev)


def _dev_init_daily(daily_hist) -> DevMoments:
    """Corrector moments from a daily-total window (B, n, H), as
    ``forecast_daily_total`` fits them."""
    wm = forecast.weekly_mean_forecast(daily_hist)
    fa = forecast.daily_factor_forecast(daily_hist)
    return dev_init(daily_hist[..., -8:] - wm[..., None]
                    * fa[..., forecast.POS8])


def init_predictor(hist_uif, hist_flex_daily, hist_res_daily, hist_usage,
                   hist_res, hist_tr_pred, hist_uif_pred, day, gamma
                   ) -> PredictorState:
    """Warm-start every streaming estimator from a burned-in history
    window (the arrays a rescan ``SimState`` carries, (B, n, H[, 24]));
    ``day`` (B,) is the next day to simulate, ``gamma`` (B,)."""
    B, n, H = hist_uif.shape[:3]
    if H < WEEK:
        raise ValueError(f"streaming init needs >= {WEEK} days of history, "
                         f"got {H}")
    # the rescan's week fold is positional (column j <-> weekday
    # (day + j) % 7); rolling by ``day`` gives the absolute weekday slots
    # the streaming carry indexes by
    roll = (torch.arange(WEEK, device=day.device) - day[:, None]) % WEEK

    uif_daily = hist_uif.mean(-1)                              # (B, n, H)
    uif_how = _week_index(forecast.hourly_factor_forecast(hist_uif), roll)
    flex_dow = _week_index(forecast.daily_factor_forecast(hist_flex_daily),
                           roll)
    res_dow = _week_index(forecast.daily_factor_forecast(hist_res_daily),
                          roll)

    u28 = hist_usage[:, :, -USAGE_WINDOW:].contiguous()
    r28 = hist_res[:, :, -USAGE_WINDOW:]
    x = torch.log(torch.clamp(u28, min=1e-9)).reshape(B, n, -1)
    y = (r28 / torch.clamp(u28, min=1e-9)).reshape(B, n, -1)

    th = hist_tr_pred[..., -THETA_WINDOW:]
    theta_err = (hist_res_daily[..., -THETA_WINDOW:] - th) \
        / torch.clamp(torch.abs(th), min=1e-9)
    up = hist_uif_pred[:, :, -GAMMA_WINDOW:]
    eps_h = (hist_uif[:, :, -GAMMA_WINDOW:] - up) \
        / torch.clamp(torch.abs(up), min=1e-9)                # (B, n, W, 24)
    gamma_err = forecast.quantile(eps_h, _col(1.0 - gamma, 3))[..., 0]

    return PredictorState(
        uif_day_ring=_dow_ring(uif_daily, day),
        uif_prev=hist_uif[:, :, -1].contiguous(),
        uif_wmean=forecast.weekly_mean_forecast(uif_daily),
        uif_how=uif_how, uif_dev=_dev_init_hourly(hist_uif),
        flex_ring=_dow_ring(hist_flex_daily, day),
        flex_wmean=forecast.weekly_mean_forecast(hist_flex_daily),
        flex_dow=flex_dow, flex_dev=_dev_init_daily(hist_flex_daily),
        res_ring=_dow_ring(hist_res_daily, day),
        res_wmean=forecast.weekly_mean_forecast(hist_res_daily),
        res_dow=res_dow, res_dev=_dev_init_daily(hist_res_daily),
        ratio=ew_init(x, y),
        theta_err_ring=theta_err.contiguous(), gamma_err_ring=gamma_err,
        usage_ring=u28)


def streaming_forecast(pred: PredictorState, day, gamma
                       ) -> Dict[str, torch.Tensor]:
    """Next-day forecast dict (the keys of ``stages.forecast_stage``) from
    the streaming carry, O(1) in the history length. ``day`` (B,) is the
    day being forecast. ``gamma`` is unused, as in the reference: the
    carry's gamma ring already holds the (1-gamma) quantiles."""
    del gamma
    dow = day % WEEK
    dow_prev = (day - 1) % WEEK

    # U_IF(h): weekly level x hour-of-week factors + prev-day correction
    wm = pred.uif_wmean[..., None]
    base = wm * _at(pred.uif_how, dow)
    prev_pred = wm * _at(pred.uif_how, dow_prev)
    dev_prev = pred.uif_prev - prev_pred
    uif = torch.clamp(base + dev_coef(pred.uif_dev)[..., None] * dev_prev,
                      min=0.0)

    # T_UF(d), T_R(d): weekly level x dow factors + prev-day correction
    def daily_total(ring, wmean, dow_f, dev):
        nxt = wmean * _at(dow_f, dow)
        prev = wmean * _at(dow_f, dow_prev)
        return torch.clamp(nxt + dev_coef(dev) * (_at(ring, dow_prev) - prev),
                           min=0.0)

    tuf = daily_total(pred.flex_ring, pred.flex_wmean, pred.flex_dow,
                      pred.flex_dev)
    tr = daily_total(pred.res_ring, pred.res_wmean, pred.res_dow,
                     pred.res_dev)

    ra, rb = ew_linfit(pred.ratio)
    theta = forecast.theta_requirement(
        tr, ring_quantile(pred.theta_err_ring, 0.97))
    alpha = forecast.alpha_inflation(theta, uif, tuf, ra, rb)
    # (1-gamma) hourly inflexible error: the trailing mean of the daily
    # (1-gamma) hour-quantiles (the rescan pools 28 x 24 hourly errors)
    epsq = pred.gamma_err_ring.mean(-1)
    uif_q = uif * (1.0 + torch.clamp(epsq, 0.0, 1.0)[..., None])
    return {"uif": uif, "tuf": tuf, "tr": tr, "ratio_a": ra, "ratio_b": rb,
            "theta": theta, "alpha": alpha, "uif_q": uif_q}


def predictor_update(pred: PredictorState, fc: Dict[str, torch.Tensor],
                     day, gamma, u_if, flex_daily, res_daily, usage_total,
                     reservations) -> PredictorState:
    """Absorb one observed day, O(1) in the history length.

    ``fc`` is the forecast issued for this ``day`` (B,), so prediction
    errors pair same-day; ``u_if``, ``usage_total`` and ``reservations``
    are (B, n, 24) actuals, ``flex_daily`` and ``res_daily`` (B, n) daily
    totals; ``gamma`` (B,)."""
    dev = u_if.device
    dow = day % WEEK
    rho_dev = decay_from_half_life(DEV_HL_DAYS).to(dev)
    rho_ratio = decay_from_half_life(RATIO_HL_DAYS).to(dev)
    a_mean = forecast.ewma_alpha(WMEAN_HL_DAYS).to(dev)
    a_factor = forecast.ewma_alpha(4.0).to(dev)   # weekly cadence a slot

    # exact error rings (same-day prediction / actual pairs)
    tr_err = (res_daily - fc["tr"]) / torch.clamp(torch.abs(fc["tr"]),
                                                  min=1e-9)
    eps_h = (u_if - fc["uif"]) / torch.clamp(torch.abs(fc["uif"]), min=1e-9)
    gamma_err = forecast.quantile(eps_h, _col(1.0 - gamma, 2))[..., 0]

    # deviations against the levels before the update (the prediction made)
    uif_daily = u_if.mean(-1)
    dev_u = uif_daily - pred.uif_wmean * _at(pred.uif_how, dow).mean(-1)
    dev_f = flex_daily - pred.flex_wmean * _at(pred.flex_dow, dow)
    dev_r = res_daily - pred.res_wmean * _at(pred.res_dow, dow)

    # trailing-week rings, then the EWMA level updates on them
    uif_ring = _put(pred.uif_day_ring, dow, uif_daily)
    flex_ring = _put(pred.flex_ring, dow, flex_daily)
    res_ring = _put(pred.res_ring, dow, res_daily)
    wk_u, wk_f, wk_r = uif_ring.mean(-1), flex_ring.mean(-1), \
        res_ring.mean(-1)

    def factor(levels, x):
        return _put(levels, dow, forecast.ewma_update(_at(levels, dow), x,
                                                      a_factor))

    x = torch.log(torch.clamp(usage_total, min=1e-9))
    y = reservations / torch.clamp(usage_total, min=1e-9)
    return pred._replace(
        uif_day_ring=uif_ring, uif_prev=u_if,
        uif_wmean=forecast.ewma_update(pred.uif_wmean, wk_u, a_mean),
        uif_how=factor(pred.uif_how,
                       u_if / torch.clamp(wk_u[..., None], min=1e-9)),
        uif_dev=dev_update(pred.uif_dev, dev_u, rho_dev),
        flex_ring=flex_ring,
        flex_wmean=forecast.ewma_update(pred.flex_wmean, wk_f, a_mean),
        flex_dow=factor(pred.flex_dow,
                        flex_daily / torch.clamp(wk_f, min=1e-9)),
        flex_dev=dev_update(pred.flex_dev, dev_f, rho_dev),
        res_ring=res_ring,
        res_wmean=forecast.ewma_update(pred.res_wmean, wk_r, a_mean),
        res_dow=factor(pred.res_dow, res_daily / torch.clamp(wk_r, min=1e-9)),
        res_dev=dev_update(pred.res_dev, dev_r, rho_dev),
        ratio=ew_update(pred.ratio, x, y, rho_ratio),
        theta_err_ring=ring_push(pred.theta_err_ring, tr_err),
        gamma_err_ring=ring_push(pred.gamma_err_ring, gamma_err),
        usage_ring=ring_push(pred.usage_ring, usage_total))


# ------------------------------------------------- hour-grain advancement

class HourAccum(NamedTuple):
    """Partial-day accumulator: the hour-grain form of ``predictor_update``
    that the MPC recourse loop advances one observed hour at a time. The
    columns land in hour order and the daily totals accumulate by the
    ordered adds of ``admission.hour_sum``, so 24 ``hour_update`` calls and
    ``hour_finalize`` equal ``predictor_update`` on the assembled arrays
    bit for bit."""
    hour: int                    # hours absorbed so far
    u_if: torch.Tensor           # (B, n, 24) realized inflexible columns
    use_flex: torch.Tensor       # (B, n, 24) realized flexible columns
    usage: torch.Tensor          # (B, n, 24) u_if + use_flex
    res: torch.Tensor            # (B, n, 24) reservations = usage * ratio
    flex_daily: torch.Tensor     # (B, n) ordered running sum of use_flex
    res_daily: torch.Tensor      # (B, n) ordered running sum of res


def hour_accum_init(lead: Sequence[int], device=None) -> HourAccum:
    """An empty accumulator for clusters of shape ``lead`` (B, n)."""
    z24 = torch.zeros(tuple(lead) + (24,), dtype=f32, device=device)
    z = torch.zeros(tuple(lead), dtype=f32, device=device)
    return HourAccum(hour=0, u_if=z24, use_flex=z24, usage=z24, res=z24,
                     flex_daily=z, res_daily=z)


def hour_update(acc: HourAccum, hour: int, u_if_h, use_flex_h, ratio_h
                ) -> HourAccum:
    """Absorb observed hour ``hour``: ``u_if_h``, ``use_flex_h`` and
    ``ratio_h`` are (B, n) actuals of that hour."""
    usage_h = u_if_h + use_flex_h
    res_h = usage_h * ratio_h
    return HourAccum(
        hour=acc.hour + 1,
        u_if=acc.u_if.select_scatter(u_if_h, -1, hour),
        use_flex=acc.use_flex.select_scatter(use_flex_h, -1, hour),
        usage=acc.usage.select_scatter(usage_h, -1, hour),
        res=acc.res.select_scatter(res_h, -1, hour),
        # ordered adds in ascending-hour order == admission.hour_sum
        flex_daily=acc.flex_daily + use_flex_h,
        res_daily=acc.res_daily + res_h)


def hour_finalize(pred: PredictorState, acc: HourAccum,
                  fc: Dict[str, torch.Tensor], day, gamma) -> PredictorState:
    """Close the day: absorb the accumulator into the streaming carry."""
    return predictor_update(pred, fc, day, gamma, acc.u_if, acc.flex_daily,
                            acc.res_daily, acc.usage, acc.res)
