"""Intra-day MPC recourse: the hourly closed loop over the day-ahead VCC
(port of ``repro.core.mpc``).

The paper commits a VCC once a day (§III), so when the actuals leave the
day-ahead forecast the plan is stale for up to 23 hours. ``mpc_day`` closes
the loop at hour grain; each hour h, for the whole (scenario x seed) batch:

  1. enforce the current plan's VCC for hour h through the open loop's own
     ``admission.admission_tick``;
  2. absorb the realized hour into the ``stats.HourAccum`` accumulator
     (finalized into the streaming ``PredictorState`` at day close);
  3. nowcast the remaining hours: persistence-decay corrections of the
     intensity and inflexible forecasts from the latest observed ratio, and
     a demand-surprise term that grows the flexible budget tau when
     arrivals outrun the forecast's pro-rata share;
  4. re-solve the remaining hours from a warm start
     (``vcc.solve_vcc_suffix``: elapsed hours pinned, 2 rounds x 8 steps of
     the fused PGD epoch, kernel #1 on the card);
  5. accept the revised plan per cluster only when a staleness trigger
     fires (elapsed-hour U_IF MAPE, intensity deviation, demand surprise
     against tau), and record how often and how far it moved.

The reference's ``lax.scan`` over the 24 hours is a Python loop here; the
hour is the same for every rollout, so the suffix mask is a plain int. The
24 re-solves include h = 23, which solves at hour 24 with every column
pinned, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch import spans
from repro_torch.core import admission, stats, vcc
from repro_torch.core.admission import hour_sum

f32 = torch.float32

# staleness triggers: a re-solved suffix is accepted only when the
# day-ahead plan is measurably stale
MAPE_TRIGGER = 0.08      # elapsed-hour U_IF MAPE above typical noise
ETA_TRIGGER = 0.20       # |realized / forecast intensity - 1| last hour
SURGE_TRIGGER = 0.05     # demand surprise as a fraction of tau
# persistence decay of the last observed forecast-error ratio over the
# remaining hours (h hours ahead decays as DECAY ** h)
ETA_DECAY = 0.7
UIF_DECAY = 0.5


class MPCDiag(NamedTuple):
    """Per-cluster recourse diagnostics."""
    recourse_frac: torch.Tensor   # (B, n) fraction of hours re-planned
    recourse_depth: torch.Tensor  # (B, n) mean |delta change| when re-planned


def gated_curve(p: vcc.VCCProblem, delta, tau, gate, cap_day):
    """The hourly reservation curve the scheduler enforces for plan
    ``(delta, tau)``: the ``solve_vcc`` curve under the SLO gate (paused and
    infeasible clusters see 10x capacity, i.e. no shaping)."""
    vcc_shaped = (p.u_if + (1.0 + delta) * tau[..., None] / 24.0) * p.ratio
    v = torch.minimum(vcc_shaped, p.capacity[..., None])
    return torch.where(gate[..., None], v, cap_day[..., None] * 10.0)


def mpc_day(prob: vcc.VCCProblem, sol: vcc.VCCSolution, tuf_fc, gate,
            cap_day, u_if, arrivals, ratio_true, queue0, power_fn,
            intensity, *, allowance_frac: float = 0.25,
            inner_iters: int = 8, outer_iters: int = 2
            ) -> Tuple[admission.DayResult, torch.Tensor, stats.HourAccum,
                       MPCDiag]:
    """One closed-loop day: 24 admission ticks with hourly warm-started
    suffix re-solves of the remaining VCC, on the device of ``prob``.

    ``prob`` / ``sol``: the day-ahead problem and its solution; ``tuf_fc``
    (B, n): the day-ahead flexible-total forecast; ``gate`` (B, n) bool:
    shaping allowed and the day-ahead solve feasible (fixed for the day);
    ``u_if`` / ``arrivals`` / ``ratio_true`` / ``intensity`` (B, n, 24):
    the actuals; ``power_fn`` maps usage (B, n, t) to power.

    Returns (DayResult, the enforced curve (B, n, 24), HourAccum, MPCDiag):
    the enforced curve is what admission saw hour by hour, which the SLO
    detector must be held against, not the 00:00 plan. Each hour's re-solve
    is a ``suffix_solve`` span (``repro_torch.spans``)."""
    dev = prob.eta.device
    tau0 = prob.tau
    hours_f = torch.arange(24, dtype=f32, device=dev)
    surge_floor = SURGE_TRIGGER * torch.clamp(tau0, min=1e-6)
    queue, delta, tau, mu = queue0, sol.delta, tau0, sol.mu
    acc = stats.hour_accum_init(tau0.shape, dev)
    zeros = torch.zeros_like(tau0)
    arr_sofar, mape_sum, trig_hours, depth_sum = zeros, zeros, zeros, zeros
    enforced = []
    for h in range(24):
        uif_h, arr_h = u_if[..., h], arrivals[..., h]
        r_h, eta_h = ratio_true[..., h], intensity[..., h]
        # 1. enforce the current plan's curve for this hour
        vcc_h = gated_curve(prob, delta, tau, gate, cap_day)[..., h]
        queue, use_flex_h = admission.admission_tick(queue, vcc_h, uif_h,
                                                     arr_h, r_h, cap_day)
        enforced.append(vcc_h)
        # 2. hour-grain predictor advancement
        acc = stats.hour_update(acc, h, uif_h, use_flex_h, r_h)
        # 3. staleness signals
        fc_uif_h, fc_eta_h = prob.u_if[..., h], prob.eta[..., h]
        elapsed = float(h + 1)
        arr_sofar = arr_sofar + arr_h
        mape_sum = mape_sum + torch.abs(fc_uif_h - uif_h) \
            / torch.clamp(torch.abs(uif_h), min=1e-6)
        r_eta = eta_h / torch.clamp(fc_eta_h, min=1e-6)
        r_uif = uif_h / torch.clamp(fc_uif_h, min=1e-6)
        q_extra = torch.clamp(arr_sofar - elapsed / 24.0 * tuf_fc, min=0.0)
        trigger = (mape_sum / elapsed > MAPE_TRIGGER) \
            | (torch.abs(r_eta - 1.0) > ETA_TRIGGER) \
            | (q_extra > surge_floor)
        # 4. nowcast the remaining hours: persistence-decay corrections and
        #    the demand-surprise budget growth
        ahead = torch.clamp(hours_f - elapsed, min=0.0)
        rem = hours_f >= elapsed                   # (24,) hours after h
        eta_corr = 1.0 + (torch.clamp(r_eta, 0.25, 4.0) - 1.0)[..., None] \
            * ETA_DECAY ** ahead
        uif_corr = 1.0 + (torch.clamp(r_uif, 0.5, 2.0) - 1.0)[..., None] \
            * UIF_DECAY ** ahead
        tau_new = tau0 + q_extra
        p_now = dataclasses.replace(
            prob, eta=torch.where(rem, prob.eta * eta_corr, prob.eta),
            u_if=torch.where(rem, prob.u_if * uif_corr, prob.u_if),
            u_if_q=torch.where(rem, prob.u_if_q * uif_corr, prob.u_if_q),
            tau=tau_new)
        # 5. warm start: elapsed hours pinned at the realized deviations (in
        #    the new budget's units), the remaining hours keep the planned
        #    usage (1 + delta) tau / 24 re-expressed at the new budget
        tau24_new = torch.clamp(tau_new[..., None] / 24.0, min=1e-9)
        pinned = acc.use_flex / tau24_new - 1.0
        scale = (tau / torch.clamp(tau_new, min=1e-9))[..., None]
        delta_warm = torch.where(rem, (1.0 + delta) * scale - 1.0, pinned)
        with spans.span("suffix_solve"):
            sol_s = vcc.solve_vcc_suffix(p_now, delta_warm, mu, h + 1,
                                         inner_iters=inner_iters,
                                         outer_iters=outer_iters, device=dev)
        accept = gate & trigger & sol_s.shaped
        delta_next = torch.where(accept[..., None], sol_s.delta, delta)
        # 6. recourse depth: mean |delta change| over the remaining hours
        #    (23 - h of them; at least 1, as the reference clips its count)
        depth = hour_sum(torch.abs(delta_next - delta) * rem.to(f32)) \
            / max(float(23 - h), 1.0)
        trig_hours = trig_hours + accept.to(f32)
        depth_sum = depth_sum + depth
        delta, tau, mu = delta_next, torch.where(accept, tau_new, tau), \
            sol_s.mu
    res = admission.finalize_day(acc.use_flex, queue, u_if, arrivals,
                                 ratio_true, queue0, power_fn, intensity,
                                 allowance_frac)
    diag = MPCDiag(recourse_frac=trig_hours / 24.0,
                   recourse_depth=depth_sum / torch.clamp(trig_hours,
                                                          min=1.0))
    return res, torch.stack(enforced, -1), acc, diag
