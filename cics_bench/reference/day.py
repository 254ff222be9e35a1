"""The CICS day in plain PyTorch: the benchmark's frozen reference for what
the program's rollout computes (paper Fig. 4/5).

One day: grid simulation and day-ahead carbon forecast; PD power fit on the
last 28 days of usage; the load forecasts, Theta and alpha (eq. 3); the VCC
solve (eq. 4) after the greedy spatial pre-shift, or the joint
spatio-temporal solve, against K forecast members where the configuration
asks for them; the SLO gate; admission of the day's actual load under the
curve, beside the unshaped counterfactual; SLO feedback; the ledger.
``burn_in`` fills the history windows with unshaped days and sets the
campus contracts; ``rollout`` runs the days from it.

Params and states are dicts of tensors with a leading rollout axis B.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from cics_bench.reference import (admission, carbon, forecast, power, prng,
                                  slo, solve)
from cics_bench.reference.admission import hour_sum

f32 = torch.float32
HIST_KEYS = ("hist_uif", "hist_flex_daily", "hist_res_daily", "hist_usage",
             "hist_res", "hist_tr_pred", "hist_uif_pred")
LEDGER_KEYS = ("carbon_kg", "kwh", "peak_kw", "served", "arrived", "unmet",
               "delayed_cpu_h", "cf_carbon_kg", "cf_kwh", "cf_peak_kw",
               "cf_served", "cf_delayed_cpu_h")
TRAJ_KEYS = ("carbon_kg", "cf_carbon_kg", "kwh", "peak_kw", "queue")


def _col(x, k: int = 1):
    return x.reshape(x.shape + (1,) * k)


def take(x, idx):
    view = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, view.expand(idx.shape + x.shape[2:]))


def roll(hist, new):
    return torch.cat([hist[:, :, 1:], new[:, :, None]], dim=2)


def _weekly_cos(day):
    return torch.cos(2 * torch.pi * (day % 7).to(f32) / 7.0)


def sample_inflexible(key, truth, day):
    hours = torch.arange(24, dtype=f32, device=key.device)
    gap = torch.abs(hours - truth["peak_hour"][..., None])
    d = torch.minimum(gap, 24 - gap)
    diurnal = 1.0 + truth["diurnal_amp"][..., None] * torch.exp(
        -0.5 * (d / 4.0) ** 2)
    weekly = 1.0 + truth["weekly_amp"][..., None] * _col(_weekly_cos(day), 2)
    eps = 1.0 + truth["noise"][..., None] * prng.normal(
        key, (truth["base_if"].shape[-1], 24))
    return truth["base_if"][..., None] * diurnal * weekly * eps


def sample_arrivals(key, truth, day):
    hours = torch.arange(24, dtype=f32, device=key.device)
    prof = 0.6 + 0.8 * torch.exp(-0.5 * ((hours - 11.0) / 5.0) ** 2)
    weekly = 1.0 + 0.5 * truth["weekly_amp"][..., None] \
        * _col(_weekly_cos(day), 2)
    eps = 1.0 + 2.5 * truth["noise"][..., None] * prng.normal(
        key, (truth["arr_level"].shape[-1], 24))
    return torch.clamp(truth["arr_level"][..., None] * prof * weekly * eps
                       / 24.0 * 24.0 / prof.sum() * 24.0, min=0.0)


def true_ratio(truth, usage):
    return torch.clamp(truth["ratio_a"][..., None]
                       + truth["ratio_b"][..., None]
                       * torch.log(torch.clamp(usage, min=1e-6)), 1.05, 3.0)


# ------------------------------------------------------------------ stages

def carbon_stage(zone, carbon_hist, key, green_scale, coal_scale):
    z = carbon_hist.shape[1]
    zp = dict(zone)
    zp["solar_cap"] = zp["solar_cap"] * green_scale
    zp["wind_cap"] = zp["wind_cap"] * green_scale
    zp["coal_share"] = zp["coal_share"] * coal_scale
    keys = prng.split(key, 2 * z)
    act_z = carbon.simulate_zone_from(keys[:, :z], zp, 1)[..., 0, :]
    fc_z = carbon.forecast_day_ahead(keys[:, z:], carbon_hist, act_z,
                                     zp["weather_vol"] * 0.15)
    return act_z, fc_z


class PowerModel:
    """The day's fitted PD piecewise-linear power models."""

    def __init__(self, hist_usage, lam, capacity, params, key):
        B, n, npd = lam.shape
        u_cl = hist_usage[:, :, -28:].reshape(B, n, -1)
        u_pd = (lam[..., None] * u_cl[:, :, None, :]).reshape(B, n * npd, -1)
        self.lam = lam
        self.cap_pd = capacity[..., None].expand(B, n, npd).reshape(B,
                                                                   n * npd)
        u_norm = u_pd / torch.clamp(self.cap_pd[..., None], min=1e-6)
        truth = power.PDTruth(idle_kw=params["pd_idle"],
                              slope_kw=params["pd_slope"],
                              curve=params["pd_curve"])
        p_pd = power.simulate_pd_power(key, truth, u_norm)
        self.coef, self.breaks = power.fit_pd_model(u_norm, p_pd)

    def _pd_usage(self, u_cluster):
        B, n, npd = self.lam.shape
        u_pd = (self.lam[..., None] * u_cluster[:, :, None, :]).reshape(
            B, n * npd, -1)
        return u_pd / torch.clamp(self.cap_pd[..., None], min=1e-6)

    def power(self, u_cluster):
        B, n, npd = self.lam.shape
        p = power.pd_power(self.coef, self.breaks, self._pd_usage(u_cluster))
        return p.reshape(B, n, npd, -1).sum(2)

    def slope(self, u_cluster):
        B, n, npd = self.lam.shape
        s = power.pd_slope(self.coef, self.breaks, self._pd_usage(u_cluster))
        s = s / torch.clamp(self.cap_pd[..., None], min=1e-6)
        return (s.reshape(B, n, npd, -1) * self.lam[..., None]).sum(2)


def forecast_stage(st, gamma):
    B, n = st["hist_uif"].shape[:2]
    uif_pred = forecast.forecast_inflexible(st["hist_uif"])
    tuf_pred = forecast.forecast_daily_total(st["hist_flex_daily"])
    tr_pred = forecast.forecast_daily_total(st["hist_res_daily"])
    ra, rb = forecast.fit_ratio_model(
        st["hist_usage"][:, :, -28:].reshape(B, n, -1),
        st["hist_res"][:, :, -28:].reshape(B, n, -1))
    eps97 = forecast.relative_error_quantile(
        st["hist_tr_pred"][..., -90:], st["hist_res_daily"][..., -90:], 0.97)
    theta = forecast.theta_requirement(tr_pred, eps97)
    alpha = forecast.alpha_inflation(theta, uif_pred, tuf_pred, ra, rb)
    epsq = forecast.relative_error_quantile(
        st["hist_uif_pred"][:, :, -28:].reshape(B, n, -1),
        st["hist_uif"][:, :, -28:].reshape(B, n, -1), _col(1 - gamma))
    uif_q = uif_pred * (1.0 + torch.clamp(epsq, 0.0, 1.0)[..., None])
    return {"uif": uif_pred, "tuf": tuf_pred, "tr": tr_pred,
            "ratio_a": ra, "ratio_b": rb, "alpha": alpha, "uif_q": uif_q}


def build_problem(fc, eta_fc, model: PowerModel, st, params, xs, cap_day
                  ) -> solve.Problem:
    tau = fc["alpha"] * fc["tuf"] + st["queue"]
    u_nom = fc["uif"] + tau[..., None] / 24.0
    ratio = forecast.ratio_at(fc["ratio_a"][..., None],
                              fc["ratio_b"][..., None], u_nom)
    return solve.Problem(
        eta=eta_fc, u_if=fc["uif"], u_if_q=fc["uif_q"], tau=tau,
        pow_nom=model.power(u_nom), pi=model.slope(u_nom),
        u_pow_cap=st["u_pow_cap"] * xs["cap_scale"], capacity=cap_day,
        ratio=ratio, campus=st["campus"],
        campus_limit=st["campus_limit"] * xs["campus_scale"],
        lambda_e=params["lambda_e"], lambda_p=params["lambda_p"])


def observe_stage(truth, day, day_key, vcc_curve, cap_day, arr_scale, queue,
                  cf_queue, power_fn, intensity, allowance_frac=0.25):
    u_if = sample_inflexible(prng.fold_in(day_key, 2), truth, day)
    u_if = torch.minimum(u_if, 0.98 * cap_day[..., None])
    arrivals = sample_arrivals(prng.fold_in(day_key, 3), truth, day)
    arrivals = arrivals * arr_scale[..., None]
    ratio_true = true_ratio(truth, u_if + arrivals)
    res = admission.run_day(vcc_curve, u_if, arrivals, ratio_true, cap_day,
                            queue, power_fn, intensity, allowance_frac)
    unshaped = (cap_day[..., None] * 10.0).expand_as(vcc_curve)
    cf = admission.run_day(unshaped, u_if, arrivals, ratio_true, cap_day,
                           cf_queue, power_fn, intensity, allowance_frac)
    return res, cf, u_if


def lower_to(dtype):
    """The control's rounding: every floating tensor of a state dict or a
    problem stored in ``dtype`` between stages, computed in float32."""
    def lower(x):
        if isinstance(x, torch.Tensor):
            return x.to(dtype).to(x.dtype) if x.is_floating_point() else x
        if isinstance(x, dict):
            return {k: lower(v) for k, v in x.items()}
        if isinstance(x, solve.Problem):
            return dataclasses.replace(x, **{
                f.name: lower(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor)})
        return x
    return lower


def _keep(x):
    return x


def day_step(cfg: Dict, params, st, xs, tally=None, lower=_keep,
             probe=None):
    """One planned day: (state', shaped DayResult, counterfactual).
    ``lower`` rounds the day's problem and the state it hands on (the
    control's lower precision); by default nothing is rounded. A ``probe``
    dict receives the problem solved, the post-gate VCC, the solver's
    shaped flags, the joint solve's call (``take``) and the SLO tests'
    ratios to their thresholds (``slo.ratios``)."""
    truth = params["truth"]
    day_key = prng.fold_in(params["key"], st["day"])
    cap_day = truth["capacity"] * xs["cap_scale"]
    model = PowerModel(st["hist_usage"], params["lam"], truth["capacity"],
                       params, prng.fold_in(day_key, 1))
    fc = forecast_stage(st, params["gamma"])
    act_z, fc_z = carbon_stage(params["zone"], st["carbon_hist"],
                               prng.fold_in(day_key, 4), xs["green_scale"],
                               xs["coal_scale"])
    eta_act = take(act_z, st["zmap"])
    eta_fc = take(fc_z, st["zmap"])
    prob = lower(build_problem(fc, eta_fc, model, st, params, xs, cap_day))
    ens = None
    if cfg["n_members"] > 1:
        uif_ens, eta_ens = solve.day_ensembles(
            prng.fold_in(day_key, 5), cfg["n_members"], fc["uif"],
            st["hist_uif_pred"], st["hist_uif"], fc_z, st["carbon_hist"],
            st["zmap"])
        ens = (eta_ens, uif_ens, params["risk_beta"])
    if cfg["joint_spatial"]:
        sol, tau_j = solve.solve_joint(prob, params["mobility"], tally=tally,
                                       probe=probe)
        prob = dataclasses.replace(prob, tau=tau_j)
        if ens is not None:
            prob = lower(solve.attach_ensemble(prob, *ens))
            sol = solve.solve_vcc(prob, tally=tally)
    else:
        prob = dataclasses.replace(
            prob, tau=solve.spatial_shift(prob, params["mobility"]))
        if ens is not None:
            prob = lower(solve.attach_ensemble(prob, *ens))
        sol = solve.solve_vcc(prob, tally=tally)
    gate = st["shaping_allowed"] & sol.shaped
    vcc_curve = torch.where(gate[..., None], sol.vcc,
                            cap_day[..., None] * 10.0)
    res, cf, u_if = observe_stage(
        truth, st["day"], day_key, vcc_curve, cap_day, xs["arrival_scale"],
        st["queue"], st["cf_queue"], model.power, eta_act,
        allowance_frac=cfg["slo_allowance"])
    slo_state = {k: st[k] for k in ("crowded_streak", "pause_left",
                                    "violation_days", "observed_days")}
    slo_cfg = slo.SLOConfig(margin=cfg["slo_margin"],
                            pause_days=cfg["slo_pause_days"])
    slo_args = (hour_sum(res.reservations), hour_sum(vcc_curve), res.unmet,
                res.arrived)
    new_slo, allowed = slo.update(slo_state, slo_cfg, *slo_args)
    if probe is not None:
        crowded, violated = slo.ratios(slo_cfg, *slo_args)
        probe.update(vcc_curve=vcc_curve, shaped=sol.shaped, prob=prob,
                     crowded=crowded, violated=violated)
    new = dict(st)
    new.update(
        day=st["day"] + 1,
        hist_uif=roll(st["hist_uif"], u_if),
        hist_flex_daily=roll(st["hist_flex_daily"], res.served),
        hist_res_daily=roll(st["hist_res_daily"], hour_sum(res.reservations)),
        hist_usage=roll(st["hist_usage"], res.usage_total),
        hist_res=roll(st["hist_res"], res.reservations),
        hist_tr_pred=roll(st["hist_tr_pred"], fc["tr"]),
        hist_uif_pred=roll(st["hist_uif_pred"], fc["uif"]),
        carbon_hist=roll(st["carbon_hist"], act_z),
        queue=res.queue_end, cf_queue=cf.queue_end, shaping_allowed=allowed,
        **new_slo)
    return lower(new), res, cf


# ---------------------------------------------------------------- burn-in

def _proxy_power(u):
    return 100.0 + 300.0 * u


def burn_in(cfg: Dict, params, lower=_keep):
    """The burned-in state: ``hist_days`` unshaped days with the linear
    power proxy, a zero-error prediction prior, and campus contracts at 97%
    of the fitted-model campus peak over the last week."""
    n, m, z, H = (cfg["n_clusters"], cfg["n_campuses"], cfg["n_zones"],
                  cfg["hist_days"])
    dev = params["key"].device
    B = params["key"].shape[0]
    cap = params["truth"]["capacity"]
    campus = (torch.arange(n, device=dev) % m).expand(B, n)
    zeros = torch.zeros((B, n), dtype=torch.int64, device=dev)

    def hist(*shape):
        return torch.zeros((B,) + shape, dtype=f32, device=dev)

    st = dict(
        day=torch.zeros((B,), dtype=torch.int64, device=dev),
        campus=campus, zmap=campus % z, campus_limit=hist(m),
        u_pow_cap=cap * 0.95,
        hist_uif=hist(n, H, 24), hist_flex_daily=hist(n, H),
        hist_res_daily=hist(n, H), hist_usage=hist(n, H, 24),
        hist_res=hist(n, H, 24), hist_tr_pred=hist(n, H),
        hist_uif_pred=hist(n, H, 24), carbon_hist=hist(z, H, 24),
        queue=hist(n), cf_queue=hist(n), crowded_streak=zeros,
        pause_left=zeros, violation_days=zeros, observed_days=zeros,
        shaping_allowed=torch.ones((B, n), dtype=torch.bool, device=dev))
    ones_z = torch.ones_like(params["zone"]["solar_cap"])
    for _ in range(H):
        day_key = prng.fold_in(params["key"], st["day"])
        act_z, _ = carbon_stage(params["zone"], st["carbon_hist"],
                                prng.fold_in(day_key, 4), ones_z, ones_z)
        unshaped = (cap[..., None] * 10.0).expand(cap.shape + (24,))
        res, _, u_if = observe_stage(
            params["truth"], st["day"], day_key, unshaped, cap,
            torch.ones_like(cap), st["queue"], st["queue"], _proxy_power,
            take(act_z, st["zmap"]))
        st.update(
            day=st["day"] + 1,
            hist_uif=roll(st["hist_uif"], u_if),
            hist_flex_daily=roll(st["hist_flex_daily"], res.served),
            hist_res_daily=roll(st["hist_res_daily"],
                                hour_sum(res.reservations)),
            hist_usage=roll(st["hist_usage"], res.usage_total),
            hist_res=roll(st["hist_res"], res.reservations),
            carbon_hist=roll(st["carbon_hist"], act_z),
            queue=res.queue_end, cf_queue=res.queue_end)
    st.update(hist_tr_pred=st["hist_res_daily"],
              hist_uif_pred=st["hist_uif"])
    model = PowerModel(st["hist_usage"], params["lam"], cap, params,
                       prng.fold_in(params["key"], 999))
    upow = model.power(st["hist_usage"][:, :, -7:].reshape(B, n, -1))
    st["campus_limit"] = solve.segment_sum(upow.amax(-1), campus, m) * 0.97
    return lower(st)


# ----------------------------------------------------------------- rollout

def day_xs(params, d: int):
    return {k: params[k][:, d] for k in ("green_scale", "coal_scale",
                                         "cap_scale", "arrival_scale",
                                         "campus_scale")}


def rollout(cfg: Dict, params, st, days: int, tally=None, lower=_keep):
    """``days`` planned days from ``st``: (state', ledger, traj), the
    ledger's per-cluster totals (B, n) and the days' fleet totals
    (B, days), as the program's rollout returns them."""
    B, n = st["queue"].shape
    zero = torch.zeros((B, n), dtype=f32, device=st["queue"].device)
    led = {k: zero for k in LEDGER_KEYS}
    traj = {k: [] for k in TRAJ_KEYS}
    for d in range(days):
        st, res, cf = day_step(cfg, params, st, day_xs(params, d), tally,
                               lower)
        m = {"carbon_kg": hour_sum(res.carbon), "kwh": hour_sum(res.power),
             "peak_kw": res.power.amax(-1), "served": res.served,
             "arrived": res.arrived, "unmet": res.unmet,
             "queue_end": res.queue_end, "cf_carbon_kg": hour_sum(cf.carbon),
             "cf_kwh": hour_sum(cf.power), "cf_peak_kw": cf.power.amax(-1),
             "cf_served": cf.served, "cf_queue_end": cf.queue_end}
        for k in LEDGER_KEYS:
            if k in ("peak_kw", "cf_peak_kw"):
                led[k] = torch.maximum(led[k], m[k])
            elif k == "delayed_cpu_h":
                led[k] = led[k] + m["queue_end"]
            elif k == "cf_delayed_cpu_h":
                led[k] = led[k] + m["cf_queue_end"]
            else:
                led[k] = led[k] + m[k]
        traj["carbon_kg"].append(hour_sum(m["carbon_kg"]))
        traj["cf_carbon_kg"].append(hour_sum(m["cf_carbon_kg"]))
        traj["kwh"].append(hour_sum(m["kwh"]))
        traj["peak_kw"].append(hour_sum(m["peak_kw"]))
        traj["queue"].append(hour_sum(m["queue_end"]))
    return st, led, {k: torch.stack(v, dim=1) for k, v in traj.items()}
