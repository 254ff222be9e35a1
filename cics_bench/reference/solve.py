"""The day's VCC solves in plain PyTorch (paper §III-C, eq. 4): the
benchmark's frozen reference for kernels #1-#3 and the solver around them.

* ``project`` — the exact Euclidean projection of each row onto
  {sum = 0} ∩ [lo, ub]: sort the 2H breakpoints of the piecewise-linear
  f(nu) = sum clamp(z - nu, lo, ub), evaluate f at each, and interpolate
  the crossing. The program bisects nu instead; both reach the same point
  to float32 rounding, by different arithmetic.
* ``Tally`` — with a trace, counts the bisection halvings that these
  inputs need (the cost model's operation count, ``costs/``): each counted
  projection is also bisected as the program's kernels do it, to the first
  halving that moves no bracket end.
* the fused epochs (temporal, CVaR ensemble, joint step with the shift
  update), the dual ascent over campus contracts, ``solve_vcc``, the greedy
  spatial pre-shift, ``solve_joint`` and the forecast ensembles.

Every tensor carries a leading rollout axis B before the cluster axis n.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from cics_bench.reference import prng

f32 = torch.float32
CVAR_SHARPNESS = 4.0
ERR_LO, ERR_HI = -0.9, 3.0
PROJ_ITERS = 50


# ---------------------------------------------------------------- projection

def project(z, lo, ub):
    """Exact projection of each row of ``z`` (..., H) onto {sum = 0} ∩
    [lo, ub] (needs sum lo <= 0 <= sum ub)."""
    t, _ = torch.sort(torch.cat([z - ub, z - lo], dim=-1), dim=-1)
    f = torch.clamp(z[..., None, :] - t[..., :, None], lo[..., None, :],
                    ub[..., None, :]).sum(-1)                  # (..., 2H)
    k = torch.clamp((f >= 0).sum(-1, keepdim=True) - 1, 0, t.shape[-1] - 2)
    t0, t1 = torch.gather(t, -1, k), torch.gather(t, -1, k + 1)
    f0, f1 = torch.gather(f, -1, k), torch.gather(f, -1, k + 1)
    drop = f0 - f1
    frac = torch.where(drop > 0, f0 / torch.where(drop > 0, drop, 1.0), 0.0)
    nu = t0 + (t1 - t0) * torch.clamp(frac, 0.0, 1.0)
    return torch.clamp(z - nu, lo, ub)


def bisect_halvings(z, lo, ub, iters: int = PROJ_ITERS):
    """Halvings the program's bisection of nu takes on each row: up to and
    including the first that moves neither end of the bracket
    [min z - max ub, max z - min lo], at most ``iters``. (..., H) -> (...)."""
    a = z.amin(-1) - ub.amax(-1)
    b = z.amax(-1) - lo.amin(-1)
    live = torch.ones_like(a, dtype=torch.bool)
    count = torch.zeros_like(a)
    for _ in range(iters):
        m = 0.5 * (a + b)
        pos = torch.clamp(z - m[..., None], lo, ub).sum(-1) > 0
        a2, b2 = torch.where(pos, m, a), torch.where(pos, b, m)
        count = count + live.to(f32)
        live = live & ((a2 != a) | (b2 != b))
        a, b = a2, b2
    return count


class Tally:
    """Halvings of the program's bisections, sampled from the reference's
    own projections: the first ``rounds`` dual-ascent rounds of every solve
    are counted, by kind (``pgd_epoch``, ``pgd_epoch_ens``, ``joint_row``,
    ``joint_shift``). ``mean(kind)`` is the mean halvings a row and step."""

    def __init__(self, rounds: int = 1):
        self.rounds = rounds
        self.sums: Dict[str, float] = {}
        self.rows: Dict[str, int] = {}
        self._round = 0

    def start_round(self, r: int):
        self._round = r

    def want(self) -> bool:
        return self._round < self.rounds

    def add(self, kind: str, z, lo, ub):
        h = bisect_halvings(z, lo, ub)
        self.sums[kind] = self.sums.get(kind, 0.0) + float(h.sum())
        self.rows[kind] = self.rows.get(kind, 0) + h.numel()

    def mean(self, kind: str) -> Optional[float]:
        n = self.rows.get(kind, 0)
        return self.sums[kind] / n if n else None


def _project(z, lo, ub, tally, kind):
    if tally is not None and tally.want():
        tally.add(kind, z, lo, ub)
    return project(z, lo, ub)


# ------------------------------------------------------------------ problem

@dataclass(frozen=True)
class Problem:
    """The fleetwide day problem: (B, n, H) hourly and (B, n) cluster
    fields, (B, m) campus limits, (B,) prices; K members (B, K, n, H) in
    the ensemble fields of a risk-aware problem."""
    eta: torch.Tensor
    u_if: torch.Tensor
    u_if_q: torch.Tensor
    tau: torch.Tensor
    pow_nom: torch.Tensor
    pi: torch.Tensor
    u_pow_cap: torch.Tensor
    capacity: torch.Tensor
    ratio: torch.Tensor
    campus: torch.Tensor
    campus_limit: torch.Tensor
    lambda_e: torch.Tensor
    lambda_p: torch.Tensor
    drop_limit: float = 0.8
    eta_ens: Optional[torch.Tensor] = None
    pow_nom_ens: Optional[torch.Tensor] = None
    risk_beta: Optional[torch.Tensor] = None


@dataclass
class Solution:
    delta: torch.Tensor
    y: torch.Tensor
    vcc: torch.Tensor
    shaped: torch.Tensor
    mu: torch.Tensor


def delta_bounds(p: Problem):
    tau24 = torch.clamp(p.tau[..., None] / 24.0, min=1e-9)
    ub_pow = (p.u_pow_cap[..., None] - p.u_if_q) / tau24 - 1.0
    ub_cap = (p.capacity[..., None] / p.ratio - p.u_if) / tau24 - 1.0
    ub = torch.minimum(ub_pow, ub_cap)
    lo = torch.full_like(ub, -p.drop_limit)
    ub = torch.clamp(ub, -p.drop_limit, 24.0)
    feasible = (ub.sum(-1) >= 0.0) & (p.tau > 1e-6) \
        & (ub > -p.drop_limit + 1e-9).all(-1)
    return lo, ub, feasible


def cluster_power(p: Problem, delta):
    return p.pow_nom + p.pi * delta * p.tau[..., None] / 24.0


def segment_sum(data, ids, num: int):
    """Per-campus sums of ``data`` (B, n) by ``ids`` (B, n): a masked sum
    over the cluster axis, one row per campus."""
    onehot = ids[..., None, :] == torch.arange(num, device=ids.device)[:, None]
    return torch.where(onehot, data[..., None, :], 0.0).sum(-1)


def campus_dual_update(mu, y, campus, campus_limit, rho):
    campus_pow = segment_sum(y, campus, campus_limit.shape[-1])
    return torch.clamp(mu + rho * (campus_pow - campus_limit)
                       / torch.clamp(campus_limit, min=1e-9), min=0.0)


def peak_temperature(pow_nom, temp_frac):
    return temp_frac * torch.clamp(pow_nom.mean(dim=(-2, -1)), min=1e-6)


def scaled_lr(lr, pi, tau, eta, lambda_e, lambda_p):
    g_scale = torch.clamp((pi * tau[..., None] / 24.0).amax(-1, keepdim=True),
                          min=1e-9)
    return lr / (g_scale * torch.clamp(
        lambda_e[..., None, None] * eta.amax(-1, keepdim=True)
        + lambda_p[..., None, None], min=1e-9))


def cvar_sharpness(beta):
    b = torch.clamp(torch.as_tensor(beta, dtype=f32), 0.05, 1.0)
    return CVAR_SHARPNESS * (1.0 - b) / b


# ------------------------------------------------------------------- epochs

def _price(p: Problem, mu):
    return (p.lambda_p[..., None] + torch.gather(mu, -1, p.campus))[..., None]


def pgd_epoch(p: Problem, delta, mu, lo, ub, lr, temp, iters, tally=None):
    """``iters`` projected-gradient steps of the point-forecast problem
    (kernel #1's function)."""
    tau24 = p.tau[..., None] / 24.0
    price = _price(p, mu)
    t = temp[..., None, None]
    lam = p.lambda_e[..., None, None]
    d = delta
    for _ in range(iters):
        pow_h = p.pow_nom + p.pi * d * tau24
        w = torch.softmax(pow_h / t, dim=-1)
        grad = (lam * p.eta + price * w) * p.pi * tau24
        d = _project(d - lr * grad, lo, ub, tally, "pgd_epoch")
    return d


def member_costs(d, eta_e, pi, pow_nom_e, tau24, price, temp, lambda_e):
    """Per-(member, cluster) day cost under ``d``: (B, K, n), with the
    members' power and softmax-peak weights (B, K, n, H)."""
    pow_e = pow_nom_e + (pi * d * tau24)[:, None]
    w_peak = torch.softmax(pow_e / temp[:, None], dim=-1)
    cost = lambda_e[:, None, :, 0] * (eta_e * pow_e).sum(-1) \
        + price[:, None, :, 0] * (w_peak * pow_e).sum(-1)
    return cost, pow_e, w_peak


def member_weights(cost, risk_s):
    """Soft-CVaR member weights (B, K, n), anchored on member 0."""
    z = cost - cost[:, :1]
    dev = cost - cost.mean(1, keepdim=True)
    scale = dev.abs().mean(1, keepdim=True) + 1e-9
    return torch.softmax(risk_s[:, None, :, 0] * z / scale, dim=1)


def pgd_epoch_ens(p: Problem, delta, mu, lo, ub, lr, temp, iters,
                  tally=None):
    """``iters`` CVaR-tilted steps over the K members (kernel #2's
    function)."""
    tau24 = p.tau[..., None] / 24.0
    price = _price(p, mu)
    slim = delta.shape[:-1] + (1,)
    t = temp[..., None, None].expand(slim)
    lam = p.lambda_e[..., None, None].expand(slim)
    risk_s = cvar_sharpness(p.risk_beta).to(delta.device)[
        ..., None, None].expand(slim)
    eta_e, pow_e0 = p.eta_ens, p.pow_nom_ens
    d = delta
    for _ in range(iters):
        cost, pow_e, w_peak = member_costs(d, eta_e, p.pi, pow_e0, tau24,
                                           price, t, lam)
        wm = member_weights(cost, risk_s)[..., None]
        eta_w = eta_e[:, 0] + (wm * (eta_e - eta_e[:, :1])).sum(1)
        w_w = w_peak[:, 0] + (wm * (w_peak - w_peak[:, :1])).sum(1)
        grad = (lam * eta_w + price * w_w) * p.pi * tau24
        d = _project(d - lr * grad, lo, ub, tally, "pgd_epoch_ens")
    return d


def joint_epoch(p: Problem, d, s, mu, lo_s, ub_s, lr_d, lr_s, temp, iters,
                tally=None):
    """``iters`` joint spatio-temporal steps, each with the fleet-coupled
    shift update (kernel #3's function)."""
    price = _price(p, mu)
    t = temp[..., None, None]
    lam = p.lambda_e[..., None, None]
    tau = p.tau[..., None]
    dl = p.drop_limit
    for _ in range(iters):
        sc = s[..., None]
        tau_s = tau + sc
        t24 = torch.clamp(tau_s / 24.0, min=1e-9)
        ub = torch.minimum((p.u_pow_cap[..., None] - p.u_if_q) / t24 - 1.0,
                           (p.capacity[..., None] / p.ratio - p.u_if) / t24
                           - 1.0)
        ub = torch.clamp(ub, -dl, 24.0)
        feas = (ub.sum(-1, keepdim=True) >= 0.0) & (tau_s > 1e-6) \
            & (ub > -dl + 1e-9).all(-1, keepdim=True)
        lo = torch.where(feas, torch.full_like(ub, -dl), 0.0)
        ub = torch.where(feas, ub, 0.0)
        pow_h = p.pow_nom + p.pi * (d * tau_s + sc) / 24.0
        w = torch.softmax(pow_h / t, dim=-1)
        gcoef = (lam * p.eta + price * w) * p.pi
        g_s = (gcoef * (1.0 + d)).sum(-1) / 24.0
        d2 = _project(d - lr_d * (gcoef * (tau_s / 24.0)), lo, ub, tally,
                      "joint_row")
        s = _project(s - lr_s[..., None] * g_s, lo_s, ub_s, tally,
                     "joint_shift")
        d = d2
    return d, s


# ------------------------------------------------------------------- solves

def _descend(p: Problem, lo, ub, outer, inner, lr, temp_frac, rho,
             tally=None):
    temp = peak_temperature(p.pow_nom, temp_frac)
    lr_eff = scaled_lr(lr, p.pi, p.tau, p.eta, p.lambda_e, p.lambda_p)
    epoch = pgd_epoch if p.eta_ens is None else pgd_epoch_ens
    delta = torch.zeros_like(p.eta)
    mu = torch.zeros_like(p.campus_limit)
    for r in range(outer):
        if tally is not None:
            tally.start_round(r)
        delta = epoch(p, delta, mu, lo, ub, lr_eff, temp, inner, tally)
        y = cluster_power(p, delta).amax(-1)
        mu = campus_dual_update(mu, y, p.campus, p.campus_limit, rho)
    return delta, mu


def solve_vcc(p: Problem, *, inner_iters=80, outer_iters=20, lr=0.5,
              temp_frac=0.02, rho=0.2, tally=None) -> Solution:
    """The day solve: ``outer_iters`` dual-ascent rounds over the campus
    contracts, each ``inner_iters`` projected-gradient steps; clusters
    whose bounds admit no shaping get VCC = machine capacity."""
    if p.eta_ens is not None and p.eta_ens.shape[1] == 1:
        p = dataclasses.replace(p, eta_ens=None, pow_nom_ens=None)
    lo, ub, feasible = delta_bounds(p)
    lo = torch.where(feasible[..., None], lo, 0.0)
    ub = torch.where(feasible[..., None], ub, 0.0)
    delta, mu = _descend(p, lo, ub, outer_iters, inner_iters, lr, temp_frac,
                         rho, tally)
    y = cluster_power(p, delta).amax(-1)
    vcc_shaped = (p.u_if + (1.0 + delta) * p.tau[..., None] / 24.0) * p.ratio
    cap = p.capacity[..., None]
    vcc = torch.where(feasible[..., None], torch.minimum(vcc_shaped, cap),
                      cap.expand_as(vcc_shaped))
    return Solution(delta=delta, y=y, vcc=vcc, shaped=feasible, mu=mu)


def minimize_linear(cost, lo, ub):
    """Exact row-wise minimizer of <cost, x> over {sum x = 0} ∩ [lo, ub]:
    spend the budget -sum(lo) on the cheapest coordinates first."""
    order = torch.argsort(cost, dim=-1, stable=True)
    room = torch.gather(ub - lo, -1, order)
    budget = -lo.sum(-1, keepdim=True)
    cum = torch.cumsum(room, dim=-1)
    add = torch.minimum(torch.clamp(budget - (cum - room), min=0.0), room)
    inv = torch.argsort(order, dim=-1, stable=True)
    return lo + torch.gather(add, -1, inv)


def shift_bounds(p: Problem, mobility):
    mob = mobility[..., None]
    room_h = torch.clamp(p.capacity[..., None] / p.ratio - p.u_if, min=0.0)
    headroom = torch.clamp(room_h.sum(-1) - p.tau, min=0.0)
    return -mob * p.tau, torch.minimum(mob * p.tau, headroom)


def spatial_shift(p: Problem, mobility):
    """Greedy pre-shift of the daily budgets toward cheap carbon."""
    price = (p.eta * p.pi).mean(-1)
    lo, ub = shift_bounds(p, mobility)
    return torch.clamp(p.tau + minimize_linear(price, lo, ub), min=0.0)


def joint_power(p: Problem, delta, s):
    return p.pow_nom + p.pi * (delta * (p.tau + s)[..., None]
                               + s[..., None]) / 24.0


def joint_carbon(p: Problem, delta, s):
    return (p.eta * joint_power(p, delta, s)).sum(dim=(-2, -1))


def joint_objective(p: Problem, delta, s):
    y = joint_power(p, delta, s).amax(-1)
    return p.lambda_e * joint_carbon(p, delta, s) \
        + (p.lambda_p[..., None] * y).sum(-1)


def solve_joint(p: Problem, mobility, *, inner_iters=80, outer_iters=20,
                joint_inner=25, joint_outer=8, lr=0.5, lr_s=0.15,
                temp_frac=0.02, rho=0.2, tally=None, probe=None):
    """The joint spatio-temporal solve: the greedy pre-shift and its
    temporal solve as the warm start, ``joint_outer`` rounds of
    ``joint_inner`` joint steps, and the joint point kept per rollout only
    where it improves both the objective and the carbon. Returns
    (solution, shifted budgets tau_j); a ``probe`` dict receives that
    call per rollout (``take``)."""
    tau_sh = spatial_shift(p, mobility)
    seq = solve_vcc(dataclasses.replace(p, tau=tau_sh),
                    inner_iters=inner_iters, outer_iters=outer_iters, lr=lr,
                    temp_frac=temp_frac, rho=rho, tally=tally)
    lo_s, ub_s = shift_bounds(p, mobility)
    s0 = torch.clamp(tau_sh - p.tau, lo_s, ub_s)
    temp = peak_temperature(p.pow_nom, temp_frac)
    lr_d = scaled_lr(lr, p.pi, p.tau, p.eta, p.lambda_e, p.lambda_p)
    g_norm = torch.clamp((p.lambda_e[..., None] * (p.eta * p.pi).mean(-1)
                          + p.lambda_p[..., None] * p.pi.mean(-1) / 24.0
                          ).amax(-1), min=1e-9)
    lr_s_eff = lr_s * torch.clamp(p.tau.mean(-1), min=1e-6) / g_norm
    d, s, mu = seq.delta, s0, seq.mu
    for r in range(joint_outer):
        if tally is not None:
            tally.start_round(r)
        d, s = joint_epoch(p, d, s, mu, lo_s, ub_s, lr_d, lr_s_eff, temp,
                           joint_inner, tally)
        y = joint_power(p, d, s).amax(-1)
        mu = campus_dual_update(mu, y, p.campus, p.campus_limit, rho)
    obj_j, obj_q = joint_objective(p, d, s), joint_objective(p, seq.delta, s0)
    co2_j, co2_q = joint_carbon(p, d, s), joint_carbon(p, seq.delta, s0)
    take = (obj_j <= obj_q) & (co2_j <= co2_q)
    if probe is not None:
        probe["take"] = take
    delta = torch.where(take[..., None, None], d, seq.delta)
    s = torch.where(take[..., None], s, s0)
    mu = torch.where(take[..., None], mu, seq.mu)
    tau_j = torch.clamp(p.tau + s, min=0.0)
    pf = dataclasses.replace(p, tau=tau_j)
    _, _, feasible = delta_bounds(pf)
    delta = torch.where(feasible[..., None], delta, 0.0)
    y = joint_power(p, delta, s).amax(-1)
    vcc_shaped = (pf.u_if + (1.0 + delta) * tau_j[..., None] / 24.0) \
        * pf.ratio
    cap = pf.capacity[..., None]
    vcc = torch.where(feasible[..., None], torch.minimum(vcc_shaped, cap),
                      cap.expand_as(vcc_shaped))
    return Solution(delta=delta, y=y, vcc=vcc, shaped=feasible, mu=mu), tau_j


# --------------------------------------------------------------- ensembles

def _member_errors(err, idx):
    B, m, _, H = err.shape
    K = idx.shape[-1]
    e = torch.gather(err, 2, idx[:, None, :, None].expand(B, m, K, H))
    e = torch.clamp(e, ERR_LO, ERR_HI).transpose(1, 2)
    return torch.cat([torch.zeros_like(e[:, :1]), e[:, 1:]], dim=1)


def day_ensembles(key, n_members, uif_pred, hist_uif_pred, hist_uif, fc_z,
                  carbon_hist, zmap):
    """K day-ahead members of (inflexible usage, intensity), member 0 the
    point forecast: whole history days of relative error resampled, one
    day a member for the whole fleet. Returns (uif_ens, eta_ens), each
    (B, K, n, 24)."""
    keys = prng.split(key, 2)
    err = (hist_uif - hist_uif_pred) / torch.clamp(hist_uif_pred.abs(),
                                                   min=1e-9)
    idx = prng.randint(keys[:, 0], (n_members,), 0, err.shape[2])
    uif_ens = torch.clamp(uif_pred[:, None] * (1.0 + _member_errors(err, idx)),
                          min=0.0)
    prev = carbon_hist[:, :, :-1]
    dz = (carbon_hist[:, :, 1:] - prev) / torch.clamp(prev.abs(), min=1e-9)
    idx = prng.randint(keys[:, 1], (n_members,), 0, dz.shape[2])
    eta_z = torch.clamp(fc_z[:, None] * (1.0 + _member_errors(dz, idx)),
                        min=1e-6)
    B, K, _, H = eta_z.shape
    eta_ens = torch.gather(eta_z, 2, zmap[:, None, :, None].expand(
        B, K, zmap.shape[-1], H))
    return uif_ens, eta_ens


def attach_ensemble(p: Problem, eta_ens, uif_ens, risk_beta) -> Problem:
    pow_nom_ens = p.pow_nom[:, None] + p.pi[:, None] \
        * (uif_ens - p.u_if[:, None])
    return dataclasses.replace(p, eta_ens=eta_ens, pow_nom_ens=pow_nom_ens,
                               risk_beta=risk_beta)
