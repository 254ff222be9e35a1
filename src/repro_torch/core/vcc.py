"""Risk-aware day-ahead VCC optimization (paper §III-C, eq. 4).

Per cluster c and hour h, choose flexible-usage deviations delta(c,h) from
the hourly average tau/24, minimizing

    lambda_e * sum_{c,h} eta(c,h) * [Pow(U_nom) + pi(U_nom) * delta * tau/24]
  + lambda_p * sum_c  y_c ,                    y_c >= Pow_c(h)  for all h

subject to daily conservation (sum_h delta = 0), power capping, machine
capacity, campus contracts and delta >= -drop_limit. Projected gradient on
delta with an exact bisection projection, and dual ascent on the campus
coupling, assembled from ``core.solver``. The PGD epoch is the fused kernel
(``kernels.vcc_pgd``). Clusters whose bounds make shaping infeasible get
VCC = machine capacity.

Port of ``repro.core.vcc``. Every field may carry leading
batch axes (the scenario x seed batch); ``lambda_e``, ``lambda_p`` and
``risk_beta`` then have the batch shape. A problem may carry K day-ahead
forecast members (``risk.attach_ensemble``); its PGD epoch then descends the
soft-CVaR member tilt at ``risk_beta`` (the CVaR ensemble kernel).

``solve_vcc(telemetry=True)`` also returns the solver's convergence
channels: the per-round objective and step trajectories and the
post-solve residuals of ``solution_diagnostics``, observers that launch no
kernel.

``solve_vcc_suffix`` is the intra-day re-solve of the MPC recourse loop
(``core.mpc``): the hours already elapsed are pinned (``suffix_bounds``)
and a short warm-started schedule of the same fused epoch re-plans the
rest.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import spans
from repro_torch.core import prng, solver
from repro_torch.core.admission import hour_sum
from repro_torch.kernels.vcc_pgd import ref as _pgd_ref

f32 = torch.float32


@dataclass(frozen=True)
class VCCProblem:
    """Stacked fleetwide problem: (..., n, H) hourly and (..., n) cluster
    fields, (..., n_dc) campus limits, per-rollout prices of shape (...).

    The optional ensemble fields carry K forecast realizations, (..., K, n,
    H), member 0 the point forecast, and the CVaR tail fraction ``risk_beta``
    (...) (1 = risk-neutral mean). None = the point-forecast problem."""
    eta: torch.Tensor           # (..., n, H) carbon intensity forecast
    u_if: torch.Tensor          # (..., n, H) predicted inflexible CPU
    u_if_q: torch.Tensor        # (..., n, H) (1-gamma) quantile of it
    tau: torch.Tensor           # (..., n) risk-aware daily flexible CPU
    pow_nom: torch.Tensor       # (..., n, H) power at nominal usage
    pi: torch.Tensor            # (..., n, H) power slope at nominal usage
    u_pow_cap: torch.Tensor     # (..., n) power-capping CPU threshold
    capacity: torch.Tensor      # (..., n) machine capacity
    ratio: torch.Tensor         # (..., n, H) reservations-to-usage ratio
    campus: torch.Tensor        # (..., n) int64 campus id
    campus_limit: torch.Tensor  # (..., n_dc) power limits (kW)
    lambda_e: torch.Tensor      # (...) $ / kg CO2e
    lambda_p: torch.Tensor      # (...) $ / kW / day
    drop_limit: float = 0.8
    eta_ens: Optional[torch.Tensor] = None       # (..., K, n, H) intensity
    pow_nom_ens: Optional[torch.Tensor] = None   # (..., K, n, H) power
    risk_beta: Optional[torch.Tensor] = None     # (...) CVaR tail fraction

    def to(self, device) -> "VCCProblem":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclass
class VCCSolution:
    delta: torch.Tensor         # (..., n, H)
    y: torch.Tensor             # (..., n) peak power
    vcc: torch.Tensor           # (..., n, H) hourly reservation capacity
    shaped: torch.Tensor        # (..., n) bool: cluster actively shaped
    mu: torch.Tensor            # (..., n_dc) campus duals
    objective: torch.Tensor     # (...)


project_conservation = solver.project_conservation


def delta_bounds(p: VCCProblem):
    """Per (c, h) bounds on delta + feasibility mask."""
    tau24 = torch.clamp(p.tau[..., None] / 24.0, min=1e-9)
    ub_pow = (p.u_pow_cap[..., None] - p.u_if_q) / tau24 - 1.0
    ub_cap = (p.capacity[..., None] / p.ratio - p.u_if) / tau24 - 1.0
    ub = torch.minimum(ub_pow, ub_cap)
    lo = torch.full_like(ub, -p.drop_limit)
    ub = torch.clamp(ub, -p.drop_limit, 24.0)
    feasible = (ub.sum(-1) >= 0.0) & (p.tau > 1e-6) \
        & (ub > -p.drop_limit + 1e-9).all(-1)
    return lo, ub, feasible


def cluster_power(p: VCCProblem, delta):
    """Hourly power under delta (local linearization around nominal)."""
    return p.pow_nom + p.pi * delta * p.tau[..., None] / 24.0


def objective(p: VCCProblem, delta, mu, *, risk: bool = True):
    """Day cost of ``delta`` at campus duals ``mu``: shape (...). Eq. 4 for
    a point-forecast problem; the soft CVaR over the members
    (``risk.soft_cvar_objective``) for an ensemble problem unless
    ``risk=False`` asks for the nominal (point-forecast) cost, which is what
    ``solve_vcc`` records."""
    if risk and p.eta_ens is not None:
        from repro_torch.core import risk as _risk
        return _risk.soft_cvar_objective(p, delta, mu)
    pow_h = cluster_power(p, delta)
    y = pow_h.amax(-1)
    carbon = p.lambda_e * (p.eta * pow_h).sum(dim=(-2, -1))
    peak_price = p.lambda_p[..., None] + torch.gather(mu, -1, p.campus)
    return carbon + (peak_price * y).sum(-1)


def cluster_objective(p: VCCProblem, delta):
    """Per-cluster nominal (eq. 4, mu-free) day cost of ``delta``:
    lambda_e * sum_h eta * pow + lambda_p * max_h pow, shape (..., n).
    Ordered hour sums only, so a batch equals its rollouts alone."""
    pow_h = cluster_power(p, delta)
    return p.lambda_e[..., None] * hour_sum(p.eta * pow_h) \
        + p.lambda_p[..., None] * pow_h.amax(-1)


def solution_diagnostics(p: VCCProblem, delta, mu, *,
                         temp_frac: float = 0.02, proj_iters: int = 50):
    """Post-solve convergence residuals of ``(delta, mu)``, the cluster and
    campus axes not reduced:

    * ``conservation_resid`` (..., n): |sum_h delta|;
    * ``proj_nu_tol`` (..., n): the certified tolerance of the projection's
      nu bisection at the solution, the initial bracket width of
      ``kernels.vcc_pgd.ref.project_row`` halved ``proj_iters`` times;
    * ``dual_resid`` (..., n_dc): the relative campus overshoot
      max(0, (sum_c y - L) / L) at the final point;
    * ``cvar_tail_mass`` (..., n): the largest soft-CVaR member weight
      per cluster at the final delta for K > 1 problems (1/K uniform, 1 =
      all on one member); 1.0 for a point-forecast problem."""
    conservation = torch.abs(hour_sum(delta))
    lo, ub, feasible = delta_bounds(p)
    lo = torch.where(feasible[..., None], lo, 0.0)
    ub = torch.where(feasible[..., None], ub, 0.0)
    width0 = torch.clamp((delta.amax(-1) - lo.amin(-1))
                         - (delta.amin(-1) - ub.amax(-1)), min=0.0)
    proj_tol = width0 * (2.0 ** -proj_iters)
    y = cluster_power(p, delta).amax(-1)
    n_dc = p.campus_limit.shape[-1]
    campus_pow = solver.segment_sum(y, p.campus, n_dc)
    dual_resid = torch.clamp((campus_pow - p.campus_limit)
                             / torch.clamp(p.campus_limit, min=1e-9),
                             min=0.0)
    if p.eta_ens is not None and p.eta_ens.shape[-3] > 1:
        slim = delta.shape[:-1] + (1,)

        def per_row(x):
            return torch.as_tensor(x)[..., None, None].expand(slim)

        tau24 = torch.clamp(p.tau[..., None] / 24.0, min=1e-9)
        price = (p.lambda_p[..., None]
                 + torch.gather(mu, -1, p.campus))[..., None]
        temp = per_row(solver.peak_temperature(p.pow_nom, temp_frac))
        cost, _, _ = _pgd_ref.member_costs(
            delta, p.eta_ens, p.pi, p.pow_nom_ens, tau24, price, temp,
            per_row(p.lambda_e))
        tail = _pgd_ref.cvar_member_weights(
            cost, per_row(_pgd_ref.cvar_sharpness(p.risk_beta))).amax(-2)
    else:
        tail = torch.ones_like(p.tau)
    return {"conservation_resid": conservation, "proj_nu_tol": proj_tol,
            "dual_resid": dual_resid, "cvar_tail_mass": tail}


def solve_vcc(p: VCCProblem, *, inner_iters: int = 80, outer_iters: int = 20,
              lr: float = 0.5, temp_frac: float = 0.02, rho: float = 0.2,
              device=None, telemetry: bool = False):
    """Solve the fleetwide VCC problem (eq. 4) on ``device`` (default
    ``"cuda"``; ``"cpu"`` runs the plain epochs). ``outer_iters`` dual-ascent
    rounds, each one fused epoch of ``inner_iters`` PGD steps. An ensemble
    problem takes the CVaR epoch; a K = 1 ensemble is the point-forecast
    problem exactly. ``objective`` is the nominal cost either way.

    ``telemetry=True`` returns ``(solution, diag)``: the same solution,
    and the per-round nominal objective and largest step of each cluster
    (``obj_cluster_traj``, ``step_max_traj``, (..., outer_iters, n)) with
    ``solution_diagnostics`` at the final point. The rounds' deltas are
    kept (``dual_ascent``'s ``diag_fn``) and both trajectories evaluated
    once over the rounds axis: the values of a per-round evaluation, bit
    for bit (elementwise ops and ordered hour sums), in ~35 launches a
    solve instead of ~35 a round. A call is a ``solve_vcc`` span
    (``repro_torch.spans``)."""
    with spans.span("solve_vcc"):
        if p.eta_ens is not None and p.eta_ens.shape[-3] == 1:
            p = dataclasses.replace(p, eta_ens=None, pow_nom_ens=None)
        p = p.to(_device.resolve(device))
        lo, ub, feasible = delta_bounds(p)
        # neutralize infeasible clusters: bounds collapse to {0}
        lo = torch.where(feasible[..., None], lo, 0.0)
        ub = torch.where(feasible[..., None], ub, 0.0)
        delta0 = torch.zeros_like(p.eta)
        out = _descend(p, lo, ub, delta0, torch.zeros_like(p.campus_limit),
                       inner_iters, outer_iters, lr, temp_frac, rho,
                       diag_fn=_keep_delta if telemetry else None)
        sol = _solution(p, out[0], out[1], feasible)
        if not telemetry:
            return sol
        rounds = out[2]["delta"]                      # (..., T, n, H)
        prev = torch.cat([delta0.unsqueeze(-3), rounds[..., :-1, :, :]], -3)
        return sol, {"obj_cluster_traj": _round_objectives(p, rounds),
                     "step_max_traj": torch.abs(rounds - prev).amax(-1),
                     **solution_diagnostics(p, sol.delta, sol.mu,
                                            temp_frac=temp_frac)}


def _keep_delta(d_prev, d_new, mu_new):
    """``dual_ascent``'s per-round record: the round's delta."""
    return {"delta": d_new}


def _round_objectives(p: VCCProblem, rounds):
    """``cluster_objective`` of each round's delta, rounds (..., T, n, H)
    -> (..., T, n): the problem's fields take the rounds axis."""
    q = dataclasses.replace(
        p, eta=p.eta.unsqueeze(-3), pow_nom=p.pow_nom.unsqueeze(-3),
        pi=p.pi.unsqueeze(-3), tau=p.tau.unsqueeze(-2),
        lambda_e=p.lambda_e[..., None], lambda_p=p.lambda_p[..., None])
    return cluster_objective(q, rounds)


def _descend(p: VCCProblem, lo, ub, delta0, mu0, inner_iters, outer_iters,
             lr, temp_frac, rho, diag_fn=None):
    """``outer_iters`` dual-ascent rounds from (delta0, mu0), each one fused
    epoch of ``inner_iters`` PGD steps in the box [lo, ub]; with
    ``diag_fn``, its per-round records too (``solver.dual_ascent``)."""
    temp = solver.peak_temperature(p.pow_nom, temp_frac)
    lr_eff = solver.scaled_lr(lr, p.pi, p.tau, p.eta, p.lambda_e, p.lambda_p)

    def inner(delta, mu):
        return solver.pgd_epochs(p, delta, mu, lo, ub, lr_eff, temp,
                                 inner_iters)

    def dual_update(delta, mu):
        y = cluster_power(p, delta).amax(-1)
        return solver.campus_dual_update(mu, y, p.campus, p.campus_limit,
                                         rho)

    return solver.dual_ascent(inner, dual_update, delta0, mu0, outer_iters,
                              diag_fn=diag_fn)


def _solution(p: VCCProblem, delta, mu, feasible) -> VCCSolution:
    """The VCC of ``delta`` (machine capacity where infeasible)."""
    y = cluster_power(p, delta).amax(-1)
    vcc_shaped = (p.u_if + (1.0 + delta) * p.tau[..., None] / 24.0) * p.ratio
    cap = p.capacity[..., None]
    vcc = torch.where(feasible[..., None], torch.minimum(vcc_shaped, cap),
                      cap.expand_as(vcc_shaped))
    return VCCSolution(delta=delta, y=y, vcc=vcc, shaped=feasible, mu=mu,
                       objective=objective(p, delta, mu, risk=False))


def suffix_bounds(p: VCCProblem, delta_committed, hour: int):
    """Bounds of the suffix polytope at intra-day ``hour`` (0-24, the same
    for every rollout): elapsed hours (h < hour) are pinned at the realized
    deviations ``delta_committed`` (lo == ub), the remaining hours keep the
    day-ahead box. The exact projection onto {sum_h delta = 0} ∩ [lo, ub]
    then enforces the tightened conservation of the suffix. A cluster whose
    realized prefix can no longer be conserved (the box sums do not bracket
    zero) is pinned to ``delta_committed`` everywhere and keeps its plan.
    Returns (lo, ub, feasible)."""
    H = delta_committed.shape[-1]
    mask = torch.arange(H, device=delta_committed.device) >= hour
    lo, ub, feasible = delta_bounds(p)
    lo = torch.where(mask, lo, delta_committed)
    ub = torch.where(mask, ub, delta_committed)
    feasible = feasible & (hour_sum(lo) <= 1e-6) & (hour_sum(ub) >= -1e-6)
    lo = torch.where(feasible[..., None], lo, delta_committed)
    ub = torch.where(feasible[..., None], ub, delta_committed)
    return lo, ub, feasible


def solve_vcc_suffix(p: VCCProblem, delta0, mu0, hour: int, *,
                     inner_iters: int = 8, outer_iters: int = 2,
                     lr: float = 0.5, temp_frac: float = 0.02,
                     rho: float = 0.2, device=None) -> VCCSolution:
    """Warm-started intra-day re-solve of the remaining hours' VCC on
    ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain epochs).

    ``delta0`` (..., n, 24): the current plan with the elapsed columns
    (h < hour) replaced by the realized deviations; ``mu0``: the campus
    duals carried from the solve before. The machinery is ``solve_vcc``'s
    (the fused epoch inside dual ascent) on the suffix box of
    ``suffix_bounds``, started from (delta0, mu0) and not from zeros, with
    infeasible rows pinned to ``delta0`` and not collapsed to {0}; the
    default schedule is 2 rounds x 8 steps against the day solve's
    20 x 80."""
    dev = _device.resolve(device)
    p, delta0, mu0 = p.to(dev), delta0.to(dev), mu0.to(dev)
    lo, ub, feasible = suffix_bounds(p, delta0, hour)
    delta, mu = _descend(p, lo, ub, delta0, mu0, inner_iters, outer_iters,
                         lr, temp_frac, rho)
    return _solution(p, delta, mu, feasible)


def synthetic_problem(n: int = 12, seed: int = 7, n_campuses: int = 2,
                      device=None) -> VCCProblem:
    """``repro.core.vcc.synthetic_problem``, drawn from the same random
    stream: a diurnal intensity curve + noisy inflexible load, uncontended
    campus limits, drop_limit=1.0."""
    dev = _device.resolve(device)
    ks = prng.split(prng.PRNGKey(seed, dev), 4)
    H = 24
    eta = torch.abs(0.3 + 0.25 * torch.sin(
        torch.linspace(0, 2 * np.pi, H, device=dev))[None]
        + 0.05 * prng.normal(ks[0], (n, H)))
    u_if = 0.4 + 0.05 * prng.normal(ks[1], (n, H))
    tau = 2.0 + 3.0 * prng.uniform(ks[2], (n,))
    pow_nom = 500.0 + 20.0 * prng.normal(ks[3], (n, H))

    def full(shape, v):
        return torch.full(shape, v, dtype=f32, device=dev)

    return VCCProblem(
        eta=eta, u_if=u_if, u_if_q=u_if * 1.1, tau=tau, pow_nom=pow_nom,
        pi=full((n, H), 300.0), u_pow_cap=full((n,), 0.95),
        capacity=full((n,), 1.3), ratio=full((n, H), 1.3),
        campus=torch.arange(n, device=dev) % n_campuses,
        campus_limit=full((n_campuses,), 1e9),
        lambda_e=torch.tensor(0.1, device=dev),
        lambda_p=torch.tensor(0.05, device=dev), drop_limit=1.0)


def solve_vcc_batched(p: VCCProblem, **kw):
    """``solve_vcc`` over a stacked problem (a leading rollout axis): the
    reference's ``vmap``; ``solve_vcc`` takes the batch as it is."""
    return solve_vcc(p, **kw)


def synthetic_zonal_problem(n: int = 12, seed: int = 3, n_campuses: int = 2,
                            device=None) -> VCCProblem:
    """``synthetic_problem`` with a strong spatial carbon gradient
    (alternating dirty and clean clusters) and machine capacity cut to
    0.85, so temporal shaping saturates in the dirty clusters and moving
    budget between clusters pays: the joint tests' problem."""
    p = synthetic_problem(n, seed=seed, n_campuses=n_campuses, device=device)
    dev = p.eta.device
    scale = torch.where(torch.arange(n, device=dev) % 2 == 0, 2.2, 0.5)
    return dataclasses.replace(p, eta=p.eta * scale[:, None],
                               capacity=p.capacity * 0.85)


def greedy_linear_reference(eta_pi, lo, ub):
    """Exact minimizer of sum_h c_h delta_h over {sum delta = 0} ∩ [lo, ub]
    for ONE cluster, in float64 numpy: the independent oracle for the PGD
    solve and ``solver.minimize_linear``. Start at lo and fill the cheapest
    hours first until the budget -sum(lo) is spent."""
    c = np.asarray(eta_pi, dtype=np.float64)
    lo = np.asarray(lo, np.float64).copy()
    ub = np.asarray(ub, np.float64).copy()
    delta = lo.copy()
    budget = -delta.sum()
    for h in np.argsort(c):
        add = min(ub[h] - delta[h], budget)
        delta[h] += add
        budget -= add
        if budget <= 1e-12:
            break
    return delta
