"""Spatial flexibility: day-ahead shifting of flexible budgets across
clusters (the paper's planned next step, §V). Port of ``repro.core.spatial``.

* ``spatial_shift`` — the greedy pre-shift: the budget shift s is the exact
  linear minimizer of the carbon price over {sum_c s = 0} ∩ [lo, ub]
  (``solver.minimize_linear``), and the temporal VCC solve runs on the
  shifted budgets.
* ``solve_joint`` — the joint spatio-temporal solve: delta (..., n, H) and
  s (..., n) descend together, the temporal bounds recomputed from tau + s
  inside every fused step (the joint-step kernel), warm-started from the
  greedy answer and never worse than it (a best-of safeguard per rollout).

Each rollout is one row of n clusters. A cluster may export at most
``mobility * tau_c`` and import at most ``min(mobility * tau_c,
headroom_c)``; mobility 0 pins s to 0.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch import device as _device
from repro_torch import spans
from repro_torch.core import solver, vcc
from repro_torch.core.vcc import VCCProblem, VCCSolution

f32 = torch.float32


def carbon_price(p: VCCProblem) -> torch.Tensor:
    """(..., n) marginal kgCO2e of one CPU-day at each cluster:
    mean_h eta * pi."""
    return (p.eta * p.pi).mean(-1)


def shift_bounds(p: VCCProblem, mobility) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Per-cluster (lo, ub) of the daily shift (negative = export).
    ``mobility``: per-rollout, shape (...)."""
    mob = torch.as_tensor(mobility, dtype=torch.float32,
                          device=p.tau.device)[..., None]
    room_h = torch.clamp(p.capacity[..., None] / p.ratio - p.u_if, min=0.0)
    headroom = torch.clamp(room_h.sum(-1) - p.tau, min=0.0)
    return -mob * p.tau, torch.minimum(mob * p.tau, headroom)


def spatial_shift(p: VCCProblem, *, mobility=0.3):
    """Greedy pre-shift: returns (tau_shifted (..., n), carbon_price). A
    call is a ``shift`` span (``repro_torch.spans``)."""
    with spans.span("shift"):
        price = carbon_price(p)
        lo, ub = shift_bounds(p, mobility)
        shift = solver.minimize_linear(price, lo, ub)
        return torch.clamp(p.tau + shift, min=0.0), price


def spatial_shift_batched(p: VCCProblem, *, mobility=0.3):
    """``spatial_shift`` over a stacked problem (a leading rollout axis),
    ``mobility`` a scalar or one per rollout ((B,)): the reference's
    ``vmap``; ``spatial_shift`` takes the batch as it is."""
    return spatial_shift(p, mobility=torch.as_tensor(
        mobility, dtype=f32, device=p.tau.device))


# ------------------------------------------------- joint spatio-temporal

def joint_power(p: VCCProblem, delta, s):
    """Hourly power under (delta, s): the linearization around the original
    nominal point, with the baseline term pi * s / 24 of moving the flat
    daily budget itself."""
    return p.pow_nom + p.pi * (delta * (p.tau + s)[..., None]
                               + s[..., None]) / 24.0


def joint_carbon(p: VCCProblem, delta, s):
    """Model-consistent expected carbon (kg) of the joint point: (...)."""
    return (p.eta * joint_power(p, delta, s)).sum(dim=(-2, -1))


def joint_objective(p: VCCProblem, delta, s, mu=None):
    """Nominal day cost of (delta, s): carbon price + hard hourly peak.
    ``mu=None`` evaluates the primal objective (lambda_p only), the scale
    both best-of candidates are compared on."""
    y = joint_power(p, delta, s).amax(-1)
    price = p.lambda_p[..., None] if mu is None \
        else p.lambda_p[..., None] + torch.gather(mu, -1, p.campus)
    return p.lambda_e * joint_carbon(p, delta, s) + (price * y).sum(-1)


class BestOf(NamedTuple):
    """The best-of safeguard's call, per rollout (the reference reports
    ``take`` as ``joint_winner`` in its telemetry)."""
    take: torch.Tensor    # (...) bool: the joint point was kept
    # (...) the smaller of the joint point's relative gains in objective and
    # in carbon over the warm start, >= 0 where kept: how close the call
    # was (-inf where no joint point was formed)
    margin: torch.Tensor


def solve_joint(p: VCCProblem, mobility, *, inner_iters: int = 80,
                outer_iters: int = 20, joint_inner: int = 25,
                joint_outer: int = 8, lr: float = 0.5, lr_s: float = 0.15,
                temp_frac: float = 0.02, rho: float = 0.2, device=None,
                telemetry: bool = False):
    """Joint spatio-temporal VCC optimization on ``device`` (default
    ``"cuda"``). Returns (solution, tau_joint (..., n), s (..., n),
    ``BestOf``); the solution's deviations and curves are those of the
    shifted budgets tau_joint = clip(tau + s, 0). ``telemetry=True``
    appends the solver diagnostics: the warm start's trajectories,
    ``vcc.solution_diagnostics`` at the final point, and ``joint_winner``
    (...) float32, 1.0 where the joint point was kept (0.0 on the
    mobility-0 shortcut, where no joint point is formed).

    1. A Python-number ``mobility == 0`` is the temporal solve alone.
       A tensor ``mobility`` (one per rollout) always runs the joint path;
       rollouts at 0 keep s = 0 through their bounds.
    2. Warm start: greedy ``spatial_shift`` + ``solve_vcc`` at the shifted
       budgets.
    3. Joint refinement: ``joint_outer`` dual-ascent rounds, each
       ``joint_inner`` fused joint steps (``solver.joint_epochs``).
    4. Best-of safeguard, per rollout: the joint point is kept only if it
       weakly improves both the nominal objective and its carbon term over
       the warm start, both evaluated model-consistently
       (``joint_objective`` / ``joint_carbon``).

    A call is a ``solve_joint`` span (``repro_torch.spans``)."""
    with spans.span("solve_joint"):
        dev = _device.resolve(device)
        p = p.to(dev)
        if not isinstance(mobility, torch.Tensor) and float(mobility) == 0.0:
            sol = vcc.solve_vcc(p, inner_iters=inner_iters,
                                outer_iters=outer_iters, lr=lr,
                                temp_frac=temp_frac, rho=rho, device=dev,
                                telemetry=telemetry)
            best = BestOf(torch.zeros_like(p.lambda_e, dtype=torch.bool),
                          torch.full_like(p.lambda_e, -torch.inf))
            if telemetry:
                sol, diag = sol
                diag["joint_winner"] = torch.zeros_like(p.lambda_e)
                return sol, p.tau, torch.zeros_like(p.tau), best, diag
            return sol, p.tau, torch.zeros_like(p.tau), best

        mob = torch.as_tensor(mobility, dtype=f32, device=dev)
        # 2. sequential two-phase warm start
        tau_sh, _ = spatial_shift(p, mobility=mob)
        sol_seq = vcc.solve_vcc(dataclasses.replace(p, tau=tau_sh),
                                inner_iters=inner_iters,
                                outer_iters=outer_iters, lr=lr,
                                temp_frac=temp_frac, rho=rho, device=dev,
                                telemetry=telemetry)
        if telemetry:
            sol_seq, diag_seq = sol_seq
        lo_s, ub_s = shift_bounds(p, mob)
        s0 = torch.clamp(tau_sh - p.tau, lo_s, ub_s)

        # 3. joint refinement from (delta_seq, s0)
        temp = solver.peak_temperature(p.pow_nom, temp_frac)
        lr_d = solver.scaled_lr(lr, p.pi, p.tau, p.eta, p.lambda_e, p.lambda_p)
        # shift-gradient scale: g_s ~ lambda_e * mean_h(eta pi) + price pi / 24
        g_norm = torch.clamp((p.lambda_e[..., None] * (p.eta * p.pi).mean(-1)
                              + p.lambda_p[..., None] * p.pi.mean(-1) / 24.0
                              ).amax(-1), min=1e-9)
        lr_s_eff = lr_s * torch.clamp(p.tau.mean(-1), min=1e-6) / g_norm

        def inner(x, mu):
            d, s = x
            return solver.joint_epochs(p, d, s, mu, lo_s, ub_s, lr_d, lr_s_eff,
                                       temp, joint_inner)

        def dual_update(x, mu):
            d, s = x
            y = joint_power(p, d, s).amax(-1)
            return solver.campus_dual_update(mu, y, p.campus, p.campus_limit,
                                             rho)

        (d_j, s_j), mu_j = solver.dual_ascent(inner, dual_update,
                                              (sol_seq.delta, s0), sol_seq.mu,
                                              joint_outer)

        # 4. best-of safeguard, per rollout
        obj_j, obj_q = joint_objective(p, d_j, s_j), \
            joint_objective(p, sol_seq.delta, s0)
        co2_j, co2_q = joint_carbon(p, d_j, s_j), \
            joint_carbon(p, sol_seq.delta, s0)
        take = (obj_j <= obj_q) & (co2_j <= co2_q)
        margin = torch.minimum((obj_q - obj_j) / obj_q.abs(),
                               (co2_q - co2_j) / co2_q.abs())
        delta = torch.where(take[..., None, None], d_j, sol_seq.delta)
        s = torch.where(take[..., None], s_j, s0)
        mu = torch.where(take[..., None], mu_j, sol_seq.mu)

        tau_j = torch.clamp(p.tau + s, min=0.0)
        pf = dataclasses.replace(p, tau=tau_j)
        _, _, feasible = vcc.delta_bounds(pf)
        delta = torch.where(feasible[..., None], delta, 0.0)
        y = joint_power(p, delta, s).amax(-1)
        vcc_shaped = (pf.u_if + (1.0 + delta) * tau_j[..., None] / 24.0) \
            * pf.ratio
        cap = pf.capacity[..., None]
        vcc_curve = torch.where(feasible[..., None],
                                torch.minimum(vcc_shaped, cap),
                                cap.expand_as(vcc_shaped))
        sol = VCCSolution(delta=delta, y=y, vcc=vcc_curve, shaped=feasible,
                          mu=mu, objective=joint_objective(p, delta, s, mu))
        if telemetry:
            diag = {"obj_cluster_traj": diag_seq["obj_cluster_traj"],
                    "step_max_traj": diag_seq["step_max_traj"],
                    **vcc.solution_diagnostics(pf, delta, mu,
                                               temp_frac=temp_frac),
                    "joint_winner": take.to(f32)}
            return sol, tau_j, s, BestOf(take, margin), diag
        return sol, tau_j, s, BestOf(take, margin)


def solve_joint_batched(p: VCCProblem, mobility, **kw):
    """``solve_joint`` over a stacked problem (a leading rollout axis),
    ``mobility`` a scalar or (B,): the reference's ``vmap``. The mobility
    is always a tensor here, as it is always traced there, so every rollout
    takes the joint path (rollouts at 0 keep s = 0 through their bounds).
    Returns what ``solve_joint`` returns."""
    mob = torch.as_tensor(mobility, dtype=f32).expand(p.tau.shape[:-1])
    return solve_joint(p, mob, **kw)
