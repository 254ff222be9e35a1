"""What decides ``correct``: the program's timed rollout held against the
plain reference, day by day, on a sample of its fleets.

The sample is ``per_scenario`` fleets of each scenario, drawn from the
run's seed. While the window runs, the program's rollout hook
(``make_rollout``'s ``on_day``) keeps each day's ``record`` of the sampled
fleets: the newest day of every history window, the state's small leaves,
the problem solved, the solver's shaped flags and the joint call, the
post-gate VCC, the day's power, carbon, arrivals and unmet work. The last
rollout's records are judged.

The days are chaotic: a cluster's hourly usage that two sound float32
computations give 5e-6 apart on the first day lies 3e-3 apart on the
second and up to 0.15 apart by the sixth. So the reference follows the
program step by step: it plans day ``d`` from the program's own state
before that day (``state_at``: the burned-in state, its windows shifted by
``d`` days, the program's newest days appended). A fleet-day whose shaped
flags or joint call (the best-of) differ is split: those calls are
discrete, rounding turns a few, and the fleet's day differs wholesale.
The solvers' own iterations amplify rounding too: a few fleet-days a run
lie 1e-3 to 0.15 apart from problems that agree bit for bit, so the
outputs are judged by their 95th percentile over the fleet-days.

Each number is the worst over the sampled fleets; a gap is |program -
reference| over that quantity's largest |reference| in the fleet (a
backlog held at a thousandth of the fleet's largest arrivals):

* ``start``: the burned-in state against the reference's own burn-in
  from the same parameters;
* ``handoff``: the program's state after the last day against
  ``state_at`` of that day, exactly: the records are the days the state
  carries on;
* ``problem``: the problem solved, the largest over fleet-days not split
  (in a joint solve it holds the solver's shifted budgets);
* ``step_p95``: each fleet-day's largest gap over its record's
  quantities, the 95th percentile over the fleet-days not split;
* ``ledger_p95``: each fleet's ledger against the reference's summed from
  its steps, the 95th percentile over the fleets never split;
* ``split_days``: the share of fleet-days split;
* ``gate_flips``: the share of cluster-days whose shaped flag, SLO gate or
  counters after the step differ;
* ``step_max`` and ``gate_edge``, shown beside them: the largest of the
  fleet-day gaps, and how far the reference's SLO test lay from its
  threshold (``slo.ratios``) where a gate or counter differs on a
  fleet-day not split: a flip that rounding explains lies at it.

A cell compares the numbers its workload file gives a limit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

START_KEYS = ("hist_uif", "hist_flex_daily", "hist_res_daily", "hist_usage",
              "hist_res", "hist_tr_pred", "hist_uif_pred", "carbon_hist",
              "campus_limit", "u_pow_cap", "queue", "cf_queue")
WINDOWS = ("hist_uif", "hist_flex_daily", "hist_res_daily", "hist_usage",
           "hist_res", "hist_tr_pred", "hist_uif_pred", "carbon_hist")
LEAVES = ("day", "queue", "cf_queue", "crowded_streak", "pause_left",
          "violation_days", "observed_days", "shaping_allowed")
CROWDING = ("crowded_streak", "pause_left", "shaping_allowed")
COUNTED = ("violation_days", "observed_days")
OUTPUTS = ("vcc", "power", "carbon", "cf_power", "cf_carbon", "arrived",
           "unmet", "cf_served")
PROBLEM = ("eta", "u_if", "u_if_q", "tau", "pow_nom", "pi", "ratio",
           "u_pow_cap", "capacity", "campus_limit", "eta_ens", "pow_nom_ens")
COMPARED = WINDOWS + ("queue", "cf_queue") + OUTPUTS
BACKLOG = {"queue", "cf_queue", "unmet", "delayed_cpu_h", "cf_delayed_cpu_h"}
NUMBERS = ("start", "handoff", "problem", "step_p95", "ledger_p95",
           "split_days", "gate_flips", "step_max", "gate_edge")


def sample_fleets(n_scenarios: int, seeds_per_scenario: int, seed: int,
                  per_scenario: int = 1) -> List[int]:
    """``per_scenario`` batch indices a scenario (all of its fleets where
    it has fewer), the fleets drawn from the run's seed."""
    rng = np.random.default_rng([int(seed), 0xC1C5])
    per_scenario = min(per_scenario, seeds_per_scenario)
    return [i * seeds_per_scenario + int(j) for i in range(n_scenarios)
            for j in sorted(rng.choice(seeds_per_scenario, per_scenario,
                                       replace=False))]


def state_fields(state) -> Dict[str, torch.Tensor]:
    """The program's state (a NamedTuple) or the reference's (a dict) as a
    dict of its tensors."""
    if isinstance(state, dict):
        return dict(state)
    return {k: getattr(state, k) for k in state._fields
            if isinstance(getattr(state, k), torch.Tensor)}


def ledger_fields(led) -> Dict[str, torch.Tensor]:
    if isinstance(led, dict):
        return dict(led)
    return {k: getattr(led, k) for k in led._fields if k != "days"}


def pick(tree: Dict, index) -> Dict[str, torch.Tensor]:
    """The rows ``index`` (a tensor on the tensors' device) of each."""
    return {k: v.index_select(0, index) for k, v in tree.items()}


def host(tree: Dict) -> Dict[str, torch.Tensor]:
    """Every tensor as float64 on the CPU."""
    return {k: v.detach().cpu().double() for k, v in tree.items()}


def record(state, res, cf, vcc, shaped, prob, take=None
           ) -> Dict[str, torch.Tensor]:
    """One day's record of a rollout (see the module's docstring), from
    the state after the day, the day's shaped and counterfactual results,
    the problem solved and, in a joint solve, its call per rollout."""
    st = state_fields(state)
    out = {k: st[k][:, :, -1] for k in WINDOWS}
    out.update({k: st[k] for k in LEAVES})
    out.update(vcc=vcc, shaped=shaped, power=res.power, carbon=res.carbon,
               cf_power=cf.power, cf_carbon=cf.carbon, arrived=res.arrived,
               unmet=res.unmet, cf_served=cf.served)
    for k in PROBLEM:
        v = getattr(prob, k, None)
        if isinstance(v, torch.Tensor):     # members (B, K, n, H) by cluster
            out["prob." + k] = v.transpose(1, 2) if v.dim() == 4 else v
    if take is not None:
        out["take"] = take
    return out


def state_at(start: Dict, steps: List[Dict], d: int) -> Dict:
    """The state before day ``d`` from the burned-in state and the first
    ``d`` days' records."""
    st = dict(start)
    if d == 0:
        return st
    for k in WINDOWS:
        new = torch.stack([s[k] for s in steps[:d]], dim=2)
        st[k] = torch.cat([start[k][:, :, d:], new.to(start[k].dtype)],
                          dim=2)
    st.update({k: steps[d - 1][k].to(start[k].dtype) for k in LEAVES})
    return st


def follow(sim: Dict, params: Dict, start: Dict, steps: List[Dict],
           tally=None) -> List[Dict]:
    """The reference's step of each day from the rollout's own state
    before it: each day's record, with the SLO tests' ``crowded`` and
    ``violated`` ratios, on the host."""
    from cics_bench.reference import day as rday
    out = []
    for d in range(len(steps)):
        probe: Dict = {}
        new, res, cf = rday.day_step(sim, params, state_at(start, steps, d),
                                     rday.day_xs(params, d), tally,
                                     probe=probe)
        rec = record(new, res, cf, probe["vcc_curve"], probe["shaped"],
                     probe["prob"], probe.get("take"))
        rec.update(crowded=probe["crowded"], violated=probe["violated"])
        out.append(host(rec))
    return out


def _rel(p, r, floor=0.0):
    """|p - r| over the largest |r| of each fleet (row), that largest held
    at ``floor`` (B,) at least, so that a quantity that is near zero in
    every cluster (a backlog) is judged on the scale of the work."""
    dims = tuple(range(1, r.dim()))
    scale = r.abs().amax(dim=dims)
    scale = torch.maximum(scale, torch.as_tensor(floor, dtype=scale.dtype)
                          * torch.ones_like(scale)).clamp(min=1e-30)
    return (p - r).abs() / scale.reshape((-1,) + (1,) * len(dims))


def ledger(steps: List[Dict]) -> Dict[str, torch.Tensor]:
    """The ledger's per-cluster totals summed from day records, as the
    program's ``sim/ledger.py`` sums them."""
    acc: Dict[str, torch.Tensor] = {}

    def add(k, v, peak=False):
        acc[k] = v if k not in acc else (torch.maximum(acc[k], v) if peak
                                         else acc[k] + v)
    for s in steps:
        add("carbon_kg", s["carbon"].sum(-1))
        add("kwh", s["power"].sum(-1))
        add("peak_kw", s["power"].amax(-1), peak=True)
        add("served", s["hist_flex_daily"])
        add("arrived", s["arrived"])
        add("unmet", s["unmet"])
        add("delayed_cpu_h", s["queue"])
        add("cf_carbon_kg", s["cf_carbon"].sum(-1))
        add("cf_kwh", s["cf_power"].sum(-1))
        add("cf_peak_kw", s["cf_power"].amax(-1), peak=True)
        add("cf_served", s["cf_served"])
        add("cf_delayed_cpu_h", s["cf_queue"])
    return acc


def _fleet_max(g):
    return g.reshape(g.shape[0], -1).amax(1)


def _q95(values) -> float:
    """The 95th percentile (numpy's linear rule); nan where empty."""
    values = np.asarray(values, dtype=np.float64).ravel()
    return float(np.quantile(values, 0.95)) if values.size else float("nan")


def _max(values, empty: float = float("nan")) -> float:
    values = np.asarray(values, dtype=np.float64).ravel()
    return float(values.max()) if values.size else empty


def compare(prog: Dict, ref_start: Dict, followed: List[Dict],
            fleet_days: bool = False) -> Dict:
    """The numbers and where they come from. ``prog`` holds the rollout's
    ``start`` state, its day ``steps``, its ``final`` state and its
    ``ledger`` (rows of the sampled fleets); ``ref_start`` the reference's
    burn-in; ``followed`` the reference's steps from the rollout's states.
    All float64 on the host. With ``fleet_days`` the detail has each
    fleet-day's readings."""
    steps = prog["steps"]
    work = 1e-3 * torch.stack([f["arrived"].amax(1) for f in followed]
                              ).amax(0)
    start_work = 1e-3 * ref_start["hist_flex_daily"].abs().amax(dim=(1, 2))
    start = max(float(_rel(prog["start"][k], ref_start[k],
                           start_work if k in BACKLOG else 0.0).max())
                for k in START_KEYS)
    carried = state_at(prog["start"], steps, len(steps))
    handoff = max(float(_rel(prog["final"][k], carried[k]).max())
                  for k in carried)
    B = steps[0]["shaped"].shape[0]
    rows = {k: [] for k in ("split", "problem", "outputs", "flips", "edge")}
    worst = ("", -1, 0.0)
    for d, (p, r) in enumerate(zip(steps, followed)):
        shaped = p["shaped"] != r["shaped"]
        take = (p["take"] != r["take"]) if "take" in p and "take" in r \
            else torch.zeros(B, dtype=torch.bool)
        split = shaped.any(1) | take
        problem = torch.zeros(B, dtype=torch.float64)
        for k in p:
            if k.startswith("prob.") and k in r:
                problem = torch.maximum(problem, _fleet_max(_rel(p[k], r[k])))
        outputs = torch.zeros(B, dtype=torch.float64)
        for k in COMPARED:
            g = _fleet_max(_rel(p[k], r[k], work if k in BACKLOG else 0.0))
            outputs = torch.maximum(outputs, g)
            v = float(g.masked_fill(split, 0.0).max())
            if v > worst[2]:
                worst = (k, d, v)
        crowding = torch.zeros_like(shaped)
        for k in CROWDING:
            crowding |= p[k] != r[k]
        counted = torch.zeros_like(shaped)
        for k in COUNTED:
            counted |= p[k] != r[k]
        e = torch.where(crowding, r["crowded"].abs(), 0.0)
        e = torch.where(counted, torch.maximum(e, r["violated"].abs()), e)
        judged = (crowding | counted) & ~split[:, None]
        for k, v in (("split", split), ("problem", problem),
                     ("outputs", outputs),
                     ("flips", (shaped | crowding | counted).sum(1)),
                     ("edge", e.masked_fill(~judged, 0.0).amax(1))):
            rows[k].append(v.tolist())
    split = np.array(rows["split"], dtype=bool)
    whole = ~split.any(0)
    led = torch.zeros(B, dtype=torch.float64)
    for k, v in ledger(followed).items():
        led = torch.maximum(led, _fleet_max(_rel(
            prog["ledger"][k], v, len(steps) * work if k in BACKLOG else 0.0)))
    kept = lambda k: np.array(rows[k])[~split]      # noqa: E731
    nums = {"start": start, "handoff": handoff,
            "problem": _max(kept("problem")),
            "step_p95": _q95(kept("outputs")),
            "ledger_p95": _q95(led.numpy()[whole]),
            "split_days": float(split.mean()),
            "gate_flips": float(np.sum(rows["flips"]))
            / (len(steps) * steps[0]["shaped"].numel()),
            "step_max": _max(kept("outputs")),
            "gate_edge": _max(kept("edge"), 0.0)}
    detail = {"step_max_at": list(worst[:2]),
              "split_fleet_days": int(split.sum()),
              "fleet_days": int(split.size)}
    if fleet_days:
        detail.update(rows, ledger=led.tolist())
    return {"numbers": nums, "detail": detail}


def judge(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, lines): each number that has a limit beside it, after
    those that have none; a number that is not finite fails."""
    ok = True
    lines = [f"{k} {nums[k]:.6e} (not compared)" for k in NUMBERS
             if k not in limits]
    for k in NUMBERS:
        if k not in limits:
            continue
        v, lim = nums[k], float(limits[k])
        good = bool(np.isfinite(v)) and v <= lim
        ok = ok and good
        lines.append(f"{k} {v:.6e} limit {lim:.3e} "
                     f"{'ok' if good else 'OVER'}")
    return ok, lines
