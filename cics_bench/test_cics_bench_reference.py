"""The frozen reference and traffic against the program's rollout, on the
CPU at a smoke fleet: the program's recorded days rebuild its states, the
reference follows them inside the cells' limits, the generator draws the
program's fleets, and the control (the reference stored in bfloat16 in
the program's place) fails the limits."""
import torch

from cics_bench import check, harness, spec
from cics_bench.reference import day as rday
from cics_bench.traffic import generator

SEED = 3000000019


def _smoke(cell_name, scenarios, days):
    cell = spec.Cell(cell_name)
    cell.config["sim"].update(n_clusters=8, n_campuses=2, n_zones=4,
                              hist_days=28)
    picked = [s for s in cell.traffic["scenarios"] if s["name"] in scenarios]
    cell.traffic = dict(cell.traffic, seeds_per_scenario=1, scenarios=picked)
    cell.workload["rollout_days"] = days
    return cell


def _fields(cell):
    dims = {k: cell.sim[k] for k in ("n_clusters", "n_campuses", "n_zones",
                                     "pds_per_cluster")}
    return generator.build_batch(cell.traffic, dims, SEED, "cpu")


def _program(cell, fields, states=None):
    """The program's rollout with each day recorded as the harness records
    it (and, with ``states``, each day's whole state kept)."""
    from repro_torch.core import stages
    from repro_torch.sim import engine
    cfg = engine.SimConfig(**cell.sim)
    params = stages.SimParams(**fields)
    steps = []

    def on_day(d, st, out):
        if d >= 0:
            steps.append(harness.program_record(st, out))
            if states is not None:
                states.append(check.state_fields(st))
    state = engine.make_init(cfg, device="cpu")(params)
    out = engine.make_rollout(cfg, cell.days, on_day=on_day)(params, state)
    return {"start": check.state_fields(state), "steps": steps,
            "final": check.state_fields(out[0]),
            "ledger": check.ledger_fields(out[1])}


def test_recorded_days_rebuild_the_programs_states():
    torch.set_num_threads(1)
    cell = _smoke("cics-paper.sweep880", ("baseline", "demand_surge"), 3)
    states = []
    prog = _program(cell, _fields(cell), states)
    for d, st in enumerate(states):
        rebuilt = check.state_at(prog["start"], prog["steps"], d + 1)
        assert set(rebuilt) == set(st)
        for k in st:
            assert torch.equal(rebuilt[k], st[k]), (d, k)


def test_reference_follows_the_programs_risk_joint_rollout():
    # the paper-mode day is held through the whole harness, in
    # test_cics_bench_faults.py
    torch.set_num_threads(1)
    cell_name = "cics-risk-joint.sweep560"
    cell = _smoke(cell_name, ("mobility030", "risk_beta50"), 2)
    fields = _fields(cell)
    every = list(range(len(fields["lambda_e"])))
    judged = harness.judge_rollout(cell, fields, every,
                                   _program(cell, fields))
    nums = judged["numbers"]
    print(cell_name, nums, judged["detail"])
    correct, lines = check.judge(nums, cell.limits)
    assert correct, lines
    assert nums["start"] < 1e-6      # the same burn-in to a rounding
    assert nums["handoff"] == 0.0


def test_generator_matches_the_programs_scenario_engine():
    from repro_torch.sim import engine, scenarios
    cell = _smoke("cics-paper.sweep880", ("cluster_outage", "peak_shaver"),
                  1)
    cfg = engine.SimConfig(**cell.sim)
    ours = _fields(cell)
    seeds = generator.fleet_seeds(SEED, 1)
    lib = {s.name: s for s in scenarios.default_library(7)}
    theirs = scenarios.build_batch(
        cfg, [lib["cluster_outage"], lib["peak_shaver"]], seeds, 7,
        device="cpu")
    for k in ("key", "pd_idle", "lam", "cap_scale", "lambda_e", "lambda_p",
              "campus_scale"):
        assert torch.equal(ours[k], getattr(theirs, k)), k
    for k in theirs.truth:
        assert torch.equal(ours["truth"][k], theirs.truth[k]), k


def test_the_control_fails_the_limits():
    torch.set_num_threads(1)
    cell = _smoke("cics-paper.sweep880", ("cluster_outage", "perfect_storm"),
                  1)
    fields = _fields(cell)
    every = list(range(len(fields["lambda_e"])))
    low = harness.reference_program(cell, fields, every,
                                    lower=rday.lower_to(torch.bfloat16))
    judged = harness.judge_rollout(cell, fields, every, low)
    print(judged)
    correct, lines = check.judge(judged["numbers"], cell.limits)
    assert not correct, lines
