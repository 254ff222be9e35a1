"""A whole run of the harness on the CPU at a smoke fleet, the chip's
look skipped: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have: a day step that hands its state on unchanged, half of the batch's
fleets left out (not advanced), and the planner's answer altered where it
is produced (the first fleet's VCCs halved). One chip, so no
exchange between chips to leave out."""
import time

import pytest
import torch

from cics_bench import harness, spec


def _cell():
    cell = spec.Cell("cics-paper.sweep880")
    cell.config["sim"].update(n_clusters=8, n_campuses=2, n_zones=4,
                              hist_days=28)
    picked = [s for s in cell.traffic["scenarios"]
              if s["name"] in ("demand_surge", "perfect_storm")]
    cell.traffic = dict(cell.traffic, seeds_per_scenario=1, scenarios=picked)
    cell.workload["rollout_days"] = 1
    return cell


def _unchanged(real):
    def make(cfg):
        step = real(cfg)

        def broken(params, state, xs):
            return state, step(params, state, xs)[1]
        return broken
    return make


def _half_left_out(real):
    def make(cfg):
        step = real(cfg)

        def broken(params, state, xs):
            new, out = step(params, state, xs)
            B = state.day.shape[0]
            keep = torch.arange(B) < B // 2

            def pick(a, b):
                if not isinstance(a, torch.Tensor) or a.dim() == 0:
                    return a
                return torch.where(keep.reshape((B,) + (1,) * (a.dim() - 1)),
                                   a, b)
            return type(new)(*(pick(a, b) for a, b in zip(new, state))), out
        return broken
    return make


def _answer_altered(real):
    def optimize(*args, **kwargs):
        prob, sol, *rest = real(*args, **kwargs)
        vcc = sol.vcc.clone()
        vcc[0] *= 0.5
        sol.vcc = vcc
        return (prob, sol, *rest)
    return optimize


FAULTS = {
    "sound": None,
    "state_unchanged": ("repro_torch.sim.engine", "make_day_step",
                        _unchanged),
    "half_batch_left_out": ("repro_torch.sim.engine", "make_day_step",
                            _half_left_out),
    "answer_altered": ("repro_torch.core.stages", "optimize_stage",
                       _answer_altered),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    import importlib
    torch.set_num_threads(1)
    if FAULTS[fault] is not None:
        mod, name, breaker = FAULTS[fault]
        m = importlib.import_module(mod)
        monkeypatch.setattr(m, name, breaker(getattr(m, name)))
    result = harness.run(_cell(), 2147483659, 0.01, False,
                         time.perf_counter(), device="cpu")
    print(fault, result["check"])
    assert result["correct"] == (fault == "sound"), result["_lines"]
    assert list(result)[-2:] == ["check", "_lines"]
