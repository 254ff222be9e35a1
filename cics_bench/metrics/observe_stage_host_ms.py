"""Host milliseconds a planned day spends in the observe stage
(``stages.observe_stage``: the day's sampled load, shaped and counterfactual
admission; in the closed loop ``observe_stage_mpc``, with its hourly
re-solves): the program's ``observe`` spans (``repro_torch.spans``) over one
rollout of the cell's days recorded without the profiler
(``cics_bench/spans.py``), a day's mean."""
from cics_bench import spans


def measure(ctx):
    got = spans.read(ctx)
    return None if got is None else got["host_ms"].get("observe")


def read(run):
    return run.measured.get("observe_stage_host_ms")
