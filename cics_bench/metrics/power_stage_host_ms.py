"""Host milliseconds a planned day spends in the power stage
(``stages.power_stage``, the PD piecewise-linear fit): the program's
``power`` spans (``repro_torch.spans``) over one rollout of the cell's days
recorded without the profiler (``cics_bench/spans.py``), a day's mean."""
from cics_bench import spans


def measure(ctx):
    got = spans.read(ctx)
    return None if got is None else got["host_ms"].get("power")


def read(run):
    return run.measured.get("power_stage_host_ms")
