"""Host milliseconds a planned day spends in the optimize stage
(``stages.optimize_stage``: the problem's assembly, the spatial shift and
the solvers): the program's ``optimize`` spans (``repro_torch.spans``) over
one rollout of the cell's days recorded without the profiler
(``cics_bench/spans.py``), a day's mean."""
from cics_bench import spans


def measure(ctx):
    got = spans.read(ctx)
    return None if got is None else got["host_ms"].get("optimize")


def read(run):
    return run.measured.get("optimize_stage_host_ms")
