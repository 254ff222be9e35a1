"""Host milliseconds a planned day spends in the carbon stage
(``stages.carbon_stage``: the zones' grid simulation and day-ahead intensity
forecast): the program's ``carbon`` spans (``repro_torch.spans``) over one
rollout of the cell's days recorded without the profiler
(``cics_bench/spans.py``), a day's mean."""
from cics_bench import spans


def measure(ctx):
    got = spans.read(ctx)
    return None if got is None else got["host_ms"].get("carbon")


def read(run):
    return run.measured.get("carbon_stage_host_ms")
