"""Host milliseconds a planned day spends in the day's own glue: the program's
``day`` spans (``repro_torch.spans``: the day step, its metrics and its
ledger update) less the part their child spans (the stages, ``ledger``)
cover: the key folds, the intensity gathers, the SLO gate, the metrics. One
rollout of the cell's days recorded without the profiler
(``cics_bench/spans.py``), a day's mean."""
from cics_bench import spans


def measure(ctx):
    got = spans.read(ctx)
    return None if got is None else got["self_ms"].get("day")


def read(run):
    return run.measured.get("day_self_host_ms")
