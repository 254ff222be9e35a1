"""Device milliseconds a planned day spends on the power stage's work inside
the day: the union of the busy intervals of the device operations launched
inside the program's ``power`` spans (``repro_torch.spans``), over one
rollout of the cell's days under the profiler (``cics_bench/spans.py``), a
day's mean. None where the trace holds no device operation of the stage."""
from cics_bench import spans


def measure(ctx):
    got = spans.read(ctx)
    if got is None or "power" not in got["device"]:
        return None
    return got["device"]["power"]["busy_ms"]


def read(run):
    return run.measured.get("power_stage_device_ms")
