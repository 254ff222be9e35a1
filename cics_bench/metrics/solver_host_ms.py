"""Host milliseconds a planned day spends in the solvers: the program's
outermost ``solve_vcc``, ``solve_joint`` and ``suffix_solve`` spans
(``repro_torch.spans``; a ``solve_vcc`` inside ``solve_joint`` counts once),
over one rollout of the cell's days recorded without the profiler
(``cics_bench/spans.py``), a day's mean. In the open loop, part of the
optimize stage's time; in the closed loop the hourly ``suffix_solve``
re-solves lie inside the observe stage."""
from cics_bench import spans


def measure(ctx):
    got = spans.read(ctx)
    return None if got is None else got["solver_ms"]


def read(run):
    return run.measured.get("solver_host_ms")
