"""A kernel's share of its roofline over a traced window: the summed bound
of the launches the window made (each from its cost module and the
halvings the reference counted) over the summed device time of the
kernel's trace events."""
from __future__ import annotations

from cics_bench.costs import peaks


def share(run, cost):
    """Percent, or None where the window launched nothing of ``cost``'s
    kernel, its trace shows no device time, or no halvings were counted."""
    launches = run.launches.get(cost.NAME) or []
    device_s = run.trace.kernel_seconds(cost.KERNELS) if run.trace else 0.0
    if not launches or device_s <= 0.0 or run.tally is None:
        return None
    halv = [run.tally.mean(k) for k in cost.HALVINGS]
    if any(h is None for h in halv):
        return None
    names = ("halvings", "shift_halvings")[:len(halv)]
    kw = dict(zip(names, halv))
    bound = sum(peaks.bound_s(cost.flops(**s, **kw), cost.nbytes(**s))
                for s in launches)
    return 100.0 * bound / device_s
