"""Host milliseconds a planned day spends inside CUDA runtime calls
(kernel launches, copies, synchronising calls) in the traced window, the
window's closing synchronisation left out: a launch that waits for room
in the device's queue, or a call that waits for the device, shows here
and not as host work."""


def read(run):
    if run.trace is None or not run.days_traced or \
            run.trace.runtime_s is None:
        return None
    return 1e3 * run.trace.runtime_s / run.days_traced
