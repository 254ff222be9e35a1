"""Device kernels launched a planned day: the kernel events of the traced
window over the days it planned."""


def read(run):
    if run.trace is None or not run.days_traced or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.days_traced
