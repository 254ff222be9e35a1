"""The 90th percentile, over every day of the measured window, of the
milliseconds between consecutive end-of-day events (the first from the
window's start): the time to plan a day, stalls included."""
import statistics


def read(run):
    ends = run.window.get("ends_ms", []) if run.window else []
    steps = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    if len(steps) < 2:
        return None
    return statistics.quantiles(steps, n=10, method="inclusive")[8]
