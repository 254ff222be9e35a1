"""Seconds of the program's burn-in (``make_init``: the history windows
filled with unshaped days, the campus contracts set), synchronised at both
ends: the largest part of ``setup_s``."""


def read(run):
    return run.spans.get("burn_in")
