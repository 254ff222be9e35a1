"""Seconds from the process's start to the measured window's start:
imports, the fleets' generation, the burn-in and the warm-up (the first
run in a checkout also builds the kernels)."""


def read(run):
    return run.spans.get("setup")
