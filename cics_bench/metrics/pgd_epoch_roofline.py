"""Kernel #1 (pgd_epoch): its share of its roofline over the traced
window, percent: the summed bound of its launches (``costs/pgd_epoch.py``,
at the halvings the reference counted) over its summed device time
in the trace."""
from cics_bench.costs import pgd_epoch as COST
from cics_bench.costs import roofline


def read(run):
    return roofline.share(run, COST)
