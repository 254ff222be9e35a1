"""Kernel #3 (joint_step, both routes): its share of its roofline over the
traced window, percent: the summed bound of its launches
(``costs/joint_step.py``, at the halvings the reference counted) over its
summed device time in the trace."""
from cics_bench.costs import joint_step as COST
from cics_bench.costs import roofline


def read(run):
    return roofline.share(run, COST)
