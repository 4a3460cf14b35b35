"""Kernel C's share of its roofline in the training window: the least time
its counted work needs on the card (benchmark/roofline/C.py) over its
device time in the trace."""

from benchmark.harness.readers import roofline_share


def read(run):
    return roofline_share(run, "C")
