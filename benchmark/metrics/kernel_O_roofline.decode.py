"""Kernel O's share of its roofline in the decode window: the least time
its counted work needs on the card (benchmark/roofline/O.py) over its
device time in the trace."""

from benchmark.harness.readers import roofline_share


def read(run):
    return roofline_share(run, "O")
