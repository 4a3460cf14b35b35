"""Kernel K's share of its roofline in the WCTS decode window: the least
time its counted work needs on the card (benchmark/roofline/K.py: the live
hypotheses and word ends of the window's real frames) over its device time
in the trace."""

from benchmark.harness.readers import roofline_share


def read(run):
    return roofline_share(run, "K")
