"""The share of the traced WCTS decode window in which no operation ran on
the card."""

from benchmark.harness.readers import device_idle


def read(run):
    return device_idle(run)
