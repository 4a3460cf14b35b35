"""The WCTS decode step's share of the card's peak: every hand kernel's
counted operations (kernels O and K) over its peak, summed, over the traced
window's seconds."""

from benchmark.harness.readers import step_mfu


def read(run):
    return step_mfu(run)
