"""The 95th percentile (linear interpolation) of the milliseconds a job took,
from its features on the host to its words on the host, over every job of
the window."""

import numpy as np


def read(run):
    if not run.steps:
        return None
    return float(np.percentile([s["seconds"] * 1e3 for s in run.steps], 95))
