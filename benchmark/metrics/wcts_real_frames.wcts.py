"""The share of the frames that kernel K scans that are real, not padding:
the program's counters ``wcts.frames_real`` over ``wcts.frames_padded`` (a
job's utterances times its longest) in the traced window."""

from benchmark.harness.spans import counter_share


def read(run):
    return counter_share(run, "wcts.frames_real", "wcts.frames_padded")
