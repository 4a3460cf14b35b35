"""The share of the frames that the int8 scorer and the linear scan get that
are real, not padding: the program's counters ``lvcsr.frames_real`` over
``lvcsr.frames_padded`` (a job's utterances times its longest) in the traced
window."""

from benchmark.harness.spans import counter_share


def read(run):
    return counter_share(run, "lvcsr.frames_real", "lvcsr.frames_padded")
