"""The share of the frames that the realignment's scoring and scan get that
are real, not padding: the program's counters ``align.frames_real`` over
``align.frames_padded`` (a batch's utterances times its length bucket) in
the traced window."""

from benchmark.harness.spans import counter_share


def read(run):
    return counter_share(run, "align.frames_real", "align.frames_padded")
