"""Seconds an EM iteration's realignment spends on the host around its
batches: the program's ``em.realign.index`` (each batch's frame index,
lengths and table rows) and ``em.realign.scatter`` (the states written into
the alignment) spans in the traced window, less the garbage collections
inside them, an iteration."""

from benchmark.harness.spans import span_seconds


def read(run):
    return span_seconds(run, "em.realign.index", "em.realign.scatter", minus=("host.gc",))
