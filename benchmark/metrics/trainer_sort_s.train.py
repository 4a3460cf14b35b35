"""Seconds an EM iteration spends grouping the frames by aligned state on
the host: the program's ``em.sorted_blocks`` span in the traced window,
less the garbage collections inside it, an iteration."""

from benchmark.harness.spans import span_seconds


def read(run):
    return span_seconds(run, "em.sorted_blocks", minus=("host.gc",))
