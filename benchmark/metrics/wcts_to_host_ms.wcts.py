"""Milliseconds a WCTS decode job spends copying kernel K's outputs (the
per-frame books, backpointers and predecessors, the statistics and the
transparent silence's tables) to the host: the program's ``wcts.to_host``
span in the traced window, less the garbage collections inside it, a job.
The first copy also waits for K to finish."""

from benchmark.harness.spans import span_seconds


def read(run):
    s = span_seconds(run, "wcts.to_host", minus=("host.gc",))
    return None if s is None else 1e3 * s
