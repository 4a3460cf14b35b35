"""Milliseconds a WCTS decode job spends in the host traceback
(``traceback_wcts``, a Python walk an utterance): the program's
``wcts.traceback`` span in the traced window, less the garbage collections
inside it, a job."""

from benchmark.harness.spans import span_seconds


def read(run):
    s = span_seconds(run, "wcts.traceback", minus=("host.gc",))
    return None if s is None else 1e3 * s
