"""Milliseconds a decode job spends turning the word ids into the Python
result lists: the program's ``lvcsr.results`` span in the traced window,
less the garbage collections inside it (``host_gc_ms.decode`` has those), a
job."""

from benchmark.harness.spans import span_seconds


def read(run):
    s = span_seconds(run, "lvcsr.results", minus=("host.gc",))
    return None if s is None else 1e3 * s
