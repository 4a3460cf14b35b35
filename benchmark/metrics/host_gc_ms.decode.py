"""Milliseconds a decode job spends in Python's garbage collections: the
program's ``host.gc`` spans (one a collection) in the traced window, a job."""

from benchmark.harness.spans import span_seconds


def read(run):
    s = span_seconds(run, "host.gc")
    return None if s is None else 1e3 * s
