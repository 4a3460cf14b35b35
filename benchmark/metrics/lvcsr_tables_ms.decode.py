"""Milliseconds a decode job spends building the linear search's tables on
the host: the program's ``lvcsr.tables`` span (``LinearTables.build``; the
copies to the card are ``lvcsr.tables_to_device``) in the traced window,
less its garbage collections, a job."""

from benchmark.harness.spans import span_seconds


def read(run):
    s = span_seconds(run, "lvcsr.tables", minus=("host.gc",))
    return None if s is None else 1e3 * s
