"""What the readers of the program's own spans and counters share. The port
names its layers' steps with ``record_function`` ranges while a profiler
records (``speechrecognition_torch/tracing.py``); a ``--trace 1`` run holds
them among the trace's host spans, and the port's counters of the window in
``tracing.counters()``. A program without them reads None."""

from __future__ import annotations

import sys
from bisect import bisect_right
from typing import Dict, Optional


def span_seconds(run, *names: str, minus: tuple = ()) -> Optional[float]:
    """Seconds a step of the host spans named ``names``, clipped to the
    window, less the time inside them of the spans named ``minus`` (which
    must not overlap one another, as ``host.gc`` spans do not); None where
    the trace holds no span of ``names``."""
    if run.trace is None or not run.steps:
        return None
    w0, w1 = run.trace.window
    cut = sorted((max(a, w0), min(b, w1)) for n, a, b in run.trace.host_spans
                 if n in minus and b > w0 and a < w1)
    ends = [b for _a, b in cut]
    total, seen = 0.0, False
    for n, a, b in run.trace.host_spans:
        if n in names and b > w0 and a < w1:
            a, b = max(a, w0), min(b, w1)
            total += b - a
            for ca, cb in cut[bisect_right(ends, a):]:
                if ca >= b:
                    break
                total -= min(b, cb) - max(a, ca)
            seen = True
    return total * 1e-6 / len(run.steps) if seen else None


def counters() -> Dict[str, int]:
    """The program's counters of the traced window ({} where the program
    has none)."""
    tracing = sys.modules.get("speechrecognition_torch.tracing")
    return tracing.counters() if tracing is not None else {}


def counter_share(run, part: str, whole: str) -> Optional[float]:
    """``part`` as a percentage of ``whole``, two of the program's counters;
    None outside a traced run or where ``whole`` was not counted."""
    c = counters()
    if run.trace is None or not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]
