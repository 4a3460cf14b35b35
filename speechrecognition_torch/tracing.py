"""Spans and counters of the port, on the device trace's clock.

Tracing is on exactly while a ``torch.profiler`` records: an operator's own
profile, or a benchmark's traced window. Then each ``span`` is a
``record_function`` range, a ``user_annotation`` in the exported trace on
the same clock as the device's operations, nested in its parent span, and
``count`` adds to an in-memory counter. Off, a span costs one flag check
(plus a host clock read where it feeds a dict of seconds) and a count one
flag check. Python's garbage collections show as ``host.gc`` spans while
tracing is on.
"""

from __future__ import annotations

import functools
import gc
import time
from typing import Dict, Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_counters: Dict[str, int] = {}


def enabled() -> bool:
    """Whether a ``torch.profiler`` is recording in this process."""
    return _profiler_enabled()


class span:
    """``with span(name):`` a named range of the trace while tracing is on.
    With ``into``, the range's host seconds are added to ``into[key]``
    whether tracing is on or not. ``@span(name)`` makes each call of the
    function such a range."""

    __slots__ = ("name", "into", "key", "_rf", "_t0")

    def __init__(self, name: str, into: Optional[dict] = None, key: Optional[str] = None):
        self.name, self.into, self.key = name, into, key
        self._rf = None

    def __enter__(self):
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.into is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.into is not None:
            self.into[self.key] += time.perf_counter() - self._t0
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name, into, key = self.name, self.into, self.key

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, into, key):
                return fn(*args, **kwargs)
        return spanned


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _profiler_enabled():
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    return dict(_counters)


def reset() -> None:
    """Clear the counters."""
    _counters.clear()


#: the ``record_function`` of the collection in progress, while tracing
_gc_open: list = []


def _on_gc(phase, _info, _on=_profiler_enabled, _open=_gc_open):
    """A ``host.gc`` span from a collection's start to its stop. The names
    it needs are bound as defaults, since collections also run while the
    interpreter shuts down."""
    if phase == "start":
        if _on():
            rf = torch.profiler.record_function("host.gc")
            rf.__enter__()
            _open.append(rf)
            count("host.gc_collections", 1)
    elif _open:
        _open.pop().__exit__(None, None, None)


gc.callbacks.append(_on_gc)
