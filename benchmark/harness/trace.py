"""The device trace of a ``--trace 1`` run: ``torch.profiler`` around the
window, reduced to the device's operations inside it (kernels, copies and
sets, each an interval on the device's clock), the seconds the device was
busy (the union of those intervals), the operations that took most time,
and the longest idle gaps named by the innermost host span around them."""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Tuple

from .core import WINDOW_SPAN

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window: Tuple[float, float]          # µs on the trace's clock
    device_ops: List[Tuple[str, float, float]]   # (name, start µs, end µs)
    host_spans: List[Tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        total, end = 0.0, -1.0
        for _n, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total * 1e-6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the operations whose name holds any of ``names``."""
        return sum(b - a for n, a, b in self.device_ops if any(k in n for k in names)) * 1e-6

    def kernel_count(self, names) -> int:
        return sum(any(k in n for k in names) for n, _a, _b in self.device_ops)

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, a, b in self.device_ops:
            by[n] = by.get(n, 0.0) + (b - a) * 1e-6
        return [[n[:120], s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The ``k`` longest stretches with no device operation inside the
        window, each named by the shortest host span that covers its middle."""
        gaps, end = [], self.window[0]
        for _n, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:k]:
            mid = (a + b) / 2
            cover = [(e - s, n) for n, s, e in self.host_spans if s <= mid <= e]
            out.append([min(cover)[1][:120] if cover else "no host span", (b - a) * 1e-6])
        return out


def reduce_profile(prof) -> Trace:
    """The chrome trace of a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            ops.append((e["name"], a, b))
        elif e.get("cat") in ("user_annotation", "cpu_op", "python_function"):
            if e["name"] == WINDOW_SPAN and e.get("cat") == "user_annotation":
                window = (a, b)
            spans.append((e["name"], a, b))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    inside = [(n, max(a, window[0]), min(b, window[1])) for n, a, b in ops
              if b > window[0] and a < window[1]]
    return Trace(window, inside, spans)
