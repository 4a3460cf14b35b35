"""What the per-layer metric readers share: a kernel's share of its roofline
and the step's share of the card's peak, from the trace of a ``--trace 1``
run and the roofline files' counts of the work the window asked for."""

from __future__ import annotations

from typing import Optional

#: NVIDIA's H100 SXM data sheet (dense rates, full 700 W power limit): HBM3
#: bandwidth and the peaks by kind of operation (an FMA counted as two)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "fp64": 34e12, "int8": 1979e12}


def _counted(run, kernel: str):
    """(roofline file, (operations, bytes)) of ``kernel`` where the trace
    holds its launches and the work has its shapes, else None."""
    rf = run.rooflines.get(kernel)
    if rf is None or run.trace is None or run.trace.kernel_count(rf.NAMES) == 0:
        return None
    counts = rf.count(run.work)
    return None if counts is None else (rf, counts)


def roofline_share(run, kernel: str) -> Optional[float]:
    """The least time the card could take for the kernel's counted work (the
    larger of operations over the peak and bytes over the bandwidth), as a
    percentage of the kernel's device time in the window."""
    got = _counted(run, kernel)
    if got is None:
        return None
    rf, (ops, nbytes) = got
    seconds = run.trace.kernel_seconds(rf.NAMES)
    if seconds <= 0:
        return None
    return 100.0 * max(ops / PEAK_OPS_S[rf.PEAK], nbytes / HBM_BYTES_S) / seconds


def step_mfu(run) -> Optional[float]:
    """The counted operations of every hand kernel the window ran, each over
    its peak, as a percentage of the window's seconds."""
    total, seen = 0.0, False
    for kernel in run.rooflines:
        got = _counted(run, kernel)
        if got is not None:
            rf, (ops, _b) = got
            total += ops / PEAK_OPS_S[rf.PEAK]
            seen = True
    if not seen or run.trace.window_s <= 0:
        return None
    return 100.0 * total / run.trace.window_s


def device_idle(run) -> Optional[float]:
    """The window's share, in percent, in which no operation ran on the card."""
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
