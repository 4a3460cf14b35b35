"""What every cell's run shares: finding the cell's files by the names in
``BENCHMARK.json``, timing set-up, the measured window, the device trace,
the check of the outputs, and the result line.

A cell names a configuration (its ``file`` in ``BENCHMARK.json``) and a
traffic mix (``benchmark/traffic/<traffic>.json``). The mix names the driver
(``benchmark/drivers/<driver>.py``) that sets the program up, runs one step
of the window and checks what the window produced against the
configuration's plain reference (``reference.py`` beside its file). Each
metric is a reader of its own (``benchmark/metrics/<name>.py``), each
kernel's operations and bytes a file of its own
(``benchmark/roofline/<kernel>.py``), and each cell's limits a file of its
own (``benchmark/limits/<workload>.json``). Nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
#: modules that may not be loaded in the process that prints a result,
#: compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "speechrecognition_tpu")
#: the host span around the measured window in a trace
WINDOW_SPAN = "bench.window"


def load_module(path: Path, name: Optional[str] = None):
    """Import the Python file at ``path`` (names with dots load by path)."""
    spec = importlib.util.spec_from_file_location(name or f"bench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    config_dir: Path
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def driver(self):
        return load_module(BENCH / "drivers" / f"{self.mix['driver']}.py")

    def reference(self):
        return load_module(self.config_dir / "reference.py", f"ref_{self.config_dir.name}")


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(root: Path, name: str) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _reports(m, name) and ("workloads" in m or m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]),
                config=json.loads((root / conf["file"]).read_text()),
                config_dir=(root / conf["file"]).parent,
                mix=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
                limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=layer)


class SetupClock:
    """Set-up time by part, from the process's start."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.parts: Dict[str, float] = {}

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t0


@dataclass
class Run:
    """What a metric reader reads: the window's steps, set-up, the trace and
    the work the driver counted."""

    cell: Cell
    setup_s: float
    steps: List[dict]
    window_s: float
    work: Dict = field(default_factory=dict)
    trace: Optional[object] = None
    rooflines: Dict = field(default_factory=dict)


def rooflines() -> Dict:
    """Every kernel's roofline file, by kernel name."""
    return {p.stem: load_module(p, f"roofline_{p.stem}")
            for p in sorted((BENCH / "roofline").glob("*.py"))}


def forbidden_modules() -> List[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def window(step, state, seconds: float, min_steps: int = 1) -> tuple:
    """Run ``step(state)`` until ``seconds`` have passed, ending at a step's
    boundary; each step returns its record (with ``audio_s``), to which its
    ``seconds`` are added. Returns (records, window seconds)."""
    import torch
    records = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        with torch.profiler.record_function("bench.step"):
            rec = step(state)
        rec["seconds"] = time.perf_counter() - ts
        records.append(rec)
        if time.perf_counter() - t0 >= seconds and len(records) >= min_steps:
            break
    return records, time.perf_counter() - t0


def compare(checks: Dict[str, float], limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every limit has its number and
    no number is above its limit (a missing or NaN number fails)."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = checks.get(name)
        good = v is not None and v == v and v <= limit
        ok &= good
        out[name] = {"value": v, "limit": limit}
    return ok, out
