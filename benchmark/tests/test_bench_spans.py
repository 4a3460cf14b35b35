"""The readers of the program's own spans and counters
(``benchmark/harness/spans.py``): on a synthetic trace, the spans clipped to
the window and averaged over its steps, None where a span or a counter is
absent; and each new metric read in a traced tiny run of its cell on the
CPU."""

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.harness import core, spans  # noqa: E402
from benchmark.harness.trace import Trace  # noqa: E402
from benchmark.tests.test_bench_cells import SEED, TINY  # noqa: E402


def synthetic(steps=2):
    """A window from 100 to 1,100 µs: ``a`` inside it twice (100 and 50 µs),
    ``a`` again across its start (50 µs inside), ``b`` across its end (100 µs
    inside), ``c`` wholly outside."""
    trace = Trace(window=(100.0, 1100.0), device_ops=[("k", 200.0, 300.0)],
                  host_spans=[("a", 200.0, 300.0), ("a", 400.0, 450.0), ("a", 50.0, 150.0),
                              ("b", 1000.0, 1200.0), ("c", 1200.0, 1300.0)])
    return SimpleNamespace(trace=trace, steps=[{}] * steps)


def test_spans_clipped_to_the_window_a_step():
    run_ = synthetic()
    assert spans.span_seconds(run_, "a") == pytest.approx(200e-6 / 2)
    assert spans.span_seconds(run_, "b") == pytest.approx(100e-6 / 2)
    assert spans.span_seconds(run_, "a", "b") == pytest.approx(300e-6 / 2)
    assert spans.span_seconds(synthetic(steps=4), "a") == pytest.approx(200e-6 / 4)


@pytest.mark.parametrize("names", [("c",), ("absent",)])
def test_no_span_in_the_window_reads_none(names):
    assert spans.span_seconds(synthetic(), *names) is None


def test_nested_spans_taken_off():
    """``g`` cuts 30 µs of the first ``a``, 20 of the second, 10 of the
    part of the third inside the window; outside the window it cuts
    nothing, and across a span's end only what lies in the span."""
    run_ = synthetic()
    run_.trace.host_spans += [("g", 210.0, 240.0), ("g", 430.0, 460.0), ("g", 60.0, 110.0),
                              ("g", 140.0, 170.0), ("g", 1200.0, 1250.0)]
    assert spans.span_seconds(run_, "a", minus=("g",)) == pytest.approx((200 - 30 - 20 - 10 - 10) * 1e-6 / 2)
    assert spans.span_seconds(run_, "b", minus=("g",)) == pytest.approx(100e-6 / 2)
    assert spans.span_seconds(run_, "a", minus=("absent",)) == spans.span_seconds(run_, "a")


def test_untraced_or_stepless_run_reads_none():
    assert spans.span_seconds(SimpleNamespace(trace=None, steps=[{}]), "a") is None
    assert spans.span_seconds(synthetic(steps=0), "a") is None


def test_counter_share(monkeypatch):
    fake = SimpleNamespace(counters=lambda: {"x.real": 3, "x.padded": 4, "y.padded": 0})
    monkeypatch.setitem(sys.modules, "speechrecognition_torch.tracing", fake)
    assert spans.counter_share(synthetic(), "x.real", "x.padded") == pytest.approx(75.0)
    assert spans.counter_share(synthetic(), "y.real", "y.padded") is None
    assert spans.counter_share(synthetic(), "z.real", "z.padded") is None
    assert spans.counter_share(SimpleNamespace(trace=None), "x.real", "x.padded") is None


def test_a_program_without_counters_reads_none(monkeypatch):
    monkeypatch.delitem(sys.modules, "speechrecognition_torch.tracing", raising=False)
    assert spans.counters() == {}
    assert spans.counter_share(synthetic(), "x.real", "x.padded") is None


def program_span_metrics(name):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [(m["name"], m["unit"]) for m in spec["per_layer"]
            if m["source"] == "program_span" and name in m.get("workloads", [name])]


@pytest.mark.parametrize("name", sorted(TINY))
def test_traced_tiny_run_reads_the_program_spans(name):
    """Every program-span metric of the cell is read, non-null, in a traced
    tiny run of it."""
    from speechrecognition_torch import tracing
    tracing.reset()
    cell = core.find_cell(ROOT, name)
    cell.mix.update(TINY[name])
    res = run.run_cell(cell, SEED, 0.0, True, torch.device("cpu"),
                       core.SetupClock(time.perf_counter()))
    tracing.reset()
    assert res["correct"] is True
    metrics = program_span_metrics(name)
    assert metrics
    for m, unit in metrics:
        assert m in res["metrics"], m
        v = res["metrics"][m]["value"]
        assert v is not None and ((0 < v <= 100) if unit == "%" else v >= 0), (m, v)
