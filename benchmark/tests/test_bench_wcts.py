"""The WCTS cell (``an4-decode-wcts-q8``): kernel K's roofline count at a
hand-worked shape, its readers on a synthetic trace, and the cell's whole
run at a tiny size on the CPU, where the program takes its plain versions:
the reference agrees with the program, a traced run reads every new
metric, and the control and the fault make ``correct`` false."""

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.harness import core, readers  # noqa: E402
from benchmark.harness.trace import Trace  # noqa: E402

RF = core.rooflines()
CELL = "an4-decode-wcts-q8"
TINY = {"utterances": 3, "length_min": 60, "length_max": 120, "length_mean": 90, "jobs": 2,
        "checked_jobs": 2, "min_steps": 2}
SEED = 2 ** 31 + 5
WORK = {"frames": 10, "mixtures": 5, "active_states": 300, "word_ends": 7, "dim": 2,
        "densities": 3}


def test_kernel_k_counts():
    # 300 live hypotheses of 11 operations and 16 bytes, 7 word ends of 2,
    # a score row of 5 floats a frame
    ops, nbytes = RF["K"].count(WORK)
    assert ops == 300 * 11 + 7 * 2
    assert nbytes == 10 * 5 * 4 + 300 * 16


def test_kernel_k_missing_shapes_count_nothing():
    assert RF["K"].count({"frames": 10, "mixtures": 5}) is None


def metric(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py")


def synthetic_run(monkeypatch):
    """A window of 1,000 µs and two steps: K ran 400 µs in two launches, O
    20 µs; ``wcts.to_host`` spans of 100 and 60 µs (a 10 µs collection
    inside the first), ``wcts.traceback`` 30 µs; the counters as a traced
    run leaves them."""
    ops = [("void (anonymous namespace)::wcts_scan_kernel<float, true, false>(Args)", 0.0, 300.0),
           ("void (anonymous namespace)::wcts_scan_kernel<float, true, false>(Args)", 500.0, 600.0),
           ("void (anonymous namespace)::quantized_mma_kernel<2, 4, false, false>(x)", 300.0, 320.0)]
    spans = [("wcts.to_host", 320.0, 420.0), ("host.gc", 330.0, 340.0),
             ("wcts.to_host", 600.0, 660.0), ("wcts.traceback", 660.0, 690.0)]
    fake = SimpleNamespace(counters=lambda: {"wcts.frames_real": 6, "wcts.frames_padded": 8})
    monkeypatch.setitem(sys.modules, "speechrecognition_torch.tracing", fake)
    return core.Run(cell=None, setup_s=1.0, steps=[{}, {}], window_s=1e-3, work=WORK,
                    trace=Trace((0.0, 1000.0), ops, spans), rooflines=RF)


def test_readers_on_a_synthetic_trace(monkeypatch):
    run_ = synthetic_run(monkeypatch)
    k_ops, k_bytes = RF["K"].count(WORK)
    o_ops, _ = RF["O"].count(WORK)
    bound = max(k_ops / readers.PEAK_OPS_S["fp32"], k_bytes / readers.HBM_BYTES_S)
    assert metric("kernel_K_roofline.wcts").read(run_) == pytest.approx(100 * bound / 400e-6)
    mfu = 100 * (k_ops / readers.PEAK_OPS_S["fp32"] + o_ops / readers.PEAK_OPS_S["int8"]) / 1e-3
    assert metric("step_mfu.wcts").read(run_) == pytest.approx(mfu)
    assert metric("device_idle.wcts").read(run_) == pytest.approx(100 * (1 - 420e-6 / 1e-3))
    assert metric("wcts_to_host_ms.wcts").read(run_) == pytest.approx(1e3 * 150e-6 / 2)
    assert metric("wcts_traceback_ms.wcts").read(run_) == pytest.approx(1e3 * 30e-6 / 2)
    assert metric("wcts_real_frames.wcts").read(run_) == pytest.approx(75.0)


def test_a_program_without_the_spans_reads_none(monkeypatch):
    """The parent's program has no ``wcts.*`` spans or counters: the span
    readers read None and raise nothing; K's share still reads."""
    run_ = synthetic_run(monkeypatch)
    run_.trace.host_spans[:] = []
    monkeypatch.setitem(sys.modules, "speechrecognition_torch.tracing",
                        SimpleNamespace(counters=lambda: {}))
    for name in ("wcts_to_host_ms.wcts", "wcts_traceback_ms.wcts", "wcts_real_frames.wcts"):
        assert metric(name).read(run_) is None
    assert metric("kernel_K_roofline.wcts").read(run_) > 0


def tiny_run(trace=False, **variant):
    cell = core.find_cell(ROOT, CELL)
    cell.mix.update(TINY)
    return run.run_cell(cell, SEED, 0.0, trace, torch.device("cpu"),
                        core.SetupClock(time.perf_counter()), **variant)


def test_sound_tiny_run_is_correct_and_reads_its_metrics():
    from speechrecognition_torch import tracing
    tracing.reset()
    res = tiny_run(trace=True)
    tracing.reset()
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] == 6
    assert all(c["value"] == 0 for c in res["checks"].values())
    for name in ("wcts_to_host_ms.wcts", "wcts_traceback_ms.wcts", "wcts_real_frames.wcts"):
        v = res["metrics"][name]["value"]
        assert v is not None and v >= 0, name
    assert 0 < res["metrics"]["wcts_real_frames.wcts"]["value"] <= 100


@pytest.mark.parametrize("kind", ["control", "no_lookahead"])
def test_control_and_fault_are_incorrect(kind):
    from benchmark.drivers import wcts_jobs
    kw = {"variant": "control"} if kind == "control" else {"fault": wcts_jobs.FAULTS[kind]}
    res = tiny_run(**kw)
    assert res["correct"] is False
    assert res["checks"]["active_states_mismatch_share"]["value"] > 0


def test_the_scan_is_unwrapped_after_a_run():
    from speechrecognition_torch.search import wcts
    scan = wcts.wcts_scan
    tiny_run()
    assert wcts.wcts_scan is scan and hasattr(scan, "LAUNCHES")
