"""The roofline files' operations and bytes at hand-worked shapes, and the
readers built on them."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import core, readers  # noqa: E402
from benchmark.harness.trace import Trace  # noqa: E402

RF = core.rooflines()


def test_kernel_c_counts():
    # 10 frames, 3 densities, dim 2, 2 mixtures: per element 10 + 2*10 + 20,
    # per density 2 + 2*20 + 3
    ops, nbytes = RF["C"].count({"frames": 10, "densities": 3, "dim": 2, "mixtures": 2})
    assert ops == 10 * 3 * (2 * 50 + 45)
    assert nbytes == 4 * 10 * 2 + 8 * (2 * 3 * 2 + 2 * 3) + 8 * 10 * 2


def test_kernel_m_counts():
    # 2 frames, words of 3 and 6 positions, a 3-state silence, 5 mixtures:
    # V = 3, slots 9 + 9
    ops, nbytes = RF["M"].count({"frames": 2, "word_len": [3, 6], "silence_positions": 3,
                                 "mixtures": 5})
    assert ops == 2 * ((9 + 9) * 12 + 3 * 2 * 2 + (2 + 3) * 4)
    assert nbytes == 2 * (4 * 5 + 2 * 13 + 3 * 12 + 4)


def test_kernel_o_counts():
    ops, nbytes = RF["O"].count({"frames": 8, "densities": 5, "dim": 3, "mixtures": 2})
    assert ops == 2 * 8 * 5 * 3
    assert nbytes == 8 * 3 * 4 + 8 * 2 * 4 + 5 * (3 + 8)


@pytest.mark.parametrize("kernel", ["C", "F", "H", "M", "O"])
def test_missing_shapes_count_nothing(kernel):
    assert RF[kernel].count({}) is None


def _run(ops, window=(0.0, 1e6)):
    tr = Trace(window=window, device_ops=ops, host_spans=[("bench.step", 0.0, 1e6)])
    work = {"frames": 10, "densities": 3, "dim": 2, "mixtures": 2}
    return core.Run(cell=None, setup_s=1.0, steps=[], window_s=1.0, work=work, trace=tr,
                    rooflines=RF)


def test_readers_share_and_idle():
    # kernel C ran 2 µs; nothing else ran
    run = _run([("void am_scores_df_kernel<4>(float*)", 10.0, 12.0)])
    ops, nbytes = RF["C"].count(run.work)
    bound = max(ops / readers.PEAK_OPS_S["fp32"], nbytes / readers.HBM_BYTES_S)
    assert readers.roofline_share(run, "C") == pytest.approx(100 * bound / 2e-6)
    assert readers.roofline_share(run, "M") is None          # not in the trace
    assert readers.step_mfu(run) == pytest.approx(100 * ops / readers.PEAK_OPS_S["fp32"] / 1.0)
    assert readers.device_idle(run) == pytest.approx(100 * (1 - 2e-6))


def test_trace_union_and_gaps():
    tr = Trace(window=(0.0, 100.0), device_ops=[("a", 0.0, 10.0), ("b", 5.0, 20.0),
                                                  ("a", 50.0, 60.0)],
               host_spans=[("bench.step", 0.0, 100.0), ("host work", 20.0, 50.0)])
    assert tr.busy_s() == pytest.approx(30e-6)
    assert tr.top_ops()[0] == ["a", pytest.approx(20e-6)]
    gaps = tr.idle_gaps()
    assert gaps[0] == ["bench.step", pytest.approx(40e-6)]
    assert gaps[1] == ["host work", pytest.approx(30e-6)]
