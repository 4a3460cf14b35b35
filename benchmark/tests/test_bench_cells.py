"""Each cell's whole run at a tiny size on the CPU, where the program takes
its plain versions: the reference agrees with the program, the result line
has the contract's shape, and each fault the cell can have, planted under the
timed path, makes ``correct`` false."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.harness import core  # noqa: E402

TINY = {
    "an4-decode-linear-q8": {"utterances": 4, "length_max": 150, "length_mean": 110,
                             "jobs": 2, "checked_jobs": 2, "min_steps": 2},
    "sietill-train-df32": {"utterances": 4, "length_min": 80, "length_max": 150,
                           "length_mean": 110, "align_batch": 4},
}
SEED = 2 ** 31 + 5


def tiny_run(name, **mix):
    cell = core.find_cell(ROOT, name)
    cell.mix.update(TINY[name], **mix)
    return run.run_cell(cell, SEED, 0.0, False, torch.device("cpu"),
                        core.SetupClock(time.perf_counter()))


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct_and_shaped(name):
    res = tiny_run(name)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= res.keys()
    assert res["device"].keys() >= {"platform", "kind", "count", "memory_peak_bytes"}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    expect = {m["name"]: m["unit"] for m in spec["end_to_end"]
              if name in m.get("workloads", [name])}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == expect
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


def _patch(monkeypatch, module, name, make):
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, make(orig))


def fault_half_batch(monkeypatch):
    """Half of each job's utterances get no words."""
    from speechrecognition_torch.search import linear_lvcsr

    def make(orig):
        def f(*a, **k):
            out = orig(*a, **k)
            return out[: (len(out) + 1) // 2] + [[] for _ in out[(len(out) + 1) // 2:]]
        return f
    _patch(monkeypatch, linear_lvcsr, "decode_batch_linear_lvcsr", make)


def fault_altered_word(monkeypatch):
    """The first utterance's first word is changed where it is produced."""
    from speechrecognition_torch.search import linear_lvcsr

    def make(orig):
        def f(*a, **k):
            out = [list(x) for x in orig(*a, **k)]
            out[0] = [out[0][0] % 5 + 1] + out[0][1:] if out[0] else [1]
            return out
        return f
    _patch(monkeypatch, linear_lvcsr, "decode_batch_linear_lvcsr", make)


def fault_altered_score(monkeypatch):
    """One score of each job is altered by one unit of the integer distance
    where it is produced, too little to change a word."""
    from speechrecognition_torch.models import quantized

    def make(orig):
        def f(pack, feats, *a, **k):
            out = orig(pack, feats, *a, **k).clone()
            best = int(out[0].argmin())         # a trained mixture's score
            out[0, best] += 1.0 / float(torch.tensor(pack.scale2x, dtype=torch.float32))
            return out
        return f
    _patch(monkeypatch, quantized, "am_scores_q_chunked", make)


def fault_stale_state(monkeypatch):
    """A step returns its state unchanged: the scorer hands on the previous
    job's scores."""
    from speechrecognition_torch.models import quantized

    def scores(orig):
        last = []

        def f(pack, feats, *a, **k):
            out = orig(pack, feats, *a, **k)
            if last and last[0].shape == out.shape:
                out, last[0] = last[0], out
            else:
                last[:] = [out]
            return out
        return f
    _patch(monkeypatch, quantized, "am_scores_q_chunked", scores)


def fault_train_half_batch(monkeypatch):
    from benchmark.drivers import em_train
    _patch_state(monkeypatch, em_train.fault_half_batch)


def fault_train_altered_state(monkeypatch):
    from benchmark.drivers import em_train
    _patch_state(monkeypatch, em_train.fault_altered_state)


def fault_train_model_unchanged(monkeypatch):
    """A step returns its state unchanged: the M-step leaves the model as
    it was."""
    from speechrecognition_torch.models import gmm
    monkeypatch.setattr(gmm.MixtureModel, "finalize", lambda self: None)


def _patch_state(monkeypatch, fault):
    """Plant a driver fault (which acts on the run's state) at set-up."""
    from benchmark.harness import core as hcore
    orig = hcore.Cell.driver

    def driver(self):
        mod = orig(self)
        setup = mod.setup
        monkeypatch.setattr(mod, "setup", lambda *a, **k: setup(*a, fault=fault, **k))
        return mod
    monkeypatch.setattr(hcore.Cell, "driver", driver)


FAULTS = {
    "an4-decode-linear-q8": [(fault_half_batch, {}), (fault_altered_word, {}),
                             (fault_altered_score, {}), (fault_stale_state, {})],
    "sietill-train-df32": [(fault_train_half_batch, {}), (fault_train_altered_state, {}),
                           (fault_train_model_unchanged, {})],
}


@pytest.mark.parametrize("name,fault,mix", [(n, f, m) for n, fs in sorted(FAULTS.items())
                                            for f, m in fs],
                         ids=lambda x: getattr(x, "__name__", None))
def test_fault_makes_the_run_incorrect(monkeypatch, name, fault, mix):
    fault(monkeypatch)
    assert tiny_run(name, **mix)["correct"] is False


def test_altered_score_leaves_the_words_and_fails_the_scores(monkeypatch):
    fault_altered_score(monkeypatch)
    checks = tiny_run("an4-decode-linear-q8")["checks"]
    assert checks["word_mismatch_share"]["value"] == 0
    assert checks["score_gap_units"]["value"] > checks["score_gap_units"]["limit"]


@pytest.mark.parametrize("module", ["jax", "jaxlib.xla_client", "flax",
                                    "speechrecognition_tpu.models"])
def test_a_forbidden_module_loaded_by_the_check_gives_no_result(monkeypatch, module):
    """The look for JAX comes after the check and the metric readers: a module
    that the reference or a reader loads still withholds the result."""
    from benchmark.harness import core as hcore
    orig = hcore.Cell.driver

    def driver(self):
        mod = orig(self)
        check = mod.check

        def planted(*a, **k):
            monkeypatch.setitem(sys.modules, module, type(sys)(module))
            return check(*a, **k)
        monkeypatch.setattr(mod, "check", planted)
        return mod
    monkeypatch.setattr(hcore.Cell, "driver", driver)
    assert tiny_run("an4-decode-linear-q8") is None


def test_without_a_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", "an4-decode-linear-q8", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
