"""The port's command-line entry point against the JAX package's, in-process.

``recognize`` (GMM scorer, ``model.pack()`` in float32 as in the reference
package) and ``corpus-statistics`` with ``--device cpu`` on a temporary
config over tests/fixtures/demo_corpus.json print the same lines as
``speechrecognition_tpu.cli.main``, except the ``Time:`` and ``RTF:`` lines;
``recognize`` prints the golden WER and SER. ``train`` with ``train-dtype``
f64 runs the EM trainer on the CPU and writes the oracle's iter-2.mix (rtol
1e-9 / atol 1e-7, as tests/test_em_demo.py holds the JAX trainer). The
actions not ported raise NotImplementedError naming their ROADMAP item, and
``--device cuda`` without a card fails instead of running on the CPU.
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import speechrecognition_tpu.cli as jcli

import speechrecognition_torch.cli as tcli
import speechrecognition_torch.io as tio

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    cfg = {"corpus": str(FIX / "demo_corpus.json"),
           "feature-path": str(FIX / "demo_features") + "/",
           "normalization-path": str(FIX / "normalization-demo.bin"),
           "load-mixtures-from": str(FIX / "iter-2.mix"), "pooling": "mixture",
           "tdp-loop": 3.0, "tdp-forward": 0.0, "tdp-skip": 30.0,
           "am-threshold": 200.0, "word-penalty": 80.0, "pruned-search": True,
           "max-recognition-runs": 10000}
    path = tmp_path_factory.mktemp("cli") / "demo.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err.splitlines()


def stable(lines):
    return [ln for ln in lines if not ln.startswith(("Time:", "RTF:"))]


@pytest.fixture(scope="module")
def recognize_both(config_path):
    """(port rc, stdout, stderr), (JAX rc, stdout, stderr) of ``recognize``,
    each run once per module (capsys is function-scoped, so redirect)."""
    results = []
    for main, argv in ((tcli.main, [config_path, "recognize", "--device", "cpu"]),
                       (jcli.main, [config_path, "recognize"])):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
        results.append((rc, out.getvalue().splitlines(), err.getvalue().splitlines()))
    return results


def test_recognize_prints_the_jax_lines(recognize_both):
    (rc, out, err), (jrc, jout, jerr) = recognize_both
    assert rc == jrc == 0
    assert stable(out) == stable(jout)
    assert stable(err) == stable(jerr)
    assert any(ln.startswith("Time:") for ln in err)
    assert any(ln.startswith("RTF:") for ln in err)


def test_recognize_prints_the_golden_wer(recognize_both):
    (_rc, _out, err), _ = recognize_both
    assert "WER: 19.587629% (S/I/D) 4/14/1" in err
    assert "SER: 20.000000%" in err


def test_corpus_statistics_prints_the_jax_lines(config_path, capsys):
    rc, out, err = run(tcli.main, [config_path, "corpus-statistics", "--device", "cpu"], capsys)
    jrc, jout, jerr = run(jcli.main, [config_path, "corpus-statistics"], capsys)
    assert rc == jrc == 0
    assert out == jout and err == jerr
    assert out[0].split() == ["segments:", "35"]


def test_train_writes_the_oracle_model(config_path, tmp_path, capsys):
    cfg = json.loads(Path(config_path).read_text())
    cfg.update({"train-dtype": "f64", "tdp-loop": 20.0, "tdp-forward": 0.0, "tdp-skip": 20.0,
                "min-obs": 1, "num-splits": 2, "num-aligns": 1, "num-estimates": 3,
                "pruning-threshold": 120.0, "mixture-path": str(tmp_path / "iter-"),
                "alignment-path": str(tmp_path / "alignment-"),
                "training-stats-path": str(tmp_path / "stats.txt")})
    path = tmp_path / "train.json"
    path.write_text(json.dumps(cfg))
    rc, _out, err = run(tcli.main, [str(path), "train", "--device", "cpu"], capsys)
    assert rc == 0
    assert any(ln.startswith("Training took") for ln in err)
    ref = tio.read_mixture_set(str(FIX / "iter-2.mix"), 25)
    mine = tio.read_mixture_set(str(tmp_path / "iter-2.mix"), 25)
    assert [len(m) for m in mine.mixtures] == [len(m) for m in ref.mixtures]
    np.testing.assert_array_equal(mine.mean_weight, ref.mean_weight)
    np.testing.assert_allclose(mine.mean_acc, ref.mean_acc, rtol=1e-9, atol=1e-7)
    lines = (tmp_path / "stats.txt").read_text().splitlines()
    assert len(lines) == 10 and lines[-1].startswith("2 0 2 31.238")


@pytest.mark.parametrize("action", ["train-nn", "compute-prior", "plot-activations"])
def test_unported_actions_raise(config_path, action):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main([config_path, action, "--device", "cpu"])


def test_nn_scorer_raises(tmp_path, config_path):
    cfg = json.loads(Path(config_path).read_text())
    cfg["feature-scorer"] = "nn"
    path = tmp_path / "nn.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main([str(path), "recognize", "--device", "cpu"])


def test_cuda_without_a_card_fails(config_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(tcli.main, [config_path, "corpus-statistics"], capsys)
    assert rc != 0 and out == []
    assert "no CUDA device" in err[-1]


def test_unknown_action(config_path, capsys):
    rc, _out, err = run(tcli.main, [config_path, "nonsense", "--device", "cpu"], capsys)
    assert rc == 1 and err == ["Error: unknown action nonsense"]
