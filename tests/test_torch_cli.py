"""The port's command-line entry point against the JAX package's, in-process.

``recognize`` (GMM scorer, ``model.pack()`` in float32 as in the reference
package) and ``corpus-statistics`` with ``--device cpu`` on a temporary
config over tests/fixtures/demo_corpus.json print the same lines as
``speechrecognition_tpu.cli.main``, except the ``Time:`` and ``RTF:`` lines;
``recognize`` prints the golden WER and SER. ``train`` with ``train-dtype``
f64 runs the EM trainer on the CPU and writes the oracle's iter-2.mix (rtol
1e-9 / atol 1e-7, as tests/test_em_demo.py holds the JAX trainer).

The NN actions on the same corpus, each against ``cli.main`` of the JAX
package on the same config: ``recognize`` with ``feature-scorer=nn``
(bench/nn_run/model.json's model) prints the same lines and the WER of
tests/fixtures/demo_recognition_nn.json; ``train-nn`` (a hidden layer of
20, 2 epochs) prints the same epoch lines and writes models/1/ and
models/2/ in the raw float32 layout, within 1e-4 relative (+1e-5) of JAX's
(tests/test_torch_nn_training.py), and the same stats lines up to the
seconds; ``compute-prior`` writes the same text; ``plot-activations``
writes the same labels and activations within 1e-5 relative (+1e-6), and a
t-SNE plot. ``--device cuda`` without a card fails instead of running on
the CPU, for every action.
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


def nn_config(config_path, out, **overrides):
    """The demo config with the NN actions' keys, written under ``out``."""
    cfg = json.loads(Path(config_path).read_text())
    cfg.update({"target-file": str(FIX / "demo_alignments" / "alignment-2-0.dump"),
                "context-frames": 1, "cv-size": 0.1, "batch-size": 8, "num-epochs": 2,
                "updater": "adadelta", "gradient-check": False,
                "output-dir": str(out / "models"),
                "nn-training-stats-path": str(out / "nn_stats.data"),
                "prior-file": str(out / "prior.txt"),
                "model-path": str(out / "models" / "2") + "/",
                "activations-path": str(out / "activations"),
                "layers": [{"layer-name": "hidden-layer1", "num-outputs": 20,
                            "type": "feed-forward", "nonlinearity": "tanh",
                            "input": ["data"]},
                           {"layer-name": "output-layer", "num-outputs": 106,
                            "type": "output", "input": ["hidden-layer1"]}]})
    cfg.update(overrides)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "nn.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def run_both(config_path, tmp_path, action, capsys, **overrides):
    """(port rc, stdout, stderr, folder), (JAX ...) of ``action``, each
    package on its own copy of the config under its own folder."""
    out = []
    for name, main, extra in (("port", tcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        folder = tmp_path / name
        path = nn_config(config_path, folder, **overrides)
        out.append((*run(main, [path, action, *extra], capsys), folder))
    return out


def test_recognize_nn_prints_the_jax_lines(config_path, tmp_path, capsys):
    m = json.loads((REPO / "bench" / "nn_run" / "model.json").read_text())
    loop, forward, skip = m["tdp"]
    (rc, out, err, _), (jrc, jout, jerr, _) = run_both(
        config_path, tmp_path, "recognize", capsys, **{
            "feature-scorer": "nn", "layers": m["layers"],
            "model-path": str(REPO / m["model_path"]) + "/",
            "prior-file": str(REPO / m["prior_file"]), "prior-scale": m["prior_scale"],
            "context-frames": m["context_frames"], "tdp-loop": loop, "tdp-forward": forward,
            "tdp-skip": skip, "word-penalty": m["word_penalty"],
            "am-threshold": m["am_threshold"]})
    assert rc == jrc == 0
    assert stable(out) == stable(jout) and stable(err) == stable(jerr)
    fix = json.loads((FIX / "demo_recognition_nn.json").read_text())["corpus"]
    assert (f"WER: {fix['wer']:.6f}% (S/I/D) {fix['sid'][0]}/{fix['sid'][1]}/{fix['sid'][2]}"
            in err)


def test_train_nn_writes_what_jax_writes(config_path, tmp_path, capsys):
    (rc, _out, err, folder), (jrc, _jout, jerr, jfolder) = run_both(
        config_path, tmp_path, "train-nn", capsys)
    assert rc == jrc == 0
    assert [ln.rsplit(" (", 1)[0] for ln in err] == [ln.rsplit(" (", 1)[0] for ln in jerr]
    assert len(err) == 2 and err[1].startswith("epoch 2: train FER")
    for epoch in ("1", "2"):
        for layer, size in (("hidden-layer1", 20 * 75 + 20), ("output-layer", 106 * 20 + 106)):
            got = np.fromfile(folder / "models" / epoch / layer, np.float32)
            ref = np.fromfile(jfolder / "models" / epoch / layer, np.float32)
            assert got.size == ref.size == size
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    stats = (folder / "nn_stats.data").read_text().splitlines()
    jstats = (jfolder / "nn_stats.data").read_text().splitlines()
    assert [ln.rsplit(" # ", 1)[0] for ln in stats] == [ln.rsplit(" # ", 1)[0] for ln in jstats]


def test_compute_prior_writes_the_jax_text(config_path, tmp_path, capsys):
    (rc, _, _, folder), (jrc, _, _, jfolder) = run_both(
        config_path, tmp_path, "compute-prior", capsys)
    assert rc == jrc == 0
    text = (folder / "prior.txt").read_text()
    assert text == (jfolder / "prior.txt").read_text()
    assert len(text.split()) == 106


def test_plot_activations_writes_what_jax_writes(config_path, tmp_path, capsys):
    """A model written by the port's train-nn, read by both packages."""
    model = tmp_path / "model"
    assert tcli.main([nn_config(config_path, model), "train-nn", "--device", "cpu"]) == 0
    capsys.readouterr()
    (rc, _, err, folder), (jrc, _, jerr, jfolder) = run_both(
        config_path, tmp_path, "plot-activations", capsys,
        **{"model-path": str(model / "models" / "2") + "/", "tsne-max-frames": 200,
           "tsne-plot": str(tmp_path / "tsne.png")})
    assert rc == jrc == 0
    assert err[0].replace("/port/", "/jax/") == jerr[0]
    assert err[0].startswith("wrote activations for")
    labels = np.fromfile(folder / "activations" / "labels.bin", np.int32)
    np.testing.assert_array_equal(
        labels, np.fromfile(jfolder / "activations" / "labels.bin", np.int32))
    for name, width in (("hidden-layer1", 20), ("output-layer", 106)):
        got = np.fromfile(folder / "activations" / f"{name}.activations", np.float32)
        ref = np.fromfile(jfolder / "activations" / f"{name}.activations", np.float32)
        assert got.size == labels.size * width
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.reshape(-1, 106).sum(axis=1), 1.0, atol=1e-4)
    assert (tmp_path / "tsne.png").stat().st_size > 0
    assert err[-1] == f"t-SNE of hidden-layer1 → {tmp_path / 'tsne.png'}"


@pytest.mark.parametrize("action", ["train-nn", "compute-prior", "plot-activations",
                                    "recognize"])
def test_nn_actions_need_the_card(config_path, tmp_path, capsys, monkeypatch, action):
    path = nn_config(config_path, tmp_path, **{"feature-scorer": "nn"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(tcli.main, [path, action], capsys)
    assert rc != 0 and out == []
    assert "no CUDA device" in err[-1]
    assert not (tmp_path / "models").exists()


def test_cuda_without_a_card_fails(config_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(tcli.main, [config_path, "corpus-statistics"], capsys)
    assert rc != 0 and out == []
    assert "no CUDA device" in err[-1]


def test_unknown_action(config_path, capsys):
    rc, _out, err = run(tcli.main, [config_path, "nonsense", "--device", "cpu"], capsys)
    assert rc == 1 and err == ["Error: unknown action nonsense"]
