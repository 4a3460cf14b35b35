"""The port's NN trainer (speechrecognition_torch/train/nn_training.py)
against the JAX package's, on the CPU, on the 35 demo utterances with the
oracle alignment tests/fixtures/demo_alignments/alignment-2-0.dump as
targets, at a small size (a hidden layer of 20, batch 8, 1-3 epochs).

Tolerances: MiniBatchBuilder, gather_batch (up to the −0.0/0.0 of the mask
multiply), the shuffles, the CV split and compute_prior_from_alignment are
bit-equal; the frame error rates of every epoch are equal (they count
argmax decisions); parameters agree within 1e-6 relative (+1e-7
absolute) after one step and within 1e-4 relative (+1e-5 absolute) after
the last epoch, float32 products of the two packages rounding differently
in the last bits.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.config as jcfg
import speechrecognition_tpu.corpus as jcorpus
import speechrecognition_tpu.features.frontend as jfront
import speechrecognition_tpu.io as jio
import speechrecognition_tpu.lexicon as jlex
import speechrecognition_tpu.models.nn as jnn
import speechrecognition_tpu.train.nn_training as jtr

import speechrecognition_torch.config as tcfg
import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.nn as tnn
import speechrecognition_torch.train.nn_training as ttr

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
TARGETS = str(FIX / "demo_alignments" / "alignment-2-0.dump")
STEP_RTOL, STEP_ATOL = 1e-6, 1e-7
END_RTOL, END_ATOL = 1e-4, 1e-5


def read_corpus(pkg_corpus, pkg_front, lexicon, **kw):
    desc = pkg_corpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lexicon)
    return pkg_corpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                  pkg_front.SignalAnalysisConfig(),
                                  normalization_path=str(FIX / "normalization-demo.bin"), **kw)


@pytest.fixture(scope="module")
def corpora():
    """(JAX corpus, port corpus) of the demo utterances."""
    return (read_corpus(jcorpus, jfront, jlex.build_sietill_lexicon(), use_native=False),
            read_corpus(tcorpus, tfront, tlex.build_sietill_lexicon()))


def recipe(out, **overrides):
    cfg = {"target-file": TARGETS, "context-frames": 1, "cv-size": 0.1, "batch-size": 8,
           "num-epochs": 2, "updater": "adadelta", "learning-rate": 0.5,
           "gradient-check": False, "output-dir": str(out / "models"),
           "nn-training-stats-path": str(out / "nn_stats.data"),
           "layers": [{"layer-name": "hidden-layer1", "num-outputs": 20,
                       "type": "feed-forward", "nonlinearity": "tanh", "input": ["data"]},
                      {"layer-name": "output-layer", "num-outputs": 106,
                       "type": "output", "input": ["hidden-layer1"]}]}
    cfg.update(overrides)
    return cfg


def builders(corpora, cfg):
    jc, tc = corpora
    return (jtr.MiniBatchBuilder.from_config(jcfg.Configuration(cfg), jc, cfg["batch-size"], 106, 0),
            ttr.MiniBatchBuilder.from_config(tcfg.Configuration(cfg), tc, cfg["batch-size"], 106, 0))


def trainers(corpora, cfg):
    jb, tb = builders(corpora, cfg)
    jl, tl = [], []
    jm = jnn.MLP(jnn.layer_specs_from_config(jcfg.Configuration(cfg)), input_dim=jb.feature_size)
    tm = tnn.MLP(tnn.layer_specs_from_config(tcfg.Configuration(cfg)), input_dim=tb.feature_size,
                 device="cpu")
    return (jtr.NnTrainer(jcfg.Configuration(cfg), jb, jm, log=jl.append), jl,
            ttr.NnTrainer(tcfg.Configuration(cfg), tb, tm, log=tl.append, device="cpu"), tl)


def train_both(corpora, tmp_path, **overrides):
    """Train the recipe with both packages (each in its own output folder);
    returns (JAX result, JAX log, port result, port log, port folder)."""
    out = {}
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir(parents=True, exist_ok=True)
        out[pkg] = recipe(tmp_path / pkg, **overrides)
    j, jl, _, _ = trainers(corpora, out["jax"])
    _, _, t, tl = trainers(corpora, out["port"])
    return j.train(), jl, t.train(), tl, tmp_path / "port"


def assert_params_close(tp, jp, rtol, atol):
    assert set(tp) == set(jp)
    for n in jp:
        for k in ("W", "b"):
            np.testing.assert_allclose(tp[n][k].numpy(), np.asarray(jp[n][k]),
                                       rtol=rtol, atol=atol, err_msg=f"{n}.{k}")


def strip_times(lines):
    """The log without the seconds each epoch took."""
    return [ln.rsplit(" (", 1)[0] if ln.startswith("epoch ") else ln for ln in lines]


@pytest.mark.parametrize("options", [{}, {"max-silence-frames": 5},
                                     {"normalize-features-per-batch": True}],
                         ids=["plain", "max-silence", "normalized"])
def test_minibatch_builder_bit_equal(corpora, tmp_path, options):
    jb, tb = builders(corpora, recipe(tmp_path, **options))
    np.testing.assert_array_equal(tb.train_segments, jb.train_segments)
    np.testing.assert_array_equal(tb.cv_segments, jb.cv_segments)
    assert (tb.num_train_batches, tb.num_cv_batches, tb.feature_size) == \
        (jb.num_train_batches, jb.num_cv_batches, jb.feature_size) == (4, 1, 75)
    for _ in range(2):
        jb.shuffle()
        tb.shuffle()
        np.testing.assert_array_equal(tb.train_segments, jb.train_segments)
        for b, cv in ((0, False), (3, False), (0, True)):
            for x, y in zip(tb.build_batch(b, cv=cv), jb.build_batch(b, cv=cv)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_gather_batch_bit_equal(corpora, tmp_path):
    """gather_batch over DeviceBatcher's metadata gives the host-built batch
    and JAX's gathered one, bit for bit up to the mask multiply's −0.0."""
    jb, tb = builders(corpora, recipe(tmp_path, **{"max-silence-frames": 5}))
    jbat, tbat = jtr.DeviceBatcher(jb), ttr.DeviceBatcher(tb, "cpu")
    for cv in (False, True):
        n = tb.num_cv_batches if cv else tb.num_train_batches
        for b in range(min(n, 2)):
            meta = tbat.batch_meta(b, cv=cv)
            jmeta = jbat.batch_meta(b, cv=cv)
            for x, y in zip(meta, jmeta):
                np.testing.assert_array_equal(x, y)
            base, lens, T = meta
            f_d, t_d, m_d = (a.numpy() for a in ttr.gather_batch(
                tbat.flat, tbat.align, torch.from_numpy(base), torch.from_numpy(lens), T,
                tb.context_frames, tb.num_classes))
            jf, jt, jm = (np.asarray(a) for a in jtr.gather_batch(
                jbat.flat, jbat.align, jnp.asarray(base), jnp.asarray(lens), T,
                jb.context_frames, jb.num_classes))
            np.testing.assert_array_equal(f_d.view(np.int32), jf.view(np.int32))
            np.testing.assert_array_equal(t_d, jt)
            np.testing.assert_array_equal(m_d, jm)
            f_h, t_h, mask_h = tb.build_batch(b, cv=cv)
            np.testing.assert_array_equal(lens, np.minimum(mask_h, T))
            n_t = min(T, f_h.shape[0])
            np.testing.assert_array_equal(f_d[:n_t] + 0.0, f_h[:n_t] + 0.0)
            np.testing.assert_array_equal(t_d[:n_t], t_h[:n_t])
            assert np.all(f_d[n_t:] == 0) and np.all(t_d[n_t:] == 0)


def test_finite_guard_keeps_the_previous_state(corpora, tmp_path):
    _, _, trainer, _ = trainers(corpora, recipe(tmp_path))
    params = trainer.mlp.init_params(np.random.default_rng(0))
    state = trainer.updater.init_state(params)
    feats, targets, mask = trainer._host_batch(0, cv=False)
    good, good_state, *_ = trainer.train_step(params, state, feats, targets, mask)
    assert not torch.equal(good["output-layer"]["W"], params["output-layer"]["W"])
    poisoned = feats.clone()
    poisoned[0, 0, 0] = float("nan")
    new, new_state, loss, _err, _n = trainer.train_step(good, good_state, poisoned, targets, mask)
    assert not torch.isfinite(loss)
    for n in params:
        for k in ("W", "b"):
            assert torch.equal(new[n][k], good[n][k])
            for key in ("grad_rms", "update_rms"):
                assert torch.equal(new_state[key][n][k], good_state[key][n][k])


@pytest.mark.parametrize("updater", ["sgd", "adadelta"])
def test_first_step_equals_jax(corpora, tmp_path, updater):
    """One step of each package's update from the same initial weights."""
    j, _, t, _ = trainers(corpora, recipe(tmp_path, updater=updater))
    jp = j.mlp.init_params(np.random.default_rng(j.seed))
    tp = t.mlp.init_params(np.random.default_rng(t.seed))
    jstep, _ = j._make_step()
    f, tg, m = j.builder.build_batch(0, cv=False)
    jp, _s, jloss, jerr, jn = jstep(jp, j.updater.init_state(jp), jnp.asarray(f),
                                    jnp.asarray(tg), jnp.asarray(m))
    feats, targets, mask = t._host_batch(0, cv=False)
    tp, _s, loss, err, n = t.train_step(tp, t.updater.init_state(tp), feats, targets, mask)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    assert (float(err), float(n)) == (float(jerr), float(jn))
    assert_params_close(tp, jp, STEP_RTOL, STEP_ATOL)


@pytest.mark.parametrize("case", [
    {"updater": "sgd", "gradient-check": True},
    {"updater": "adadelta", "method": "newBob", "num-epochs": 3},
    {"updater": "sgd", "learning-rate": 8.0, "method": "newBob", "num-epochs": 3},
    {"updater": "sgd", "learning-rate": 8.0, "method": "newbob-restore", "num-epochs": 3},
], ids=["sgd-gradient-check", "adadelta-newbob", "sgd-newbob", "sgd-newbob-restore"])
def test_trainer_equals_jax(corpora, tmp_path, case):
    jr, jl, tr, tl, out = train_both(corpora, tmp_path, **case)
    # the logs agree line by line: FERs, newbob halvings and restores
    assert [ln.split(":")[0] for ln in tl] == [ln.split(":")[0] for ln in jl]
    assert strip_times(tl[1:] if case.get("gradient-check") else tl) == \
        strip_times(jl[1:] if case.get("gradient-check") else jl)
    if case.get("gradient-check"):
        assert tl[0].startswith("gradient check max rel dev") and float(tl[0].split()[-1]) < 1e-6
    assert (tr["train_fer"], tr["cv_fer"]) == (jr["train_fer"], jr["cv_fer"])
    assert_params_close(tr["params"], jr["params"], END_RTOL, END_ATOL)
    epochs = case.get("num-epochs", 2)
    stats = (out / "nn_stats.data").read_text().splitlines()
    jstats = (tmp_path / "jax" / "nn_stats.data").read_text().splitlines()
    assert len(stats) == epochs + 1 and stats[0] == jstats[0]
    assert [ln.rsplit(" # ", 1)[0] for ln in stats[1:]] == \
        [ln.rsplit(" # ", 1)[0] for ln in jstats[1:]]
    for e in range(1, epochs + 1):
        assert (out / "models" / str(e) / "output-layer").exists()
    if "newbob" in case.get("method", "").lower():
        assert any(ln.startswith("newbob: halving") for ln in tl)
    if case.get("method") == "newbob-restore":
        assert any(ln.startswith("newbob-restore: cv FER") for ln in tl)


def test_trainer_trains_the_module_in_place(corpora, tmp_path):
    """After train() the MLP module holds the trained weights: the ones
    train() returns and the last epoch's saved files."""
    cfg = recipe(tmp_path)
    _, _, t, _ = trainers(corpora, cfg)
    result = t.train()
    saved = tnn.MLP(t.mlp.specs, t.mlp.input_dim, device="cpu").load(
        f"{cfg['output-dir']}/{cfg['num-epochs']}/")
    for n in saved:
        assert result["params"][n]["W"] is t.mlp.W[n]
        for k in ("W", "b"):
            np.testing.assert_array_equal(t.mlp.params()[n][k].numpy(), saved[n][k].numpy())


def test_start_epoch_resumes_from_the_saved_model(corpora, tmp_path):
    """start-epoch 2 loads output-dir/1/ and trains epoch 2 only, as JAX."""
    train_both(corpora, tmp_path, **{"num-epochs": 1})
    jr, jl, tr, tl, _ = train_both(corpora, tmp_path, **{"num-epochs": 2, "start-epoch": 2})
    assert strip_times(tl) == strip_times(jl) and len(tl) == 1 and tl[0].startswith("epoch 2:")
    assert_params_close(tr["params"], jr["params"], END_RTOL, END_ATOL)


def test_weight_decay_has_no_effect_in_training(corpora, tmp_path):
    """The reference package's steps call loss without max_len, so an l2
    weight decay in the config changes nothing; the port keeps that."""
    plain = train_both(corpora, tmp_path / "a")
    decayed = [dict(spec) for spec in recipe(tmp_path)["layers"]]
    for spec in decayed:
        spec.update({"weight-decay": "l2", "weight-decay-factor": 0.5})
    wd = train_both(corpora, tmp_path / "b", layers=decayed)
    for got, ref in ((wd[2]["params"], plain[2]["params"]), (wd[0]["params"], plain[0]["params"])):
        for n in ref:
            for k in ("W", "b"):
                np.testing.assert_array_equal(np.asarray(got[n][k]), np.asarray(ref[n][k]))


def test_compute_prior_from_alignment_bit_equal():
    states, _, _ = tio.read_alignment(TARGETS)
    jstates, _, _ = jio.read_alignment(TARGETS)
    got = ttr.compute_prior_from_alignment(states, 106)
    np.testing.assert_array_equal(got, jtr.compute_prior_from_alignment(jstates, 106))
    assert got.dtype == np.float64 and abs(got.sum() - 1.0) < 1e-12


def test_trainer_defaults_to_the_card(corpora, tmp_path, monkeypatch):
    cfg = recipe(tmp_path)
    _, tb = builders(corpora, cfg)
    mlp = tnn.MLP(tnn.layer_specs_from_config(tcfg.Configuration(cfg)), 75, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.NnTrainer(tcfg.Configuration(cfg), tb, mlp)
