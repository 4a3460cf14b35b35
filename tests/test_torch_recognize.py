"""The port's recognition slice end to end on the CPU: Corpus.read →
MixtureModel.from_raw → pack(method="pallas") → Recognizer.recognize_corpus,
in float32, against the oracle's golden transcripts and against the JAX
package's Recognizer on the same inputs."""

import json
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
import speechrecognition_tpu.models.gmm as jgmm
import speechrecognition_tpu.search.decoder as jdec
import speechrecognition_tpu.tdp as jtdp

import speechrecognition_torch.config as tcfg
import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.gmm as tgmm
import speechrecognition_torch.search.decoder as tdec
import speechrecognition_torch.tdp as ttdp

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
# decode settings of demo_recognition.json and bench/model.mix.json
SETTINGS = {"am-threshold": 200.0, "word-penalty": 80.0, "pruned-search": True,
            "max-recognition-runs": 10000}
MODELS = {"iter-2": (FIX / "iter-2.mix", "MIXTURE_POOLING"),
          "bench": (REPO / "bench" / "model.mix", "NO_POOLING")}


def read_corpus(pkg_corpus, pkg_front, lexicon, **kw):
    desc = pkg_corpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lexicon)
    return pkg_corpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                  pkg_front.SignalAnalysisConfig(),
                                  normalization_path=str(FIX / "normalization-demo.bin"),
                                  **kw)


@pytest.fixture(scope="module")
def golden():
    with open(FIX / "demo_recognition.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port():
    lex = tlex.build_sietill_lexicon()
    return lex, read_corpus(tcorpus, tfront, lex)


def port_recognizer(lex, name, settings=SETTINGS, dtype=torch.float32):
    path, pooling = MODELS[name]
    model = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(path), 25),
                                       tgmm.VarianceModel[pooling], max_approx=True)
    tdp = ttdp.TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    return tdec.Recognizer(tcfg.Configuration(settings), lex, tdp,
                           model.pack(method="pallas", device="cpu"), dtype=dtype)


@pytest.fixture(scope="module")
def run_both(port):
    """name → (port result, JAX result) of the f32 "pallas" recognizer on the
    demo corpus, each computed once per module."""
    cache = {}

    def run(name):
        if name not in cache:
            lex, corpus = port
            res = port_recognizer(lex, name).recognize_corpus(corpus, batch_size=35)
            jl = jlex.build_sietill_lexicon()
            jc = read_corpus(jcorpus, jfront, jl, use_native=False)
            path, pooling = MODELS[name]
            model = jgmm.MixtureModel.from_raw(jio.read_mixture_set(str(path), 25),
                                               jgmm.VarianceModel[pooling], max_approx=True)
            tdp = jtdp.TdpModel(silence_state=jl.silence_state, loop=3.0, forward=0.0,
                                skip=30.0)
            jrec = jdec.Recognizer(jcfg.Configuration(SETTINGS), jl, tdp,
                                   model.pack(method="pallas"), dtype=jnp.float32)
            cache[name] = res, jrec.recognize_corpus(jc, batch_size=35)
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_equals_jax_recognizer(run_both, name):
    res, jres = run_both(name)
    assert res["num_decoded"] == jres["num_decoded"] == 35
    assert res["hyps"] == jres["hyps"]
    for key in ("wer", "ser", "substitutions", "insertions", "deletions",
                "audio_seconds", "coverage"):
        assert res[key] == jres[key], key


def test_port_reproduces_golden(run_both, golden):
    res, _ = run_both("iter-2")
    mismatches = [(u["idx"], res["hyps"][u["idx"]], u["hyp"]) for u in golden["utts"]
                  if res["hyps"][u["idx"]] != u["hyp"]]
    assert not mismatches
    ref = golden["corpus"]
    assert abs(res["wer"] - ref["wer"]) < 1e-5 and abs(res["ser"] - ref["ser"]) < 1e-9
    assert [res["substitutions"], res["insertions"], res["deletions"]] == ref["sid"]


def test_decode_batch_precomputed_am_and_padding(port, golden):
    """decode_batch with precomputed acoustic scores and a padded batch gives
    the same transcripts as scoring inside the decoder."""
    lex, corpus = port
    rec = port_recognizer(lex, "iter-2")
    ids = [0, 5, 34]
    feats, lens = corpus.padded_batch(ids, pad_to=701)
    am = tgmm.am_scores(rec.pack, torch.from_numpy(feats.reshape(-1, 25))).reshape(3, 701, -1)
    args = (rec.tables, rec.am_threshold, lex.silence_idx)
    got = tdec.decode_batch(rec.pack, feats, lens, *args, am=am)
    assert got == tdec.decode_batch(rec.pack, feats, lens, *args)
    assert got == [golden["utts"][i]["hyp"] for i in ids]


def test_warmup_runs(port):
    lex, corpus = port
    rec = port_recognizer(lex, "iter-2")
    rec.warmup(corpus, batch_size=2)


@pytest.mark.parametrize("what", ["tree"])
def test_unported_paths_raise(port, what):
    """The tree search is ported in float32 and float64; df32 has no tree
    path (the reference's df32 branch ignores the search type) and raises."""
    lex, _corpus = port
    path, pooling = MODELS["iter-2"]
    model = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(path), 25),
                                       tgmm.VarianceModel[pooling], max_approx=True)
    tdp = ttdp.TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    with pytest.raises(ValueError, match="df32 has no tree path"):
        tdec.Recognizer(tcfg.Configuration({**SETTINGS, "search-type": what}), lex, tdp,
                        model.pack_df(device="cpu"), dtype="df32")


def test_device_corpus_batch_equals_padded_batch(port):
    lex, corpus = port
    dc = tdec.DeviceCorpus(corpus, "cpu")
    ids = [7, 2, 30, 30]
    feats, _lens = corpus.padded_batch(ids, pad_to=704)
    np.testing.assert_array_equal(dc.batch(ids, 704).numpy(), feats)
