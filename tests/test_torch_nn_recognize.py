"""The port's NN hybrid recognizer (Recognizer with an NNScorer, kernel B's
plain version on the CPU) against the JAX package's, on the 35 demo
utterances of tests/fixtures/demo_corpus.json.

tests/fixtures/demo_recognition_nn.json holds the JAX package's NN
Recognizer output with bench/nn_run/model.json's model and settings (1×150
tanh, context 2, bench/nn_tanh/models_r/24/, prior bench/nn_tanh/prior.txt
at scale 1.2, TDP 4-0-30, word penalty 105, threshold 200) in float32.
The card's check (chip_smoke.py, which has no JAX) reads it. Written by

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_nn_recognize.py

and held equal to the JAX package's output here. Transcripts, WER, SER and
S/I/D must be equal, not close: the MLP's scores agree within 1e-5 across
the packages (tests/test_torch_nn.py), and no decision of these decodes
lies that close.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.config as jcfg
import speechrecognition_tpu.corpus as jcorpus
import speechrecognition_tpu.features.frontend as jfront
import speechrecognition_tpu.lexicon as jlex
import speechrecognition_tpu.models.nn as jnn
import speechrecognition_tpu.search.decoder as jdec
import speechrecognition_tpu.tdp as jtdp

import speechrecognition_torch.config as tcfg
import speechrecognition_torch.convert as tconv
import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.nn as tnn
import speechrecognition_torch.search.decoder as tdec
import speechrecognition_torch.tdp as ttdp

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
FIXTURE = FIX / "demo_recognition_nn.json"
KEYS = ("wer", "ser", "substitutions", "insertions", "deletions", "num_decoded")


def model_json():
    """bench/nn_run/model.json's model and decode settings."""
    with open(REPO / "bench" / "nn_run" / "model.json") as f:
        m = json.load(f)
    return {"layers": m["layers"], "model-path": str(REPO / m["model_path"]) + "/",
            "prior-file": str(REPO / m["prior_file"]), "prior-scale": m["prior_scale"],
            "context-frames": m["context_frames"], "tdp": m["tdp"],
            "word-penalty": m["word_penalty"], "am-threshold": m["am_threshold"]}


def recognize_nn_config():
    """bench/nn_run/recognize_nn.config's model and settings (1×150 sigmoid,
    bench/nn_run/models/20/, prior scale 0.0), its paths in the repo."""
    with open(REPO / "bench" / "nn_run" / "recognize_nn.config") as f:
        c = json.load(f)
    return {"layers": c["layers"], "model-path": str(REPO / "bench/nn_run/models/20") + "/",
            "prior-file": str(REPO / "bench/nn_run/prior.txt"), "prior-scale": c["prior-scale"],
            "context-frames": c["context-frames"],
            "tdp": [c["tdp-loop"], c["tdp-forward"], c["tdp-skip"]],
            "word-penalty": c["word-penalty"], "am-threshold": c["am-threshold"]}


def read_corpus(pkg_corpus, pkg_front, lexicon, **kw):
    desc = pkg_corpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lexicon)
    return pkg_corpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                  pkg_front.SignalAnalysisConfig(),
                                  normalization_path=str(FIX / "normalization-demo.bin"), **kw)


def nn_recognizer(port, m, dtype, pack=None):
    """Each package's Recognizer with the NN scorer of ``m``."""
    cfg_m, corpus_m, front_m, lex_m, dec_m, tdp_m, nn_m = (
        (tcfg, tcorpus, tfront, tlex, tdec, ttdp, tnn) if port
        else (jcfg, jcorpus, jfront, jlex, jdec, jtdp, jnn))
    dev = {"device": "cpu"} if port else {}
    lex = lex_m.build_sietill_lexicon()
    mlp = nn_m.MLP(nn_m.layer_specs_from_config(cfg_m.Configuration({"layers": m["layers"]})),
                   input_dim=25 * (2 * m["context-frames"] + 1), **dev)
    params = mlp.load(m["model-path"])
    with np.errstate(divide="ignore", invalid="ignore"):
        prior = nn_m.NNScorer.load_prior(m["prior-file"], lex.num_states, m["prior-scale"], **dev)
    loop, forward, skip = m["tdp"]
    tdp = tdp_m.TdpModel(silence_state=lex.silence_state, loop=loop, forward=forward, skip=skip)
    settings = cfg_m.Configuration({"am-threshold": m["am-threshold"],
                                    "word-penalty": m["word-penalty"], "pruned-search": True,
                                    "max-recognition-runs": 10 ** 9})
    rec = dec_m.Recognizer(settings, lex, tdp, pack, dtype=dtype)
    # the port's scorer reads its module's weights; JAX's takes the pytree
    weights = () if port else (params,)
    rec.nn_scorer = nn_m.NNScorer(mlp, *weights, prior, m["context-frames"])
    kw = {} if port else {"use_native": False}
    return rec, read_corpus(corpus_m, front_m, lex, **kw)


def recognize(port, m, dtype):
    rec, corpus = nn_recognizer(port, m, dtype)
    return rec.recognize_corpus(corpus, batch_size=35)


def fixture_from(res, m):
    return {"utts": [{"idx": s, "hyp": res["hyps"][s]} for s in sorted(res["hyps"])],
            "corpus": {"wer": res["wer"], "ser": res["ser"],
                       "sid": [res["substitutions"], res["insertions"], res["deletions"]]},
            "config": {**{k: v for k, v in m.items() if k not in ("model-path", "prior-file")},
                       "model-path": "bench/nn_tanh/models_r/24/",
                       "prior-file": "bench/nn_tanh/prior.txt", "dtype": "float32",
                       "made-by": "speechrecognition_tpu Recognizer with NNScorer, CPU"}}


@pytest.fixture(scope="module")
def results():
    """(kind, package) → recognize_corpus result, each computed once."""
    cache = {}

    def get(kind, port):
        if (kind, port) not in cache:
            m = recognize_nn_config() if kind == "models20" else model_json()
            if kind == "f64":
                dtype = torch.float64 if port else jnp.float64
            else:
                dtype = torch.float32 if port else jnp.float32
            cache[kind, port] = recognize(port, m, dtype)
        return cache[kind, port]

    return get


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def assert_matches_fixture(res, fix):
    assert res["num_decoded"] == len(fix["utts"]) == 35
    assert {u["idx"]: u["hyp"] for u in fix["utts"]} == res["hyps"]
    assert res["wer"] == fix["corpus"]["wer"] and res["ser"] == fix["corpus"]["ser"]
    assert [res["substitutions"], res["insertions"], res["deletions"]] == fix["corpus"]["sid"]


def test_jax_nn_recognizer_reproduces_the_fixture(results, fixture):
    assert fixture_from(results("model", False), model_json()) == fixture


def test_port_nn_recognizer_reproduces_the_fixture(results, fixture):
    assert_matches_fixture(results("model", True), fixture)


@pytest.mark.parametrize("kind", ["models20", "f64"])
def test_port_equals_jax(results, kind):
    """recognize_nn.config's sigmoid model at prior scale 0.0, and the f64
    NN decode (f64 scan on the MLP's f32 scores cast up), against JAX."""
    res, jres = results(kind, True), results(kind, False)
    assert res["hyps"] == jres["hyps"]
    for key in KEYS:
        assert res[key] == jres[key], key


def test_f64_agrees_with_f32_on_the_demo(results):
    assert results("f64", True)["hyps"] == results("model", True)["hyps"]


def test_converted_scorer_decodes_as_jax(results):
    """convert.nn_scorer_from_jax carries the JAX scorer across."""
    jrec, _ = nn_recognizer(False, model_json(), jnp.float32)
    rec, corpus = nn_recognizer(True, model_json(), torch.float32)
    rec.nn_scorer = tconv.nn_scorer_from_jax(jrec.nn_scorer, device="cpu")
    assert rec.recognize_corpus(corpus, batch_size=35)["hyps"] == results("model", False)["hyps"]


def test_nn_recognizer_runs_on_the_scorers_device():
    rec, corpus = nn_recognizer(True, model_json(), torch.float32)
    assert rec.pack is None and rec.device.type == "cpu"
    rec.warmup(corpus, batch_size=2)


def test_df32_with_an_nn_scorer_raises():
    """The reference package's df32 branch decodes with the GMM pack and
    ignores its nn_scorer; the port refuses instead."""
    import speechrecognition_torch.io as tio
    import speechrecognition_torch.models.gmm as tgmm
    model = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                       tgmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    rec, corpus = nn_recognizer(True, model_json(), "df32", pack=model.pack_df(device="cpu"))
    with pytest.raises(ValueError, match="df32 has no NN path"):
        rec.recognize_corpus(corpus, batch_size=35)
    with pytest.raises(TypeError, match="ScorePackDF"):
        nn_recognizer(True, model_json(), "df32")


if __name__ == "__main__":
    res = recognize(False, model_json(), jnp.float32)
    with open(FIXTURE, "w") as f:
        json.dump(fixture_from(res, model_json()), f, indent=1)
        f.write("\n")
    print(f"wrote {FIXTURE}: WER {res['wer']:.6f}% S/I/D {res['substitutions']}/"
          f"{res['insertions']}/{res['deletions']}")
