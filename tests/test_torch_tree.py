"""The port's prefix-tree decoder (speechrecognition_torch/search/
tree_decoder.py) and ``search-type=tree`` against the JAX package.

``TreeTables`` equals JAX's arrays on the SieTill lexicon, on a lexicon whose
words share prefixes (word ends inside the tree, homophones) and on a
repetition-1 lexicon. The plain version of kernel I is bit-equal to JAX's
``_tree_scan`` on the same scores (float32 and float64, pruned and not).
The port's Recognizer with ``search-type=tree`` reproduces
tests/fixtures/demo_recognition.json in float32 "pallas" and float64, and
equals JAX's ``decode_batch_tree`` on the same scores; in df32 it raises.
The CLI's ``recognize`` takes ``search-type=tree`` and prints the golden WER
line.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.lexicon import build_sietill_lexicon as jbuild_lexicon
from speechrecognition_tpu.search import tree_decoder as jtree
from speechrecognition_tpu.tdp import TdpModel as JTdp

import speechrecognition_torch.cli as tcli
from speechrecognition_torch.config import Configuration
from speechrecognition_torch.models import gmm
from speechrecognition_torch.search import decoder as tdec
from speechrecognition_torch.search import tree_decoder as ttree
from speechrecognition_torch.tdp import TdpModel
from torch_search_tables import (DEMO_SETTINGS, FIXTURES, PrefixLexicon, am_scores, demo_setup,
                                 repetition1_lexicon)

torch.set_num_threads(1)
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
TABLE_FIELDS = ("state", "parent", "grand", "depth", "tdp", "loop_allowed", "end_word",
                "exit_penalty", "end_node")


def lexica(name):
    """(port lexicon, JAX lexicon, port TDPs, JAX TDPs) for a test lexicon;
    the duck-typed prefix lexicon serves both packages."""
    if name == "sietill":
        from speechrecognition_torch.lexicon import build_sietill_lexicon
        lex, jl = build_sietill_lexicon(), jbuild_lexicon()
        pen = (3.0, 0.0, 30.0)
    elif name == "prefix":
        lex = jl = PrefixLexicon(30, 1)
        pen = (2.0, 0.5, 9.0)
    else:
        lex = jl = repetition1_lexicon()
        pen = (2.0, 0.5, 9.0)
    return (lex, jl, TdpModel(lex.silence_state, *pen),
            JTdp(silence_state=jl.silence_state, loop=pen[0], forward=pen[1], skip=pen[2]))


@pytest.mark.parametrize("name", ["sietill", "prefix", "repetition-1"])
def test_tree_tables_equal_jax(name):
    lex, jl, tdp, jt = lexica(name)
    got = ttree.TreeTables.build(lex, tdp, 80.0)
    want = jtree.TreeTables.build(jl, jt, 80.0)
    assert (got.num_nodes, got.num_words) == (want.num_nodes, want.num_words)
    for f in TABLE_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    if name == "prefix":
        assert (got.depth == 1).sum() > 1 and ((got.end_word >= 0) & got.loop_allowed).any()


def both_tree_scans(tables, am, lens, prune):
    args = tables.device_args("cpu", am.dtype, am.shape[2])
    got = ttree.tree_scan(am, torch.as_tensor(lens, dtype=torch.int32), *args, 200.0,
                          prune=prune)
    jdt = JDT[am.dtype]
    want = jtree._tree_scan(jnp.asarray(am.numpy(), jdt), jnp.asarray(lens, jnp.int32),
                            *(jnp.asarray(getattr(tables, f)) for f in TABLE_FIELDS[:8]),
                            jnp.asarray(200.0, jdt), prune=prune)
    return got, want


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w, g = np.asarray(w), g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


@pytest.fixture(scope="module")
def demo():
    lex, corpus, tdp, model = demo_setup()
    feats, lens = corpus.padded_batch(list(range(corpus.num_segments)))
    am = {}
    for dtype, method in ((torch.float32, "pallas"), (torch.float64, "mxu")):
        pack = model.pack(dtype=dtype, device="cpu", method=method)
        am[dtype] = gmm.am_scores(pack, torch.from_numpy(feats.reshape(-1, 25))).reshape(
            feats.shape[0], feats.shape[1], -1).to(dtype)
    return lex, corpus, tdp, model, feats, np.asarray(lens), am


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_bit_equal_on_demo_scores(demo, prune, dtype):
    lex, _c, tdp, _m, _f, lens, am = demo
    tables = ttree.TreeTables.build(lex, tdp, 80.0)
    got, want = both_tree_scans(tables, am[dtype][:12].contiguous(), lens[:12], prune)
    assert_bit_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_bit_equal_on_a_prefix_tree(dtype):
    lex, _jl, tdp, _jt = lexica("prefix")
    tables = ttree.TreeTables.build(lex, tdp, 15.0)
    am = am_scores(5, 60, lex.num_states, seed=2, dtype=dtype)
    got, want = both_tree_scans(tables, am, np.array([60, 41, 13, 0, 59]), prune=True)
    assert_bit_equal(got, want)


def recognizer(lex, tdp, model, dtype, settings=DEMO_SETTINGS):
    cfg = Configuration({**settings, "search-type": "tree"})
    if dtype == "df32":
        return tdec.Recognizer(cfg, lex, tdp, model.pack_df(device="cpu"), dtype="df32")
    pack = model.pack(dtype=dtype, device="cpu",
                      method="pallas" if dtype == torch.float32 else "mxu")
    return tdec.Recognizer(cfg, lex, tdp, pack, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_recognizer_tree_reproduces_golden(demo, dtype):
    lex, corpus, tdp, model, _f, _l, _am = demo
    with open(FIXTURES / "demo_recognition.json") as f:
        golden = json.load(f)
    rec = recognizer(lex, tdp, model, dtype)
    before = ttree.tree_scan.LAUNCHES
    res = rec.recognize_corpus(corpus, batch_size=35)
    assert ttree.tree_scan.LAUNCHES == before       # the CPU takes the plain version
    assert [res["hyps"][u["idx"]] for u in golden["utts"]] == [u["hyp"] for u in golden["utts"]]
    ref = golden["corpus"]
    assert abs(res["wer"] - ref["wer"]) < 1e-5 and abs(res["ser"] - ref["ser"]) < 1e-9
    assert [res["substitutions"], res["insertions"], res["deletions"]] == ref["sid"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_decode_batch_tree_equals_jax(demo, dtype):
    """The traceback too, on the same scores (the JAX traceback walks the
    best-end tables even where the book is BIG; so does the port's)."""
    lex, _c, tdp, _m, feats, lens, am = demo
    tables = ttree.TreeTables.build(lex, tdp, 80.0)
    got = ttree.decode_batch_tree(None, feats, lens, tables, 200.0, lex.silence_idx,
                                  dtype=dtype, am=am[dtype])
    jl = jbuild_lexicon()
    jt = jtree.TreeTables.build(jl, JTdp(silence_state=jl.silence_state, loop=3.0,
                                         forward=0.0, skip=30.0), 80.0)
    want = jtree.decode_batch_tree(None, feats, lens, jt, 200.0, jl.silence_idx,
                                   dtype=JDT[dtype], am=jnp.asarray(am[dtype].numpy()))
    assert got == want


def test_df32_has_no_tree_path(demo):
    lex, _c, tdp, model, _f, _l, _am = demo
    with pytest.raises(ValueError, match="df32 has no tree path"):
        recognizer(lex, tdp, model, "df32")


def test_cli_recognize_tree(tmp_path):
    cfg = {"corpus": str(FIXTURES / "demo_corpus.json"),
           "feature-path": str(FIXTURES / "demo_features") + "/",
           "normalization-path": str(FIXTURES / "normalization-demo.bin"),
           "load-mixtures-from": str(FIXTURES / "iter-2.mix"), "pooling": "mixture",
           "tdp-loop": 3.0, "tdp-forward": 0.0, "tdp-skip": 30.0, "search-type": "tree",
           **DEMO_SETTINGS}
    path = tmp_path / "tree.json"
    path.write_text(json.dumps(cfg))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main([str(path), "recognize", "--device", "cpu"])
    assert rc in (0, None)
    assert "WER: 19.587629% (S/I/D) 4/14/1" in err.getvalue().splitlines()


def test_recognizer_tree_with_the_nn_scorer():
    """search-type=tree decodes the NN scorer's scores too (as the reference
    package's Recognizer does); on SieTill's tree, which has no shared
    prefixes, it gives tests/fixtures/demo_recognition_nn.json's transcripts."""
    from speechrecognition_torch.models import nn as tnn
    from torch_search_tables import REPO
    with open(REPO / "bench" / "nn_run" / "model.json") as f:
        m = json.load(f)
    lex, corpus, _tdp, _model = demo_setup()
    mlp = tnn.MLP(tnn.layer_specs_from_config(Configuration({"layers": m["layers"]})),
                  input_dim=25 * (2 * m["context_frames"] + 1), device="cpu")
    mlp.load(str(REPO / m["model_path"]) + "/")
    prior = tnn.NNScorer.load_prior(str(REPO / m["prior_file"]), lex.num_states,
                                    m["prior_scale"], device="cpu")
    tdp = TdpModel(lex.silence_state, *m["tdp"])
    cfg = Configuration({"am-threshold": m["am_threshold"], "word-penalty": m["word_penalty"],
                         "pruned-search": True, "max-recognition-runs": 10 ** 9,
                         "search-type": "tree"})
    rec = tdec.Recognizer(cfg, lex, tdp, dtype=torch.float32)
    rec.nn_scorer = tnn.NNScorer(mlp, prior, m["context_frames"])
    before = ttree.tree_scan.LAUNCHES
    res = rec.recognize_corpus(corpus, batch_size=35)
    assert ttree.tree_scan.LAUNCHES == before
    with open(FIXTURES / "demo_recognition_nn.json") as f:
        fixture = json.load(f)
    assert [res["hyps"][u["idx"]] for u in fixture["utts"]] == [u["hyp"] for u in fixture["utts"]]
