"""The port's bigram word-loop decoder (speechrecognition_torch/search/
ngram_decoder.py) against the JAX package's on the same acoustic scores.

The plain version of kernel J is bit-equal to JAX's ``_decode_scan_bigram``
(books, backpointers, predecessors and offsets) in float32 and float64,
pruned and unpruned, on the demo scores, on random scores with integer ties
and on a repetition-1 lexicon; ``decode_batch_bigram`` gives JAX's
transcripts on the 35 demo utterances with the demo bigram LM; with the
uniform LM it gives the golden word-loop transcripts.

tests/fixtures/demo_bigram_lm.json is the bigram LM of tests/test_wcts.py
(CountLM(order=2) on the demo transcripts, scale 8; silence free), which
``test_bigram_lm_fixture_rebuilds`` rebuilds with the JAX package. Write it
anew with ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ngram.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.lexicon import build_sietill_lexicon as jbuild_lexicon
from speechrecognition_tpu.lm.ngram import CountLM
from speechrecognition_tpu.search import decoder as jdec
from speechrecognition_tpu.search import ngram_decoder as jng
from speechrecognition_tpu.tdp import TdpModel as JTdp

from speechrecognition_torch.search import decoder as tdec
from speechrecognition_torch.search import ngram_decoder as tng
from torch_search_tables import (FIXTURES, am_scores, demo_bigram_lm, demo_setup, random_lm,
                                 repetition1_lexicon, uniform_lm)

torch.set_num_threads(1)
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def build_demo_bigram_lm(orths):
    """tests/test_wcts.py's construction on the given transcripts (lists of
    SieTill word indices)."""
    lexicon = jbuild_lexicon()
    lm_model = CountLM(order=2)
    for orth in orths:
        lm_model.add_sentence([lexicon.orth[w] for w in orth], grow_vocab=True)
    lm_model.estimate_discounts()
    W, sil, scale = lexicon.num_words, lexicon.silence_idx, 8.0
    ids = [lm_model.vocabulary.index(lexicon.orth[w]) for w in range(W)]
    lm = np.zeros((W, W))
    for v in range(W):
        for w in range(W):
            if v != sil and w != sil:
                lm[v, w] = scale * lm_model.score(ids[w], [ids[v]])
    lm[:, sil] = 0.0
    lm_start = np.zeros(W)
    for w in range(W):
        if w != sil:
            lm_start[w] = scale * lm_model.score(ids[w], [lm_model.vocabulary.start])
            lm[sil, w] = scale * lm_model.score(ids[w], [])
    return lm, lm_start


def demo_orths():
    """The transcripts as the JAX package's corpus description reads them."""
    from speechrecognition_tpu.corpus import CorpusDescription
    desc = CorpusDescription.read(str(FIXTURES / "demo_corpus.json"), jbuild_lexicon())
    return [list(seg.orth) for seg in desc.segments]


def test_bigram_lm_fixture_rebuilds():
    lm, lm_start = build_demo_bigram_lm(demo_orths())
    got_lm, got_start = demo_bigram_lm()
    assert got_lm.shape == (12, 12) and got_start.shape == (12,)
    assert np.array_equal(got_lm, lm) and np.array_equal(got_start, lm_start)
    assert np.isfinite(lm).all() and lm.max() > 0


@pytest.fixture(scope="module")
def demo():
    lex, corpus, tdp, model = demo_setup()
    feats, lens = corpus.padded_batch(list(range(corpus.num_segments)))
    am = {}
    for dtype in (torch.float32, torch.float64):
        pack = model.pack(dtype=dtype, device="cpu", method="pallas" if dtype == torch.float32
                          else "mxu")
        from speechrecognition_torch.models import gmm
        am[dtype] = gmm.am_scores(pack, torch.from_numpy(feats.reshape(-1, 25))).reshape(
            feats.shape[0], feats.shape[1], -1).to(dtype)
    return lex, corpus, tdp, feats, np.asarray(lens), am


def scan_args(tables, lm, lm_start):
    return (tables.state_table, tables.last_pos, tables.word_len, tables.tdp_within,
            tables.entry_pen, lm, lm_start)


def both_scans(am, lens, tables, lm, lm_start, prune):
    """(port outputs, JAX outputs) of the bigram scan on the same am."""
    a = scan_args(tables, lm, lm_start)
    got = tng.decode_scan_bigram(am, torch.as_tensor(lens, dtype=torch.int32),
                                 *map(torch.as_tensor, a), 200.0, prune=prune)
    jdt = JDT[am.dtype]
    want = jng._decode_scan_bigram(
        jnp.asarray(am.numpy(), jdt), jnp.asarray(lens, jnp.int32),
        jnp.asarray(tables.state_table), jnp.asarray(tables.last_pos),
        jnp.asarray(tables.word_len), jnp.asarray(tables.first_state),
        jnp.asarray(tables.tdp_within), jnp.asarray(tables.entry_pen), jnp.asarray(lm),
        jnp.asarray(lm_start), jnp.asarray(200.0, jdt), prune=prune)
    return got, want


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_bit_equal_on_demo_scores(demo, prune, dtype):
    lex, _corpus, tdp, _feats, lens, am = demo
    tables = tdec.DecoderTables.build(lex, tdp, 0.0)
    lm, lm_start = demo_bigram_lm()
    n = 12
    got, want = both_scans(am[dtype][:n].contiguous(), lens[:n], tables, lm, lm_start, prune)
    assert_bit_equal(got, want)


@pytest.mark.parametrize("case", ["ties", "repetition-1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_bit_equal_on_random_scores(case, dtype):
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.tdp import TdpModel
    lex = repetition1_lexicon() if case == "repetition-1" else build_sietill_lexicon()
    tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    tables = tdec.DecoderTables.build(lex, tdp, 0.0)
    lm, lm_start = random_lm(lex.num_words, seed=5)
    am = am_scores(5, 60, lex.num_states, seed=9, dtype=dtype)
    if case == "ties":
        am = am.round() % 3
        lm, lm_start = np.round(lm) % 2, np.round(lm_start) % 2
    lens = np.array([60, 41, 13, 0, 59], np.int32)
    got, want = both_scans(am, lens, tables, lm, lm_start, prune=True)
    assert_bit_equal(got, want)


@pytest.mark.parametrize("lm_kind", ["bigram", "uniform"])
def test_decode_batch_bigram_equals_jax(demo, lm_kind):
    """Transcripts of the 35 demo utterances equal JAX's on the same f64
    scores; with the uniform LM they are the golden word-loop transcripts."""
    lex, _corpus, tdp, feats, lens, am = demo
    lm, lm_start = demo_bigram_lm() if lm_kind == "bigram" else uniform_lm(lex)
    tables = tdec.DecoderTables.build(lex, tdp, 0.0)
    got = tng.decode_batch_bigram(None, feats, lens, tables, lm, lm_start, 200.0,
                                  lex.silence_idx, dtype=torch.float64, am=am[torch.float64])
    jl = jbuild_lexicon()
    jt = jdec.DecoderTables.build(jl, JTdp(silence_state=jl.silence_state, loop=3.0,
                                           forward=0.0, skip=30.0), 0.0)
    want = jng.decode_batch_bigram(None, feats, lens, jt, lm, lm_start, 200.0, jl.silence_idx,
                                   dtype=jnp.float64, am=jnp.asarray(am[torch.float64].numpy()))
    assert got == want
    if lm_kind == "uniform":
        with open(FIXTURES / "demo_recognition.json") as f:
            golden = {u["idx"]: u["hyp"] for u in json.load(f)["utts"]}
        assert got == [golden[b] for b in range(35)]


if __name__ == "__main__":
    lm, lm_start = build_demo_bigram_lm(demo_orths())
    with open(FIXTURES / "demo_bigram_lm.json", "w") as f:
        json.dump({"construction": "CountLM(order=2) on the transcripts of "
                                   "tests/fixtures/demo_corpus.json, scale 8, silence free "
                                   "(tests/test_wcts.py:41-64)",
                   "lm": lm.tolist(), "lm_start": lm_start.tolist()}, f, indent=1)
