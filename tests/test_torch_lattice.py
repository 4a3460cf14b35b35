"""The port's word and context lattices (speechrecognition_torch/search/
lattice.py, context_lattice.py; host numpy) against the JAX package's on the
same arrays: the lattices the port's scans emit on the demo scores are built
by both packages' classes, and every method gives the same result (floats
within 1e-12 relative): best path and words, LM rescoring, forward-backward
posteriors, posterior pruning, oracle WER, per-arc time alignment, the
projection to a word lattice; for word lattices also n-best and word arcs.
The port's lattice best path equals its decoder's 1-best."""

import math

import pytest
import torch

from speechrecognition_tpu.search import context_lattice as jcl
from speechrecognition_tpu.search import lattice as jlat

from speechrecognition_torch.models import gmm
from speechrecognition_torch.search import decoder as tdec
from speechrecognition_torch.search import lattice as tlat
from speechrecognition_torch.search import ngram_decoder as tng
from speechrecognition_torch.search import tree_decoder as ttree
from speechrecognition_torch.search import wcts as tw
from torch_search_tables import demo_bigram_lm, demo_setup, uniform_lm

torch.set_num_threads(1)
N = 8


def close(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= 1e-12 * max(1.0, abs(a), abs(b))
    return a == b


def arcs(lat):
    return [tuple(vars(a).values()) for a in lat.arcs]


@pytest.fixture(scope="module")
def demo():
    lex, corpus, tdp, model = demo_setup()
    feats, lens = corpus.padded_batch(list(range(N)))
    pack = model.pack(dtype=torch.float64, device="cpu", method="mxu")
    am = gmm.am_scores(pack, torch.from_numpy(feats.reshape(-1, 25))).reshape(
        feats.shape[0], feats.shape[1], -1)
    lm, lm_start = demo_bigram_lm()
    tables = ttree.TreeTables.build(lex, tdp, 0.0)
    hyps, lats = tw.decode_batch_wcts(None, feats, lens, tables, tdp, lm, lm_start, 200.0,
                                      lex.silence_idx, dtype=torch.float64, am=am,
                                      emit_lattice=True)
    lm_ext = tw.extend_lm(lm, lm_start)
    # the JAX package's lattices from the same arrays
    wt = tw.WctsTables.build(tables, tdp, lm, lm_start)
    _c, outs = tw.wcts_scan(am, torch.as_tensor(lens, dtype=torch.int32),
                            *wt.args("cpu", torch.float64, am.shape[2]), 200.0, emit_ends=True)
    books, _b, _p, offsets, cands, ebkps = (o.numpy() for o in outs)
    jlats = [jcl.ContextLattice.from_wcts(books[:, b], cands[:, b], ebkps[:, b],
                                          offsets[:, b], int(lens[b]), lm_ext,
                                          lex.silence_idx) for b in range(N)]
    # word lattices from the bigram scan's books
    dt = tdec.DecoderTables.build(lex, tdp, 0.0)
    lm0, start0 = uniform_lm(lex)
    args = [torch.as_tensor(a) for a in (dt.state_table, dt.last_pos, dt.word_len,
                                         dt.tdp_within, dt.entry_pen, lm0, start0)]
    sc, bk, _pr, off = (o.numpy() for o in tng.decode_scan_bigram(
        am, torch.as_tensor(lens, dtype=torch.int32), *args, 200.0))
    wl = [(tlat.WordLattice.from_books(sc[:, b], bk[:, b], off[:, b], int(lens[b]),
                                       silence=lex.silence_idx),
           jlat.WordLattice.from_books(sc[:, b], bk[:, b], off[:, b], int(lens[b]),
                                       silence=lex.silence_idx)) for b in range(N)]
    return lex, corpus, tdp, am, hyps, lats, jlats, lm_ext, wl


def test_context_lattices_equal_jax(demo):
    *_, hyps, lats, jlats, _lm, _wl = demo
    for b in range(N):
        assert arcs(lats[b]) == arcs(jlats[b])
        assert lats[b].best_words() == jlats[b].best_words() == hyps[b]


def test_context_lattice_methods_equal_jax(demo):
    lex, corpus, tdp, am, _h, lats, jlats, lm_ext, _wl = demo
    rescaled = lm_ext * 1.7
    for b in range(N):
        lat, jl = lats[b], jlats[b]
        assert close(lat.best_path(), jl.best_path())
        assert arcs(lat.lm_rescore(rescaled)) == arcs(jl.lm_rescore(rescaled))
        assert close(lat.best_path(lambda a: 2.0 * a.lm), jl.best_path(lambda a: 2.0 * a.lm))
        post, jpost = lat.forward_backward(), jl.forward_backward()
        assert close([post[a] for a in lat.arcs], [jpost[a] for a in jl.arcs])
        assert arcs(lat.posterior_prune(5.0)) == arcs(jl.posterior_prune(5.0))
        assert lat.oracle_wer(corpus.orths[b]) == jl.oracle_wer(corpus.orths[b])
        assert sorted(lat.nodes()) == sorted(jl.nodes())
        wl, jwl = lat.to_word_lattice(), jl.to_word_lattice()
        assert close(arcs(wl), arcs(jwl))
        # per-arc time alignment of the 1-best arcs
        _, back = lat._viterbi()
        node = min((s, n) for n, s in lat._viterbi()[0].items() if n[0] == lat.num_frames)[1]
        am_b = am[b].numpy()
        while back.get(node) is not None:
            a = back[node]
            aut = lex.get_automaton_for_word(a.word)
            tbl = tdp.table_for_states(aut.states[None, :])[0]
            pos = lat.time_align(a, am_b[a.start:a.end], aut.states, tbl)
            assert pos == jl.time_align(a, am_b[a.start:a.end], aut.states, tbl)
            node = (a.start, a.pred)


def test_word_lattice_methods_equal_jax(demo):
    lex, corpus, *_rest, wl = demo
    for b, (lat, jl) in enumerate(wl):
        assert arcs(lat) == arcs(jl)
        assert close(lat.best_path(), jl.best_path())
        assert close(lat.n_best(5), jl.n_best(5))
        fb, post = lat.forward_backward()
        jfb, jpost = jl.forward_backward()
        assert close(list(fb), list(jfb))
        assert close([post[a] for a in lat.arcs], [jpost[a] for a in jl.arcs])
        assert arcs(lat.posterior_prune(4.0)) == arcs(jl.posterior_prune(4.0))
        assert lat.oracle_wer(corpus.orths[b]) == jl.oracle_wer(corpus.orths[b])
        assert [tuple(vars(a).values()) for a in lat.word_arcs()] == \
            [tuple(vars(a).values()) for a in jl.word_arcs()]
