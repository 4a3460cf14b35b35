"""The port's word-conditioned tree search (speechrecognition_torch/search/
wcts.py) against the JAX package's on the same acoustic scores.

Tables: ``build_entry_tables`` (also on a repetition-1 lexicon, where the
entered node's state is not the word's first state, and with a Sprint-style
transition model), ``LookaheadTables`` (with and without a cutoff) and
``extend_lm`` equal JAX's arrays. The plain version of kernel K is bit-equal
to JAX's ``_wcts_scan`` (carry and every output) over every option, in
float32 and float64, over two chunks with carry, on the demo scores and on a
tree with shared prefixes. On the 35 demo utterances: the uniform LM gives
the golden transcripts; with the demo bigram LM WCTS equals the port's
bigram decode, pruned and unpruned; lookahead changes no transcript; a state
limit of 10^6 changes nothing and 48 keeps at least 8 of 10;
``decode_batch_wcts`` (lattices, statistics, transparent silence) equals
JAX's.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.lexicon import build_sietill_lexicon as jbuild_lexicon
from speechrecognition_tpu.search import tree_decoder as jtree
from speechrecognition_tpu.search import wcts as jw
from speechrecognition_tpu.tdp import TdpModel as JTdp

from speechrecognition_torch.models import gmm
from speechrecognition_torch.search import decoder as tdec
from speechrecognition_torch.search import ngram_decoder as tng
from speechrecognition_torch.search import tree_decoder as ttree
from speechrecognition_torch.search import wcts as tw
from speechrecognition_torch.tdp import TdpModel
from torch_search_tables import (FIXTURES, PrefixLexicon, am_scores, demo_bigram_lm, demo_setup,
                                 prefix_tdp, random_lm, repetition1_lexicon, uniform_lm)

torch.set_num_threads(1)
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
OPTIONS = {
    "pruned": {},
    "unpruned": {"prune": False},
    "lookahead": {"use_lookahead": True},
    "limit-48": {"state_limit": 48, "histogram_bins": 101},
    "limit-la-17-bins": {"use_lookahead": True, "state_limit": 30, "histogram_bins": 17},
    "limit-1e6": {"state_limit": 10 ** 6},
    "ends-stats": {"emit_ends": True, "emit_stats": True},
    "silence": {"transparent_silence": 0, "use_lookahead": True, "emit_stats": True},
    "everything": {"transparent_silence": 0, "use_lookahead": True, "state_limit": 40,
                   "emit_ends": True, "emit_stats": True},
}


def jax_tdp(tdp):
    return JTdp(silence_state=tdp.silence_state, loop=tdp.loop, forward=tdp.forward,
                skip=tdp.skip)


@pytest.mark.parametrize("name", ["sietill", "repetition-1", "prefix", "sprint"])
def test_entry_tables_equal_jax(name):
    if name == "sietill":
        from speechrecognition_torch.lexicon import build_sietill_lexicon
        lex, jl = build_sietill_lexicon(), jbuild_lexicon()
    else:
        lex = jl = repetition1_lexicon() if name == "repetition-1" else PrefixLexicon(30, 1)
    tdp = TdpModel(lex.silence_state, 2.0, 0.5, 9.0)
    tables = ttree.TreeTables.build(lex, tdp, 0.0)
    jtables = jtree.TreeTables.build(jl, jax_tdp(tdp), 0.0)
    if name == "sprint":
        model = SimpleNamespace(entry_m1=SimpleNamespace(forward=1.5, skip=np.inf), scale=2.0)
        got, want = tw.build_entry_tables(tables, model), jw.build_entry_tables(jtables, model)
    else:
        got = tw.build_entry_tables(tables, tdp)
        want = jw.build_entry_tables(jtables, jax_tdp(tdp))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    if name == "repetition-1":
        # the skip entry lands in the word's second state and pays its emission
        d2 = tables.depth == 2
        assert (got[0][d2] != tables.state[tables.parent[d2]]).all()


@pytest.mark.parametrize("cutoff", [None, 1, 3])
@pytest.mark.parametrize("name", ["sietill", "prefix"])
def test_lookahead_tables_equal_jax(name, cutoff):
    if name == "sietill":
        from speechrecognition_torch.lexicon import build_sietill_lexicon
        lex, jl = build_sietill_lexicon(), jbuild_lexicon()
    else:
        lex = jl = PrefixLexicon(30, 1)
    tdp = TdpModel(lex.silence_state, 2.0, 0.5, 9.0)
    got = tw.LookaheadTables.build(ttree.TreeTables.build(lex, tdp, 0.0), cutoff)
    want = jw.LookaheadTables.build(jtree.TreeTables.build(jl, jax_tdp(tdp), 0.0), cutoff)
    assert got.num_tables == want.num_tables
    assert np.array_equal(got.node_id, want.node_id.reshape(-1))
    assert np.array_equal(got.word_sets, want.word_sets)
    lm, lm_start = random_lm(lex.num_words, seed=3)
    lm_ext = tw.extend_lm(lm, lm_start)
    assert np.array_equal(lm_ext, jw.extend_lm(lm, lm_start))
    assert np.array_equal(got.scores(lm_ext), want.scores(lm_ext))


@pytest.fixture(scope="module")
def demo():
    lex, corpus, tdp, model = demo_setup()
    feats, lens = corpus.padded_batch(list(range(corpus.num_segments)))
    am = {}
    for dtype, method in ((torch.float32, "pallas"), (torch.float64, "mxu")):
        pack = model.pack(dtype=dtype, device="cpu", method=method)
        am[dtype] = gmm.am_scores(pack, torch.from_numpy(feats.reshape(-1, 25))).reshape(
            feats.shape[0], feats.shape[1], -1).to(dtype)
    jl = jbuild_lexicon()
    return lex, jl, corpus, tdp, feats, np.asarray(lens), am


def both_scans(lex, jl, tdp, lm, lm_start, am, lens, opts, chunks):
    """(port [carry..., outs...], JAX [carry..., outs...]) over the chunks."""
    la = opts.get("use_lookahead", False)
    tables = ttree.TreeTables.build(lex, tdp, 0.0)
    wt = tw.WctsTables.build(tables, tdp, lm, lm_start,
                             tw.LookaheadTables.build(tables) if la else None)
    jt = jtree.TreeTables.build(jl, jax_tdp(tdp), 0.0)
    es, ep = jw.build_entry_tables(jt, jax_tdp(tdp))
    lm_ext = jw.extend_lm(lm, lm_start)
    jla = (jw.LookaheadTables.build(jt).scores(lm_ext) if la
           else np.zeros((lm_ext.shape[0], jt.num_nodes)))
    jargs = [jnp.asarray(a) for a in (jt.state, jt.parent, jt.grand, jt.tdp, jt.loop_allowed,
                                      es, ep, jt.end_node, lm_ext, jla)]
    targs = wt.args("cpu", am.dtype, am.shape[2])
    jdt = JDT[am.dtype]
    lens_t = torch.as_tensor(lens, dtype=torch.int32)
    tc = jc = None
    touts, jouts, t0 = [], [], 0
    for n in chunks:
        piece = am[:, t0:t0 + n].contiguous()
        tc, to = tw.wcts_scan(piece, lens_t, *targs, 200.0, carry_in=tc, t0=t0, **opts)
        jc, jo = jw._wcts_scan(jnp.asarray(piece.numpy(), jdt), jnp.asarray(lens, jnp.int32),
                               *jargs, jnp.asarray(200.0, jdt), carry_in=jc,
                               t0=jnp.asarray(t0, jnp.int32), **opts)
        touts.append(to)
        jouts.append(jo)
        t0 += n
    got = [x.numpy() for x in tc] + [torch.cat([o[k] for o in touts]).numpy()
                                     for k in range(len(touts[0]))]
    want = [np.asarray(x) for x in jc] + [np.concatenate([np.asarray(o[k]) for o in jouts])
                                          for k in range(len(jouts[0]))]
    return got, want


def assert_bit_equal(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_bit_equal_on_demo_scores(demo, option, dtype):
    lex, jl, _c, tdp, _f, lens, am = demo
    lm, lm_start = demo_bigram_lm()
    n = 10
    a = am[dtype][:n, :300]
    got, want = both_scans(lex, jl, tdp, lm, lm_start, a, np.minimum(lens[:n], 300),
                           OPTIONS[option], (128, 172))
    assert_bit_equal(got, want)
    if option == "limit-48":
        # the state limit prunes here: fewer live slots than the beam alone
        base, _ = both_scans(lex, jl, tdp, lm, lm_start, a, np.minimum(lens[:n], 300),
                             {"emit_stats": True}, (300,))
        limited, _ = both_scans(lex, jl, tdp, lm, lm_start, a, np.minimum(lens[:n], 300),
                                {"emit_stats": True, **OPTIONS[option]}, (300,))
        assert limited[9].sum() < base[9].sum()


@pytest.mark.parametrize("option", ["pruned", "lookahead", "limit-la-17-bins", "everything"])
def test_scan_bit_equal_on_a_prefix_tree(option):
    lex = PrefixLexicon(30, 1)
    lm, lm_start = random_lm(lex.num_words, seed=4)
    am = am_scores(5, 60, lex.num_states, seed=6, dtype=torch.float32)
    got, want = both_scans(lex, lex, prefix_tdp(lex), lm, lm_start, am,
                           np.array([60, 41, 13, 0, 59], np.int32), OPTIONS[option], (27, 33))
    assert_bit_equal(got, want)


def golden_hyps():
    with open(FIXTURES / "demo_recognition.json") as f:
        return {u["idx"]: u["hyp"] for u in json.load(f)["utts"]}


def wcts(demo, lm, lm_start, n=35, dtype=torch.float64, **kw):
    lex, _jl, _c, tdp, feats, lens, am = demo
    tables = ttree.TreeTables.build(lex, tdp, 0.0)
    return tw.decode_batch_wcts(None, feats[:n], lens[:n], tables, tdp, lm, lm_start, 200.0,
                                lex.silence_idx, dtype=dtype, am=am[dtype][:n], **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniform_lm_reproduces_golden(demo, dtype):
    lex = demo[0]
    hyps = wcts(demo, *uniform_lm(lex), dtype=dtype)
    golden = golden_hyps()
    assert hyps == [golden[b] for b in range(35)]


@pytest.mark.parametrize("prune", [True, False])
def test_bigram_lm_equals_bigram_decode(demo, prune):
    lex, _jl, _c, tdp, feats, lens, am = demo
    lm, lm_start = demo_bigram_lm()
    lin = tng.decode_batch_bigram(None, feats, lens, tdec.DecoderTables.build(lex, tdp, 0.0),
                                  lm, lm_start, 200.0, lex.silence_idx, prune=prune,
                                  dtype=torch.float64, am=am[torch.float64])
    assert wcts(demo, lm, lm_start, prune=prune) == lin


def test_lookahead_changes_no_transcript(demo):
    lex, _jl, _c, tdp, *_ = demo
    lm, lm_start = demo_bigram_lm()
    la = tw.LookaheadTables.build(ttree.TreeTables.build(lex, tdp, 0.0))
    assert wcts(demo, lm, lm_start, lookahead=la) == wcts(demo, lm, lm_start)


def test_state_limit(demo):
    lex = demo[0]
    lm, lm_start = uniform_lm(lex)
    base = wcts(demo, lm, lm_start, n=10)
    assert wcts(demo, lm, lm_start, n=10, state_limit=10 ** 6) == base
    tight = wcts(demo, lm, lm_start, n=10, state_limit=48)
    assert sum(t == b for t, b in zip(tight, base)) >= 8


@pytest.mark.parametrize("transparent", [False, True])
def test_decode_batch_wcts_equals_jax(demo, transparent):
    """Transcripts, lattices (as arc tuples) and statistics of the 12 first
    utterances equal JAX's decode_batch_wcts on the same f64 scores."""
    lex, jl, _c, tdp, feats, lens, am = demo
    lm, lm_start = demo_bigram_lm()
    n = 12
    tables = ttree.TreeTables.build(lex, tdp, 0.0)
    la = tw.LookaheadTables.build(tables)
    got = tw.decode_batch_wcts(None, feats[:n], lens[:n], tables, tdp, lm, lm_start, 200.0,
                               lex.silence_idx, lookahead=la, dtype=torch.float64,
                               am=am[torch.float64][:n], emit_lattice=True, emit_stats=True,
                               transparent_silence=transparent)
    jt = jtree.TreeTables.build(jl, jax_tdp(tdp), 0.0)
    want = jw.decode_batch_wcts(None, feats[:n], lens[:n], jt, jax_tdp(tdp), lm, lm_start,
                                200.0, jl.silence_idx, lookahead=jw.LookaheadTables.build(jt),
                                dtype=jnp.float64, am=jnp.asarray(am[torch.float64][:n].numpy()),
                                emit_lattice=True, emit_stats=True,
                                transparent_silence=transparent)
    assert got[0] == want[0]
    for lg, lw in zip(got[1], want[1]):
        assert [tuple(vars(a).values()) for a in lg.arcs] == \
            [tuple(vars(a).values()) for a in lw.arcs]
    for key in ("active_states", "active_trees", "word_ends"):
        assert np.array_equal(got[2][key], np.asarray(want[2][key])), key


def test_histogram_pruning_ranks_by_prospect():
    """tests/test_wcts.py's construction through the port: with lookahead
    and state_limit 1 the survivor is the word with the better prospect
    (5 + 0) rather than the better raw score (0 + 100)."""
    big = float(tdec.BIG)
    f64 = torch.float64
    am = torch.tensor([[[5.0, 0.0], [0.0, 0.0]]], dtype=f64)
    args = (torch.tensor([0, 0, 1]), torch.tensor([0, 0, 0]), torch.tensor([0, 0, 0]),
            torch.zeros((3, 3), dtype=f64), torch.tensor([False, True, True]),
            torch.tensor([0, 0, 1]), torch.tensor([big, 0.0, 0.0], dtype=f64),
            torch.tensor([1, 2]), torch.tensor([[0.0, 100.0]] * 3, dtype=f64),
            torch.tensor([[0.0, 0.0, 100.0]] * 3, dtype=f64))
    _c, (books, *_rest) = tw.wcts_scan(am, torch.tensor([2], dtype=torch.int32), *args, 200.0,
                                       use_lookahead=True, state_limit=1, histogram_bins=101)
    assert books[0, 0, 0] < big * 0.5 and books[0, 0, 1] >= big * 0.5
