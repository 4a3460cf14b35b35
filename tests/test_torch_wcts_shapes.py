"""wcts_scan (kernel K's wrapper; on CPU tensors its plain version) against
the JAX package's ``_wcts_scan`` where kernel K's owner instance could break
ties by its fixed ownership of slots and its parallel reductions:

* a prefix tree of C 5 contexts x N 27 nodes (135 slots, no multiple of
  32), so warps and lanes own ragged runs of slots;
* LM rows that are all equal and integer scores with zero TDPs, so the word
  ends of many contexts tie and the recombination must take the first
  context;
* histogram pruning whose cumulative count reaches the state limit exactly
  at a bin edge: at frame 1 only the sentence start's tree is open, its
  entries' renormalised scores are integers and one bin is one integer
  (threshold 20, 21 bins), and the limit is the count of the first two bins;
* the statistics and every output with transparent silence, carried across
  two chunks (t0 > 0).

Float32 and float64, carry and every output bit-equal.
tests/test_torch_cuda.py holds the kernel against the plain version on the
same kinds of inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.search import tree_decoder as jtree
from speechrecognition_tpu.search import wcts as jw
from speechrecognition_tpu.tdp import TdpModel as JTdp

from speechrecognition_torch.search import tree_decoder as ttree
from speechrecognition_torch.search import wcts as tw
from speechrecognition_torch.search.decoder import BIG
from speechrecognition_torch.tdp import TdpModel
from torch_search_tables import PrefixLexicon

torch.set_num_threads(1)

B, T = 4, 12
CHUNKS = (5, 7)            # two chunks: the second starts at t0 = 5
LENS = np.array([T, 1, 0, T - 3], np.int32)
THR = 20.0
JDT = {"float32": jnp.float32, "float64": jnp.float64}


def lexicon():
    """4 words: a tree of 27 nodes, 5 contexts."""
    lex = PrefixLexicon(4, 4)
    return lex


def tdp_of(lex, flat):
    pen = (0.0, 0.0, 0.0) if flat else (2.0, 0.5, 9.0)
    return TdpModel(silence_state=lex.silence_state, loop=pen[0], forward=pen[1], skip=pen[2])


def frame1_limit(tables, am0, flat_tdp):
    """The state limit at which the first frame's histogram count reaches
    the limit exactly at the edge of its second bin: at frame 1 only the
    start context's entries are open (score entry_pen + emission of the
    entered node's state), renormalised by their minimum, one bin an integer."""
    entry_state, entry_pen = tw.build_entry_tables(tables, flat_tdp)
    s = entry_pen + am0[entry_state]
    s = s[(s < BIG * 0.5) & (np.arange(tables.num_nodes) != 0)]
    ps = s - s.min()
    n0, n1 = int((ps < 1).sum()), int(((ps >= 1) & (ps < 2)).sum())
    assert n0 + n1 < len(ps), "the limit must prune at frame 1"
    return n0 + n1


def case_inputs(case, dtype):
    """(lexicon, TDPs, lm [W, W], lm_start [W], am [B, T, S], options)."""
    lex = lexicon()
    W, S = lex.num_words, lex.num_states
    rng = np.random.default_rng(len(case))
    flat = case != "ragged"
    tdp = tdp_of(lex, flat)
    if case == "ragged":
        am = rng.uniform(0.0, 40.0, size=(B, T, S))
        lm, start = rng.uniform(0.0, 25.0, size=(W, W)), rng.uniform(0.0, 25.0, size=W)
        return lex, tdp, lm, start, am, {"use_lookahead": True, "emit_ends": True}
    am = rng.integers(0, 3, size=(B, T, S)).astype(np.float64)
    if case == "tied-rows":
        row = np.round(rng.uniform(0.0, 2.0, size=W))
        return lex, tdp, np.tile(row, (W, 1)), row.copy(), am, {"emit_ends": True,
                                                                "emit_stats": True}
    lm, start = np.round(rng.uniform(0.0, 2.0, size=(W, W))), np.round(rng.uniform(0, 2, W))
    if case == "bin-edge":
        am[:, 0] = am[0, 0]          # every utterance starts alike
        tables = ttree.TreeTables.build(lex, tdp, 0.0)
        limit = frame1_limit(tables, am[0, 0], tdp)
        return lex, tdp, lm, start, am, {"state_limit": limit, "histogram_bins": 21,
                                         "emit_stats": True}
    # "silence-stats": transparent silence, statistics and word ends with
    # the lookahead and a state limit, over two chunks
    return lex, tdp, lm, start, am, {"transparent_silence": 0, "use_lookahead": True,
                                     "state_limit": 12, "emit_ends": True, "emit_stats": True}


def jax_tdp(tdp):
    return JTdp(silence_state=tdp.silence_state, loop=tdp.loop, forward=tdp.forward,
                skip=tdp.skip)


def scans(case, dtype):
    """(port [carry..., outs...], JAX [carry..., outs...]) over CHUNKS."""
    lex, tdp, lm, start, am, opts = case_inputs(case, dtype)
    la = opts.get("use_lookahead", False)
    tables = ttree.TreeTables.build(lex, tdp, 0.0)
    wt = tw.WctsTables.build(tables, tdp, lm, start,
                             tw.LookaheadTables.build(tables) if la else None)
    jt = jtree.TreeTables.build(lex, jax_tdp(tdp), 0.0)
    es, ep = jw.build_entry_tables(jt, jax_tdp(tdp))
    lm_ext = jw.extend_lm(lm, start)
    jla = (jw.LookaheadTables.build(jt).scores(lm_ext) if la
           else np.zeros((lm_ext.shape[0], jt.num_nodes)))
    jargs = [jnp.asarray(a) for a in (jt.state, jt.parent, jt.grand, jt.tdp, jt.loop_allowed,
                                      es, ep, jt.end_node, lm_ext, jla)]
    td, jd = getattr(torch, dtype), JDT[dtype]
    targs = wt.args("cpu", td, am.shape[2])
    am_t = torch.from_numpy(am).to(td)
    lens_t = torch.from_numpy(LENS)
    tc = jc = None
    touts, jouts, t0 = [], [], 0
    for n in CHUNKS:
        piece = am_t[:, t0:t0 + n].contiguous()
        tc, to = tw.wcts_scan(piece, lens_t, *targs, THR, carry_in=tc, t0=t0, **opts)
        jc, jo = jw._wcts_scan(jnp.asarray(piece.numpy(), jd), jnp.asarray(LENS),
                               *jargs, jnp.asarray(THR, jd), carry_in=jc,
                               t0=jnp.asarray(t0, jnp.int32), **opts)
        touts.append(to)
        jouts.append(jo)
        t0 += n
    got = [x.numpy() for x in tc] + [torch.cat([o[k] for o in touts]).numpy()
                                     for k in range(len(touts[0]))]
    want = [np.asarray(x) for x in jc] + [np.concatenate([np.asarray(o[k]) for o in jouts])
                                          for k in range(len(jouts[0]))]
    return (tables.num_nodes, lm_ext.shape[0]), opts, got, want


@pytest.mark.parametrize("case", ["ragged", "tied-rows", "bin-edge", "silence-stats"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wcts_scan_equals_jax_where_ties_break(case, dtype):
    (N, C), opts, got, want = scans(case, dtype)
    assert (C, N) == (5, 27) and (C * N) % 32 != 0
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k
    assert got[0].dtype == np.dtype(dtype)
    if case == "tied-rows":
        # word ends tie across contexts: the book takes the first one
        cand, pred = got[9], got[7]                  # [T, B, C, W], [T, B, W]
        ties = (cand == cand.min(axis=2, keepdims=True)).sum(axis=2) > 1
        live = cand.min(axis=2) < BIG * 0.5
        assert (ties & live).any()
        first = (cand == cand.min(axis=2, keepdims=True)).argmax(axis=2)
        assert np.array_equal(pred, first)
    if case == "bin-edge":
        # the limit prunes frame 1 to exactly the first two bins' count
        states = got[9]                               # active states [T, B]
        assert (states[0, [0, 1, 3]] == opts["state_limit"]).all()
