"""The scans' plain versions with one NaN acoustic score, against the JAX
package on the same seeded inputs (the CPU wrappers run the plain versions).

One score of one live state is NaN, in utterance 0 of several, mid-way
through its frames. The reference keeps the NaN where its minimum and its
clamp meet it (``jnp.minimum`` and ``.min`` propagate a NaN, ``jnp.argmin``
takes the first NaN; the double-float scans fold by
``doublefloat.min_axis``, whose pairwise halving keeps a NaN only where it
is the second of a pair), so the NaN spreads through the utterance's
lattice from that frame on. Each case holds every output of the port's
plain version to JAX's: NaN equal to NaN, everything else bit for bit.
Kernels B and E in float32 and float64 (``decode_scan``,
``align_fwd_chunk``), D (``decode_scan_df``), I (``tree_scan``), J
(``decode_scan_bigram``), K (``wcts_scan``) and M
(``decode_scan_linear``). tests/test_torch_cuda.py holds the kernels
against these plain versions on the same kind of input.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.align.viterbi as jvit
import speechrecognition_tpu.search.decoder as jdec
import speechrecognition_tpu.search.ngram_decoder as jng
import speechrecognition_tpu.search.tree_decoder as jtree
from speechrecognition_tpu.ops import doublefloat as jdf
from speechrecognition_tpu.search import linear_lvcsr as jl
from speechrecognition_tpu.search import wcts as jw
from speechrecognition_tpu.tdp import TdpModel as JTdp

import speechrecognition_torch.align.viterbi as tvit
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.search.decoder as tdec
import speechrecognition_torch.search.ngram_decoder as tng
import speechrecognition_torch.search.tree_decoder as ttree
from speechrecognition_torch.ops import doublefloat as tdf
from speechrecognition_torch.search import linear_lvcsr as tl
from speechrecognition_torch.search import wcts as tw
from speechrecognition_torch.tdp import TdpModel
from test_torch_linear_lvcsr import jax_scan_args
from torch_linear_tables import linear_case
from torch_search_tables import PrefixLexicon, random_lm, random_tree, tree_scores

torch.set_num_threads(1)

B, T = 4, 12
CHUNKS = (5, 7)                  # two chunks: the NaN (frame index 6) in the second
LENS = np.array([T, 1, 0, T - 3], np.int32)
NAN_AT = (0, 6)                  # utterance 0, frame index 6 of 12
JDT = {"float32": jnp.float32, "float64": jnp.float64}
THR = 60.0


def assert_same(got, want, name):
    """Equal bit for bit, NaN counted equal to NaN (payload and sign
    aside), and the NaN pattern the same."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if got.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), name
    assert got[~nan].tobytes() == want[~nan].tobytes(), name


def assert_all_same(got, want, names, nan_out=True):
    """Every output the same; ``nan_out``: a NaN reaches some output."""
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert_same(g, w, name)
    floats = [np.asarray(g) for g in got if np.asarray(g).dtype.kind == "f"]
    assert any(np.isnan(g).any() for g in floats) == nan_out


def with_nan(am, state):
    am = np.array(am, np.float64)
    am[NAN_AT[0], NAN_AT[1], state] = np.nan
    return am


# -- kernel B (float32, float64) and D (double-float): the word-loop scan -------------


def word_loop_tables(W, P):
    """Silence plus W - 1 words of 2..P states with repetition 1."""
    rng = np.random.default_rng(W * 100 + P)
    lex = tlex.Lexicon()
    lex.add_word("[silence]", 1, 1, silence=True)
    for w in range(W - 1):
        lex.add_word(f"w{w}", P if w == 0 else int(rng.integers(2, P + 1)), 1)
    tdp = TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)
    tables = tdec.DecoderTables.build(lex, tdp, 15.0)
    assert tables.state_table.shape == (W, P)
    return tables, lex.num_states


def lex_arrays(tables):
    return (tables.state_table, tables.last_pos, tables.word_len, tables.first_state)


@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "unpruned"])
@pytest.mark.parametrize("W,P", [(4, 9), (33, 8)])
@pytest.mark.parametrize("kind", ["float32", "float64", "df32"])
def test_word_loop_scan_keeps_a_nan_as_jax(W, P, kind, prune):
    """The NaN is the last word's last state. The double-float scan's
    minimum (min_axis over positions, then words) is NaN only where the
    lattice's last cell [W - 1, P - 1] is: the halving keeps the second of
    a pair, which the last element always is. So only a last word of P
    states takes the NaN to the outputs, and not where the scan prunes
    (not less_equal(NaN, thr) prunes every cell of the NaN row)."""
    tables, S = word_loop_tables(W, P)
    rng = np.random.default_rng(W + P)
    last = int(tables.word_len[W - 1]) - 1
    am = with_nan(rng.uniform(0.0, 40.0, size=(B, T, S)), tables.state_table[W - 1, last])
    want, got = [], []
    if kind == "df32":
        jam, tam = jdf.from_f64(am), tdf.from_f64(am)
        tdp, ent = jdf.from_f64(tables.tdp_within), jdf.from_f64(tables.entry_pen)
        jargs = (*(jnp.asarray(a) for a in lex_arrays(tables)), tdp.hi, tdp.lo, ent.hi,
                 ent.lo, jnp.asarray(THR, jnp.float32))
        targs = (*(torch.from_numpy(np.asarray(a)) for a in lex_arrays(tables)),
                 tdf.from_f64(tables.tdp_within), tdf.from_f64(tables.entry_pen))
        jc = tc = None
        jouts, touts, pos = [], [], 0
        for n in CHUNKS:
            jc, jo = jdec._decode_scan_df(jam.hi[:, pos:pos + n], jam.lo[:, pos:pos + n],
                                          jnp.asarray(LENS), *jargs, prune=prune, carry_in=jc,
                                          t0=jnp.asarray(pos, jnp.int32))
            tc, to = tdec.decode_scan_df(tdf.DF(tam.hi[:, pos:pos + n].contiguous(),
                                                tam.lo[:, pos:pos + n].contiguous()),
                                         torch.from_numpy(LENS), *targs, THR, prune=prune,
                                         carry_in=tc, t0=pos)
            jouts.append(jo)
            touts.append(to)
            pos += n
        (hh, hl), bk, (bh, bl) = jc
        want = [np.asarray(x) for x in (hh, hl, bk, bh, bl)]
        got = [x.numpy() for x in (tc[0].hi, tc[0].lo, tc[1], tc[2].hi, tc[2].lo)]
        names = ("hyp.hi", "hyp.lo", "bkp", "book.hi", "book.lo")
    else:
        jd, td = JDT[kind], getattr(torch, kind)
        jargs = (*(jnp.asarray(a) for a in lex_arrays(tables)),
                 jnp.asarray(tables.tdp_within), jnp.asarray(tables.entry_pen))
        targs = (*(torch.from_numpy(np.asarray(a)) for a in lex_arrays(tables)),
                 torch.from_numpy(tables.tdp_within), torch.from_numpy(tables.entry_pen))
        jc = tc = None
        jouts, touts, pos = [], [], 0
        for n in CHUNKS:
            jc, jo = jdec._decode_scan(jnp.asarray(am[:, pos:pos + n], jd), jnp.asarray(LENS),
                                       *jargs, jnp.asarray(THR, jd), prune=prune, carry_in=jc,
                                       t0=jnp.asarray(pos, jnp.int32))
            tc, to = tdec.decode_scan(torch.from_numpy(np.ascontiguousarray(am[:, pos:pos + n]))
                                      .to(td), torch.from_numpy(LENS), *targs, THR, prune=prune,
                                      carry_in=tc, t0=pos)
            jouts.append(jo)
            touts.append(to)
            pos += n
        want = [np.asarray(x) for x in jc]
        got = [x.numpy() for x in tc]
        names = ("hyp", "bkp", "book")
    want += [np.concatenate([np.asarray(o[k]) for o in jouts]) for k in range(3)]
    got += [torch.cat([o[k] for o in touts]).numpy() for k in range(3)]
    assert_all_same(got, want, names + ("score", "word", "bkp_t"),
                    nan_out=kind != "df32" or (not prune and last == P - 1))


# -- kernel E (float32, float64): the alignment DP -------------------------------------


@pytest.mark.parametrize("A", [9, 300])
@pytest.mark.parametrize("tie", [True, False], ids=["pruned", "full-dp"])
@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_alignment_keeps_a_nan_as_jax(A, tie, kind):
    rng = np.random.default_rng(A)
    ams = with_nan(rng.uniform(0.0, 40.0, size=(B, T, A)), A // 2)
    tdp = rng.uniform(0.0, 20.0, size=(B, A, 3))
    lens = np.array([T, 9, 0, 5], np.int32)
    aut = np.array([A, A - 3, 5, 2], np.int32)
    pos_valid = np.arange(A)[None, :] < aut[:, None]
    prev = rng.uniform(0.0, 50.0, size=(B, A))
    jd, td = JDT[kind], getattr(torch, kind)
    jc, tc = jnp.asarray(prev, jd), torch.from_numpy(prev).to(td)
    jj, tj, pos = [], [], 0
    for n in CHUNKS:
        t0 = 3 + pos
        jc, j = jvit._align_fwd_chunk(jc, jnp.asarray(ams[:, pos:pos + n], jd),
                                      jnp.asarray(tdp, jd), jnp.asarray(pos_valid),
                                      jnp.asarray(lens), jnp.asarray(THR, jd),
                                      jnp.asarray(t0, jnp.int32), tie_pruned=tie, use_pruning=tie)
        tc, k = tvit.align_fwd_chunk(tc, torch.from_numpy(np.ascontiguousarray(
            ams[:, pos:pos + n])).to(td), torch.from_numpy(tdp).to(td),
            torch.from_numpy(pos_valid), torch.from_numpy(lens), THR, t0, tie_pruned=tie,
            use_pruning=tie)
        jj.append(np.asarray(j))
        tj.append(k.numpy())
        pos += n
    assert_all_same([tc.numpy(), np.concatenate(tj)], [np.asarray(jc), np.concatenate(jj)],
                    ("cost", "jumps"))


# -- kernel I: the tree scan -----------------------------------------------------------

TREE_FIELDS = ("state", "parent", "grand", "depth", "tdp", "loop_allowed", "end_word",
               "exit_penalty")


@pytest.mark.parametrize("N", [33, 212, 1025])
@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_tree_scan_keeps_a_nan_as_jax(N, kind):
    tree = random_tree(N, seed=N)
    am = tree_scores(B, T, seed=N + 7).numpy()
    am = with_nan(am, int(tree.state[N // 2]))
    td, jd = getattr(torch, kind), JDT[kind]
    tam = torch.from_numpy(am).to(td)
    got = ttree.tree_scan(tam, torch.from_numpy(LENS), *tree.device_args("cpu", td, am.shape[2]),
                          45.0, prune=True)
    want = jtree._tree_scan(jnp.asarray(tam.numpy()), jnp.asarray(LENS),
                            *(jnp.asarray(getattr(tree, f)) for f in TREE_FIELDS),
                            jnp.asarray(45.0, jd), prune=True)
    assert_all_same([g.numpy() for g in got], [np.asarray(w) for w in want],
                    ("score", "word", "bkp"))


# -- kernel J: the bigram scan ---------------------------------------------------------


@pytest.mark.parametrize("W,P", [(5, 8), (33, 8)])
@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_bigram_scan_keeps_a_nan_as_jax(W, P, kind):
    tables, S = word_loop_tables(W, P)
    rng = np.random.default_rng(W * 7 + P)
    am = with_nan(rng.uniform(0.0, 40.0, size=(B, T, S)), tables.state_table[1, 1])
    lm, start = rng.uniform(0.0, 25.0, size=(W, W)), rng.uniform(0.0, 25.0, size=W)
    td, jd = getattr(torch, kind), JDT[kind]
    args = (tables.state_table, tables.last_pos, tables.word_len, tables.tdp_within,
            tables.entry_pen)
    got = tng.decode_scan_bigram(torch.from_numpy(am).to(td), torch.from_numpy(LENS),
                                 *(torch.from_numpy(np.asarray(a)) for a in args),
                                 torch.from_numpy(lm), torch.from_numpy(start), THR)
    want = jng._decode_scan_bigram(
        jnp.asarray(am, jd), jnp.asarray(LENS), jnp.asarray(tables.state_table),
        jnp.asarray(tables.last_pos), jnp.asarray(tables.word_len),
        jnp.asarray(tables.first_state), jnp.asarray(tables.tdp_within),
        jnp.asarray(tables.entry_pen), jnp.asarray(lm), jnp.asarray(start),
        jnp.asarray(THR, jd), prune=True)
    assert_all_same([g.numpy() for g in got], [np.asarray(w) for w in want],
                    ("book", "bkp", "pred", "offset"))


# -- kernel K: the word-conditioned tree search ----------------------------------------


@pytest.mark.parametrize("opts", [{}, {"use_lookahead": True, "state_limit": 12,
                                       "emit_ends": True, "emit_stats": True}],
                         ids=["pruned", "everything"])
@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_wcts_scan_keeps_a_nan_as_jax(opts, kind):
    lex = PrefixLexicon(4, 4)
    W, S = lex.num_words, lex.num_states
    tdp = TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)
    jtdp = JTdp(silence_state=tdp.silence_state, loop=tdp.loop, forward=tdp.forward,
                skip=tdp.skip)
    rng = np.random.default_rng(5)
    lm, start = random_lm(W, 5)
    la = opts.get("use_lookahead", False)
    tables = ttree.TreeTables.build(lex, tdp, 0.0)
    am = with_nan(rng.uniform(0.0, 40.0, size=(B, T, S)), int(tables.state[3]))
    wt = tw.WctsTables.build(tables, tdp, lm, start,
                             tw.LookaheadTables.build(tables) if la else None)
    jt = jtree.TreeTables.build(lex, jtdp, 0.0)
    es, ep = jw.build_entry_tables(jt, jtdp)
    lm_ext = jw.extend_lm(lm, start)
    jla = (jw.LookaheadTables.build(jt).scores(lm_ext) if la
           else np.zeros((lm_ext.shape[0], jt.num_nodes)))
    jargs = [jnp.asarray(a) for a in (jt.state, jt.parent, jt.grand, jt.tdp, jt.loop_allowed,
                                      es, ep, jt.end_node, lm_ext, jla)]
    td, jd = getattr(torch, kind), JDT[kind]
    targs = wt.args("cpu", td, S)
    am_t = torch.from_numpy(am).to(td)
    tc = jc = None
    touts, jouts, t0 = [], [], 0
    for n in CHUNKS:
        piece = am_t[:, t0:t0 + n].contiguous()
        tc, to = tw.wcts_scan(piece, torch.from_numpy(LENS), *targs, 20.0, carry_in=tc, t0=t0,
                              **opts)
        jc, jo = jw._wcts_scan(jnp.asarray(piece.numpy(), jd), jnp.asarray(LENS), *jargs,
                               jnp.asarray(20.0, jd), carry_in=jc,
                               t0=jnp.asarray(t0, jnp.int32), **opts)
        touts.append(to)
        jouts.append(jo)
        t0 += n
    got = [x.numpy() for x in tc] + [torch.cat([o[k] for o in touts]).numpy()
                                     for k in range(len(touts[0]))]
    want = [np.asarray(x) for x in jc] + [np.concatenate([np.asarray(o[k]) for o in jouts])
                                          for k in range(len(jouts[0]))]
    assert_all_same(got, want, tuple(f"out{k}" for k in range(len(got))))


# -- kernel M: the linear-lexicon LVCSR scan -------------------------------------------


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_linear_scan_keeps_a_nan_as_jax(prune, kind):
    lex, tm, lm, lm_start, am, lens, thr = linear_case("lengths-1-2-3")
    tables = tm.decoder_tables(lex)
    b = int(np.argmax(lens))
    am = np.array(am)
    am[b, int(lens[b]) // 2, int(tables.state_table[1, 0])] = np.nan
    td, jd = getattr(torch, kind), JDT[kind]
    want = jl._decode_scan_linear_ts(jnp.asarray(am, jd), jnp.asarray(lens),
                                     *jax_scan_args(tables, lm, lm_start, 0, jd),
                                     jnp.asarray(thr, jd), prune=prune)
    lt = tl.LinearTables.build(tables, lm, lm_start, 0)
    got = tl.decode_scan_linear(torch.as_tensor(am).to(td), torch.as_tensor(lens),
                                *lt.args("cpu", td, am.shape[2]), thr, prune=prune)
    assert_all_same([g.numpy() for g in got], [np.asarray(w) for w in want], tl.OUTPUTS)
