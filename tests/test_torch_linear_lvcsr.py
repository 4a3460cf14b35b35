"""The port's linear-lexicon LVCSR decode (speechrecognition_torch/search/
linear_lvcsr.py) against the JAX package's on the same acoustic scores.

The plain version of kernel M is bit-equal to JAX's ``_decode_scan_linear_ts``
(all eight per-frame outputs: book, bkp, pred, via, origin, silend, silorg,
offset) in float32 and float64, pruned and unpruned, on
tests/torch_linear_tables.py's LINEAR_CASES: a zero-length and an
all-silence utterance, words of 1, 2 and 3 positions, silences of 1, 2 and
3 positions, integer scores, TDPs and LM costs that tie the recursion, the
predecessor minimum, the silence entry and the pruning threshold, and a
silence exit that float32 does not represent (the reference rounds it to
float32 before its float64 scan). The plain version of kernel N is
bit-equal to JAX's ``_traceback_device`` on those outputs and on random
books whose walks pass MAX_TRACE_WORDS words. ``decode_batch_linear_lvcsr``
gives JAX's transcripts; the reference's silence-copy oracle (an explicit
per-context silence lexicon decoded by the bigram decoder) holds for 7
seeds; the port's an4_system.decode runs the linear engine on float and
q8 scores and the exact WCTS on a small synthetic AN4-shaped corpus.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.lexicon import Lexicon as JLexicon
from speechrecognition_tpu.lexicon import MarkovAutomaton as JAutomaton
from speechrecognition_tpu.search import decoder as jdec
from speechrecognition_tpu.search import linear_lvcsr as jl
from speechrecognition_tpu.tdp import TdpModel as JTdp

from speechrecognition_torch.corpus import Corpus
from speechrecognition_torch.search import linear_lvcsr as tl
from speechrecognition_torch.search.decoder import DecoderTables
from speechrecognition_torch.search.ngram_decoder import decode_batch_bigram
from speechrecognition_torch.tdp import TdpModel
from speechrecognition_torch.tools import an4_system
from torch_linear_tables import (AN4_TDP, LINEAR_CASES, features_near_means, linear_case,
                                 oracle_case, pooled_model, pooled_raw, random_lm,
                                 tied_lexicon, traceback_books, utterance_states)

torch.set_num_threads(1)
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
DTYPES = [torch.float32, torch.float64]


def jax_lexicon(lex):
    return JLexicon(orth=list(lex.orth),
                    automata=[JAutomaton(states=a.states.copy()) for a in lex.automata],
                    silence=lex.silence)


def jax_scan_args(tables, lm_matrix, lm_start, silence_idx, dtype):
    """The scan's arguments as the reference's decode_batch_linear_lvcsr
    builds them (speechrecognition_tpu/search/linear_lvcsr.py:266-278, 290-296)."""
    Wfull = tables.num_words
    real = np.asarray([w for w in range(Wfull) if w != silence_idx], np.int32)
    sl = int(tables.word_len[silence_idx])
    sil_exit = float(lm_matrix[real[0], silence_idx])
    lm_r = lm_matrix[np.ix_(real, real)]
    lm_ext = np.concatenate([lm_r, lm_start[real][None, :]], axis=0)
    return (jnp.asarray(tables.state_table[real]), jnp.asarray(tables.last_pos[real]),
            jnp.asarray(tables.word_len[real]), jnp.asarray(tables.tdp_within[real]),
            jnp.asarray(tables.entry_pen[real]),
            jnp.asarray(tables.state_table[silence_idx, :sl]),
            jnp.asarray(tables.tdp_within[silence_idx, :sl]),
            jnp.asarray(tables.entry_pen[silence_idx]),
            jnp.asarray(sil_exit, jnp.float32), jnp.asarray(lm_ext))


@functools.lru_cache(maxsize=None)
def run(name, dtype, prune):
    """(JAX outputs, port outputs, JAX words, port words, lens) of a case."""
    lex, tm, lm, lm_start, am, lens, thr = linear_case(name)
    tables = tm.decoder_tables(lex)
    jargs = jax_scan_args(tables, lm, lm_start, 0, JDT[dtype])
    jout = jl._decode_scan_linear_ts(jnp.asarray(am, JDT[dtype]), jnp.asarray(lens), *jargs,
                                     jnp.asarray(thr, JDT[dtype]), prune=prune)
    lt = tl.LinearTables.build(tables, lm, lm_start, 0)
    tout = tl.decode_scan_linear(torch.as_tensor(am).to(dtype), torch.as_tensor(lens),
                                 *lt.args("cpu", dtype, am.shape[2]), thr, prune=prune)
    jw = np.asarray(jl._traceback_device(jout, jnp.asarray(lens), len(lt.real)))
    tw = tl.traceback_linear(*(tout[i] for i in (0, 1, 2, 4, 5, 6)), torch.as_tensor(lens))
    return [np.asarray(o) for o in jout], [o.numpy() for o in tout], jw, tw.numpy(), lens


@pytest.mark.parametrize("name", sorted(LINEAR_CASES))
def test_tables_as_the_reference_builds_them(name):
    lex, tm, lm, lm_start, _am, _lens, _thr = linear_case(name)
    tables = tm.decoder_tables(lex)
    lt = tl.LinearTables.build(tables, lm, lm_start, 0)
    jargs = jax_scan_args(tables, lm, lm_start, 0, jnp.float64)
    port = (lt.state_table, lt.last_pos, lt.word_len, lt.tdp_within, lt.entry_pen,
            lt.sil_states, lt.sil_tdp, lt.sil_entry_pen, lt.sil_exit, lt.lm_ext)
    for j, p in zip(jargs, port):
        np.testing.assert_array_equal(np.asarray(j), np.asarray(p))
    # the silence exit is the float32 value, widened
    assert lt.sil_exit == float(np.float32(lm[1, 0]))


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(LINEAR_CASES))
def test_scan_bit_equal(name, dtype, prune):
    jout, tout, _jw, _tw, lens = run(name, dtype, prune)
    for key, j, t in zip(tl.OUTPUTS, jout, tout):
        assert j.dtype == t.dtype and j.shape == t.shape, key
        np.testing.assert_array_equal(j, t, err_msg=key)
    if name == "ties":
        assert predecessor_ties(name, tout) > 0


def predecessor_ties(name, tout):
    """Live word entries whose min-plus minimum several predecessors reach."""
    lex, tm, lm, lm_start, _am, lens, _thr = linear_case(name)
    lm_ext = tl.LinearTables.build(tm.decoder_tables(lex), lm, lm_start, 0).lm_ext
    book, silend = tout[0], tout[5]
    ties = 0
    for t in range(1, book.shape[0]):
        for b in np.nonzero(lens > t)[0]:
            eb = np.minimum(np.concatenate([book[t - 1, b], [1e30]]), silend[t - 1, b])
            cand = eb[:, None] + lm_ext
            m = cand.min(0)
            ties += int(((cand == m[None]).sum(0) > 1)[m < 1e29].sum())
    return ties
    for b, n in enumerate(lens):                       # a finished utterance's offset
        assert (tout[7][n:, b] == 0).all()


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(LINEAR_CASES))
def test_traceback_bit_equal(name, dtype, prune):
    _jout, _tout, jw, tw, lens = run(name, dtype, prune)
    assert jw.dtype == tw.dtype == np.int32
    np.testing.assert_array_equal(jw, tw)
    assert (tw[:, lens == 0] == -1).all()


def test_all_silence_scan_ends_in_a_silence_copy():
    _jout, tout, _jw, tw, lens = run("all-silence", torch.float64, False)
    assert (tw == -1).all()
    silend, book = tout[5], tout[0]
    assert silend[lens[0] - 1, 0].min() < book[lens[0] - 1, 0].min()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traceback_random_books(seed):
    """Walks of up to 600 frames with boundaries 1-2 frames apart: the first
    utterance passes MAX_TRACE_WORDS words, the second meets the sentence
    start, the third is empty."""
    book, bkp, pred, origin, silend, silorg, lens = traceback_books(seed)
    W = book.shape[2]
    for dtype in DTYPES:
        jw = np.asarray(jl._traceback_device(
            tuple(jnp.asarray(a) for a in (book.astype(dtype_np(dtype)), bkp, pred,
                                           np.zeros(bkp.shape, bool), origin,
                                           silend.astype(dtype_np(dtype)), silorg,
                                           np.zeros(book.shape[:2]))),
            jnp.asarray(lens), W))
        tw = tl.traceback_linear(*(torch.as_tensor(a) for a in (
            book.astype(dtype_np(dtype)), bkp, pred, origin, silend.astype(dtype_np(dtype)),
            silorg)), torch.as_tensor(lens)).numpy()
        np.testing.assert_array_equal(jw, tw)
    assert (tw[:, 0] >= 0).all()                       # MAX_TRACE_WORDS words
    assert tw.shape == (tl.MAX_TRACE_WORDS, len(lens))
    assert (tw[:, 2] == -1).all()


def dtype_np(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["lengths-1-2-3", "ties", "exit-off-float32"])
def test_decode_equals_jax(name, dtype):
    lex, tm, lm, lm_start, am, lens, thr = linear_case(name)
    tables = tm.decoder_tables(lex)
    feats = np.zeros(am.shape[:2] + (1,), np.float32)
    for prune in (False, True):
        want = jl.decode_batch_linear_lvcsr(None, feats, lens, tables, lm, lm_start, thr, 0,
                                            prune=prune, am=jnp.asarray(am),
                                            dtype=JDT[dtype])
        got = tl.decode_batch_linear_lvcsr(None, feats, lens, tables, lm, lm_start, thr, 0,
                                           prune=prune, am=torch.as_tensor(am), dtype=dtype)
        assert got == want


def word_lists_by_loop(words, real):
    """The hand-off as a loop over every utterance and word slot."""
    results = []
    for b in range(words.shape[1]):
        seq = [int(real[w]) for w in words[:, b] if w >= 0]
        seq.reverse()
        results.append(seq)
    return results


HANDOFF_CASES = ["tails", "holes", "all-empty", "some-empty", "full", "batch-0"]


def handoff_ids(case, rng, W):
    """[MAX_TRACE_WORDS, B] word ids in kernel N's reverse order."""
    M = tl.MAX_TRACE_WORDS
    ids = rng.integers(0, W, (M, 40)).astype(np.int32)
    if case == "tails":
        for b, n in enumerate(rng.integers(0, M + 1, 40)):
            ids[n:, b] = -1
    elif case == "holes":
        ids[rng.random(ids.shape) < 0.6] = -1
        ids[:, :3] = -1
    elif case == "all-empty":
        ids[:] = -1
    elif case == "some-empty":
        ids[12:, :] = -1
        ids[:, ::3] = -1
    elif case == "batch-0":
        ids = ids[:, :0]
    return ids


@pytest.mark.parametrize("case", HANDOFF_CASES)
def test_word_lists_equal_the_loop(case):
    W = 131
    real = np.asarray([w for w in range(W + 1) if w != 7], np.int32)    # silence 7 left out
    ids = handoff_ids(case, np.random.default_rng(HANDOFF_CASES.index(case)), W)
    got = tl.word_lists(ids, real)
    assert got == word_lists_by_loop(ids, real) and len(got) == ids.shape[1]
    assert all(type(seq) is list for seq in got)
    assert all(type(w) is int for seq in got for w in seq)
    if case == "full":
        assert all(len(seq) == tl.MAX_TRACE_WORDS for seq in got)


# -- the reference's silence-copy oracle (tests/test_linear_lvcsr.py) ----------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6])
def test_matches_silence_copy_oracle(seed):
    """The explicitly extended lexicon (one silence copy per context)
    decoded by the bigram decoder agrees with the linear decoder's implicit
    per-predecessor silence copies."""
    base, lm, lm_start, am, ext, ext_lm, ext_start, am_ext = oracle_case(seed)
    tdp = TdpModel(silence_state=0, loop=1.0, forward=0.0, skip=4.0)
    T = am.shape[1]
    feats = np.zeros((1, T, 1), np.float32)
    hyps_ora = decode_batch_bigram(
        None, feats, np.asarray([T]), DecoderTables.build(ext, tdp, word_penalty=0.0),
        ext_lm, ext_start, 1e9, silence_idx=-1, prune=False, dtype=torch.float64,
        am=torch.as_tensor(am_ext))
    want = [w for w in hyps_ora[0] if w in (1, 2)]
    got = tl.decode_batch_linear_lvcsr(
        None, feats, np.asarray([T]), DecoderTables.build(base, tdp, word_penalty=0.0),
        lm, lm_start, 1e9, silence_idx=0, prune=False, dtype=torch.float64,
        am=torch.as_tensor(am))
    assert got[0] == want, (seed, got[0], want)
    # the JAX package's linear decode on the same inputs
    jgot = jl.decode_batch_linear_lvcsr(
        None, feats, np.asarray([T]), jdec.DecoderTables.build(
            jax_lexicon(base), JTdp(silence_state=0, loop=1.0, forward=0.0, skip=4.0),
            word_penalty=0.0),
        lm, lm_start, 1e9, silence_idx=0, prune=False, dtype=jnp.float64, am=jnp.asarray(am))
    assert got == jgot


def test_all_silence_utterance():
    base = oracle_case(0)[0]
    tdp = TdpModel(silence_state=0, loop=0.1, forward=0.0, skip=4.0)
    lm = np.full((3, 3), 50.0)
    lm[:, 0] = 0.1
    lm_start = np.full(3, 50.0)
    lm_start[0] = 0.1
    T = 8
    am = np.zeros((1, T, base.num_states))
    am[:, :, 1:] = 30.0              # only silence is plausible
    got = tl.decode_batch_linear_lvcsr(
        None, np.zeros((1, T, 1), np.float32), np.asarray([T]),
        DecoderTables.build(base, tdp, word_penalty=0.0), lm, lm_start, 1e9, silence_idx=0,
        prune=False, dtype=torch.float64, am=torch.as_tensor(am))
    assert got[0] == []


# -- the AN4 system's decode on a small synthetic corpus ----------------------


@pytest.fixture(scope="module")
def small_system():
    """An AN4-shaped system cut small: 30 tied classes of a pooled model
    (dim 13), 12 words, 6 utterances of seeded words near the means."""
    rng = np.random.default_rng(11)
    model = pooled_model(pooled_raw(rng, 30, 4, 13))
    lex = tied_lexicon(3 * np.clip(1 + rng.poisson(1.5, 12), 1, 4), 3, 30, rng,
                       own_silence=True)
    lens = rng.integers(20, 60, 6)
    spoken = [utterance_states(rng, lex, int(n)) for n in lens]
    feats = np.concatenate([features_near_means(rng, model, s) for s, _w in spoken])
    corpus = Corpus(features=feats, feature_offsets=np.concatenate([[0], np.cumsum(lens)]),
                    orths=[w for _s, w in spoken], names=[f"u{i}" for i in range(6)],
                    frame_duration=0.01, dim=13)
    lm, lm_start = random_lm(rng, lex.num_words, 0, 10.0, low=2.0, high=12.0)
    return model, corpus, lex, lm, lm_start


@pytest.mark.parametrize("name", ["linear", "linear-q8", "linear-q8-preselect"])
def test_an4_decode_linear_equals_the_scan(small_system, name):
    """an4_system.decode's linear engine gives decode_batch_linear_lvcsr's
    transcripts on the same scores, zero search-space statistics, and its
    report's fields."""
    model, corpus, lex, lm, lm_start = small_system
    r = an4_system.decode(model, corpus, corpus.orths, lex, AN4_TDP, lm, lm_start, 200.0,
                          True, False, name, device="cpu")
    feats, lens = corpus.padded_batch(range(corpus.num_segments))
    if "q8" in name:
        from speechrecognition_torch.models import quantized as tq
        qp = tq.build_quant_pack(model, preselection="preselect" in name, device="cpu")
        am = tq.am_scores_q_chunked(qp, torch.as_tensor(feats.reshape(-1, 13)))
        am = am.reshape(feats.shape[0], feats.shape[1], -1)
        want = tl.decode_batch_linear_lvcsr(None, feats, lens, AN4_TDP.decoder_tables(lex),
                                            lm, lm_start, 200.0, 0, am=am)
    else:
        want = tl.decode_batch_linear_lvcsr(model.pack(device="cpu"), feats, lens,
                                            AN4_TDP.decoder_tables(lex), lm, lm_start, 200.0, 0)
    assert r["hyps"] == want
    assert r["mean_active_states"] == 0.0 and r["max_active_states"] == 0
    assert r["audio_s"] == pytest.approx(corpus.features.shape[0] * 0.01)
    assert set(r) >= {"wer", "ser", "errors", "n_words", "rtf", "mean_word_ends"}


def test_an4_decode_linear_equals_exact_wcts(small_system):
    """Unpruned, the linear engine's 1-best transcripts equal the exact WCTS
    decode with transparent silence (the reference's A/B on AN4)."""
    model, corpus, lex, lm, lm_start = small_system
    lin = an4_system.decode(model, corpus, corpus.orths, lex, AN4_TDP, lm, lm_start, 1e9,
                            False, False, "linear", device="cpu")
    wcts = an4_system.decode(model, corpus, corpus.orths, lex, AN4_TDP, lm, lm_start, 1e9,
                             False, False, "f32", device="cpu")
    assert lin["hyps"] == wcts["hyps"]
    assert any(lin["hyps"]) and wcts["mean_active_states"] > 0


def test_the_card_is_the_default(small_system, monkeypatch):
    """Without a card the entry points raise unless the caller asks for the
    CPU, and the kernels' launches refuse CPU tensors (nothing falls
    back)."""
    model, corpus, lex, lm, lm_start = small_system
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        an4_system.decode(model, corpus, corpus.orths, lex, AN4_TDP, lm, lm_start, 200.0,
                          True, False, "linear-q8")
    lex_, tm, lm_, lm_start_, am, lens, thr = linear_case("lengths-1-2-3")
    lt = tl.LinearTables.build(tm.decoder_tables(lex_), lm_, lm_start_, 0)
    args = (torch.as_tensor(am, dtype=torch.float32), torch.as_tensor(lens),
            *lt.args("cpu", torch.float32, am.shape[2]))
    with pytest.raises(ValueError, match="unsupported device"):
        tl.decode_scan_linear_cuda(*args, thr)
    outs = tl.decode_scan_linear(*args, thr)
    with pytest.raises(ValueError, match="unsupported device"):
        tl.traceback_linear_cuda(*(outs[i] for i in (0, 1, 2, 4, 5, 6)), args[1])
