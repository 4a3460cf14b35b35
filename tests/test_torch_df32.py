"""The port's double-float (df32) recognition path against the JAX package's.

* ``am_scores_df_reference`` (kernel C's plain version) is bit-equal in hi
  and lo to the JAX ``am_scores_df`` evaluated op by op
  (``jax.disable_jit``), on 2000 demo frames of both models. The jitted JAX
  function agrees in hi; its lo words differ by at most 2^-40·|hi| because
  XLA:CPU contracts ``a.hi*b.lo + a.lo*b.hi`` of ``doublefloat.mul`` into one
  fused multiply-add, which the port (and the card, through its
  round-to-nearest intrinsics) does not. Against float64 the scores hold the
  bound of tests/test_decode_demo.py, |Δ| <= |ref|·2^-38 + 2^-30.
* ``decode_scan_df_reference`` (kernel D's plain version) is bit-equal to
  the jitted JAX ``_decode_scan_df`` in every carry word and output: the scan
  only adds, compares and selects, so nothing is contracted.
* One test per tie rule: within-word jumps (larger jump wins, strict less),
  entries (win with less_equal), word ends (first index), the score cap
  (wins ties against the mixture minimum).
* The df32 and f64 Recognizers equal the JAX recognizers (hyps, WER, SER,
  S/I/D) and the oracle's golden demo transcripts.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import speechrecognition_tpu.config as jcfg
import speechrecognition_tpu.corpus as jcorpus
import speechrecognition_tpu.features.frontend as jfront
import speechrecognition_tpu.io as jio
import speechrecognition_tpu.lexicon as jlex
import speechrecognition_tpu.models.gmm as jgmm
import speechrecognition_tpu.search.decoder as jdec
import speechrecognition_tpu.tdp as jtdp
from speechrecognition_tpu.ops import doublefloat as jdf

import speechrecognition_torch.config as tcfg
import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.gmm as tgmm
import speechrecognition_torch.search.decoder as tdec
import speechrecognition_torch.tdp as ttdp
from speechrecognition_torch.convert import score_pack_df_from_jax
from speechrecognition_torch.ops import doublefloat as tdf

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
SETTINGS = {"am-threshold": 200.0, "word-penalty": 80.0, "pruned-search": True,
            "max-recognition-runs": 10000}
MODELS = {"iter-2": (FIX / "iter-2.mix", "MIXTURE_POOLING"),
          "bench": (REPO / "bench" / "model.mix", "NO_POOLING")}
#: jitted JAX lo words against the port's: one FMA rounding per mul
JIT_LO_TOL = 2.0 ** -40


def read_corpus(pkg_corpus, pkg_front, lexicon, **kw):
    desc = pkg_corpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lexicon)
    return pkg_corpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                  pkg_front.SignalAnalysisConfig(),
                                  normalization_path=str(FIX / "normalization-demo.bin"),
                                  **kw)


def load_models(name):
    path, pooling = MODELS[name]
    j = jgmm.MixtureModel.from_raw(jio.read_mixture_set(str(path), 25),
                                   jgmm.VarianceModel[pooling], max_approx=True)
    t = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(path), 25),
                                   tgmm.VarianceModel[pooling], max_approx=True)
    return j, t


@pytest.fixture(scope="module")
def port():
    lex = tlex.build_sietill_lexicon()
    return lex, read_corpus(tcorpus, tfront, lex)


@pytest.fixture(scope="module")
def golden():
    with open(FIX / "demo_recognition.json") as f:
        return json.load(f)


# -- acoustic scores (kernel C's plain version) ---------------------------------


@pytest.fixture(scope="module")
def scores_both(port):
    """name → (port DF, JAX DF op by op, JAX DF jitted, JAX float64) on 2000
    demo frames, each computed once per module."""
    cache = {}

    def run(name):
        if name not in cache:
            feats = port[1].features[:2000]
            j, t = load_models(name)
            got = tgmm.am_scores_df(t.pack_df(device="cpu"), torch.from_numpy(feats))
            with jax.disable_jit():
                eager = jgmm.am_scores_df(j.pack_df(), jnp.asarray(feats))
            jitted = jgmm.am_scores_df(j.pack_df(), jnp.asarray(feats))
            f64 = np.asarray(jgmm.am_scores(j.pack(dtype=jnp.float64), jnp.asarray(feats)))
            cache[name] = got, eager, jitted, f64
        return cache[name]

    return run


@pytest.mark.parametrize("name", sorted(MODELS))
def test_am_scores_df_bit_equal_to_jax(scores_both, name):
    got, eager, jitted, _ = scores_both(name)
    assert got.hi.dtype == got.lo.dtype == torch.float32
    assert got.hi.shape == (2000, 106)
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(eager.hi))
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(eager.lo))
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(jitted.hi))
    lo_err = np.abs(got.lo.numpy().astype(np.float64) - np.asarray(jitted.lo))
    assert (lo_err <= np.abs(got.hi.numpy()) * JIT_LO_TOL).all()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_am_scores_df_tracks_f64(scores_both, name):
    got, _, _, ref = scores_both(name)
    err = np.abs(tdf.to_f64(got) - ref)
    tol = np.abs(ref) * 2.0 ** -38 + 2.0 ** -30
    assert (err <= tol).all(), f"worst excess {(err - tol).max()}"


def test_am_scores_df_chunking(port):
    """N > AM_CHUNK_DF: frames are scored in chunks, each row independent."""
    _j, t = load_models("iter-2")
    pack = t.pack_df(device="cpu")
    feats = torch.from_numpy(np.resize(port[1].features, (tgmm.AM_CHUNK_DF + 37, 25)))
    whole = tgmm.am_scores_df(pack, feats)
    tail = tgmm.am_scores_df(pack, feats[tgmm.AM_CHUNK_DF - 3:])
    assert whole.hi.shape == (tgmm.AM_CHUNK_DF + 37, 106)
    assert torch.equal(whole.hi[tgmm.AM_CHUNK_DF - 3:], tail.hi)
    assert torch.equal(whole.lo[tgmm.AM_CHUNK_DF - 3:], tail.lo)


def test_am_scores_df_refuses_sum_mode_and_float64(port):
    _j, t = load_models("iter-2")
    pack = t.pack_df(device="cpu")
    feats = torch.from_numpy(port[1].features[:8])
    pack.max_approx = False
    with pytest.raises(NotImplementedError, match="max-approx"):
        tgmm.am_scores_df(pack, feats)
    pack.max_approx = True
    pack.mu = tdf.DF(pack.mu.hi.double(), pack.mu.lo)
    with pytest.raises(TypeError, match="float32"):
        tgmm.am_scores_df(pack, feats)
    with pytest.raises(ValueError, match="unsupported device"):
        tgmm.am_scores_df(t.pack_df(device="cpu"), torch.empty((8, 25), device="meta"))


def test_cap_wins_ties():
    """minimum(m, cap) = where(less(m, cap), m, cap): a mixture whose best
    density scores exactly MIN_SCORE_INIT gets the cap's own pair (lo +0.0
    here, where the density's is -0.0); above the cap, the cap."""
    S, D = 2, 2
    pack = tgmm.ScorePackDF(mu=tdf.df(np.zeros((S * D, 1))), iv=tdf.df(np.zeros((S * D, 1))),
                            norm=tdf.df(np.zeros(S * D)), logw=tdf.df(np.zeros(S * D)),
                            active=torch.ones((S, D), dtype=torch.bool), num_mixtures=S,
                            density_cap=D, dim=1, max_approx=True)
    crafted = tdf.DF(torch.tensor([[1e10, 3e10, 2e10, 4e10]]),
                     torch.tensor([[-0.0, 0.0, 0.0, 0.0]]))
    jcrafted = jdf.DF(jnp.asarray(crafted.hi.numpy()), jnp.asarray(crafted.lo.numpy()))
    orig = tgmm.density_scores_df_reference
    tgmm.density_scores_df_reference = lambda packdf, x: crafted
    try:
        got = tgmm.am_scores_df(pack, torch.zeros((1, 1)))
    finally:
        tgmm.density_scores_df_reference = orig
    jpack = jgmm.ScorePackDF(mu=None, iv=None, norm=None, logw=None, active=None,
                             num_mixtures=S, density_cap=D, dim=1, max_approx=True)
    jorig = jgmm._density_scores_df
    jgmm._density_scores_df = lambda packdf, x: jcrafted
    try:
        with jax.disable_jit():
            want = jgmm._am_chunk_df(jpack, jnp.zeros((1, 1)))
    finally:
        jgmm._density_scores_df = jorig
    assert got.hi.tolist() == [[1e10, 1e10]]
    assert not torch.signbit(got.lo).any()
    np.testing.assert_array_equal(np.signbit(np.asarray(want.lo)), torch.signbit(got.lo).numpy())
    np.testing.assert_array_equal(np.asarray(want.hi), got.hi.numpy())


# -- the df32 scan (kernel D's plain version) ----------------------------------

B, T = 4, 50
LENS = np.array([50, 37, 12, 0], np.int32)     # full, short, very short, padding


def sietill_tables(prune=True, flat=False):
    lex = tlex.build_sietill_lexicon()
    pen = (0.0, 0.0, 0.0, 0.0) if flat else (3.0, 0.0, 30.0, 80.0)
    tdp = ttdp.TdpModel(silence_state=lex.silence_state, loop=pen[0], forward=pen[1],
                        skip=pen[2])
    return (tdec.DecoderTables.build(lex, tdp, pen[3], exclude_last_pred=prune),
            lex.num_states)


def repetition1_tables(seed):
    """Repetition 1: positions 0 and 1 of a word are different states, so the
    df32 reference's first-state entry charge differs from the f32 scan's."""
    rng = np.random.default_rng(seed)
    lex = tlex.Lexicon()
    lex.add_word("[silence]", 1, 1, silence=True)
    for w in range(7):
        lex.add_word(f"w{w}", int(rng.integers(2, 13)), 1)
    st = lex.state_table()
    assert (st[1:, 0] != st[1:, 1]).all()
    tdp = ttdp.TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)
    return tdec.DecoderTables.build(lex, tdp, 15.0), lex.num_states


def lex_arrays(tables):
    return (tables.state_table, tables.last_pos, tables.word_len, tables.first_state)


def run_jax_df(tables, am64, lens, thr, prune, chunks, carry=None, t0=0):
    am = jdf.from_f64(am64)
    tdp, ent = jdf.from_f64(tables.tdp_within), jdf.from_f64(tables.entry_pen)
    args = (*(jnp.asarray(a) for a in lex_arrays(tables)), tdp.hi, tdp.lo, ent.hi, ent.lo,
            jnp.asarray(thr, jnp.float32))
    W, P = tables.state_table.shape
    nb = am64.shape[0]
    if carry is None:
        carry = ((jnp.full((nb, W, P), jdec.BIG, jnp.float32), jnp.zeros((nb, W, P), jnp.float32)),
                 jnp.zeros((nb, W, P), jnp.int32),
                 (jnp.zeros((nb,), jnp.float32), jnp.zeros((nb,), jnp.float32)))
    else:
        (hh, hl), bk, (bh, bl) = carry
        carry = ((jnp.asarray(hh), jnp.asarray(hl)), jnp.asarray(bk),
                 (jnp.asarray(bh), jnp.asarray(bl)))
    outs, pos = [], 0
    for n in chunks:
        carry, out = jdec._decode_scan_df(
            am.hi[:, pos:pos + n], am.lo[:, pos:pos + n], jnp.asarray(lens), *args,
            prune=prune, carry_in=carry, t0=jnp.asarray(t0 + pos, jnp.int32))
        outs.append(out)
        pos += n
    (hh, hl), bk, (bh, bl) = carry
    return ([np.asarray(x) for x in (hh, hl, bk, bh, bl)],
            [np.concatenate([np.asarray(o[k]) for o in outs]) for k in range(3)])


def run_torch_df(tables, am64, lens, thr, prune, chunks, carry=None, t0=0, fn=None):
    fn = fn or tdec.decode_scan_df_reference
    am = tdf.from_f64(am64)
    args = (*(torch.from_numpy(np.asarray(a)) for a in lex_arrays(tables)),
            tdf.from_f64(tables.tdp_within), tdf.from_f64(tables.entry_pen))
    if carry is not None:
        (hh, hl), bk, (bh, bl) = carry
        carry = (tdf.DF(torch.from_numpy(hh), torch.from_numpy(hl)), torch.from_numpy(bk),
                 tdf.DF(torch.from_numpy(bh), torch.from_numpy(bl)))
    outs, pos = [], 0
    for n in chunks:
        carry, out = fn(tdf.DF(am.hi[:, pos:pos + n].contiguous(),
                               am.lo[:, pos:pos + n].contiguous()),
                        torch.from_numpy(lens), *args, thr, prune=prune, carry_in=carry,
                        t0=t0 + pos)
        outs.append(out)
        pos += n
    (hyp, bk, book) = carry
    return ([x.numpy() for x in (hyp.hi, hyp.lo, bk, book.hi, book.lo)],
            [np.concatenate([o[k].numpy() for o in outs]) for k in range(3)])


def assert_same(a, b):
    (ca, oa), (cb, ob) = a, b
    for name, x, y in zip(("hyp.hi", "hyp.lo", "bkp", "book.hi", "book.lo",
                           "score", "word", "bkp_t"), ca + oa, cb + ob):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def random_am(S, seed, integer=False, nb=B, nt=T):
    rng = np.random.default_rng(seed)
    if integer:   # many exact ties: exercises every tie-breaking rule
        return rng.integers(0, 3, size=(nb, nt, S)).astype(np.float64)
    return rng.uniform(0.0, 40.0, size=(nb, nt, S)) + rng.uniform(0, 1e-9, size=(nb, nt, S))


@pytest.mark.parametrize("prune", [True, False])
def test_scan_df_matches_jax_sietill(prune):
    tables, S = sietill_tables(prune)
    args = (tables, random_am(S, seed=1), LENS, 60.0, prune, (T,))
    assert_same(run_jax_df(*args), run_torch_df(*args))


def test_scan_df_matches_jax_two_chunks():
    tables, S = sietill_tables()
    am = random_am(S, seed=2)
    chunked = run_torch_df(tables, am, LENS, 60.0, True, (30, 20))
    assert_same(run_jax_df(tables, am, LENS, 60.0, True, (30, 20)), chunked)
    assert_same(run_torch_df(tables, am, LENS, 60.0, True, (T,)), chunked)


@pytest.mark.parametrize("seed", [3, 4])
def test_scan_df_matches_jax_repetition1(seed):
    tables, S = repetition1_tables(seed)
    args = (tables, random_am(S, seed=seed), LENS, 25.0, True, (30, 20))
    assert_same(run_jax_df(*args), run_torch_df(*args))


@pytest.mark.parametrize("prune", [True, False])
def test_scan_df_matches_jax_ties(prune):
    tables, S = sietill_tables(prune, flat=True)
    args = (tables, random_am(S, seed=6, integer=True), LENS, 4.0, prune, (T,))
    assert_same(run_jax_df(*args), run_torch_df(*args))


def tiny_tables():
    """Silence plus two 4-state words with repetition 1 and zero TDPs and
    word penalty, so a crafted carry decides every tie."""
    lex = tlex.Lexicon()
    lex.add_word("[silence]", 1, 1, silence=True)
    lex.add_word("a", 4, 1)
    lex.add_word("b", 4, 1)
    tdp = ttdp.TdpModel(silence_state=lex.silence_state, loop=0.0, forward=0.0, skip=0.0)
    return tdec.DecoderTables.build(lex, tdp, 0.0), lex.num_states


def one_frame(hyp_hi, bkp, book_hi, t0=7):
    """Decode one frame of zero acoustic scores from a crafted carry, in the
    port and in JAX; returns the port's (carry, outputs) after asserting
    that both agree."""
    tables, S = tiny_tables()
    nb = hyp_hi.shape[0]
    carry = ((hyp_hi.astype(np.float32), np.zeros_like(hyp_hi, np.float32)),
             bkp.astype(np.int32),
             (book_hi.astype(np.float32), np.zeros(nb, np.float32)))
    am = np.zeros((nb, 1, S))
    lens = np.full(nb, 100, np.int32)
    port_out = run_torch_df(tables, am, lens, 1e6, True, (1,), carry=carry, t0=t0)
    assert_same(run_jax_df(tables, am, lens, 1e6, True, (1,), carry=carry, t0=t0), port_out)
    return port_out


def test_tie_larger_jump_wins():
    """Within-word candidates c2, c1, c0 tie: the jump-2 predecessor's
    backpointer wins; with c2 worse, jump 1 wins over the loop."""
    big = float(np.float32(1e30))
    hyp = np.full((2, 3, 4), big)
    bkp = np.zeros((2, 3, 4), np.int64)
    hyp[:, 1, :3] = 5.0
    hyp[1, 1, 0] = 6.0
    bkp[:, 1, :3] = [10, 11, 12]
    (_hh, _hl, new_bkp, _bh, _bl), _ = one_frame(hyp, bkp, np.full(2, big))
    assert new_bkp[0, 1, 2] == 10 and new_bkp[1, 1, 2] == 11


def test_tie_entry_wins():
    """An entry into position 0 that ties the within-word loop wins
    (less_equal): the new backpointer is the previous frame, t0."""
    hyp = np.full((1, 3, 4), float(np.float32(1e30)))
    bkp = np.zeros((1, 3, 4), np.int64)
    hyp[0, 1, 0] = 3.0
    bkp[0, 1, 0] = 99
    (_hh, _hl, new_bkp, _bh, _bl), _ = one_frame(hyp, bkp, np.array([3.0]), t0=7)
    assert new_bkp[0, 1, 0] == 7


def test_tie_first_word_end_wins():
    """Words 1 and 2 end with equal scores: the smaller word index is the
    frame's best word end."""
    big = float(np.float32(1e30))
    hyp = np.full((1, 3, 4), big)
    bkp = np.zeros((1, 3, 4), np.int64)
    hyp[0, 1:, 2] = 2.0               # both words reach their last position
    bkp[0, 1, 2], bkp[0, 2, 2] = 21, 22
    _carry, (_score, word, wbkp) = one_frame(hyp, bkp, np.array([big]))
    assert word.tolist() == [[1]] and wbkp.tolist() == [[21]]


def test_scan_df_wrapper_on_cpu_is_the_plain_version():
    tables, S = sietill_tables()
    am = random_am(S, seed=8)
    before = tdec.decode_scan_df.LAUNCHES
    args = (tables, am, LENS, 60.0, True, (30, 20))
    assert_same(run_torch_df(*args, fn=tdec.decode_scan_df), run_torch_df(*args))
    assert tdec.decode_scan_df.LAUNCHES == before


def test_scan_df_refuses_float64_and_other_devices():
    tables, S = sietill_tables()
    args = (*(torch.from_numpy(np.asarray(a)) for a in lex_arrays(tables)),
            tdf.from_f64(tables.tdp_within), tdf.from_f64(tables.entry_pen))
    am = tdf.from_f64(random_am(S, seed=9))
    with pytest.raises(TypeError, match="float32"):
        tdec.decode_scan_df(tdf.DF(am.hi.double(), am.lo.double()),
                            torch.from_numpy(LENS), *args, 60.0)
    meta = torch.empty((B, T, S), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_scan_df(tdf.DF(meta, meta), torch.from_numpy(LENS), *args, 60.0)


# -- weights carried across ----------------------------------------------------


def test_convert_score_pack_df_round_trip(port):
    """The JAX pack_df() carried across scores bit-equal to the port's own."""
    j, t = load_models("bench")
    feats = torch.from_numpy(port[1].features[:512])
    carried = score_pack_df_from_jax(j.pack_df(), device="cpu")
    own = t.pack_df(device="cpu")
    assert carried.device == own.device == torch.device("cpu")
    for field in ("mu", "iv", "norm", "logw"):
        for a, b in zip(getattr(carried, field), getattr(own, field)):
            assert a.dtype == torch.float32 and torch.equal(a, b), field
    assert torch.equal(carried.active, own.active)
    x, y = tgmm.am_scores_df(carried, feats), tgmm.am_scores_df(own, feats)
    assert torch.equal(x.hi, y.hi) and torch.equal(x.lo, y.lo)


# -- the recognizers on the demo corpus ----------------------------------------


@pytest.fixture(scope="module")
def recognize_both(port):
    """dtype name → (port result, JAX result) of the iter-2.mix recognizer
    on the 35 demo utterances, each computed once per module."""
    cache = {}

    def run(kind):
        if kind not in cache:
            lex, corpus = port
            _j, t = load_models("iter-2")
            tdp = ttdp.TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0,
                                skip=30.0)
            pack, dtype = ((t.pack_df(device="cpu"), "df32") if kind == "df32"
                           else (t.pack(dtype=torch.float64, device="cpu"), torch.float64))
            res = tdec.Recognizer(tcfg.Configuration(SETTINGS), lex, tdp, pack,
                                  dtype=dtype).recognize_corpus(corpus, batch_size=35)
            jl = jlex.build_sietill_lexicon()
            jc = read_corpus(jcorpus, jfront, jl, use_native=False)
            jm, _t = load_models("iter-2")
            jt = jtdp.TdpModel(silence_state=jl.silence_state, loop=3.0, forward=0.0,
                               skip=30.0)
            jpack, jdtype = ((jm.pack_df(), "df32") if kind == "df32"
                             else (jm.pack(dtype=jnp.float64), jnp.float64))
            jres = jdec.Recognizer(jcfg.Configuration(SETTINGS), jl, jt, jpack,
                                   dtype=jdtype).recognize_corpus(jc, batch_size=35)
            cache[kind] = res, jres
        return cache[kind]

    return run


@pytest.mark.parametrize("kind", ["df32", "f64"])
def test_recognizer_equals_jax(recognize_both, kind):
    res, jres = recognize_both(kind)
    assert res["num_decoded"] == jres["num_decoded"] == 35
    assert res["hyps"] == jres["hyps"]
    for key in ("wer", "ser", "substitutions", "insertions", "deletions",
                "audio_seconds", "coverage"):
        assert res[key] == jres[key], key


@pytest.mark.parametrize("kind", ["df32", "f64"])
def test_recognizer_reproduces_golden(recognize_both, golden, kind):
    res, _ = recognize_both(kind)
    mismatches = [(u["idx"], res["hyps"][u["idx"]], u["hyp"]) for u in golden["utts"]
                  if res["hyps"][u["idx"]] != u["hyp"]]
    assert not mismatches
    ref = golden["corpus"]
    assert abs(res["wer"] - ref["wer"]) < 1e-5 and abs(res["ser"] - ref["ser"]) < 1e-9
    assert [res["substitutions"], res["insertions"], res["deletions"]] == ref["sid"]


def test_df32_recognizer_needs_a_df_pack(port):
    lex, _corpus = port
    _j, t = load_models("iter-2")
    tdp = ttdp.TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    with pytest.raises(TypeError, match="ScorePackDF"):
        tdec.Recognizer(tcfg.Configuration(SETTINGS), lex, tdp, t.pack(device="cpu"),
                       dtype="df32")
