"""The port's forced alignment against the JAX package's, on the CPU.

* ``align_fwd_chunk_reference`` (kernel E's plain version), float32 and
  float64, and ``align_fwd_chunk_df_reference`` (kernel F's) are bit-equal
  to the JAX ``_align_fwd_chunk`` / ``_align_fwd_chunk_df`` in every jump
  and carry word, over two chunks with carry, ragged lengths (0 included),
  both tie orders and pruning on and off. The DP only adds, compares and
  selects, so the jitted JAX functions are the reference as they stand.
* A zero-TDP, integer-score case makes ties common; it pins the tie order
  (tests flip it in a copy to see it fail).
* ``align_backtrack_reference`` (kernel G's) equals ``_final_pos_dev`` +
  ``_align_bwd_chunk`` + ``_states_from_positions``.
* ``align_batch_chunked`` and ``align_batch`` on demo utterances with
  iter-2.mix give the JAX states in f32, f64 and df32.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.align.viterbi as jvit
import speechrecognition_tpu.io as jio
import speechrecognition_tpu.lexicon as jlex
import speechrecognition_tpu.models.gmm as jgmm
import speechrecognition_tpu.tdp as jtdp
from speechrecognition_tpu.ops import doublefloat as jdf

import speechrecognition_torch.align.viterbi as tvit
import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.gmm as tgmm
import speechrecognition_torch.tdp as ttdp
from speechrecognition_torch.ops import doublefloat as tdf

# The plain versions issue many small tensor ops. Under pytest-xdist each
# worker would run an OpenMP pool as wide as the machine, and the pools
# starve one another: one intra-op thread per test process.
torch.set_num_threads(1)

FIX =Path(__file__).resolve().parent / "fixtures"
LENS = np.array([60, 41, 13, 0, 59, 1], np.int32)
CASES = ["pruned", "full-dp", "pruned-nothr", "ties-pruned", "ties-full-dp"]


def dp_inputs(case, A=9):
    """Seeded DP inputs: scores [B, T, A] in float64, TDP [B, A, 3], valid
    positions, threshold, tie order and pruning."""
    B, T = LENS.shape[0], 60
    rng = np.random.default_rng(len(case) * 7 + A)
    ties = case.startswith("ties")
    aut = np.array([A, A - 2, 3, 5, A, 2], np.int32)
    if ties:
        ams = rng.integers(0, 3, size=(B, T, A)).astype(np.float64)
        tdp = np.zeros((B, A, 3))
        thr = 4.0
    else:
        ams = rng.uniform(0.0, 40.0, size=(B, T, A))
        tdp = rng.uniform(0.0, 20.0, size=(B, A, 3))
        thr = 60.0
    pos_valid = np.arange(A)[None, :] < aut[:, None]
    tie_pruned = "full-dp" not in case
    use_pruning = case != "pruned-nothr" and tie_pruned
    return ams, tdp, pos_valid, aut, thr, tie_pruned, use_pruning


def run_chunks(fn, ams, chunks, prev, *args):
    jumps, t0 = [], 0
    for n in chunks:
        prev, j = fn(prev, ams[:, t0:t0 + n], t0, *args)
        jumps.append(np.asarray(j))
        t0 += n
    return prev, np.concatenate(jumps)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("A", [9, 303, 1024])
def test_align_fwd_chunk_equals_jax(A, case, dtype):
    """At A 9, and at the lengths of kernel E's wide instance on the card
    (the Sprint path's 303 and its longest, 1,024), whose plain version the
    card holds it to. The wide lengths run two chunks of 30 frames: one
    JAX compile a case."""
    ams, tdp, pos_valid, aut, thr, tie, prune = dp_inputs(case, A=A)
    chunks = (25, 35) if A == 9 else (30, 30)
    B, T, A = ams.shape
    big = np.full((B, A), 1e30, dtype)
    tt = getattr(torch, dtype)

    def port(prev, am, t0):
        return tvit.align_fwd_chunk(prev, torch.as_tensor(am, dtype=tt),
                                    torch.as_tensor(tdp, dtype=tt), torch.as_tensor(pos_valid),
                                    torch.as_tensor(LENS), thr, t0, tie_pruned=tie,
                                    use_pruning=prune)

    def ref(prev, am, t0):
        return jvit._align_fwd_chunk(prev, jnp.asarray(am, dtype), jnp.asarray(tdp, dtype),
                                     jnp.asarray(pos_valid), jnp.asarray(LENS),
                                     jnp.asarray(thr, dtype), jnp.asarray(t0, jnp.int32),
                                     tie_pruned=tie, use_pruning=prune)

    got, gj = run_chunks(port, ams, chunks, torch.as_tensor(big))
    want, wj = run_chunks(ref, ams, chunks, jnp.asarray(big))
    assert got.dtype == tt and gj.dtype == np.int8
    np.testing.assert_array_equal(gj, wj)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("case", CASES)
def test_align_fwd_chunk_df_equals_jax(case):
    ams, tdp, pos_valid, aut, thr, tie, prune = dp_inputs(case)
    B, T, A = ams.shape
    jam, jtdp_ = jdf.from_f64(ams), jdf.from_f64(tdp)
    jthr = jdf.from_f64(np.float64(thr))
    tam, ttdp_ = tdf.from_f64(ams), tdf.from_f64(tdp)
    tthr = tdf.from_f64(np.float64(thr))
    big = np.full((B, A), np.float32(1e30))
    zeros = np.zeros((B, A), np.float32)

    def port(prev, am, t0):
        return tvit.align_fwd_chunk_df(prev, am, ttdp_, torch.as_tensor(pos_valid),
                                       torch.as_tensor(LENS), tthr, t0, tie_pruned=tie,
                                       use_pruning=prune)

    def ref(prev, am, t0):
        hi, lo, j = jvit._align_fwd_chunk_df(
            prev[0], prev[1], am[0], am[1], jtdp_.hi, jtdp_.lo, jnp.asarray(pos_valid),
            jnp.asarray(LENS), jthr.hi, jthr.lo, jnp.asarray(t0, jnp.int32),
            tie_pruned=tie, use_pruning=prune)
        return (hi, lo), j

    gj, wj, t0 = [], [], 0
    got = tdf.DF(torch.as_tensor(big), torch.as_tensor(zeros))
    want = (jnp.asarray(big), jnp.asarray(zeros))
    for n in (25, 35):
        got, j = port(got, tdf.DF(tam.hi[:, t0:t0 + n], tam.lo[:, t0:t0 + n]), t0)
        gj.append(j.numpy())
        want, j = ref(want, (jam.hi[:, t0:t0 + n], jam.lo[:, t0:t0 + n]), t0)
        wj.append(np.asarray(j))
        t0 += n
    np.testing.assert_array_equal(np.concatenate(gj), np.concatenate(wj))
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want[1]))


def test_tie_case_has_ties():
    """The zero-TDP integer-score case really decides between equal
    candidates, so it pins the tie order: both orders give the same costs
    and different jumps."""
    ams, tdp, pos_valid, aut, thr, _tie, prune = dp_inputs("ties-pruned")
    B, T, A = ams.shape
    prev = torch.full((B, A), 1e30, dtype=torch.float64)
    args = (torch.as_tensor(ams), torch.as_tensor(tdp), torch.as_tensor(pos_valid),
            torch.as_tensor(LENS), thr, 0)
    c_pruned, j_pruned = tvit.align_fwd_chunk(prev, *args, tie_pruned=True, use_pruning=prune)
    c_full, j_full = tvit.align_fwd_chunk(prev, *args, tie_pruned=False, use_pruning=prune)
    assert torch.equal(c_pruned, c_full)
    assert int((j_pruned != j_full).sum()) > 20


@pytest.mark.parametrize("case", CASES)
def test_align_backtrack_equals_jax(case):
    ams, tdp, pos_valid, aut, thr, tie, prune = dp_inputs(case)
    B, T, A = ams.shape
    rng = np.random.default_rng(5)
    states_tbl = rng.integers(0, 106, size=(B, A)).astype(np.int32)
    big = torch.full((B, A), 1e30)
    final, jumps = run_chunks(
        lambda p, a, t0: tvit.align_fwd_chunk(p, torch.as_tensor(a, dtype=torch.float32),
                                              torch.as_tensor(tdp, dtype=torch.float32),
                                              torch.as_tensor(pos_valid),
                                              torch.as_tensor(LENS), thr, t0,
                                              tie_pruned=tie, use_pruning=prune),
        ams, (25, 35), big)
    Tout = 53
    states, fp = tvit.align_backtrack(final, torch.as_tensor(aut), torch.as_tensor(jumps),
                                      torch.as_tensor(LENS), torch.as_tensor(states_tbl),
                                      Tout, tie_pruned=tie)
    jfp = jvit._final_pos_dev(jnp.asarray(final.numpy()), jnp.asarray(aut), tie_pruned=tie)
    cur, pos = jfp, []
    for t0, n in ((25, 35), (0, 25)):
        cur, p = jvit._align_bwd_chunk(cur, jnp.asarray(jumps[t0:t0 + n]), jnp.asarray(LENS),
                                       jfp, jnp.asarray(t0, jnp.int32))
        pos.insert(0, p)
    want = jvit._states_from_positions(jnp.concatenate(pos)[:Tout], jnp.asarray(states_tbl))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
    assert states.dtype == torch.int32 and states.shape == (B, Tout)
    np.testing.assert_array_equal(states.numpy(), np.asarray(want).astype(np.int32))


@pytest.fixture(scope="module")
def demo_batch():
    """Eight demo utterances (the longest among them) padded to the 960-frame
    bucket, iter-2.mix in both packages, tdp 20-0-20 tables."""
    lex = tlex.build_sietill_lexicon()
    desc = tcorpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = tcorpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                 tfront.SignalAnalysisConfig(),
                                 normalization_path=str(FIX / "normalization-demo.bin"))
    ids = [int(np.argmax(corpus.lengths)), 0, 3, 9, 14, 20, 27, 34]
    feats, lens = corpus.padded_batch(ids, pad_to=960)
    auts = [tlex.build_segment_automaton(lex, corpus.orths[s]) for s in ids]
    tables = tvit.AlignerTables.build(auts, ttdp.TdpModel(silence_state=0, loop=20.0,
                                                          forward=0.0, skip=20.0))
    jl = jlex.build_sietill_lexicon()
    jtables = jvit.AlignerTables.build(
        [jlex.build_segment_automaton(jl, corpus.orths[s]) for s in ids],
        jtdp.TdpModel(silence_state=0, loop=20.0, forward=0.0, skip=20.0))
    jm = jgmm.MixtureModel.from_raw(jio.read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                    jgmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    tm = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                    tgmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    return feats, lens, tables, jtables, jm, tm


#: costs: equal in f64; the f32 costs come from a float32 [x², x, 1] · P
#: product whose reduction order differs between torch and XLA (both lose
#: ~1e-4 relative to cancellation, ScorePack); the df32 ones from
#: am_scores_df, whose jitted JAX version contracts one multiply-add per DF
#: mul (tests/test_torch_df32.py), ≤ 2^-40 relative per score
COST_RTOL = {"f32": 1e-4, "f64": 0.0, "df32": 1e-12}


@pytest.mark.parametrize("kind", ["f32", "f64", "df32"])
@pytest.mark.parametrize("fn", ["align_batch_chunked", "align_batch"])
@pytest.mark.parametrize("thr", [120.0, None])
def test_align_batch_equals_jax(demo_batch, kind, fn, thr):
    feats, lens, tables, jtables, jm, tm = demo_batch
    if kind == "df32":
        pack, jpack, dt, jdt = tm.pack_df(device="cpu"), jm.pack_df(), "df32", "df32"
    else:
        dt = torch.float32 if kind == "f32" else torch.float64
        jdt = jnp.float32 if kind == "f32" else jnp.float64
        pack, jpack = tm.pack(dtype=dt, device="cpu"), jm.pack(dtype=jdt)
    tie = thr is not None
    states, costs = getattr(tvit, fn)(pack, feats, lens, tables, thr, tie_pruned=tie,
                                      dtype=dt)
    jstates, jcosts = getattr(jvit, fn)(jpack, feats, lens, jtables, thr, tie_pruned=tie,
                                        dtype=jdt)
    assert states.dtype == np.int32 and states.shape == feats.shape[:2]
    np.testing.assert_array_equal(states, np.asarray(jstates))
    np.testing.assert_allclose(costs, np.asarray(jcosts), rtol=COST_RTOL[kind], atol=0)


def test_realign_batch_equals_align_batch(demo_batch):
    """The trainer's device-corpus gather gives the padded batch's states."""
    feats, lens, tables, _jt, _jm, tm = demo_batch
    B, T, dim = feats.shape
    flat = torch.as_tensor(np.concatenate([feats[b, :lens[b]] for b in range(B)]))
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = offs[:, None] + np.arange(T)[None, :]
    idx = np.where(np.arange(T)[None, :] < lens[:, None], idx, 0)
    pack = tm.pack_df(device="cpu")
    got = tvit.realign_batch(pack, flat, idx, lens, tables, 120.0, dtype="df32")
    want, _ = tvit.align_batch_chunked(pack, feats, lens, tables, 120.0, dtype="df32")
    np.testing.assert_array_equal(got.numpy(), want)


def test_padding_rows_change_nothing(demo_batch):
    """A batch padded with duplicated rows (the reference's fixed batch
    shape) aligns its real rows as the unpadded batch does."""
    feats, lens, tables, _jt, _jm, tm = demo_batch
    pad = [0, 1, 1, 7]
    pfeats = np.concatenate([feats, feats[pad]])
    plens = np.concatenate([lens, lens[pad]])
    ptables = tables.rows(list(range(len(lens))) + pad)
    pack = tm.pack(dtype=torch.float64, device="cpu")
    got, _ = tvit.align_batch_chunked(pack, pfeats, plens, ptables, 120.0,
                                      dtype=torch.float64)
    want, _ = tvit.align_batch_chunked(pack, feats, lens, tables, 120.0, dtype=torch.float64)
    np.testing.assert_array_equal(got[:len(lens)], want)
    np.testing.assert_array_equal(got[len(lens):], want[pad])
