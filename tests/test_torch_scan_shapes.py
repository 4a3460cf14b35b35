"""The port's scans past 1,024 lattice slots or automaton positions, against
the JAX package's, on the CPU.

The JAX scans take any lattice [W, P] and any automaton length A. The port's
kernels B, D, E and F take them too (each has an instance that keeps its
lattice in device scratch past 1,024; tests/test_torch_cuda.py holds those
against the plain versions on the card). Here the plain versions, which
the CPU wrappers run, are held bit for bit against the JAX functions on the
same seeded inputs:

* ``decode_scan_reference`` (float32, float64) and
  ``decode_scan_df_reference`` at W x P = 92 x 12 = 1,104 slots, on a random
  lexicon with repetition 1 (positions 0 and 1 are different states, so the
  two entry-emission rules differ), over two chunks from a random live
  carry, so every slot takes part;
* ``align_fwd_chunk_reference`` (float32, float64) and
  ``align_fwd_chunk_df_reference`` at A = 1,100, both tie orders, over two
  chunks from a random live cost row;
* the wrappers take those shapes on the CPU and give the plain versions'
  results.

B <= 3 and T <= 12, and each JAX result is computed once per module, so the
file stays quick.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.align.viterbi as jvit
import speechrecognition_tpu.search.decoder as jdec
from speechrecognition_tpu.ops import doublefloat as jdf

import speechrecognition_torch.align.viterbi as tvit
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.search.decoder as tdec
from speechrecognition_torch.ops import doublefloat as tdf
from speechrecognition_torch.tdp import TdpModel

# one intra-op thread per test process (the plain versions issue many small
# tensor ops; see tests/test_torch_align.py)
torch.set_num_threads(1)

B = 3
CHUNKS = (5, 7)          # two chunks, 12 frames
T0 = 3                   # past the alignment's initialisation frame
DEC_LENS = np.array([12, 7, 0], np.int32)
ALIGN_A = 1100
ALIGN_LENS = np.array([20, 9, 0], np.int32)


def big_lexicon_tables():
    """Silence plus 91 random words of 2-12 states with repetition 1."""
    rng = np.random.default_rng(61)
    lex = tlex.Lexicon()
    lex.add_word("[silence]", 1, 1, silence=True)
    for w in range(91):
        lex.add_word(f"w{w}", int(rng.integers(2, 13)), 1)
    tdp = TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)
    return tdec.DecoderTables.build(lex, tdp, 15.0), lex.num_states


@pytest.fixture(scope="module")
def dec_inputs():
    tables, S = big_lexicon_tables()
    W, P = tables.state_table.shape
    rng = np.random.default_rng(62)
    am = rng.uniform(0.0, 40.0, size=(B, sum(CHUNKS), S))
    hyp = rng.uniform(0.0, 40.0, size=(B, W, P))
    bkp = rng.integers(0, T0, size=(B, W, P)).astype(np.int32)
    book = rng.uniform(0.0, 10.0, size=B)
    return tables, am, (hyp, bkp, book)


def test_big_lexicon_is_past_1024_slots(dec_inputs):
    tables, _am, _carry = dec_inputs
    W, P = tables.state_table.shape
    assert W * P > 1024 and (W, P) == (92, 12)
    st = tables.state_table
    assert (st[1:, 0] != st[1:, 1]).all()      # repetition 1


def lex_arrays(tables):
    return (tables.state_table, tables.last_pos, tables.word_len, tables.first_state)


def run_jax_decode(tables, am, carry, dtype):
    jd = getattr(jnp, dtype)
    args = tuple(jnp.asarray(a) for a in lex_arrays(tables)) + (
        jnp.asarray(tables.tdp_within), jnp.asarray(tables.entry_pen))
    hyp, bkp, book = carry
    carry = (jnp.asarray(hyp, jd), jnp.asarray(bkp), jnp.asarray(book, jd))
    outs, pos = [], 0
    for n in CHUNKS:
        carry, out = jdec._decode_scan(
            jnp.asarray(am[:, pos:pos + n], jd), jnp.asarray(DEC_LENS), *args,
            jnp.asarray(60.0, jd), prune=True, carry_in=carry,
            t0=jnp.asarray(T0 + pos, jnp.int32))
        outs.append(out)
        pos += n
    return ([np.asarray(c) for c in carry]
            + [np.concatenate([np.asarray(o[k]) for o in outs]) for k in range(3)])


def run_torch_decode(fn, tables, am, carry, dtype):
    td = getattr(torch, dtype)
    args = tuple(torch.from_numpy(np.asarray(a)) for a in lex_arrays(tables)) + (
        torch.from_numpy(tables.tdp_within), torch.from_numpy(tables.entry_pen))
    hyp, bkp, book = carry
    carry = (torch.from_numpy(hyp).to(td), torch.from_numpy(bkp), torch.from_numpy(book).to(td))
    outs, pos = [], 0
    for n in CHUNKS:
        carry, out = fn(torch.from_numpy(np.ascontiguousarray(am[:, pos:pos + n])).to(td),
                        torch.from_numpy(DEC_LENS), *args, 60.0, prune=True, carry_in=carry,
                        t0=T0 + pos)
        outs.append(out)
        pos += n
    return ([c.numpy() for c in carry]
            + [np.concatenate([o[k].numpy() for o in outs]) for k in range(3)])


def run_jax_decode_df(tables, am64, carry):
    am = jdf.from_f64(am64)
    tdp, ent = jdf.from_f64(tables.tdp_within), jdf.from_f64(tables.entry_pen)
    args = (*(jnp.asarray(a) for a in lex_arrays(tables)), tdp.hi, tdp.lo, ent.hi, ent.lo,
            jnp.asarray(60.0, jnp.float32))
    hyp, bkp, book = carry
    h, bo = jdf.from_f64(hyp), jdf.from_f64(book)
    carry = ((h.hi, h.lo), jnp.asarray(bkp), (bo.hi, bo.lo))
    outs, pos = [], 0
    for n in CHUNKS:
        carry, out = jdec._decode_scan_df(
            am.hi[:, pos:pos + n], am.lo[:, pos:pos + n], jnp.asarray(DEC_LENS), *args,
            prune=True, carry_in=carry, t0=jnp.asarray(T0 + pos, jnp.int32))
        outs.append(out)
        pos += n
    (hh, hl), bk, (bh, bl) = carry
    return ([np.asarray(x) for x in (hh, hl, bk, bh, bl)]
            + [np.concatenate([np.asarray(o[k]) for o in outs]) for k in range(3)])


def run_torch_decode_df(fn, tables, am64, carry):
    am = tdf.from_f64(am64)
    args = (*(torch.from_numpy(np.asarray(a)) for a in lex_arrays(tables)),
            tdf.from_f64(tables.tdp_within), tdf.from_f64(tables.entry_pen))
    hyp, bkp, book = carry
    carry = (tdf.from_f64(hyp), torch.from_numpy(bkp), tdf.from_f64(book))
    outs, pos = [], 0
    for n in CHUNKS:
        carry, out = fn(tdf.DF(am.hi[:, pos:pos + n].contiguous(),
                               am.lo[:, pos:pos + n].contiguous()),
                        torch.from_numpy(DEC_LENS), *args, 60.0, prune=True, carry_in=carry,
                        t0=T0 + pos)
        outs.append(out)
        pos += n
    hyp, bk, book = carry
    return ([x.numpy() for x in (hyp.hi, hyp.lo, bk, book.hi, book.lo)]
            + [np.concatenate([o[k].numpy() for o in outs]) for k in range(3)])


@pytest.fixture(scope="module")
def jax_decodes(dec_inputs):
    """kind → the JAX scan's carry and outputs, each computed once."""
    cache = {}

    def run(kind):
        if kind not in cache:
            tables, am, carry = dec_inputs
            cache[kind] = (run_jax_decode_df(tables, am, carry) if kind == "df32"
                           else run_jax_decode(tables, am, carry, kind))
        return cache[kind]

    return run


def torch_decode(kind, dec_inputs, fn=None):
    tables, am, carry = dec_inputs
    if kind == "df32":
        return run_torch_decode_df(fn or tdec.decode_scan_df_reference, tables, am, carry)
    return run_torch_decode(fn or tdec.decode_scan_reference, tables, am, carry, kind)


def assert_all_equal(got, want):
    assert len(got) == len(want)
    for k, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=str(k))


@pytest.mark.parametrize("kind", ["float32", "float64", "df32"])
def test_decode_plain_equals_jax_past_1024_slots(jax_decodes, dec_inputs, kind):
    got = torch_decode(kind, dec_inputs)
    assert_all_equal(got, jax_decodes(kind))
    words = got[-2]
    assert len(np.unique(words)) > 3             # the word-end choice is exercised


@pytest.mark.parametrize("kind", ["float32", "float64", "df32"])
def test_decode_wrapper_takes_past_1024_slots(dec_inputs, kind):
    fn = tdec.decode_scan_df if kind == "df32" else tdec.decode_scan
    before = fn.LAUNCHES
    assert_all_equal(torch_decode(kind, dec_inputs, fn=fn), torch_decode(kind, dec_inputs))
    assert fn.LAUNCHES == before                 # the CPU takes the plain version
    assert not hasattr(tdec, "MAX_SLOTS")


# -- the alignment DP at A = 1,100 ---------------------------------------------------


@pytest.fixture(scope="module")
def align_inputs():
    rng = np.random.default_rng(63)
    A = ALIGN_A
    ams = rng.uniform(0.0, 40.0, size=(B, sum(CHUNKS), A))
    tdp = rng.uniform(0.0, 20.0, size=(B, A, 3))
    aut = np.array([A, A - 37, 5], np.int32)
    pos_valid = np.arange(A)[None, :] < aut[:, None]
    prev = rng.uniform(0.0, 50.0, size=(B, A))
    return ams, tdp, pos_valid, prev


def run_jax_align(kind, inputs, tie):
    ams, tdp, pos_valid, prev = inputs
    thr, prune = 60.0, tie
    jumps, pos = [], 0
    if kind == "df32":
        jam, jt, jthr = jdf.from_f64(ams), jdf.from_f64(tdp), jdf.from_f64(np.float64(thr))
        p = jdf.from_f64(prev)
        carry = (p.hi, p.lo)
        for n in CHUNKS:
            hi, lo, j = jvit._align_fwd_chunk_df(
                carry[0], carry[1], jam.hi[:, pos:pos + n], jam.lo[:, pos:pos + n], jt.hi, jt.lo,
                jnp.asarray(pos_valid), jnp.asarray(ALIGN_LENS), jthr.hi, jthr.lo,
                jnp.asarray(T0 + pos, jnp.int32), tie_pruned=tie, use_pruning=prune)
            carry = (hi, lo)
            jumps.append(np.asarray(j))
            pos += n
        return [np.asarray(carry[0]), np.asarray(carry[1]), np.concatenate(jumps)]
    jd = getattr(jnp, kind)
    carry = jnp.asarray(prev, jd)
    for n in CHUNKS:
        carry, j = jvit._align_fwd_chunk(
            carry, jnp.asarray(ams[:, pos:pos + n], jd), jnp.asarray(tdp, jd),
            jnp.asarray(pos_valid), jnp.asarray(ALIGN_LENS), jnp.asarray(thr, jd),
            jnp.asarray(T0 + pos, jnp.int32), tie_pruned=tie, use_pruning=prune)
        jumps.append(np.asarray(j))
        pos += n
    return [np.asarray(carry), np.concatenate(jumps)]


def run_torch_align(kind, inputs, tie, wrapper=False):
    ams, tdp, pos_valid, prev = inputs
    thr, prune = 60.0, tie
    jumps, pos = [], 0
    valid, lens = torch.from_numpy(pos_valid), torch.from_numpy(ALIGN_LENS)
    if kind == "df32":
        fn = tvit.align_fwd_chunk_df if wrapper else tvit.align_fwd_chunk_df_reference
        tam, tt, tthr = tdf.from_f64(ams), tdf.from_f64(tdp), tdf.from_f64(np.float64(thr))
        carry = tdf.from_f64(prev)
        for n in CHUNKS:
            carry, j = fn(carry, tdf.DF(tam.hi[:, pos:pos + n].contiguous(),
                                        tam.lo[:, pos:pos + n].contiguous()),
                          tt, valid, lens, tthr, T0 + pos, tie_pruned=tie, use_pruning=prune)
            jumps.append(j.numpy())
            pos += n
        return [carry.hi.numpy(), carry.lo.numpy(), np.concatenate(jumps)]
    fn = tvit.align_fwd_chunk if wrapper else tvit.align_fwd_chunk_reference
    td = getattr(torch, kind)
    carry = torch.from_numpy(prev).to(td)
    for n in CHUNKS:
        carry, j = fn(carry, torch.from_numpy(np.ascontiguousarray(ams[:, pos:pos + n])).to(td),
                      torch.from_numpy(tdp).to(td), valid, lens, thr, T0 + pos,
                      tie_pruned=tie, use_pruning=prune)
        jumps.append(j.numpy())
        pos += n
    return [carry.numpy(), np.concatenate(jumps)]


@pytest.fixture(scope="module")
def jax_aligns(align_inputs):
    cache = {}

    def run(kind, tie):
        if (kind, tie) not in cache:
            cache[kind, tie] = run_jax_align(kind, align_inputs, tie)
        return cache[kind, tie]

    return run


@pytest.mark.parametrize("tie", [True, False], ids=["pruned", "full-dp"])
@pytest.mark.parametrize("kind", ["float32", "float64", "df32"])
def test_align_plain_equals_jax_past_1024_positions(jax_aligns, align_inputs, kind, tie):
    got = run_torch_align(kind, align_inputs, tie)
    assert got[0].shape == (B, ALIGN_A)
    assert_all_equal(got, jax_aligns(kind, tie))
    live = got[0] < 1e29
    assert live[0, 1024:].any()                  # positions past 1,024 carry scores


@pytest.mark.parametrize("kind", ["float32", "float64", "df32"])
def test_align_wrapper_takes_past_1024_positions(align_inputs, kind):
    fn = tvit.align_fwd_chunk_df if kind == "df32" else tvit.align_fwd_chunk
    before = fn.LAUNCHES
    assert_all_equal(run_torch_align(kind, align_inputs, True, wrapper=True),
                     run_torch_align(kind, align_inputs, True))
    assert fn.LAUNCHES == before
    assert not hasattr(tvit, "MAX_POSITIONS")
