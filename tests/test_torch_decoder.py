"""decode_scan_reference (kernel B's plain version) against the JAX
package's ``_decode_scan``.

Every operation of the step is an add, compare, select or min on the same
dtype, so all outputs must be bit-equal: ``word``/``bkp`` per frame, the
per-frame best ``score``, and the carried ``hyp``/``bkp``/``book``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.search.decoder as jdec

import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.search.decoder as tdec
from speechrecognition_torch.tdp import TdpModel

B, T = 4, 50
LENS = np.array([50, 37, 12, 0], np.int32)     # full, short, very short, padding


def sietill_tables(prune=True, flat=False):
    """SieTill tables; ``flat`` zeroes every TDP and the word penalty, so
    that integer acoustic scores tie across words and jumps."""
    lex = tlex.build_sietill_lexicon()
    pen = (0.0, 0.0, 0.0, 0.0) if flat else (3.0, 0.0, 30.0, 80.0)
    tdp = TdpModel(silence_state=lex.silence_state, loop=pen[0], forward=pen[1], skip=pen[2])
    return (tdec.DecoderTables.build(lex, tdp, pen[3], exclude_last_pred=prune),
            lex.num_states)


def repetition1_tables(seed):
    """A random lexicon with repetition 1: positions 0 and 1 of a word are
    different states, so the entry emission rule matters."""
    rng = np.random.default_rng(seed)
    lex = tlex.Lexicon()
    lex.add_word("[silence]", 1, 1, silence=True)
    for w in range(7):
        lex.add_word(f"w{w}", int(rng.integers(2, 13)), 1)
    st = lex.state_table()
    assert (st[1:, 0] != st[1:, 1]).all()
    tdp = TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)
    return tdec.DecoderTables.build(lex, tdp, 15.0), lex.num_states


def table_arrays(tables):
    return (tables.state_table, tables.last_pos, tables.word_len,
            tables.first_state, tables.tdp_within, tables.entry_pen)


def run_jax(tables, am, lens, thr, prune, dtype, chunks, exit_pen=None):
    jd = getattr(jnp, dtype)
    args = tuple(jnp.asarray(a) for a in table_arrays(tables))
    W, P = tables.state_table.shape
    carry = (jnp.full((B, W, P), jdec.BIG, jd), jnp.zeros((B, W, P), jnp.int32),
             jnp.zeros((B,), jd))
    outs, t0 = [], 0
    for n in chunks:
        carry, out = jdec._decode_scan(
            jnp.asarray(am[:, t0:t0 + n], jd), jnp.asarray(lens), *args,
            jnp.asarray(thr, jd), prune=prune, carry_in=carry,
            t0=jnp.asarray(t0, jnp.int32),
            exit_pen=None if exit_pen is None else jnp.asarray(exit_pen))
        outs.append(out)
        t0 += n
    return ([np.asarray(c) for c in carry],
            [np.concatenate([np.asarray(o[k]) for o in outs]) for k in range(3)])


def run_torch(tables, am, lens, thr, prune, dtype, chunks, exit_pen=None, fn=None):
    fn = fn or tdec.decode_scan_reference
    td = getattr(torch, dtype)
    args = tuple(torch.from_numpy(np.asarray(a)) for a in table_arrays(tables))
    carry, outs, t0 = None, [], 0
    for n in chunks:
        carry, out = fn(torch.from_numpy(np.ascontiguousarray(am[:, t0:t0 + n])).to(td),
                        torch.from_numpy(lens), *args, thr, prune=prune,
                        carry_in=carry, t0=t0,
                        exit_pen=None if exit_pen is None else torch.from_numpy(exit_pen))
        outs.append(out)
        t0 += n
    return ([c.numpy() for c in carry],
            [np.concatenate([o[k].numpy() for o in outs]) for k in range(3)])


def assert_same(a, b):
    (ca, oa), (cb, ob) = a, b
    for name, x, y in zip(("hyp", "bkp", "book", "score", "word", "bkp"),
                          ca + oa, cb + ob):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def random_am(S, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:   # many exact ties: exercises every tie-breaking rule
        return rng.integers(0, 3, size=(B, T, S)).astype(np.float64)
    return rng.uniform(0.0, 40.0, size=(B, T, S))


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_matches_jax_sietill(dtype, prune):
    tables, S = sietill_tables(prune)
    am = random_am(S, seed=1)
    args = (tables, am, LENS, 60.0, prune, dtype, (T,))
    assert_same(run_jax(*args), run_torch(*args))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_matches_jax_two_chunks(dtype):
    tables, S = sietill_tables()
    am = random_am(S, seed=2)
    chunked = run_torch(tables, am, LENS, 60.0, True, dtype, (30, 20))
    assert_same(run_jax(tables, am, LENS, 60.0, True, dtype, (30, 20)), chunked)
    assert_same(run_torch(tables, am, LENS, 60.0, True, dtype, (T,)), chunked)


@pytest.mark.parametrize("seed", [3, 4])
def test_matches_jax_repetition1(seed):
    tables, S = repetition1_tables(seed)
    am = random_am(S, seed=seed)
    args = (tables, am, LENS, 25.0, True, "float32", (T,))
    assert_same(run_jax(*args), run_torch(*args))


def test_matches_jax_exit_penalty():
    tables, S = sietill_tables()
    exit_pen = np.random.default_rng(5).uniform(0.0, 20.0, size=tables.num_words)
    am = random_am(S, seed=5)
    args = (tables, am, LENS, 60.0, True, "float32", (T,))
    assert_same(run_jax(*args, exit_pen=exit_pen), run_torch(*args, exit_pen=exit_pen))


@pytest.mark.parametrize("prune", [True, False])
def test_matches_jax_ties(prune):
    tables, S = sietill_tables(prune, flat=True)
    am = random_am(S, seed=6, integer=True)
    args = (tables, am, LENS, 4.0, prune, "float32", (T,))
    assert_same(run_jax(*args), run_torch(*args))


def test_wrapper_on_cpu_is_the_plain_version():
    tables, S = sietill_tables()
    am = random_am(S, seed=8)
    before = tdec.decode_scan.LAUNCHES
    args = (tables, am, LENS, 60.0, True, "float32", (30, 20))
    assert_same(run_torch(*args, fn=tdec.decode_scan), run_torch(*args))
    assert tdec.decode_scan.LAUNCHES == before


def test_wrapper_refuses_other_devices():
    tables, S = sietill_tables()
    args = tuple(torch.from_numpy(np.asarray(a)) for a in table_arrays(tables))
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_scan(torch.empty((B, T, S), device="meta"),
                         torch.from_numpy(LENS), *args, 60.0)
