"""decode_scan (kernel B's wrapper; on CPU tensors its plain version) against
the JAX package's ``_decode_scan`` at the edges of kernel B's warp
instance: W x P = 1 x 2 (one word), 4 x 9 (P one past a lane's 8
positions), 32 x 32 (its widest lattice), and 33 x 8 and 4 x 33, which take
its block instance. Random lexica with repetition 1 (positions 0 and 1 are
different states, so the entry emission rule matters), float32 and
float64, two chunks from a random live carry (every slot takes part),
utterances of 0 frames and ending mid-chunk; once with an exit penalty.
Every output is bit-equal. tests/test_torch_cuda.py holds the kernel against
the plain version at the same shapes.

Each JAX result is computed once per module (each shape compiles once).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.search.decoder as jdec

import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.search.decoder as tdec
from speechrecognition_torch.tdp import TdpModel

torch.set_num_threads(1)

SHAPES = [(1, 2), (4, 9), (32, 32), (33, 8), (4, 33)]
B = 4
CHUNK = 7                  # two chunks of 7 frames
T0 = 3                     # the carry enters at frame 3
LENS = np.array([14, 9, 0, 13], np.int32)


def edge_tables(W, P):
    """Silence (P states when it is the only word, else 1) plus W - 1 words
    with repetition 1, the first of P states: a W x P lattice."""
    rng = np.random.default_rng(W * 100 + P)
    lex = tlex.Lexicon()
    lex.add_word("[silence]", P if W == 1 else 1, 1, silence=True)
    for w in range(W - 1):
        lex.add_word(f"w{w}", P if w == 0 else int(rng.integers(2, P + 1)), 1)
    tdp = TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)
    tables = tdec.DecoderTables.build(lex, tdp, 15.0)
    assert tables.state_table.shape == (W, P)
    return tables, lex.num_states


@pytest.fixture(scope="module")
def lattices():
    """Tables, scores, a live carry and exit penalties for every shape."""
    out = {}
    for W, P in SHAPES:
        tables, S = edge_tables(W, P)
        rng = np.random.default_rng(W + P)
        out[W, P] = (tables, rng.uniform(0.0, 40.0, size=(B, 2 * CHUNK, S)),
                     (rng.uniform(0.0, 40.0, size=(B, W, P)),
                      rng.integers(0, T0, size=(B, W, P)).astype(np.int32),
                      rng.uniform(0.0, 10.0, size=B)),
                     rng.uniform(0.0, 20.0, size=W))
    return out


def table_arrays(tables):
    return (tables.state_table, tables.last_pos, tables.word_len, tables.first_state,
            tables.tdp_within, tables.entry_pen)


@pytest.fixture(scope="module")
def jax_scan(lattices):
    """The JAX scan's outputs over both chunks, memoised per case."""
    cache = {}

    def run(W, P, dtype, exit_pen):
        key = (W, P, dtype, exit_pen)
        if key not in cache:
            tables, am, (hyp, bkp, book), xp = lattices[W, P]
            jd = getattr(jnp, dtype)
            args = tuple(jnp.asarray(a) for a in table_arrays(tables))
            carry = (jnp.asarray(hyp, jd), jnp.asarray(bkp), jnp.asarray(book, jd))
            outs = []
            for c in range(2):
                carry, out = jdec._decode_scan(
                    jnp.asarray(am[:, c * CHUNK:(c + 1) * CHUNK], jd), jnp.asarray(LENS),
                    *args, jnp.asarray(60.0, jd), prune=True, carry_in=carry,
                    t0=jnp.asarray(T0 + c * CHUNK, jnp.int32),
                    exit_pen=jnp.asarray(xp) if exit_pen else None)
                outs.append(out)
            cache[key] = ([np.asarray(x) for x in carry]
                          + [np.concatenate([np.asarray(o[k]) for o in outs]) for k in range(3)])
        return cache[key]

    return run


CASES = ([(W, P, dt, False) for W, P in SHAPES for dt in ("float32", "float64")]
         + [(4, 9, "float32", True)])


@pytest.mark.parametrize("W,P,dtype,exit_pen", CASES)
def test_decode_scan_equals_jax_at_the_warp_edges(lattices, jax_scan, W, P, dtype, exit_pen):
    tables, am, (hyp, bkp, book), xp = lattices[W, P]
    td = getattr(torch, dtype)
    args = tuple(torch.from_numpy(np.asarray(a)) for a in table_arrays(tables))
    carry = (torch.from_numpy(hyp).to(td), torch.from_numpy(bkp), torch.from_numpy(book).to(td))
    outs = []
    for c in range(2):
        carry, out = tdec.decode_scan(
            torch.from_numpy(np.ascontiguousarray(am[:, c * CHUNK:(c + 1) * CHUNK])).to(td),
            torch.from_numpy(LENS), *args, 60.0, prune=True, carry_in=carry,
            t0=T0 + c * CHUNK, exit_pen=torch.from_numpy(xp) if exit_pen else None)
        outs.append(out)
    got = [c.numpy() for c in carry] + [torch.cat([o[k] for o in outs]).numpy()
                                        for k in range(3)]
    want = jax_scan(W, P, dtype, exit_pen)
    for name, g, w in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].dtype == np.dtype(dtype)
    if W > 1:
        assert len(np.unique(got[4])) > 1
