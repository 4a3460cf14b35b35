"""decode_scan_bigram (kernel J's wrapper; on CPU tensors its plain version)
against the JAX package's ``_decode_scan_bigram`` at the edges of kernel J's
warp instance and just past them: W in {1, 4, 5, 32, 33} words and P in {2,
3, 8, 9, 32, 33} positions (the warp instance takes W <= 32 and P <= 32; a
lane holds ceil(P / 8) positions and a lane group of 8 splits the W
predecessors of the min-plus product), float32 and float64. Random lexica
with repetition 1 (positions 0 and 1 are different states, so the entry
emission rule matters), utterances of T, 1, 0 and T - 3 frames. Two tie
cases on integer scores with zero TDPs: LM rows that are all equal (every
predecessor ties; the first one wins) and a start row equal to the
predecessors' sum at frame 1 (BIG + 0: the predecessor wins, the start row
only where strictly less). Every output is bit-equal.
tests/test_torch_cuda.py holds the kernel against the plain version at the
same edges.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.search.ngram_decoder as jng

import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.search.decoder as tdec
import speechrecognition_torch.search.ngram_decoder as tng
from speechrecognition_torch.search.decoder import BIG
from speechrecognition_torch.tdp import TdpModel

torch.set_num_threads(1)

B, T = 4, 12
LENS = np.array([T, 1, 0, T - 3], np.int32)
#: (W, P) at and just past the warp instance's edges
SHAPES = [(1, 2), (4, 3), (5, 8), (4, 9), (32, 32), (33, 8), (4, 33), (5, 2), (32, 9),
          (1, 33)]
JDT = {"float32": jnp.float32, "float64": jnp.float64}


def edge_tables(W, P, flat):
    """Silence (P states when it is the only word, else 1) plus W - 1 words
    with repetition 1, the first of P states: a W x P lattice. ``flat``: every
    TDP 0."""
    rng = np.random.default_rng(W * 100 + P)
    lex = tlex.Lexicon()
    lex.add_word("[silence]", P if W == 1 else 1, 1, silence=True)
    for w in range(W - 1):
        lex.add_word(f"w{w}", P if w == 0 else int(rng.integers(2, P + 1)), 1)
    pen = (0.0, 0.0, 0.0) if flat else (2.0, 0.5, 9.0)
    tdp = TdpModel(silence_state=lex.silence_state, loop=pen[0], forward=pen[1], skip=pen[2])
    tables = tdec.DecoderTables.build(lex, tdp, 0.0)
    assert tables.state_table.shape == (W, P)
    return tables, lex.num_states


def case_inputs(W, P, case):
    """Tables, scores [B, T, S], lm [W, W], lm_start [W] and the threshold."""
    tables, S = edge_tables(W, P, flat=case != "random")
    rng = np.random.default_rng(W * 7 + P + len(case))
    if case == "random":
        return (tables, rng.uniform(0.0, 40.0, size=(B, T, S)),
                rng.uniform(0.0, 25.0, size=(W, W)), rng.uniform(0.0, 25.0, size=W), 60.0)
    am = rng.integers(0, 3, size=(B, T, S)).astype(np.float64)
    if case == "tied-rows":
        row = np.round(rng.uniform(0.0, 2.0, size=W))
        return tables, am, np.tile(row, (W, 1)), row.copy(), 6.0
    # "start-tie": at frame 1 every book is BIG, so a predecessor offers
    # BIG + lm[v, w]; where lm[:, w] is 0 and the start row BIG they tie
    lm = np.round(rng.uniform(0.0, 2.0, size=(W, W)))
    start = np.round(rng.uniform(0.0, 2.0, size=W))
    lm[:, ::2] = 0.0
    start[::2] = BIG
    return tables, am, lm, start, 6.0


def table_arrays(tables):
    return (tables.state_table, tables.last_pos, tables.word_len, tables.tdp_within,
            tables.entry_pen)


@pytest.fixture(scope="module")
def jax_scan():
    """The JAX scan's outputs, memoised per case."""
    cache = {}

    def run(W, P, dtype, case):
        key = (W, P, dtype, case)
        if key not in cache:
            tables, am, lm, start, thr = case_inputs(W, P, case)
            jd = JDT[dtype]
            out = jng._decode_scan_bigram(
                jnp.asarray(am, jd), jnp.asarray(LENS), jnp.asarray(tables.state_table),
                jnp.asarray(tables.last_pos), jnp.asarray(tables.word_len),
                jnp.asarray(tables.first_state), jnp.asarray(tables.tdp_within),
                jnp.asarray(tables.entry_pen), jnp.asarray(lm), jnp.asarray(start),
                jnp.asarray(thr, jd), prune=True)
            cache[key] = [np.asarray(x) for x in out]
        return cache[key]

    return run


CASES = ([(W, P, dt, "random") for W, P in SHAPES[:6] for dt in ("float32", "float64")]
         + [(W, P, "float32", "random") for W, P in SHAPES[6:]]
         + [(W, P, dt, case) for W, P in ((4, 9), (32, 32), (33, 8))
            for dt in ("float32", "float64") for case in ("tied-rows", "start-tie")])


@pytest.mark.parametrize("W,P,dtype,case", CASES)
def test_decode_scan_bigram_equals_jax_at_the_warp_edges(jax_scan, W, P, dtype, case):
    tables, am, lm, start, thr = case_inputs(W, P, case)
    td = getattr(torch, dtype)
    args = [torch.from_numpy(np.asarray(a)) for a in table_arrays(tables)]
    got = tng.decode_scan_bigram(torch.from_numpy(am).to(td), torch.from_numpy(LENS), *args,
                                 torch.from_numpy(lm), torch.from_numpy(start), thr)
    want = jax_scan(W, P, dtype, case)
    assert len(got) == len(want) == 4
    for name, g, w in zip(("book", "bkp", "pred", "offset"), got, want):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name
    book, pred = got[0].numpy(), got[2].numpy()
    assert book.dtype == np.dtype(dtype)
    if case != "random":
        # words are entered from predecessors that tie with one another
        assert (pred >= 0).any()
    if case == "start-tie":
        # the one-position silence ends at frame 1 entered from predecessor
        # 0, which ties with its start row (BIG), not from the start (-1)
        assert (pred[0, :, 0] == 0).all()
