"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present. This file
imports no jax, so it also runs where the JAX package is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest because tests/conftest.py configures jax). Criteria as in
chip_smoke.py: kernel A within 1e-6 relative of its plain version over
active slots (FMA contraction and operation order), at dims up to 128, and
its fused entry bit-equal to the capped minimum of the unfused one; kernel B (float32 and
float64), kernel C (double-float scores, also on tables whose magnitudes
span 1e-6 .. 1e6) and kernel D (double-float scan) bit-equal, hi and lo,
the scans B and D on lattices of every instance up to 24,000 slots (B's
warp instance from 1 x 2 to 32 x 32); the trainer's kernels E (alignment
DP, float32 and
float64, every instance: warp, and block with its row in shared memory or
past A = 1,024 in device scratch), F (its
double-float twin, every instance, every lane boundary up to A = 3,000)
and G (backtrack: tests/torch_df_tables.py's cases, Tp up to 3,000, A up
to 120,000, jumps off a 16-byte boundary) bit-equal, kernel H
(double-float E-step) with w bit-equal, its float64 sums within 1e-12
relative and two launches bit-identical; the golden demo trainer in df32
and f64 on the card; the search tier's kernels I (tree scan), J (bigram
scan) and K (word-conditioned tree search, every option, two chunks with
carry) bit-equal in float32 and float64, also on prefix-sharing trees and
past shared memory (tests/torch_search_tables.py's inputs), I's owner
instance and first design at the owner instance's edges; kernel L
(forward-backward, float32 and float64, every instance: 1 to 3 positions a
lane, the block instance with its rows in shared memory and past A = 1,024
in device scratch, and the first design of the A <= 96 instance;
tests/torch_fb_tables.py's inputs with ragged lengths, T = 1 and
unreachable final positions) bit-equal to its plain version, gamma and
log_z, each of its two chains alone bit-equal to its plain phase, and
baum_welch_posteriors / accumulate_baum_welch on the card within 1e-12 of
the same calls on the CPU.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from speechrecognition_torch.config import Configuration
from speechrecognition_torch.corpus import Corpus, CorpusDescription
from speechrecognition_torch.features.frontend import SignalAnalysisConfig
from speechrecognition_torch.io import read_mixture_set
from speechrecognition_torch.lexicon import Lexicon, build_sietill_lexicon
from speechrecognition_torch.models import gmm
from speechrecognition_torch.ops import doublefloat as dfm
from speechrecognition_torch.ops import mahalanobis as maha
from speechrecognition_torch.search import decoder as dec
from speechrecognition_torch.tdp import TdpModel
from torch_df_tables import (BACKTRACK_CASES, backtrack_frames, backtrack_inputs,
                             wide_magnitude_pack_df)
from torch_fb_tables import L_INSTANCES, fb_inputs
from torch_linear_tables import TRACEBACK_STARTS, TRACEBACK_WIDTHS
from torch_nan_tables import NAN_FRAME, NAN_LENS, nan_lexicon_tables, nan_scores, same_bits

pytestmark = pytest.mark.cuda

FIX = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return ((got - ref).abs() / (1.0 + ref.abs())).max().item()


def random_tables(dev, n, j, dim, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, dim)).astype(np.float32), device=dev)
    mu = torch.as_tensor(rng.normal(size=(j, dim)).astype(np.float32), device=dev)
    a = torch.as_tensor(rng.uniform(0.1, 2.0, size=(j, dim)).astype(np.float32), device=dev)
    c = torch.as_tensor(rng.uniform(10.0, 40.0, size=j).astype(np.float32), device=dev)
    return x, mu, a, c


@pytest.mark.parametrize("n,j,dim", [(777, 300, 25), (64, 64, 25), (1, 1, 13), (4100, 130, 64),
                                     (300, 70, 100), (64, 80, 128)])
def test_kernel_a_matches_plain(dev, n, j, dim):
    """Any dim up to 128 (the generic instance past dim 25), J not a multiple
    of the block's 32 slots, N not a multiple of its frames."""
    x, mu, a, c = random_tables(dev, n, j, dim, seed=n + j + dim)
    before = maha.mahalanobis_scores.LAUNCHES
    got = maha.mahalanobis_scores(x, mu, a, c)
    torch.cuda.synchronize()
    assert maha.mahalanobis_scores.LAUNCHES == before + 1
    assert got.shape == (n, j) and got.dtype == torch.float32
    assert rel_err(got, maha.mahalanobis_scores_reference(x, mu, a, c)) <= 1e-6


@pytest.mark.parametrize("n,s,d,dim", [(777, 19, 16, 25), (1, 1, 1, 13), (4100, 106, 4, 25),
                                       (300, 7, 3, 100), (64, 5, 16, 128), (200, 3, 128, 64),
                                       (300, 5, 40, 25)])
def test_kernel_a_fused_min(dev, n, s, d, dim):
    """The fused entry: bit-equal to the capped minimum of the unfused kernel
    on the same tensors (one routine scores both), within 1e-6 relative of its
    plain version; a mixture of inactive slots gives the cap. D = 40 and 128
    take several rounds of staged slots (shared memory does not grow with D)."""
    x, mu, a, c = random_tables(dev, n, s * d, dim, seed=n + s + d + dim)
    mu[-d:] = 0.0
    a[-d:] = 0.0
    c[-d:] = gmm.INACTIVE_SCORE
    before = (maha.mahalanobis_min_scores.LAUNCHES, maha.mahalanobis_scores.LAUNCHES)
    got = maha.mahalanobis_min_scores(x, mu, a, c, d)
    unfused = maha.mahalanobis_scores(x, mu, a, c)
    ref = maha.mahalanobis_min_scores_reference(x, mu, a, c, d)
    torch.cuda.synchronize()
    assert (maha.mahalanobis_min_scores.LAUNCHES, maha.mahalanobis_scores.LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert got.shape == (n, s) and got.dtype == torch.float32
    expect = torch.clamp(unfused.reshape(n, s, d).amin(dim=-1), max=gmm.MIN_SCORE_INIT)
    assert torch.equal(got, expect)
    assert bool((got[:, -1] == 1e10).all())
    assert rel_err(got, ref) <= 1e-6


def test_kernel_a_demo_model(dev):
    model = gmm.MixtureModel.from_raw(read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                      gmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    pack = model.pack(method="pallas", device=dev)
    active = pack.active.reshape(-1)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(1000, 25)).astype(np.float32),
                        device=dev)
    got = maha.mahalanobis_scores(x, pack.mu, pack.a, pack.c)
    ref = maha.mahalanobis_scores_reference(x, pack.mu, pack.a, pack.c)
    assert rel_err(got[:, active], ref[:, active]) <= 1e-6
    assert torch.equal(got[:, ~active], ref[:, ~active])
    fused = gmm.am_scores(pack, x)
    expect = torch.clamp(got.reshape(1000, 106, -1).amin(dim=-1), max=gmm.MIN_SCORE_INIT)
    assert torch.equal(fused, expect)


def test_kernel_a_checks_inputs(dev):
    x = torch.zeros((8, 25), device=dev)
    mu = torch.zeros((4, 25), device=dev)
    c = torch.zeros(4, device=dev)
    with pytest.raises(TypeError):
        maha.mahalanobis_scores(x.double(), mu, mu, c)
    with pytest.raises(ValueError, match="contiguous"):
        maha.mahalanobis_scores(torch.zeros((25, 8), device=dev).t(), mu, mu, c)
    with pytest.raises(ValueError, match="on"):
        maha.mahalanobis_scores(x, mu.cpu(), mu, c)
    with pytest.raises(ValueError, match="S·D"):
        maha.mahalanobis_min_scores(x, mu, mu, c, 3)
    wide = torch.zeros((8, 129), device=dev)
    with pytest.raises(ValueError, match="1..128"):
        maha.mahalanobis_scores(wide, wide[:4], wide[:4], c)
    with pytest.raises(ValueError, match="1..128"):
        maha.mahalanobis_min_scores(wide, wide[:4], wide[:4], c, 2)


def sietill_tables(prune=True, flat=False):
    """SieTill tables; ``flat`` zeroes every TDP and the word penalty, so
    that integer acoustic scores tie across words and jumps."""
    lex = build_sietill_lexicon()
    pen = (0.0, 0.0, 0.0, 0.0) if flat else (3.0, 0.0, 30.0, 80.0)
    tdp = TdpModel(silence_state=lex.silence_state, loop=pen[0], forward=pen[1], skip=pen[2])
    return (dec.DecoderTables.build(lex, tdp, pen[3], exclude_last_pred=prune),
            lex.num_states)


def repetition1_tables():
    rng = np.random.default_rng(11)
    lex = Lexicon()
    lex.add_word("[silence]", 1, 1, silence=True)
    for w in range(7):
        lex.add_word(f"w{w}", int(rng.integers(2, 13)), 1)
    tdp = TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)
    return dec.DecoderTables.build(lex, tdp, 15.0), lex.num_states


def scan_both(dev, tables, am, lens, thr, prune, chunks, exit_pen=None,
              dtype=torch.float32):
    targs = tuple(torch.as_tensor(a, device=dev) for a in (
        tables.state_table, tables.last_pos, tables.word_len, tables.first_state,
        tables.tdp_within, tables.entry_pen))
    xp = None if exit_pen is None else torch.as_tensor(exit_pen, device=dev)
    lens = torch.as_tensor(lens, device=dev)
    results = []
    for fn in (dec.decode_scan, dec.decode_scan_reference):
        carry, outs, t0 = None, [], 0
        for n in chunks:
            am_c = torch.as_tensor(am[:, t0:t0 + n], dtype=dtype, device=dev)
            carry, out = fn(am_c.contiguous(), lens, *targs, thr, prune=prune,
                            carry_in=carry, t0=t0, exit_pen=xp)
            outs.append(out)
            t0 += n
        results.append(list(carry) + [torch.cat([o[k] for o in outs]) for k in range(3)])
    torch.cuda.synchronize()
    return results


@pytest.mark.parametrize("case", ["pruned", "unpruned", "two-chunks", "exit-pen",
                                  "ties", "repetition-1"])
def test_kernel_b_bit_equal(dev, case):
    B, T = 5, 60
    lens = np.array([60, 41, 13, 0, 59], np.int32)
    tables, S = (repetition1_tables() if case == "repetition-1"
                 else sietill_tables(prune=case != "unpruned", flat=case == "ties"))
    rng = np.random.default_rng(len(case))
    am = (rng.integers(0, 3, size=(B, T, S)).astype(np.float64) if case == "ties"
          else rng.uniform(0.0, 40.0, size=(B, T, S)))
    exit_pen = (rng.uniform(0.0, 20.0, size=tables.num_words)
                if case == "exit-pen" else None)
    chunks = (25, 35) if case == "two-chunks" else (T,)
    thr = 4.0 if case == "ties" else 60.0
    from speechrecognition_torch.ops import _native
    W, P = tables.state_table.shape
    assert _native.load().sr_decode_scan_instance(W, P) == D_INSTANCES[W, P] > 0
    before = dec.decode_scan.LAUNCHES
    kern, plain = scan_both(dev, tables, am, lens, thr, case != "unpruned", chunks, exit_pen)
    assert dec.decode_scan.LAUNCHES == before + len(chunks)
    for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"), kern, plain):
        assert k.dtype == p.dtype and torch.equal(k, p), name


@pytest.mark.parametrize("case", ["pruned", "unpruned", "two-chunks", "exit-pen"])
def test_kernel_b_float64_bit_equal(dev, case):
    B, T = 5, 60
    lens = np.array([60, 41, 13, 0, 59], np.int32)
    tables, S = sietill_tables(prune=case != "unpruned")
    rng = np.random.default_rng(20 + len(case))
    am = rng.uniform(0.0, 40.0, size=(B, T, S))
    exit_pen = (rng.uniform(0.0, 20.0, size=tables.num_words)
                if case == "exit-pen" else None)
    chunks = (25, 35) if case == "two-chunks" else (T,)
    before = dec.decode_scan.LAUNCHES
    kern, plain = scan_both(dev, tables, am, lens, 60.0, case != "unpruned", chunks,
                            exit_pen, dtype=torch.float64)
    assert dec.decode_scan.LAUNCHES == before + len(chunks)
    for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"), kern, plain):
        assert k.dtype == p.dtype and torch.equal(k, p), name
    assert kern[0].dtype == torch.float64


def random_pack_df(dev, S, D, dim, seed, inactive=()):
    """A ScorePackDF of random float64 tables split on the host; the slots
    in ``inactive`` carry the padding values (norm INACTIVE_SCORE, rest 0)."""
    rng = np.random.default_rng(seed)
    J = S * D
    mu = rng.normal(size=(J, dim))
    iv = rng.uniform(0.2, 3.0, size=(J, dim))
    norm = rng.uniform(10.0, 40.0, size=J)
    logw = np.log(rng.uniform(0.05, 1.0, size=J))
    active = np.ones((S, D), bool)
    for j in inactive:
        mu[j] = iv[j] = logw[j] = 0.0
        norm[j] = gmm.INACTIVE_SCORE
        active.reshape(-1)[j] = False
    return gmm.ScorePackDF(mu=dfm.from_f64(mu, dev), iv=dfm.from_f64(iv, dev),
                           norm=dfm.from_f64(norm, dev), logw=dfm.from_f64(logw, dev),
                           active=torch.as_tensor(active, device=dev), num_mixtures=S,
                           density_cap=D, dim=dim, max_approx=True)


@pytest.mark.parametrize("n,s,d,dim,tables", [
    (777, 9, 3, 25, "random"), (64, 4, 1, 25, "random"), (1, 1, 1, 13, "random"),
    (300, 7, 16, 25, "random"), (130, 3, 40, 64, "random"),
    (1000, 106, 16, 25, "wide"), (257, 5, 3, 13, "wide"), (130, 3, 8, 64, "wide"),
    (513, 106, 4, 25, "random"), (300, 5, 16, 150, "random"), (140, 3, 8, 100, "wide")])
def test_kernel_c_bit_equal(dev, n, s, d, dim, tables):
    """Random tables with inactive slots, and tables whose magnitudes span
    1e-6 .. 1e6 with frames equal to mu.hi (the FMA product of df.cuh against
    the plain version's Dekker product); N not a multiple of the block's 256
    frames; dims other than 25 (the generic instance), up to 150."""
    if tables == "wide":
        pack, x = wide_magnitude_pack_df(s, d, dim, seed=n + s, n=n, device=dev)
    else:
        inactive = (0, s * d - 1) if s * d > 2 else ()
        pack = random_pack_df(dev, s, d, dim, seed=n + s + d + dim, inactive=inactive)
        x = torch.as_tensor(np.random.default_rng(n).normal(size=(n, dim)).astype(np.float32),
                            device=dev)
    before = gmm.am_scores_df.LAUNCHES
    got = gmm.am_scores_df(pack, x)
    ref = gmm.am_scores_df_reference(pack, x)
    torch.cuda.synchronize()
    assert gmm.am_scores_df.LAUNCHES == before + 1
    assert got.hi.shape == (n, s) and got.hi.dtype == got.lo.dtype == torch.float32
    assert torch.equal(got.hi, ref.hi) and torch.equal(got.lo, ref.lo)


def test_kernel_c_demo_model(dev):
    model = gmm.MixtureModel.from_raw(read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                      gmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    pack = model.pack_df(device=dev)
    assert not bool(pack.active.all())        # the model pads some mixtures
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4133, 25)).astype(np.float32),
                        device=dev)
    got = gmm.am_scores_df(pack, x)
    ref = gmm.am_scores_df_reference(pack, x)
    assert torch.equal(got.hi, ref.hi) and torch.equal(got.lo, ref.lo)


def scan_df_both(dev, tables, am64, lens, thr, prune, chunks):
    am = dfm.from_f64(am64, dev)
    targs = (*(torch.as_tensor(a, device=dev) for a in (
        tables.state_table, tables.last_pos, tables.word_len, tables.first_state)),
        dfm.from_f64(tables.tdp_within, dev), dfm.from_f64(tables.entry_pen, dev))
    lens = torch.as_tensor(lens, device=dev)
    results = []
    for fn in (dec.decode_scan_df, dec.decode_scan_df_reference):
        carry, outs, t0 = None, [], 0
        for n in chunks:
            am_c = dfm.DF(am.hi[:, t0:t0 + n].contiguous(), am.lo[:, t0:t0 + n].contiguous())
            carry, out = fn(am_c, lens, *targs, thr, prune=prune, carry_in=carry, t0=t0)
            outs.append(out)
            t0 += n
        hyp, bkp, book = carry
        results.append([hyp.hi, hyp.lo, bkp, book.hi, book.lo]
                       + [torch.cat([o[k] for o in outs]) for k in range(3)])
    torch.cuda.synchronize()
    return results


#: kernel D's instance for each lattice W x P the tests use, as
#: sr_decode_scan_df_instance must report it: positions a lane of the warp
#: instance (1-4); the block instance with its lattice in shared memory (0)
#: or in device scratch (-1)
D_INSTANCES = {(8, 10): 2, (12, 24): 3, (5, 3): 1, (9, 16): 2, (32, 32): 4, (33, 8): 0,
               (40, 25): 0, (44, 24): -1, (1000, 24): -1}


@pytest.mark.parametrize("case", ["pruned", "unpruned", "two-chunks", "ties", "repetition-1"])
def test_kernel_d_bit_equal(dev, case):
    from speechrecognition_torch.ops import _native
    B, T = 5, 60
    lens = np.array([60, 41, 13, 0, 59], np.int32)
    tables, S = (repetition1_tables() if case == "repetition-1"
                 else sietill_tables(prune=case != "unpruned", flat=case == "ties"))
    W, P = tables.state_table.shape
    assert _native.load().sr_decode_scan_df_instance(W, P) == D_INSTANCES[W, P] > 0
    rng = np.random.default_rng(30 + len(case))
    am = (rng.integers(0, 3, size=(B, T, S)).astype(np.float64) if case == "ties"
          else rng.uniform(0.0, 40.0, size=(B, T, S)))
    chunks = (25, 35) if case in ("two-chunks", "repetition-1") else (T,)
    thr = 4.0 if case == "ties" else 60.0
    before = dec.decode_scan_df.LAUNCHES
    kern, plain = scan_df_both(dev, tables, am, lens, thr, case != "unpruned", chunks)
    assert dec.decode_scan_df.LAUNCHES == before + len(chunks)
    for name, k, p in zip(("hyp.hi", "hyp.lo", "bkp", "book.hi", "book.lo", "score",
                           "word", "bkp_t"), kern, plain):
        assert k.dtype == p.dtype and torch.equal(k, p), name


def random_lexicon_tables(W, P, seed, flat=False):
    """Silence (P states when it is the only word, else 1) plus W - 1 words
    of 1..P states (the first of P) with repetition 1: a W x P lattice.
    ``flat`` zeroes every TDP and the word penalty, so that integer
    acoustic scores tie across words and jumps."""
    rng = np.random.default_rng(seed)
    lex = Lexicon()
    lex.add_word("[silence]", P if W == 1 else 1, 1, silence=True)
    for w in range(W - 1):
        lex.add_word(f"w{w}", P if w == 0 else int(rng.integers(1, P + 1)), 1)
    pen = (0.0, 0.0, 0.0, 0.0) if flat else (2.0, 0.5, 9.0, 15.0)
    tdp = TdpModel(silence_state=lex.silence_state, loop=pen[0], forward=pen[1], skip=pen[2])
    tables = dec.DecoderTables.build(lex, tdp, pen[3])
    assert tables.state_table.shape == (W, P)
    return tables, lex.num_states


#: lattices of every instance of kernel D: the warp instance's K = 1-4 and
#: its widest utterance (32 words, 8 warps), and the block instance (W > 32
#: or P > 32) with its lattice in shared memory, and past 1,024 slots (1,056
#: and 24,000) in device scratch
LATTICES = [(5, 3), (9, 16), (12, 24), (32, 32), (33, 8), (40, 25), (44, 24), (1000, 24)]


@pytest.mark.parametrize("W,P", LATTICES)
@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "unpruned"])
def test_kernel_d_every_instance(dev, W, P, prune):
    """B 4, T 40 over two chunks, from the initial carry and from a random
    live one (every slot takes part)."""
    from speechrecognition_torch.ops import _native
    assert _native.load().sr_decode_scan_df_instance(W, P) == D_INSTANCES[W, P]
    tables, S = random_lexicon_tables(W, P, seed=W * P)
    rng = np.random.default_rng(W + P)
    B, T = 4, 40
    lens = np.array([40, 23, 0, 39], np.int32)
    am = rng.uniform(0.0, 40.0, size=(B, T, S))
    before = dec.decode_scan_df.LAUNCHES
    kern, plain = scan_df_both(dev, tables, am, lens, 60.0, prune, (15, 25))
    assert dec.decode_scan_df.LAUNCHES == before + 2
    for name, k, p in zip(("hyp.hi", "hyp.lo", "bkp", "book.hi", "book.lo", "score",
                           "word", "bkp_t"), kern, plain):
        assert k.dtype == p.dtype and torch.equal(k, p), name
    assert torch.unique(kern[6]).numel() > 1


@pytest.mark.parametrize("W,P", [(44, 24), (1000, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_b_past_1024_slots(dev, W, P, dtype):
    """The scratch instance (W*P = 1,056 and 24,000), with an exit penalty."""
    from speechrecognition_torch.ops import _native
    assert _native.load().sr_decode_scan_instance(W, P) == -1
    tables, S = random_lexicon_tables(W, P, seed=W + P)
    rng = np.random.default_rng(W * P)
    B, T = 4, 40
    lens = np.array([40, 23, 0, 39], np.int32)
    am = rng.uniform(0.0, 40.0, size=(B, T, S))
    for exit_pen in (None, rng.uniform(0.0, 20.0, size=W)):
        before = dec.decode_scan.LAUNCHES
        kern, plain = scan_both(dev, tables, am, lens, 60.0, True, (15, 25), exit_pen, dtype)
        assert dec.decode_scan.LAUNCHES == before + 2
        for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"), kern, plain):
            assert k.dtype == p.dtype and torch.equal(k, p), name
        assert torch.unique(kern[4]).numel() > 1


#: kernel B's instance at each lattice of its sweep (kernel D's rule):
#: positions a lane of the warp instance, 0 for the block instance with its
#: lattice in shared memory
B_INSTANCES = {(1, 2): 1, (4, 8): 1, (4, 9): 2, (12, 24): 3, (32, 32): 4, (33, 8): 0,
               (4, 33): 0}


@pytest.mark.parametrize("W,P", list(B_INSTANCES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["pruned", "unpruned", "ties", "exit-pen"])
def test_kernel_b_every_instance(dev, W, P, dtype, case):
    """The warp instance at its edges (one word; P at, one past and far past
    a lane's 8 positions; its widest lattice) and the block instance past it,
    on repetition-1 lexica (the entered position's emission): B 4, T 40 over
    two chunks (the second at t0 = 15), utterances of 0 frames and ending
    mid-chunk; ties on integer scores with zero TDPs, an exit penalty, no
    pruning."""
    from speechrecognition_torch.ops import _native
    assert _native.load().sr_decode_scan_instance(W, P) == B_INSTANCES[W, P]
    tables, S = random_lexicon_tables(W, P, seed=W * 7 + P, flat=case == "ties")
    rng = np.random.default_rng(W + P + len(case))
    B, T = 4, 40
    lens = np.array([40, 23, 0, 39], np.int32)
    am = (rng.integers(0, 3, size=(B, T, S)).astype(np.float64) if case == "ties"
          else rng.uniform(0.0, 40.0, size=(B, T, S)))
    exit_pen = rng.uniform(0.0, 20.0, size=W) if case == "exit-pen" else None
    thr = 4.0 if case == "ties" else 60.0
    before = dec.decode_scan.LAUNCHES
    kern, plain = scan_both(dev, tables, am, lens, thr, case != "unpruned", (15, 25), exit_pen,
                            dtype)
    assert dec.decode_scan.LAUNCHES == before + 2
    for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"), kern, plain):
        assert k.dtype == p.dtype and torch.equal(k, p), name


def test_kernel_b_queries(dev):
    """The instance query (warp instance up to 32 x 32, then the block
    instance, its lattice in scratch past 1,024 slots) and the residency
    query: 8 SieTill utterances an SM in both types, so 1,024 take one wave
    on 132 SMs."""
    from speechrecognition_torch.ops import _native
    lib = _native.load()
    for (W, P), k in {**B_INSTANCES, (31, 33): 0, (44, 24): -1, (1000, 24): -1}.items():
        assert lib.sr_decode_scan_instance(W, P) == k, (W, P)
    for f64 in (0, 1):
        assert lib.sr_decode_scan_residency(12, 24, f64) >= 8
        assert lib.sr_decode_scan_residency(44, 24, f64) >= 1
    tables, S = random_lexicon_tables(1, 1, seed=0)     # one position: no scan takes it
    targs = [torch.as_tensor(a, device=dev) for a in (
        tables.state_table, tables.last_pos, tables.word_len, tables.first_state,
        tables.tdp_within, tables.entry_pen)]
    with pytest.raises(ValueError, match="2 or more"):
        dec.decode_scan(torch.zeros((2, 5, S), device=dev), torch.full((2,), 5, device=dev),
                        *targs, 60.0)


@pytest.mark.parametrize("kind", ["pallas", "df32", "f64"])
def test_recognizer_golden_on_card(dev, kind):
    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = Corpus.read(desc, str(FIX / "demo_features") + "/", SignalAnalysisConfig(),
                         normalization_path=str(FIX / "normalization-demo.bin"))
    model = gmm.MixtureModel.from_raw(read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                      gmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    config = Configuration({"am-threshold": 200.0, "word-penalty": 80.0,
                            "pruned-search": True, "max-recognition-runs": 10000})
    unfused = maha.mahalanobis_scores.LAUNCHES
    if kind == "pallas":
        rec = dec.Recognizer(config, lex, tdp, model.pack(method="pallas", device=dev))
        counters = (maha.mahalanobis_min_scores, dec.decode_scan)
    elif kind == "df32":
        rec = dec.Recognizer(config, lex, tdp, model.pack_df(device=dev), dtype="df32")
        counters = (gmm.am_scores_df, dec.decode_scan_df)
    else:
        rec = dec.Recognizer(config, lex, tdp, model.pack(dtype=torch.float64, device=dev),
                             dtype=torch.float64)
        counters = (dec.decode_scan,)
    before = [c.LAUNCHES for c in counters]
    res = rec.recognize_corpus(corpus, batch_size=35)
    assert all(c.LAUNCHES > b for c, b in zip(counters, before))
    assert maha.mahalanobis_scores.LAUNCHES == unfused     # the max-approximation fuses
    with open(FIX / "demo_recognition.json") as f:
        golden = json.load(f)
    assert all(res["hyps"][u["idx"]] == u["hyp"] for u in golden["utts"])
    assert [res["substitutions"], res["insertions"], res["deletions"]] == golden["corpus"]["sid"]


# -- the trainer's kernels: E, F, G, H ------------------------------------------------


def align_inputs(case, B=6, T=60, A=9):
    """Seeded alignment DP inputs (float64), as tests/test_torch_align.py."""
    rng = np.random.default_rng(len(case) * 7 + A)
    aut = np.array([A, A - 2, 3, 5, A, 2], np.int32)[:B]
    lens = np.array([60, 41, 13, 0, 59, 1], np.int32)[:B]
    if case.startswith("ties"):
        ams = rng.integers(0, 3, size=(B, T, A)).astype(np.float64)
        tdp, thr = np.zeros((B, A, 3)), 4.0
    else:
        ams = rng.uniform(0.0, 40.0, size=(B, T, A))
        tdp, thr = rng.uniform(0.0, 20.0, size=(B, A, 3)), 60.0
    tie = "full-dp" not in case
    valid = np.arange(A)[None, :] < aut[:, None]
    return ams, tdp, valid, aut, lens, thr, tie, tie and case != "pruned-nothr"


ALIGN_CASES = ["pruned", "full-dp", "pruned-nothr", "ties-pruned", "ties-full-dp"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ALIGN_CASES)
def test_kernels_e_and_g_bit_equal(dev, case, dtype):
    from speechrecognition_torch.align import viterbi as vit
    ams, tdp, valid, aut, lens, thr, tie, prune = align_inputs(case)
    B, T, A = ams.shape
    args = (torch.as_tensor(tdp, dtype=dtype, device=dev), torch.as_tensor(valid, device=dev),
            torch.as_tensor(lens, device=dev), thr)
    tbl = torch.as_tensor(np.random.default_rng(1).integers(0, 106, size=(B, A)),
                          dtype=torch.int32, device=dev)
    results = []
    for fwd, back in ((vit.align_fwd_chunk, vit.align_backtrack),
                      (vit.align_fwd_chunk_reference, vit.align_backtrack_reference)):
        prev = torch.full((B, A), 1e30, dtype=dtype, device=dev)
        jumps = []
        for t0, n in ((0, 25), (25, 35)):
            am = torch.as_tensor(ams[:, t0:t0 + n], dtype=dtype, device=dev).contiguous()
            prev, j = fwd(prev, am, *args, t0, tie_pruned=tie, use_pruning=prune)
            jumps.append(j)
        states, fp = back(prev.float().contiguous(), torch.as_tensor(aut, device=dev),
                          torch.cat(jumps), torch.as_tensor(lens, device=dev), tbl, 53,
                          tie_pruned=tie)
        results.append((prev, torch.cat(jumps), states, fp))
    torch.cuda.synchronize()
    for name, k, p in zip(("carry", "jumps", "states", "final_pos"), *results):
        assert k.dtype == p.dtype and torch.equal(k, p), name


@pytest.mark.parametrize("Tp,A,jumps,tie_pruned,T", BACKTRACK_CASES + [
    (3000, 1025, "dp", True, "Tp"), (3000, 1025, "random", False, "Tp-7")])
def test_kernel_g_every_case(dev, Tp, A, jumps, tie_pruned, T):
    """tests/test_torch_backtrack_shapes.py's cases (walks below -A, all-BIG
    final rows, feat_len 0, 1 and Tp, T 0 to Tp, A 1 to 1,025, Tp 1 to
    2,000) and Tp 3,000, on 9 utterances (not a multiple of a block's 4):
    states and final positions bit-equal to the plain version."""
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.ops import _native
    assert _native.load().sr_align_backtrack_tile(A) > 0     # every row staged
    args = [torch.as_tensor(a, device=dev)
            for a in backtrack_inputs(Tp, A, jumps, seed=Tp + A, B=9)]
    T = backtrack_frames(Tp, T)
    before = vit.align_backtrack.LAUNCHES
    got = vit.align_backtrack(*args, T, tie_pruned=tie_pruned)
    want = vit.align_backtrack_reference(*args, T, tie_pruned=tie_pruned)
    torch.cuda.synchronize()
    assert vit.align_backtrack.LAUNCHES == before + 1
    for name, g, w in zip(("states", "final_pos"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_kernel_g_layouts(dev):
    """The tile query (128 frames for short rows, fewer past 96 bytes a
    row but not below 32 while two tiles fit a block, 0 where a row is
    walked from device memory), that walk at A = 120,000, and jumps that do
    not start on a 16-byte boundary (the wrapper copies them)."""
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.ops import _native
    lib = _native.load()
    assert [lib.sr_align_backtrack_tile(A) for A in (1, 70, 162, 1025, 3000, 5000, 120000)] == [
        128, 128, 64, 32, 32, 23, 0]
    for Tp, A, jumps, cut in ((5, 120000, "random", False), (300, 70, "dp", True)):
        final_hi, aut_len, jmp, lens, tbl = (torch.as_tensor(a, device=dev) for a in
                                             backtrack_inputs(Tp, A, jumps, seed=A, B=4))
        if cut:     # frames 1 .. Tp-1 of a longer array: starts 4 * 70 bytes in
            jmp = torch.cat([jmp[:1], jmp])[1:]
            assert jmp.data_ptr() % 16 != 0
        for tie in (True, False):
            got = vit.align_backtrack(final_hi, aut_len, jmp, lens, tbl, Tp - 1, tie_pruned=tie)
            want = vit.align_backtrack_reference(final_hi, aut_len, jmp, lens, tbl, Tp - 1,
                                                 tie_pruned=tie)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want))


#: kernel E's instance for each automaton length the tests use, as
#: sr_align_fwd_warps and sr_align_fwd_positions must report it: the warp
#: instance's warps an utterance, one position a lane (A <= 128); the wide
#: instance's warps and positions a lane (128 < A <= 1024: 3 up to A = 768,
#: 4 up to 1024; 2 to 8 warps); -1 and 0, the block instance with its row
#: in device scratch
ALIGN_INSTANCES = {1: (1, 1), 2: (1, 1), 9: (1, 1), 31: (1, 1), 32: (1, 1), 33: (2, 1),
                   70: (3, 1), 96: (3, 1), 97: (4, 1), 128: (4, 1), 129: (2, 3), 160: (2, 3),
                   300: (4, 3), 303: (4, 3), 512: (6, 3), 700: (8, 3), 768: (8, 3),
                   769: (7, 4), 1024: (8, 4), 1025: (-1, 0), 3000: (-1, 0)}


def e_instance(A):
    """Kernel E's (warps, positions a lane) for A, as its C entry reports them."""
    from speechrecognition_torch.ops import _native
    lib = _native.load()
    return lib.sr_align_fwd_warps(A), lib.sr_align_fwd_positions(A)


def e_first_design(*args, **kw):
    """Kernel E's first design for 128 < A <= 1024 (the block instance, its
    row in shared memory), forced; uncounted."""
    from speechrecognition_torch.align import viterbi as vit
    out, jumps, _scratch = vit.align_fwd_chunk_cuda(*args, first_design=True, **kw)
    return out, jumps


@pytest.mark.parametrize("A", list(ALIGN_INSTANCES))
@pytest.mark.parametrize("case", ALIGN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_e_bit_equal(dev, case, A, dtype):
    """Every lane and warp boundary of the warp instance (1-4 warps an
    utterance), the wide instance past A = 128 at 3 and 4 positions a lane
    on 2 to 8 warps, with the first design (the block instance, its row in shared
    memory) forced beside it, and the block instance past A = 1,024 in
    device scratch, in both score types."""
    from speechrecognition_torch.align import viterbi as vit
    assert e_instance(A) == ALIGN_INSTANCES[A]
    ams, tdp, valid, aut, lens, thr, tie, prune = align_inputs(case, A=A)
    B, T, A = ams.shape
    args = (torch.as_tensor(tdp, dtype=dtype, device=dev), torch.as_tensor(valid, device=dev),
            torch.as_tensor(lens, device=dev), thr)
    before = vit.align_fwd_chunk.LAUNCHES
    results = []
    for fwd in (vit.align_fwd_chunk, e_first_design, vit.align_fwd_chunk_reference):
        prev = torch.full((B, A), 1e30, dtype=dtype, device=dev)
        jumps = []
        for t0, n in ((0, 25), (25, 35)):
            am = torch.as_tensor(ams[:, t0:t0 + n], dtype=dtype, device=dev).contiguous()
            prev, j = fwd(prev, am, *args, t0, tie_pruned=tie, use_pruning=prune)
            jumps.append(j)
        results.append((prev, torch.cat(jumps)))
    torch.cuda.synchronize()
    assert vit.align_fwd_chunk.LAUNCHES == before + 2
    for name, k, f, p in zip(("carry", "jumps"), *results):
        assert k.dtype == p.dtype and torch.equal(k, p), name
        assert f.dtype == p.dtype and torch.equal(f, p), f"{name} (first design)"


#: kernel F's instance for A positions (sr_align_fwd_df_warps,
#: sr_align_fwd_df_positions): the warp instance's warps an utterance, one
#: position a lane; the wide instance's warps and positions a lane (128 < A
#: <= 1024: 2 up to A = 512, 3 up to 768, 4 up to 1024; 3 to 8 warps); -1
#: and 0, the block instance with its row in device scratch
F_INSTANCES = {1: (1, 1), 2: (1, 1), 9: (1, 1), 31: (1, 1), 32: (1, 1), 33: (2, 1), 70: (3, 1),
               96: (3, 1), 97: (4, 1), 128: (4, 1), 129: (3, 2), 160: (3, 2), 300: (5, 2),
               303: (5, 2), 512: (8, 2), 700: (8, 3), 1024: (8, 4), 1025: (-1, 0),
               3000: (-1, 0)}


def f_first_design(*args, **kw):
    """Kernel F's first design for 128 < A <= 1024 (the block instance, its
    row in shared memory), forced; uncounted."""
    from speechrecognition_torch.align import viterbi as vit
    out, jumps, _scratch = vit.align_fwd_chunk_df_cuda(*args, first_design=True, **kw)
    return out, jumps


@pytest.mark.parametrize("A", list(F_INSTANCES))
@pytest.mark.parametrize("case", ALIGN_CASES)
def test_kernel_f_bit_equal(dev, case, A):
    """Every lane boundary of the warp instance (1-4 warps an utterance), the
    wide instance past A = 128 at 2, 3 and 4 positions a lane, with the
    first design (the block instance, its row in shared memory) forced
    beside it, and the block instance past A = 1,024 in device scratch."""
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.ops import _native
    lib = _native.load()
    assert (lib.sr_align_fwd_df_warps(A), lib.sr_align_fwd_df_positions(A)) == F_INSTANCES[A]
    ams, tdp, valid, aut, lens, thr, tie, prune = align_inputs(case, A=A)
    B, T, A = ams.shape
    am = dfm.from_f64(ams, dev)
    args = (dfm.from_f64(tdp, dev), torch.as_tensor(valid, device=dev),
            torch.as_tensor(lens, device=dev), dfm.from_f64(np.float64(thr), dev))
    before = vit.align_fwd_chunk_df.LAUNCHES
    results = []
    for fwd in (vit.align_fwd_chunk_df, f_first_design, vit.align_fwd_chunk_df_reference):
        prev = dfm.DF(torch.full((B, A), 1e30, device=dev), torch.zeros((B, A), device=dev))
        jumps = []
        for t0, n in ((0, 25), (25, 35)):
            chunk = dfm.DF(am.hi[:, t0:t0 + n].contiguous(), am.lo[:, t0:t0 + n].contiguous())
            prev, j = fwd(prev, chunk, *args, t0, tie_pruned=tie, use_pruning=prune)
            jumps.append(j)
        results.append((prev.hi, prev.lo, torch.cat(jumps)))
    torch.cuda.synchronize()
    assert vit.align_fwd_chunk_df.LAUNCHES == before + 2
    for name, k, f, p in zip(("hi", "lo", "jumps"), *results):
        assert torch.equal(k, p), name
        assert torch.equal(f, p), f"{name} (first design)"


@pytest.mark.parametrize("A", [2, 9, 33, 70, 97, 128, 129, 300, 303, 512, 700, 1024, 1025])
@pytest.mark.parametrize("case", ALIGN_CASES)
@pytest.mark.parametrize("kind", ["f32", "f64", "df32"])
def test_kernels_e_f_infinite_skip_bit_equal(dev, case, A, kind):
    """Tables with an infinite skip into every third position (the AN4 TDPs
    forbid the silence skip): double-float splits inf into (inf, NaN), so
    kernel F's rows hold NaN costs, and it folds them as its plain version
    does (doublefloat.min_axis). Kernel E sees inf and no NaN. Every
    instance, carry and jumps bit-equal (NaN equal to NaN); kernel F's first
    design forced beside its wide instance (128 < A <= 1024), and kernel E's
    beside its own."""
    from speechrecognition_torch.align import viterbi as vit
    ams, tdp, valid, aut, lens, thr, tie, prune = align_inputs(case, A=A)
    tdp[:, 2::3, 2] = np.inf
    B, T, A = ams.shape
    df = kind == "df32"
    results = []
    for fwd in ((vit.align_fwd_chunk_df, f_first_design, vit.align_fwd_chunk_df_reference) if df
                else (vit.align_fwd_chunk, e_first_design, vit.align_fwd_chunk_reference)):
        if df:
            args = (dfm.from_f64(tdp, dev), torch.as_tensor(valid, device=dev),
                    torch.as_tensor(lens, device=dev), dfm.from_f64(np.float64(thr), dev))
            prev = dfm.DF(torch.full((B, A), 1e30, device=dev), torch.zeros((B, A), device=dev))
            am = dfm.from_f64(ams, dev)
        else:
            dt = torch.float32 if kind == "f32" else torch.float64
            args = (torch.as_tensor(tdp, dtype=dt, device=dev), torch.as_tensor(valid, device=dev),
                    torch.as_tensor(lens, device=dev), thr)
            prev = torch.full((B, A), 1e30, dtype=dt, device=dev)
        jumps = []
        for t0, n in ((0, 25), (25, 35)):
            if df:
                chunk = dfm.DF(am.hi[:, t0:t0 + n].contiguous(), am.lo[:, t0:t0 + n].contiguous())
            else:
                chunk = torch.as_tensor(ams[:, t0:t0 + n], dtype=dt, device=dev).contiguous()
            prev, j = fwd(prev, chunk, *args, t0, tie_pruned=tie, use_pruning=prune)
            jumps.append(j)
        results.append((*(prev if df else (prev,)), torch.cat(jumps)))
    torch.cuda.synchronize()
    for outs in zip(*results):
        assert all(same_bits(k, outs[-1]) for k in outs[:-1])


def sorted_demo_blocks(dev, block):
    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = Corpus.read(desc, str(FIX / "demo_features") + "/", SignalAnalysisConfig(),
                         normalization_path=str(FIX / "normalization-demo.bin"))
    from speechrecognition_torch.io import read_alignment
    align, _w, _m = read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    frame_idx, block_state, _nb = gmm.sorted_blocks(align, 106, block=block)
    frames = torch.as_tensor(corpus.features[np.maximum(frame_idx, 0)], device=dev)
    mask = torch.as_tensor((frame_idx >= 0).astype(np.float32), device=dev)
    return frames, mask, torch.as_tensor(block_state, device=dev)


@pytest.mark.parametrize("block,first_pass,cap,case", [
    (4096, False, None, "demo"), (256, False, 16, "demo"), (4096, True, None, "demo"),
    (1000, False, None, "demo"), (1000, False, None, "masked-block"),
    (1000, False, None, "one-density"), (1000, False, None, "dim-100")])
def test_kernel_h_matches_plain(dev, block, first_pass, cap, case):
    """w bit-equal, xs, x2s and the total within 1e-12 relative (float64
    sums in another order), two launches bit-identical; R = 1000 is not a
    multiple of the kernel's 512-row tile, "masked-block" masks a whole
    block, "one-density" scores against random tables with D = 1, "dim-100"
    random tables and frames of dim 100 (the generic instance)."""
    model = gmm.MixtureModel.from_raw(read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                      gmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    pack = (random_pack_df(dev, 106, 1, 25, seed=5) if case == "one-density"
            else random_pack_df(dev, 106, 4, 100, seed=6) if case == "dim-100"
            else model.pack_df(density_cap=cap, device=dev))
    frames, mask, bs = sorted_demo_blocks(dev, block)
    if case == "masked-block":
        mask[1] = 0.0
    if case == "dim-100":
        rng = np.random.default_rng(6)
        frames = torch.as_tensor(rng.normal(size=(*frames.shape[:2], 100)).astype(np.float32),
                                 device=dev)
    before = gmm.em_pass_sorted.LAUNCHES
    got = gmm.em_pass_sorted(pack, frames, mask, bs, first_pass=first_pass)
    again = gmm.em_pass_sorted(pack, frames, mask, bs, first_pass=first_pass)
    ref = gmm.em_pass_sorted_reference(pack, frames, mask, bs, first_pass=first_pass)
    torch.cuda.synchronize()
    assert gmm.em_pass_sorted.LAUNCHES == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[1], ref[1]) and got[1].dtype == torch.float64
    for g, r in ((got[0], ref[0]), (got[2], ref[2]), (got[3], ref[3])):
        assert ((g - r).abs() <= 1e-12 * r.abs().max()).all()


@pytest.mark.parametrize("kind", ["df32", "f64"])
def test_trainer_golden_on_card(dev, kind, tmp_path):
    """The oracle recipe through the kernels: the ten AM-score lines within
    1e-4, alignment-2-0.dump equal to the C++ trainer's."""
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.io import read_alignment
    from speechrecognition_torch.train.em import Trainer, TrainerConfig
    oracle = [32.9885, 32.5804, 32.1673, 31.9418, 31.9074, 31.8869, 31.4152, 31.3187,
              31.2697, 31.2383]
    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = Corpus.read(desc, str(FIX / "demo_features") + "/", SignalAnalysisConfig(),
                         normalization_path=str(FIX / "normalization-demo.bin"))
    model = gmm.MixtureModel(25, lex.num_states, gmm.VarianceModel.MIXTURE_POOLING)
    cfg = TrainerConfig(min_obs=1, num_splits=2, num_aligns=1, num_estimates=3,
                        pruning_threshold=120.0, alignment_path=str(tmp_path) + "/alignment-")
    tdp = TdpModel(silence_state=lex.silence_state, loop=20.0, forward=0.0, skip=20.0)
    counters = ([gmm.am_scores_df, vit.align_fwd_chunk_df, vit.align_backtrack,
                 gmm.em_pass_sorted] if kind == "df32"
                else [vit.align_fwd_chunk, vit.align_backtrack])
    before = [c.LAUNCHES for c in counters]
    trainer = Trainer(cfg, lex, model, tdp, dtype="df32" if kind == "df32" else torch.float64,
                      device=dev, log=lambda *a: None)
    trainer.train(corpus)
    assert all(c.LAUNCHES > b for c, b in zip(counters, before))
    got = [float(line.split()[3]) for line in trainer.stats_lines]
    assert len(got) == 10 and all(abs(g - o) < 1e-4 for g, o in zip(got, oracle))
    ref, _, _ = read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    mine, _, _ = read_alignment(str(tmp_path / "alignment-2-0.dump"))
    np.testing.assert_array_equal(mine, ref)


# -- the search tier: kernels I (tree), J (bigram) and K (WCTS) ----------------------


def bits(x):
    """A tensor's bits, so that equality is bit-equality (-0 is not +0)."""
    if x.is_floating_point():
        return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)
    return x


def same(got, ref):
    return all(g.dtype == r.dtype and g.shape == r.shape and torch.equal(bits(g), bits(r))
               for g, r in zip(got, ref)) and len(got) == len(ref)


def sietill_search():
    lex = build_sietill_lexicon()
    return lex, TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)


SEARCH_LENS = [60, 41, 13, 0, 59]


@pytest.mark.parametrize("lexicon", ["sietill", "prefix", "scratch"])
@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_i_bit_equal(dev, lexicon, prune, dtype):
    """Kernel I against its plain version on the card: the SieTill tree, a
    tree with shared prefixes, word ends inside it and homophones, and a
    9,499-node tree whose lattice lives in device scratch."""
    from speechrecognition_torch.search import tree_decoder as td
    from torch_search_tables import PrefixLexicon, am_scores, prefix_tdp
    if lexicon == "sietill":
        lex, tdp = sietill_search()
        S = lex.num_states
    else:
        lex = (PrefixLexicon(30, 1) if lexicon == "prefix"
               else PrefixLexicon(2000, 3, max_len=16, branch=4))
        tdp, S = prefix_tdp(lex), lex.num_states
    tables = td.TreeTables.build(lex, tdp, 80.0)
    T = 60 if lexicon != "scratch" else 30
    B = len(SEARCH_LENS)
    am = am_scores(B, T, S, seed=T + S, dtype=dtype, device=dev)
    lens = torch.as_tensor(np.minimum(SEARCH_LENS, T), dtype=torch.int32, device=dev)
    args = tables.device_args(dev, dtype, S)
    before = td.tree_scan.LAUNCHES, td.tree_scan.SCRATCH_LAUNCHES
    got = td.tree_scan(am, lens, *args, 200.0 if prune else 60.0, prune=prune)
    ref = td.tree_scan_reference(am, lens, *args, 200.0 if prune else 60.0, prune=prune)
    torch.cuda.synchronize()
    assert same(got, ref)
    assert td.tree_scan.LAUNCHES == before[0] + 1
    assert td.tree_scan.SCRATCH_LAUNCHES == before[1] + (lexicon == "scratch")


#: kernel I's instance at each tree size of its edge tests, in both types
#: (sr_tree_scan_instance): nodes a lane of the owner instance, 0 for the
#: block instance with its lattice in shared memory
I_INSTANCES = {2: 1, 31: 1, 32: 1, 33: 1, 212: 4, 224: 4, 225: 4, 1024: 4, 1025: 0}


@pytest.mark.parametrize("N", list(I_INSTANCES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["pruned", "unpruned", "ties"])
def test_kernel_i_every_instance(dev, N, dtype, case):
    """Kernel I's owner instance at its edges (a warp's edges, SieTill's 212,
    7 warps full and one node past them, 1,024 nodes) and the block instance
    past it, on trees built from a seed (tests/torch_search_tables.py::
    random_tree: word ends inside the tree, homophones), utterances of 0 and
    1 frames and ending early; ties on integer scores, zero TDPs and exit
    penalties of 0 or 1. The block instance (the first design) is also
    forced at every size: both bit-equal to the plain version."""
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.search import tree_decoder as td
    from torch_search_tables import random_tree, tree_scores
    f64 = int(dtype == torch.float64)
    assert _native.load().sr_tree_scan_instance(N, f64) == I_INSTANCES[N]
    ties = case == "ties"
    tree = random_tree(N, seed=N + 1000 * ties, ties=ties)
    am = tree_scores(5, 40, seed=N + 7, ties=ties, dtype=dtype, device=dev)
    lens = torch.as_tensor([40, 23, 0, 1, 37], dtype=torch.int32, device=dev)
    args = tree.device_args(dev, dtype, am.shape[2])
    thr = 4.0 if ties else 45.0
    prune = case != "unpruned"
    before = td.tree_scan.LAUNCHES, td.tree_scan.SCRATCH_LAUNCHES
    got = td.tree_scan(am, lens, *args, thr, prune=prune)
    first, scratch = td.tree_scan_cuda(am, lens, *args, thr, prune=prune, first_design=True)
    ref = td.tree_scan_reference(am, lens, *args, thr, prune=prune)
    torch.cuda.synchronize()
    assert same(got, ref)
    assert same(first, ref)
    assert not scratch
    assert td.tree_scan.LAUNCHES == before[0] + 1
    assert td.tree_scan.SCRATCH_LAUNCHES == before[1]


def test_kernel_i_queries(dev):
    """The instance query (the owner instance up to 1,024 nodes, then the
    block instance, its lattice in scratch past 96 KB) and the residency
    query: SieTill's 212 nodes run 4 nodes a lane, 2 warps, and the launch
    bounds let 8 utterances share an SM (1,024 in one wave on 132 SMs)."""
    from speechrecognition_torch.ops import _native
    lib = _native.load()
    for f64 in (0, 1):
        for N, k in {**I_INSTANCES, 0: 0, 9499: -1}.items():
            assert lib.sr_tree_scan_instance(N, f64) == k, (N, f64)
        assert lib.sr_tree_scan_residency(212, f64, 0) >= 8
        assert lib.sr_tree_scan_residency(212, f64, 1) >= 1
        assert lib.sr_tree_scan_residency(1024, f64, 0) >= 1


@pytest.mark.parametrize("case", ["pruned", "unpruned", "ties", "repetition-1", "scratch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_j_bit_equal(dev, case, dtype):
    """Kernel J against its plain version: SieTill with a random bigram LM
    (pruned, unpruned, integer scores that tie across predecessors and
    jumps), a repetition-1 lexicon, and a 200 x 24 lattice in scratch."""
    from speechrecognition_torch.search import ngram_decoder as ng
    from torch_search_tables import am_scores, random_lm, repetition1_lexicon, wide_linear_tables
    if case == "scratch":
        tables, S = wide_linear_tables(200, 8, 3)
    else:
        lex = repetition1_lexicon() if case == "repetition-1" else build_sietill_lexicon()
        tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
        tables, S = dec.DecoderTables.build(lex, tdp, 0.0), lex.num_states
    W = tables.num_words
    lm, lm_start = random_lm(W, seed=W)
    B, T = len(SEARCH_LENS), 60
    am = am_scores(B, T, S, seed=S, dtype=dtype, device=dev)
    if case == "ties":
        am = am.round() % 3
        lm, lm_start = np.round(lm) % 2, np.round(lm_start) % 2
    lens = torch.as_tensor(SEARCH_LENS, dtype=torch.int32, device=dev)
    args = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (tables.state_table, tables.last_pos, tables.word_len)]
    args += [torch.as_tensor(a, dtype=dtype, device=dev)
             for a in (tables.tdp_within, tables.entry_pen, lm, lm_start)]
    before = ng.decode_scan_bigram.LAUNCHES, ng.decode_scan_bigram.SCRATCH_LAUNCHES
    got = ng.decode_scan_bigram(am, lens, *args, 200.0, prune=case != "unpruned")
    ref = ng.decode_scan_bigram_reference(am, lens, *args, 200.0, prune=case != "unpruned")
    torch.cuda.synchronize()
    assert same(got, ref)
    assert ng.decode_scan_bigram.LAUNCHES == before[0] + 1
    assert ng.decode_scan_bigram.SCRATCH_LAUNCHES == before[1] + (case == "scratch")


WCTS_OPTIONS = {
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


def wcts_both(dev, lex, tdp, S, W, opts, dtype, T, chunks, lens, seed, kernel=None,
              ties=False, nan=None):
    """(kernel, plain) carries and outputs over the chunks; ``kernel`` is
    wcts_scan unless given; ``ties``: integer scores and LM rows of 0 and 1,
    so contexts, predecessors and histogram bins tie; ``nan``: the
    (utterance, frame, state) of a NaN score."""
    from speechrecognition_torch.search import wcts
    from torch_search_tables import am_scores, random_lm, wcts_inputs
    lm, lm_start = random_lm(W, seed=seed)
    if ties:
        lm, lm_start = np.round(lm) % 2, np.round(lm_start) % 2
    _tables, wt = wcts_inputs(lex, tdp, lm, lm_start, lookahead=opts.get("use_lookahead", False))
    args = wt.args(dev, dtype, S)
    am = am_scores(len(lens), T, S, seed=seed, dtype=dtype, device=dev)
    if ties:
        am = am.round() % 3
    if nan is not None:
        am[nan] = float("nan")
    lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    results = []
    for fn in (kernel or wcts.wcts_scan, wcts.wcts_scan_reference):
        carry, outs, t0 = None, [], 0
        for n in chunks:
            carry, o = fn(am[:, t0:t0 + n].contiguous(), lens, *args, 200.0, carry_in=carry,
                          t0=t0, **opts)
            outs.append(o)
            t0 += n
        results.append(list(carry) + [torch.cat([o[k] for o in outs])
                                      for k in range(len(outs[0]))])
    torch.cuda.synchronize()
    return results


@pytest.mark.parametrize("option", sorted(WCTS_OPTIONS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_k_bit_equal_sietill(dev, option, dtype):
    """Kernel K against its plain version on SieTill (C 13, N 212) with each
    option, two chunks with carry: the carry and every output bit-equal."""
    from speechrecognition_torch.search import wcts
    lex, tdp = sietill_search()
    before = wcts.wcts_scan.LAUNCHES
    got, ref = wcts_both(dev, lex, tdp, lex.num_states, lex.num_words, WCTS_OPTIONS[option],
                         dtype, 60, (23, 37), SEARCH_LENS, seed=7)
    assert same(got, ref)
    assert wcts.wcts_scan.LAUNCHES == before + 2


@pytest.mark.parametrize("option", ["pruned", "lookahead", "limit-la-17-bins", "everything"])
@pytest.mark.parametrize("size", ["prefix", "scratch"])
def test_kernel_k_bit_equal_prefix_tree(dev, option, size):
    """Kernel K on trees with shared prefixes: W 30 (4,650 slots, shared
    memory) and W 200 (145,122 slots, device scratch), float32, two chunks."""
    from speechrecognition_torch.search import wcts
    from torch_search_tables import PrefixLexicon, prefix_tdp
    lex = PrefixLexicon(30, 1) if size == "prefix" else PrefixLexicon(200, 2)
    lens, T = ([60, 41, 13, 0, 59], 60) if size == "prefix" else ([20, 11], 20)
    before = wcts.wcts_scan.SCRATCH_LAUNCHES
    got, ref = wcts_both(dev, lex, prefix_tdp(lex), lex.num_states, lex.num_words,
                         WCTS_OPTIONS[option], torch.float32, T, (T // 2, T - T // 2), lens,
                         seed=3)
    assert same(got, ref)
    assert wcts.wcts_scan.SCRATCH_LAUNCHES == before + (2 if size == "scratch" else 0)


@pytest.mark.parametrize("option", ["pruned", "silence"])
def test_kernel_k_bit_equal_an4_tree(dev, option):
    """Kernel K at the AN4 cell's shape (an4_lexicon: 131 words, C 132, its
    prefix tree under the AN4 TDPs, the block instance in device scratch),
    the cell's options (lookahead, statistics, transparent silence) or plain
    pruning, two chunks with carry: bit-equal to its plain version."""
    from speechrecognition_torch.search import wcts
    from torch_linear_tables import AN4_TDP, an4_lexicon
    from torch_search_tables import am_scores, random_lm
    lex = an4_lexicon()
    tables = AN4_TDP.tree_tables(lex)
    lm, lm_start = random_lm(lex.num_words, seed=5)
    opts = WCTS_OPTIONS[option]
    la = wcts.LookaheadTables.build(tables) if opts.get("use_lookahead") else None
    wt = wcts.WctsTables.build(tables, AN4_TDP, lm, lm_start, la)
    assert wt.num_contexts == 132 and tables.num_nodes > 1024
    args = wt.args(dev, torch.float32, 501)
    am = am_scores(3, 30, 501, seed=5, dtype=torch.float32, device=dev)
    lens = torch.tensor([30, 17, 1], dtype=torch.int32, device=dev)
    before = wcts.wcts_scan.SCRATCH_LAUNCHES
    results = []
    for fn in (wcts.wcts_scan, wcts.wcts_scan_reference):
        carry, outs = None, []
        for t0, n in ((0, 13), (13, 17)):
            carry, o = fn(am[:, t0:t0 + n].contiguous(), lens, *args, 200.0, carry_in=carry,
                          t0=t0, **opts)
            outs.append(o)
        results.append(list(carry) + [torch.cat([o[k] for o in outs])
                                      for k in range(len(outs[0]))])
    torch.cuda.synchronize()
    assert same(*results)
    assert wcts.wcts_scan.SCRATCH_LAUNCHES == before + 2


def test_wcts_decode_copies_to_page_locked_memory(dev):
    """``decode_batch_wcts`` on the card hands back what it hands back on
    the CPU, its outputs copied through page-locked host memory."""
    from speechrecognition_torch.search import wcts
    from torch_linear_tables import AN4_TDP, random_lm, tied_lexicon
    outs = [torch.arange(12.0, device=dev).reshape(3, 4),
            torch.tensor([True, False], device=dev), torch.arange(5, device=dev)]
    host = wcts.host_copies(outs)
    for h, o in zip(host, outs):
        assert h.device.type == "cpu" and h.is_pinned() and torch.equal(h, o.cpu())
    rng = np.random.default_rng(5)
    lex = tied_lexicon([3, 6, 9, 3, 6], 3, 12, rng, own_silence=True)
    lm, lm_start = random_lm(rng, lex.num_words, 0, 2.0)
    tables = AN4_TDP.tree_tables(lex)
    lens = np.array([30, 22, 27], np.int32)
    am = torch.as_tensor(rng.uniform(0.0, 10.0, (3, 30, 12)).astype(np.float32))
    got = [wcts.decode_batch_wcts(None, np.zeros((3, 30, 1), np.float32), lens, tables, AN4_TDP,
                                  lm, lm_start, 200.0, 0,
                                  lookahead=wcts.LookaheadTables.build(tables), emit_stats=True,
                                  transparent_silence=True, am=a) for a in (am.to(dev), am)]
    assert got[0][0] == got[1][0] and sum(map(len, got[0][0])) > 0
    for k in got[1][1]:
        assert np.array_equal(got[0][1][k], got[1][1][k]), k


#: kernel J's instance at each lattice of its tests, in both types
#: (sr_decode_scan_bigram_instance): positions a lane of the warp instance,
#: 0 for the block instance with its lattice in shared memory
J_INSTANCES = {(1, 2): 1, (4, 3): 1, (5, 9): 2, (12, 24): 3, (32, 32): 4, (33, 8): 0,
               (4, 33): 0}


@pytest.mark.parametrize("W,P", list(J_INSTANCES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["pruned", "unpruned", "ties"])
def test_kernel_j_every_instance(dev, W, P, dtype, case):
    """Kernel J's warp instance at its edges (one word; P at, one past and
    far past a lane's 8 positions; 32 x 32) and the block instance past it,
    on repetition-1 lexica, utterances of 0 frames and ending early; ties on
    integer scores, zero TDPs and LM scores of 0 and 1. The block instance
    (the first design) is also forced at every shape: both bit-equal to the
    plain version."""
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.search import ngram_decoder as ng
    from torch_search_tables import random_lm
    f64 = int(dtype == torch.float64)
    assert _native.load().sr_decode_scan_bigram_instance(W, P, f64) == J_INSTANCES[W, P]
    tables, S = random_lexicon_tables(W, P, seed=W * 5 + P, flat=case == "ties")
    rng = np.random.default_rng(W + P + len(case))
    lm, lm_start = random_lm(W, seed=W + P)
    if case == "ties":
        lm, lm_start = np.round(lm) % 2, np.round(lm_start) % 2
    B, T = 4, 40
    am = (rng.integers(0, 3, size=(B, T, S)).astype(np.float64) if case == "ties"
          else rng.uniform(0.0, 40.0, size=(B, T, S)))
    am = torch.as_tensor(am, dtype=dtype, device=dev)
    lens = torch.as_tensor([40, 23, 0, 39], dtype=torch.int32, device=dev)
    args = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (tables.state_table, tables.last_pos, tables.word_len)]
    args += [torch.as_tensor(a, dtype=dtype, device=dev)
             for a in (tables.tdp_within, tables.entry_pen, lm, lm_start)]
    thr = 4.0 if case == "ties" else 60.0
    prune = case != "unpruned"
    before = ng.decode_scan_bigram.LAUNCHES
    got = ng.decode_scan_bigram(am, lens, *args, thr, prune=prune)
    first, _scratch = ng.decode_scan_bigram_cuda(am, lens, *args, thr, prune=prune,
                                                 first_design=True)
    ref = ng.decode_scan_bigram_reference(am, lens, *args, thr, prune=prune)
    torch.cuda.synchronize()
    assert same(got, ref)
    assert same(first, ref)
    assert ng.decode_scan_bigram.LAUNCHES == before + 1


def test_kernel_j_queries(dev):
    """The instance query (the warp instance up to 32 x 32, then the block
    instance, its lattice in scratch past 96 KB) and the residency query:
    the launch bounds promise 768 threads an SM, so 8 SieTill utterances of
    96 threads share one (1,024 in one wave on 132 SMs)."""
    from speechrecognition_torch.ops import _native
    lib = _native.load()
    for f64 in (0, 1):
        for (W, P), k in {**J_INSTANCES, (32, 33): 0, (33, 32): 0, (200, 24): -1}.items():
            assert lib.sr_decode_scan_bigram_instance(W, P, f64) == k, (W, P, f64)
        assert lib.sr_decode_scan_bigram_residency(12, 24, f64, 0) >= 8
        assert lib.sr_decode_scan_bigram_residency(12, 24, f64, 1) >= 1


#: kernel K's instance at SieTill's shape and at the owner instance's edges
#: (C, N, W, S, bins) → sr_wcts_scan_instance in both types: contexts a
#: thread of the owner instance (a thread a node), 0 for the block instance
#: in shared memory, -1 in device scratch
K_INSTANCES = {(13, 212, 12, 106, 0): 16, (13, 212, 12, 106, 101): 16, (5, 37, 4, 40, 0): 8,
               (8, 300, 7, 40, 0): 8, (13, 300, 12, 40, 0): 0, (32, 32, 31, 40, 101): 16,
               (32, 64, 31, 40, 0): 16, (17, 129, 16, 40, 0): 8, (33, 100, 32, 40, 0): 0,
               (201, 722, 200, 37, 0): -1}


def test_kernel_k_queries(dev):
    """The instance query at 8 / 13 / 32 / 33 contexts and at the owner
    instance's thread bounds, and the residency query: SieTill's owner
    instance runs what its launch bounds promise (256 threads; 4 blocks an
    SM in float32, 2 in float64) with every option; the block instance (the
    first design) 1 or more; a forced configuration that does not exist -1."""
    from speechrecognition_torch.ops import _native
    lib = _native.load()
    for f64 in (0, 1):
        for shape, k in K_INSTANCES.items():
            assert lib.sr_wcts_scan_instance(*shape, f64) == k, (shape, f64)
        promised = 2 if f64 else 4
        for bins in (0, 101):
            for la in (0, 1):
                assert lib.sr_wcts_scan_residency(13, 212, 12, 106, bins, f64, la, 0) >= promised
                assert lib.sr_wcts_scan_residency(13, 212, 12, 106, bins, f64, la, 1) >= 1
        assert lib.sr_wcts_scan_residency(13, 212, 12, 106, 0, f64, 0, 12) == -1


@pytest.mark.parametrize("force", [1, 8, 16])
@pytest.mark.parametrize("option", ["pruned", "everything"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_k_every_configuration(dev, force, option, dtype):
    """Kernel K on SieTill with each instance forced: the block instance
    (the first design) and the owner instance at 8 and 16 contexts a thread
    (two threads a node, or one), bit-equal to the plain version over two
    chunks."""
    from speechrecognition_torch.search import wcts

    def kernel(*a, **kw):
        out, outs, _scratch = wcts.wcts_scan_cuda(*a, force=force, **kw)
        return out, outs

    lex, tdp = sietill_search()
    got, ref = wcts_both(dev, lex, tdp, lex.num_states, lex.num_words, WCTS_OPTIONS[option],
                         dtype, 60, (23, 37), SEARCH_LENS, seed=11, kernel=kernel)
    assert same(got, ref)


@pytest.mark.parametrize("words", [4, 12, 31, 32])
@pytest.mark.parametrize("option", ["pruned", "everything", "limit-la-17-bins"])
@pytest.mark.parametrize("ties", [False, True])
def test_kernel_k_owner_edges(dev, words, option, ties):
    """Kernel K on prefix trees of 4, 12, 31 and 32 words (C 5 to 33 and N
    27 to 135: the owner instance at 8 and 16 contexts a thread and past
    its edges, node counts that are no multiple of 32, word ends inside the
    tree and homophones) in float32; with ties, integer
    scores and LM rows of 0 and 1, so that contexts tie in the
    recombination and slots at histogram bin edges."""
    from speechrecognition_torch.ops import _native
    from torch_search_tables import PrefixLexicon, prefix_tdp, wcts_inputs
    lex = PrefixLexicon(words, 4)
    tables, _wt = wcts_inputs(lex, prefix_tdp(lex), np.zeros((words, words)), np.zeros(words),
                              False)
    C, N = words + 1, tables.num_nodes
    inst = _native.load().sr_wcts_scan_instance(C, N, words, lex.num_states, 0, 0)
    assert inst == {4: 8, 12: 16, 31: 0, 32: 0}[words]
    got, ref = wcts_both(dev, lex, prefix_tdp(lex), lex.num_states, words,
                         WCTS_OPTIONS[option], torch.float32, 60, (23, 37), SEARCH_LENS,
                         seed=words, ties=ties)
    assert same(got, ref)


def fb_args(dev, A, T, dtype, seed, B=5):
    lams, ltdp, pv, fl, al = fb_inputs(B, T, A, seed=seed)
    return (torch.as_tensor(lams, dtype=dtype, device=dev),
            torch.as_tensor(ltdp, dtype=dtype, device=dev), torch.as_tensor(pv, device=dev),
            torch.as_tensor(fl, device=dev), torch.as_tensor(al, device=dev))


@pytest.mark.parametrize("A", list(L_INSTANCES))
@pytest.mark.parametrize("T", [1, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_l_matches_plain(dev, A, T, dtype):
    """Every instance of kernel L bit-equal to its plain version on the
    card, gamma and log_z; for A <= 96 the two chains with the posterior
    pass and the first design (forced) both. forward_backward.LAUNCHES
    counts the wrapper's call once, though the chains' instance launches
    twice; the forced first design is not counted."""
    from speechrecognition_torch.align import baumwelch as bw
    from speechrecognition_torch.ops import _native
    assert _native.load().sr_forward_backward_instance(A) == L_INSTANCES[A]
    args = fb_args(dev, A, T, dtype, seed=A * 7 + T)
    n0, s0 = bw.forward_backward.LAUNCHES, bw.forward_backward.SCRATCH_LAUNCHES
    g, z = bw.forward_backward(*args)
    gf, zf, _scratch = bw.forward_backward_cuda(*args, first_design=True)
    gr, zr = bw.forward_backward_reference(*args)
    torch.cuda.synchronize()
    assert bw.forward_backward.LAUNCHES == n0 + 1
    assert bw.forward_backward.SCRATCH_LAUNCHES == s0 + (L_INSTANCES[A] < 0)
    assert g.dtype == dtype and torch.isfinite(g).all() and torch.isfinite(z).all()
    assert torch.equal(g, gr) and torch.equal(z, zr)
    assert torch.equal(gf, gr) and torch.equal(zf, zr)
    assert (g >= 0).all()


@pytest.mark.parametrize("A", [a for a, inst in L_INSTANCES.items() if inst > 0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_l_chains_match_the_plain_phases(dev, A, dtype):
    """Each chain of kernel L's A <= 96 instance alone, bit-equal to its
    plain phase: the forward rows below feat_len and log_z
    (forward_reference), the backward rows up to feat_len - 1
    (backward_reference)."""
    from speechrecognition_torch.align import baumwelch as bw
    args = fb_args(dev, A, 40, dtype, seed=A + 500)
    n0 = bw.forward_backward.LAUNCHES
    alphas, z = bw.forward_backward_chain_cuda(0, *args)
    betas = bw.forward_backward_chain_cuda(1, *args)
    ar, zr = bw.forward_reference(*args)
    br = bw.backward_reference(*args)
    torch.cuda.synchronize()
    assert bw.forward_backward.LAUNCHES == n0
    assert torch.equal(z, zr)
    for b, n in enumerate(args[3].tolist()):
        assert torch.equal(alphas[b, :n], ar[b, :n]) and torch.equal(betas[b, :n], br[b, :n])


def test_kernel_l_on_the_main_path_equals_the_cpu(dev):
    """baum_welch_posteriors and accumulate_baum_welch on iter-2.mix and ten
    demo utterances, float64 "mxu" pack: the card (kernel L) within 1e-12 of
    the CPU (the plain version)."""
    from speechrecognition_torch.align import baumwelch as bw
    from speechrecognition_torch.align.viterbi import AlignerTables
    from speechrecognition_torch.lexicon import build_segment_automaton
    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = Corpus.read(desc, str(FIX / "demo_features") + "/", SignalAnalysisConfig(),
                         normalization_path=str(FIX / "normalization-demo.bin"))
    model = gmm.MixtureModel.from_raw(read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                      gmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    ids = list(range(10))
    feats, lens = corpus.padded_batch(ids, pad_to=int(corpus.lengths[ids].max()))
    tables = AlignerTables.build([build_segment_automaton(lex, corpus.orths[s]) for s in ids],
                                 TdpModel(silence_state=lex.silence_state, loop=3.0,
                                          forward=0.0, skip=30.0))
    out = {}
    for where in ("cpu", dev):
        pack = model.pack(dtype=torch.float64, device=where)
        g, z = bw.baum_welch_posteriors(pack, feats, lens, tables, dtype=torch.float64)
        stats = bw.accumulate_baum_welch(pack, feats, g,
                                         torch.as_tensor(tables.states, device=where))
        out[str(where)] = [t.cpu() for t in (g, z, *stats)]
    for got, ref in zip(out[str(dev)], out["cpu"]):
        assert ((got - ref).abs() / (1.0 + ref.abs())).max().item() <= 1e-12


# -- the LVCSR tier's 1-best path: kernels M, N and O ------------------------------


def linear_inputs(name, dtype, where):
    from speechrecognition_torch.search import linear_lvcsr as tl
    from torch_linear_tables import linear_case
    lex, tm, lm, lm_start, am, lens, thr = linear_case(name)
    lt = tl.LinearTables.build(tm.decoder_tables(lex), lm, lm_start, 0)
    return (torch.as_tensor(am, device=where).to(dtype).contiguous(),
            torch.as_tensor(lens, device=where), *lt.args(where, dtype, am.shape[2])), thr


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["lengths-1-2-3", "silence-1", "silence-2", "ties",
                                  "all-silence", "exit-off-float32"])
def test_kernel_m_and_n_bit_equal(dev, name, dtype, prune):
    """Kernel M's eight outputs and kernel N's words equal their plain
    versions on the same card tensors (tests/torch_linear_tables.py's
    cases: zero-length and all-silence utterances, words of 1-3 positions,
    silences of 1-3 positions, forced ties, a silence exit off float32), in
    both of M's designs: the warp instance the shape chooses and the first
    design, forced."""
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.search import linear_lvcsr as tl
    args, thr = linear_inputs(name, dtype, dev)
    (B, T, S), (W, P), Ps = args[0].shape, args[2].shape, args[7].shape[0]
    assert _native.load().sr_linear_scan_instance(W, P, Ps, S, T,
                                                  int(dtype == torch.float64)) == 1
    before = (tl.decode_scan_linear.LAUNCHES, tl.traceback_linear.LAUNCHES)
    got = tl.decode_scan_linear(*args, thr, prune=prune)
    first, _scratch = tl.decode_scan_linear_cuda(*args, thr, prune=prune, first_design=True)
    ref = tl.decode_scan_linear_reference(*args, thr, prune=prune)
    words = tl.traceback_linear(*(got[i] for i in (0, 1, 2, 4, 5, 6)), args[1])
    ref_words = tl.traceback_linear_reference(*(ref[i] for i in (0, 1, 2, 4, 5, 6)), args[1])
    torch.cuda.synchronize()
    assert (tl.decode_scan_linear.LAUNCHES, tl.traceback_linear.LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    for key, g, f, r in zip(tl.OUTPUTS, got, first, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), key
        assert torch.equal(f, r), f"{key} (first design)"
    assert torch.equal(words, ref_words)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("words,positions", [(299, 30), (600, 2), (600, 4)])
def test_kernel_m_large_lexica(dev, dtype, words, positions):
    """A lattice past the kernel's shared memory (299 words of 30
    positions: the state in device scratch) and more words than a block's
    512 threads (600 words: a thread takes two words and two silence
    copies; of 2 positions in shared memory, of 4 in scratch in float64),
    bit-equal; the launches in scratch are those the library's query
    names. Every such lexicon is past the warp instance, so the shape's
    choice and the forced first design are the same launch."""
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.search import linear_lvcsr as tl
    from torch_linear_tables import AN4_TDP, random_lm, tied_lexicon
    rng = np.random.default_rng(words)
    lex = tied_lexicon([positions] * words + [3], 3, 40, rng)
    lm, lm_start = random_lm(rng, lex.num_words, 0, 10.0)
    lt = tl.LinearTables.build(AN4_TDP.decoder_tables(lex), lm, lm_start, 0)
    am = torch.as_tensor(rng.uniform(0.0, 6.0, (2, 12, 40)), device=dev).to(dtype)
    lens = torch.as_tensor([12, 9], dtype=torch.int32, device=dev)
    args = (am, lens, *lt.args(dev, dtype, 40))
    lib = _native.load()
    f64 = int(dtype == torch.float64)
    in_scratch = lib.sr_linear_scan_scratch(words + 1, positions, 3, 40, f64) > 0
    assert in_scratch == (words == 299 or (positions == 4 and dtype == torch.float64))
    assert lib.sr_linear_scan_instance(words + 1, positions, 3, 40, 12, f64) < 1
    before = tl.decode_scan_linear.SCRATCH_LAUNCHES
    got = tl.decode_scan_linear(*args, 200.0, prune=True)
    first, first_in_scratch = tl.decode_scan_linear_cuda(*args, 200.0, prune=True,
                                                         first_design=True)
    ref = tl.decode_scan_linear_reference(*args, 200.0, prune=True)
    torch.cuda.synchronize()
    assert tl.decode_scan_linear.SCRATCH_LAUNCHES == before + in_scratch
    assert first_in_scratch == in_scratch
    for key, g, f, r in zip(tl.OUTPUTS, got, first, ref):
        assert torch.equal(g, r) and torch.equal(f, r), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("positions", [3, 30])
def test_kernel_m_warp_instance_edge(dev, dtype, positions):
    """The largest lexicon the warp instance takes (its state just fits in
    shared memory) and one word more, where the C entry falls back to the
    first design: both bit-equal to the plain version, in either design."""
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.search import linear_lvcsr as tl
    from torch_linear_tables import AN4_TDP, random_lm, tied_lexicon
    lib = _native.load()
    f64 = int(dtype == torch.float64)
    edge = max(W for W in range(2, 400) if lib.sr_linear_scan_instance(W, positions, 3, 40, 12,
                                                                       f64) == 1)
    assert edge >= 130 and lib.sr_linear_scan_instance(edge + 1, positions, 3, 40, 12, f64) < 1
    for W in (edge, edge + 1):
        rng = np.random.default_rng(W + positions)
        lex = tied_lexicon([positions] * W, 3, 40, rng)
        lm, lm_start = random_lm(rng, lex.num_words, 0, 10.0)
        lt = tl.LinearTables.build(AN4_TDP.decoder_tables(lex), lm, lm_start, 0)
        assert lt.state_table.shape == (W, positions)
        am = torch.as_tensor(rng.uniform(0.0, 6.0, (2, 12, 40)), device=dev).to(dtype)
        lens = torch.as_tensor([12, 9], dtype=torch.int32, device=dev)
        args = (am, lens, *lt.args(dev, dtype, 40))
        got, _ = tl.decode_scan_linear_cuda(*args, 200.0, prune=True)
        first, _ = tl.decode_scan_linear_cuda(*args, 200.0, prune=True, first_design=True)
        ref = tl.decode_scan_linear_reference(*args, 200.0, prune=True)
        torch.cuda.synchronize()
        for key, g, f, r in zip(tl.OUTPUTS, got, first, ref):
            assert torch.equal(g, r) and torch.equal(f, r), (W, key)


def traceback_args(dev, dtype, *a, **kw):
    from torch_linear_tables import traceback_books
    book, bkp, pred, origin, silend, silorg, lens = traceback_books(*a, **kw)
    fl = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return [torch.as_tensor(x, device=dev) for x in (book.astype(fl), bkp, pred, origin,
                                                      silend.astype(fl), silorg, lens)]


def kernel_n_designs(args):
    """Kernel N's words from its counted wrapper (the warp design), from
    the forced first design and from the plain version."""
    from speechrecognition_torch.search import linear_lvcsr as tl
    got = tl.traceback_linear(*args)
    first = tl.traceback_linear_cuda(*args, first_design=True)
    ref = tl.traceback_linear_reference(*args)
    torch.cuda.synchronize()
    return got, first, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_n_random_books(dev, seed, dtype):
    """Walks past MAX_TRACE_WORDS words (they stop at exactly that many),
    one ending at the sentence start, one empty utterance: both designs."""
    got, first, ref = kernel_n_designs(traceback_args(dev, dtype, seed))
    assert torch.equal(got, ref) and torch.equal(first, ref) and (got[:, 0] >= 0).all()
    assert got.shape[0] == 128 and (got[:, 2] == -1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("W", TRACEBACK_WIDTHS)
@pytest.mark.parametrize("name", list(TRACEBACK_STARTS))
def test_kernel_n_forced_starts(dev, name, W, dtype):
    """tests/torch_linear_tables.py's TRACEBACK_STARTS (a NaN first, in the
    middle and last in the word ends or the silence ends; ties across lane
    boundaries 0/31/32/63 won by the word end, the silence copy or
    neither; -0.0 tied with +0.0) at W 1 to 300, B 5: both designs pick
    argmin's start (the first NaN) and walk to the plain version's words."""
    got, first, ref = kernel_n_designs(traceback_args(dev, dtype, W, B=5, T=160, W=W,
                                                      **TRACEBACK_STARTS[name]))
    assert torch.equal(got, ref) and torch.equal(first, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["nan-book-middle", "nan-silend-last", "ties-31-32-63-silence",
                                  "signed-zero-31-32-63"])
@pytest.mark.parametrize("B", [1, 3, 33, 133])
def test_kernel_n_batches(dev, B, name, dtype):
    """One utterance, fewer than a block's 4 warps, 33 (a block not full)
    and 133 (34 blocks): both designs equal the plain version."""
    got, first, ref = kernel_n_designs(traceback_args(dev, dtype, B, B=B, T=160, W=130,
                                                      **TRACEBACK_STARTS[name]))
    assert torch.equal(got, ref) and torch.equal(first, ref)


def test_kernel_n_first_design_only_when_forced(dev):
    """The counted wrapper and traceback_linear_cuda's default launch the
    warp design; only first_design=True launches the first design (the
    launches' kernel names, torch.profiler). The counted wrapper counts its
    launch, the forced one does not."""
    from speechrecognition_torch.search import linear_lvcsr as tl
    args = traceback_args(dev, torch.float32, 0)
    tl.traceback_linear(*args)
    torch.cuda.synchronize()
    launched = {}
    for tag, call in (("counted", lambda: tl.traceback_linear(*args)),
                      ("default", lambda: tl.traceback_linear_cuda(*args)),
                      ("forced", lambda: tl.traceback_linear_cuda(*args, first_design=True))):
        n0 = tl.traceback_linear.LAUNCHES
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        launched[tag] = ({e.key for e in prof.key_averages() if "linear_traceback" in e.key},
                         tl.traceback_linear.LAUNCHES - n0)
    for tag in ("counted", "default", "forced"):
        names, counted = launched[tag]
        assert len(names) == 1, (tag, names)
        (name,) = names
        assert ("linear_traceback_warp_kernel" in name) == (tag != "forced"), (tag, name)
        assert ("linear_traceback_kernel" in name) == (tag == "forced"), (tag, name)
        assert counted == (tag == "counted"), tag


@pytest.fixture(scope="module")
def an4_model():
    return gmm.MixtureModel.from_raw(read_mixture_set("bench/an4/am.mix", 45),
                                     gmm.VarianceModel.GLOBAL_POOLING, max_approx=True)


@pytest.mark.parametrize("n", [1, 64, 1000, 4133])
def test_kernel_o_bit_equal_an4(dev, an4_model, n):
    """The AN4 model (501 x 16 slots, dim 45 padded to 64 bytes), frames near
    its means, no preselection: the same float32 scores as the plain
    version, N not a multiple of the kernel's 64-frame tile (nor of the
    first design's 32, whose scores are the same)."""
    from speechrecognition_torch.models import quantized as tq
    from torch_linear_tables import features_near_means
    rng = np.random.default_rng(n)
    x = torch.as_tensor(features_near_means(rng, an4_model, rng.integers(0, 501, n)),
                        device=dev)
    qp = tq.build_quant_pack(an4_model, device=dev)
    before = tq.am_scores_q.LAUNCHES
    got = tq.am_scores_q(qp, x)
    first = tq.am_scores_q_cuda(qp, x, first_design=True)
    ref = tq.am_scores_q_reference(qp, x)
    torch.cuda.synchronize()
    assert tq.am_scores_q.LAUNCHES == before + 1
    assert got.dtype == torch.float32 and torch.equal(got, ref) and torch.equal(first, ref)


@pytest.mark.parametrize("dim", [4, 13, 45, 100, 128, 129, 200, 256])
@pytest.mark.parametrize("clusters,selected", [(0, 0), (16, 4), (24, 1), (32, 32), (256, 32),
                                               (257, 32), (512, 64), (1024, 32)])
def test_kernel_o_bit_equal_synthetic(dev, dim, clusters, selected):
    """Synthetic pooled models at every padded width (dim 4 to 256: 64, 128
    and 256 bytes), with and without preselection (1 to 1,024 clusters,
    past 352 in device scratch; ties at the threshold from a palette of
    means, select-all), D 6 (not a multiple of 8), inactive densities;
    frames drawn near their means, NaN where the mean is an inactive
    density's (both quantize NaN to 0). The first design, where it takes
    the shape (dim <= 128, at most 256 clusters), gives the same scores."""
    from speechrecognition_torch.models import quantized as tq
    from torch_linear_tables import pooled_model, pooled_raw
    rng = np.random.default_rng(dim + clusters)
    raw = pooled_raw(rng, 400 if clusters > 256 else 300 if clusters == 256 else 40, 6, dim,
                     empty_share=0.2, palette=5 if clusters == 24 else 0)
    model = pooled_model(raw)
    qp = tq.build_quant_pack(model, preselection=clusters > 0, num_clusters=max(clusters, 1),
                             n_selected=max(selected, 1), device=dev)
    mi = rng.integers(0, model.means.shape[0], 300)
    x = model.means[mi] + rng.standard_normal((300, dim)) * np.sqrt(model.vars[0])
    x = torch.as_tensor(x.astype(np.float32), device=dev)
    assert qp.density_cap == 6 and (clusters <= 256 or qp.qcenters.shape[0] > 256)
    got = tq.am_scores_q(qp, x)
    ref = tq.am_scores_q_reference(qp, x)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if dim <= tq.FIRST_DESIGN_MAX_DIM and clusters <= tq.FIRST_DESIGN_MAX_CLUSTERS:
        first = tq.am_scores_q_cuda(qp, x, first_design=True)
        torch.cuda.synchronize()
        assert torch.equal(first, ref)


@pytest.mark.parametrize("preselection", [False, True])
def test_kernel_o_non_finite_and_half_way_frames(dev, preselection):
    """NaN, ±inf and products half way between integers: kernel O quantizes
    them as the plain version does (NaN to 0, ±inf clipped, halves to even),
    so the scores are the same bits."""
    from speechrecognition_torch.models import quantized as tq
    from torch_linear_tables import pooled_model, pooled_raw
    rng = np.random.default_rng(8)
    model = pooled_model(pooled_raw(rng, 40, 6, 13, empty_share=0.3))
    kw = dict(preselection=True, num_clusters=8, n_selected=2) if preselection else {}
    qp = tq.build_quant_pack(model, device=dev, **kw)
    x = (model.means[rng.integers(0, model.means.shape[0], 40)]
         + rng.standard_normal((40, 13)) * np.sqrt(model.vars[0])).astype(np.float32)
    x[3, 2], x[5, :], x[7, 0] = np.inf, -np.inf, np.nan
    x[9] = ((np.arange(13) - 6.5) / qp.inv_sqrt_var.cpu().numpy()).astype(np.float32)
    x = torch.as_tensor(x, device=dev)
    got = tq.am_scores_q(qp, x)
    first = tq.am_scores_q_cuda(qp, x, first_design=True)
    ref = tq.am_scores_q_reference(qp, x)
    torch.cuda.synchronize()
    assert bool(torch.isnan(x).any()) and torch.equal(got, ref) and torch.equal(first, ref)


def test_linear_decode_on_the_card_equals_the_cpu(dev):
    """decode_batch_linear_lvcsr on the same float32 scores on the card
    (kernels M and N) and on the CPU (the plain versions): the same
    transcripts."""
    from speechrecognition_torch.search import linear_lvcsr as tl
    from torch_linear_tables import (AN4_TDP, features_near_means, pooled_model, pooled_raw,
                                     random_lm, tied_lexicon, utterance_states)
    rng = np.random.default_rng(11)
    model = pooled_model(pooled_raw(rng, 30, 4, 13))
    lex = tied_lexicon(3 * np.clip(1 + rng.poisson(1.5, 12), 1, 4), 3, 30, rng,
                       own_silence=True)
    lens = rng.integers(20, 60, 6).astype(np.int32)
    feats = np.zeros((6, int(lens.max()), 13), np.float32)
    for b, n in enumerate(lens):
        feats[b, :n] = features_near_means(rng, model, utterance_states(rng, lex, int(n))[0])
    lm, lm_start = random_lm(rng, lex.num_words, 0, 10.0, low=2.0, high=12.0)
    tables = AN4_TDP.decoder_tables(lex)
    am = gmm.am_scores(model.pack(dtype=torch.float32, device="cpu"),
                       torch.as_tensor(feats.reshape(-1, 13))).reshape(6, -1, 30)
    out = [tl.decode_batch_linear_lvcsr(None, feats, lens, tables, lm, lm_start, 200.0, 0,
                                        am=am.to(where))
           for where in (dev, "cpu")]
    assert out[0] == out[1] and any(out[0])


@pytest.mark.parametrize("seed", range(7))
def test_silence_copy_oracle_on_the_card(dev, seed):
    """The reference's oracle on the card: the extended lexicon through
    kernel J, the linear decode through kernels M and N, float64."""
    from speechrecognition_torch.search.linear_lvcsr import decode_batch_linear_lvcsr
    from speechrecognition_torch.search.ngram_decoder import decode_batch_bigram
    from torch_linear_tables import oracle_case
    base, lm, lm_start, am, ext, ext_lm, ext_start, am_ext = oracle_case(seed)
    tdp = TdpModel(silence_state=0, loop=1.0, forward=0.0, skip=4.0)
    T = am.shape[1]
    feats, lens = np.zeros((1, T, 1), np.float32), np.asarray([T])
    want = decode_batch_bigram(None, feats, lens, dec.DecoderTables.build(ext, tdp, 0.0), ext_lm,
                               ext_start, 1e9, silence_idx=-1, prune=False,
                               dtype=torch.float64, am=torch.as_tensor(am_ext, device=dev))
    got = decode_batch_linear_lvcsr(None, feats, lens, dec.DecoderTables.build(base, tdp, 0.0),
                                    lm, lm_start, 1e9, 0, prune=False, dtype=torch.float64,
                                    am=torch.as_tensor(am, device=dev))
    assert got[0] == [w for w in want[0] if w in (1, 2)]


# -- kernel P: the context-sharded WCTS frame step (parallel/wcts_step.py) ---------


def _p_inputs(dev, dtype, kind):
    """(am on the card, lens, lex, tdp, lm, lm_start): the demo tie inputs
    (small integer scores, LM entries in steps of 5; "nan": one NaN score)
    or random scores in [0, 40) at SieTill's widths."""
    import torch_parallel_ranks as tpr
    from torch_search_tables import am_scores, random_lm
    lex, tdp = sietill_search()
    if kind in ("ties", "nan"):
        am, lens, lm, lm_start = tpr.tie_inputs(lex, nan=kind == "nan")
        am = torch.as_tensor(am)
    else:
        lens = np.asarray(SEARCH_LENS, np.int32)
        am = am_scores(len(lens), 60, lex.num_states, seed=5)
        lm, lm_start = random_lm(lex.num_words, 4)
    return am.to(device=dev, dtype=dtype), lens, lex, tdp, lm, lm_start


@pytest.mark.parametrize("design", ["owner", "block"])
@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["random", "ties", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_p_bit_equal(dev, dtype, kind, ranks, design):
    """Kernel P against its plain version, launch by launch, over every
    frame of 1-5 virtual ranks (13 contexts: 3 and 5 leave padding rows),
    the exchange made in-process; NaN counted equal to NaN. P1 through the
    instance SieTill's shape takes (the owner instance) or the block
    instance forced (the first design, uncounted)."""
    import torch_parallel_ranks as tpr
    from speechrecognition_torch.parallel import wcts_step as ws
    args = _p_inputs(dev, dtype, kind)
    k = tpr.virtual_ranks(*args, ranks)
    p = [st.clone() for st in k]
    before = ws.LAUNCHES
    n = tpr.lockstep(k, p, first_design=design == "block")
    T = args[0].shape[1]
    assert n == ranks * (2 * T + 1)
    assert ws.LAUNCHES == before + (n if design == "owner" else ranks * T)
    assert ws.launcher(k[0]).instance == 1
    if kind == "nan":
        assert torch.isnan(k[0].out_book).any()


#: shapes past the owner instance: (lexicon words, seed, ranks, dtype); the
#: tree has 266 nodes at 60 words (row at 1 rank 127 KB in float32, past
#: search::SHARED_LIMIT; at 2 ranks 66 KB, the owner instance's, and 99 KB
#: in float64) and 722 at 200 (more nodes than a block's 512 threads)
P_SHAPES = {"w60-r1-f32": (60, 1, 1, torch.float32, 0),
            "w60-r2-f32": (60, 1, 2, torch.float32, 1),
            "w60-r2-f64": (60, 1, 2, torch.float64, 0),
            "w200-r4-f32": (200, 2, 4, torch.float32, 0)}


@pytest.mark.parametrize("shape", sorted(P_SHAPES))
def test_kernel_p_instance_by_shape(dev, shape):
    """Prefix-sharing trees past the owner instance take the block instance
    unforced (its scratch rows allocated by the launcher), bit-equal to the
    plain version launch by launch; utterances end at frames 20, 11, 1
    and 0."""
    import torch_parallel_ranks as tpr
    from speechrecognition_torch.parallel import wcts_step as ws
    from torch_search_tables import PrefixLexicon, am_scores, prefix_tdp, random_lm
    words, seed, ranks, dtype, instance = P_SHAPES[shape]
    lex = PrefixLexicon(words, seed)
    lens = np.asarray([20, 11, 1, 0], np.int32)
    am = am_scores(len(lens), 20, lex.num_states, seed=5).to(device=dev, dtype=dtype)
    lm, lm_start = random_lm(lex.num_words, 4)
    k = tpr.virtual_ranks(am, lens, lex, prefix_tdp(lex), lm, lm_start, ranks)
    p = [st.clone() for st in k]
    assert all(ws.launcher(st).instance == instance for st in k)
    assert (ws.launcher(k[0]).scratch[0] is None) == (instance == 1)
    before = ws.LAUNCHES
    n = tpr.lockstep(k, p)
    assert n == ranks * 41 and ws.LAUNCHES == before + n


@pytest.mark.parametrize("chunk", [1, 8, 13])
@pytest.mark.parametrize("kind", ["random", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_p_graph_route(dev, dtype, kind, chunk, monkeypatch):
    """wcts_sharded on the local transport replays its frames from a CUDA
    graph (chunks of 1, 8 and 13 frames, then an eager tail; random scores
    over 60 frames, or the NaN tie inputs over 40 with dead utterances):
    books, bkps and preds equal the eager route's, kernel K's plain
    version's on the CPU and kernel K's decode on the card (NaN equal to
    NaN), and kernel P launches 2T + 1 times."""
    import torch_parallel_ranks as tpr
    from speechrecognition_torch.parallel import mesh as pm
    from speechrecognition_torch.parallel import wcts_step as ws
    from speechrecognition_torch.search import wcts
    from speechrecognition_torch.search.tree_decoder import TreeTables
    am, lens, lex, tdp, lm, lm_start = _p_inputs(dev, dtype, kind)
    B, T, S = am.shape
    tree = TreeTables.build(lex, tdp, 0.0)
    mesh = pm.make_mesh(1, ("model",), device=dev, transport="local")
    monkeypatch.setattr(pm, "FRAME_CHUNK", chunk)
    before = ws.LAUNCHES
    graph = pm.wcts_sharded(mesh, None, np.zeros((B, T, 25), np.float32), lens, tree, tdp, lm,
                            lm_start, tpr.THRESHOLD, dtype=dtype, am=am)
    assert ws.LAUNCHES == before + 2 * T + 1
    st = pm.shard_state(am, lens, tree, tdp, lm, lm_start, tpr.THRESHOLD, 0, 1)
    pm.run_frames_eager(st, mesh.transports["model"])
    eager = [o.cpu().numpy() for o in (st.out_book, st.out_bkp, st.out_pred)]
    wt = wcts.WctsTables.build(tree, tdp, lm, lm_start)
    _c, plain = wcts.wcts_scan(am.cpu(), torch.as_tensor(lens), *wt.args("cpu", dtype, S),
                               tpr.THRESHOLD)
    _c, kern = wcts.wcts_scan(am, torch.as_tensor(lens, device=dev), *wt.args(dev, dtype, S),
                              tpr.THRESHOLD)
    for g, e, p, k in zip(graph, eager, plain[:3], kern[:3]):
        nan = g.dtype.kind == "f"
        assert np.array_equal(g, e, equal_nan=nan) and np.array_equal(g, p.numpy(), equal_nan=nan)
        assert np.array_equal(g, k.cpu().numpy(), equal_nan=nan)
    assert np.isnan(graph[0]).any() == (kind == "nan")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_p_sharded_equals_kernel_k(dev, dtype):
    """Four virtual ranks through kernel P give kernel K's books, bkps and
    preds on the same scores."""
    import torch_parallel_ranks as tpr
    from speechrecognition_torch.search import wcts
    am, lens, lex, tdp, lm, lm_start = _p_inputs(dev, dtype, "random")
    k = tpr.virtual_ranks(am, lens, lex, tdp, lm, lm_start, 4)
    tpr.lockstep(k, [st.clone() for st in k])
    from speechrecognition_torch.search.tree_decoder import TreeTables
    wt = wcts.WctsTables.build(TreeTables.build(lex, tdp, 0.0), tdp, lm, lm_start)
    _c, outs = wcts.wcts_scan(am, torch.as_tensor(lens, device=dev),
                              *wt.args(dev, dtype, am.shape[2]), tpr.THRESHOLD)
    for st in k:
        for got, want in zip((st.out_book, st.out_bkp, st.out_pred), outs[:3]):
            assert torch.equal(got, want)


def test_kernel_p_refuses_bad_frames(dev):
    import torch_parallel_ranks as tpr
    from speechrecognition_torch.parallel import wcts_step as ws
    st = tpr.virtual_ranks(*_p_inputs(dev, torch.float32, "random"), 2)[0]
    T = st.am.shape[1]
    for t, recombine, step in ((0, False, True), (T + 1, False, True), (1, True, True),
                               (T + 2, True, False)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            ws.shard_entries_cuda(st, t, recombine, step)


def test_host_staged_gloo_equals_nccl_at_world_one(dev):
    """The gloo transport stages CUDA tensors through pinned host buffers;
    at world size 1 its collectives and a sharded WCTS decode equal NCCL's."""
    import torch.distributed as dist
    import torch_parallel_ranks as tpr
    from speechrecognition_torch.parallel import mesh as pm
    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    try:
        gloo = pm.make_mesh(1, ("model",), device=dev, transport="gloo",
                            init_method=f"tcp://localhost:{tpr.free_port()}", rank=0,
                            world_size=1)
        nccl = pm.make_mesh(1, ("model",), device=dev, transport="nccl")
        assert nccl.transport == "nccl" and gloo.transport == "gloo"
        rng = np.random.default_rng(0)
        for dt in (torch.int32, torch.int64, torch.float64):
            x = torch.as_tensor(rng.integers(-99, 99, 257)).to(device=dev, dtype=dt)
            got = [m.transports["model"].all_reduce(x.clone(), op) for m in (gloo, nccl)
                   for op in ("min", "sum")]
            assert torch.equal(got[0], got[2]) and torch.equal(got[1], got[3])
            outs = [torch.empty((1, 257), dtype=dt, device=dev) for _ in range(2)]
            for m, o in zip((gloo, nccl), outs):
                m.transports["model"].all_gather(o, x)
            assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0][0], x)
        am, lens, lex, tdp, lm, lm_start = _p_inputs(dev, torch.float32, "random")
        from speechrecognition_torch.search.tree_decoder import TreeTables
        tree = TreeTables.build(lex, tdp, 0.0)
        feats = np.zeros((*am.shape[:2], 25), np.float32)
        res = [pm.wcts_sharded(m, None, feats, lens, tree, tdp, lm, lm_start, tpr.THRESHOLD,
                               am=am) for m in (gloo, nccl)]
        for a, b in zip(*res):
            assert np.array_equal(a, b)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- one NaN score: kernels B, D, E, I, J, K and M keep it as their plain versions do --
#
# One acoustic score of a live state is NaN, in utterance 0 of several, in the
# middle of its frames (the second chunk where there are two). The plain
# versions keep the NaN as the reference does (jnp.minimum, .min and
# jnp.argmin for B, E, I, J, K and M; doublefloat.min_axis's halving for D),
# so it spreads through the utterance's lattice. Every output and carry is
# bit-equal to the plain version's, NaN counted equal to NaN, on every
# instance the shapes select (inputs: tests/torch_nan_tables.py, which
# chip_smoke.py's NaN phase shares).


@pytest.mark.parametrize("W,P", [(4, 9), (12, 24), (33, 8), (44, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_b_keeps_a_nan(dev, W, P, dtype):
    """Kernel B's warp instance at 2 and 3 positions a lane, its block
    instance and its scratch instance, two chunks."""
    from speechrecognition_torch.ops import _native
    assert _native.load().sr_decode_scan_instance(W, P) == {(4, 9): 2, (12, 24): 3, (33, 8): 0,
                                                            (44, 24): -1}[W, P]
    tables, S = nan_lexicon_tables(W, P, seed=W + P)
    am = nan_scores(tables, S, 1, seed=W * P)
    kern, plain = scan_both(dev, tables, am, NAN_LENS, 60.0, True, (15, 25), dtype=dtype)
    for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"), kern, plain):
        assert same_bits(k, p), name
    assert torch.isnan(kern[3]).any()


@pytest.mark.parametrize("W,P", [(5, 3), (12, 24), (33, 8), (44, 24)])
@pytest.mark.parametrize("where", ["last", "inner"])
@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "unpruned"])
def test_kernel_d_keeps_a_nan(dev, W, P, where, prune):
    """Kernel D's warp instance at 1 and 3 positions a lane, its block
    instance and its scratch instance. The plain version's halving keeps a
    NaN only as the second of a pair: the NaN in the lattice's last cell
    makes the row minimum NaN (unpruned, a NaN reaches the outputs), one in
    the last word's position 1 is lost or takes its pair's first with it."""
    from speechrecognition_torch.ops import _native
    assert _native.load().sr_decode_scan_df_instance(W, P) == D_INSTANCES[W, P]
    tables, S = nan_lexicon_tables(W, P, seed=W + P)
    am = nan_scores(tables, S, P - 1 if where == "last" else 1, seed=W * P)
    kern, plain = scan_df_both(dev, tables, am, NAN_LENS, 60.0, prune, (15, 25))
    for name, k, p in zip(("hyp.hi", "hyp.lo", "bkp", "book.hi", "book.lo", "score", "word",
                           "bkp_t"), kern, plain):
        assert same_bits(k, p), name
    if where == "last" and not prune:
        assert torch.isnan(kern[5]).any()


@pytest.mark.parametrize("A", [9, 70, 129, 303, 1024, 1025])
@pytest.mark.parametrize("case", ["pruned", "full-dp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_e_keeps_a_nan(dev, A, case, dtype):
    """Kernel E's warp instance at 1 and 3 warps an utterance, its wide
    instance at 3 and 4 positions a lane with the first design (the block
    instance in shared memory) forced beside it, and its scratch instance,
    three chunks, the second ending at the NaN's frame, every chunk's carry
    compared."""
    from speechrecognition_torch.align import viterbi as vit
    assert e_instance(A) == ALIGN_INSTANCES[A]
    ams, tdp, valid, aut, lens, thr, tie, prune = align_inputs(case, A=A)
    ams[0, 30, A // 2] = np.nan
    B, T, A = ams.shape
    args = (torch.as_tensor(tdp, dtype=dtype, device=dev), torch.as_tensor(valid, device=dev),
            torch.as_tensor(lens, device=dev), thr)
    results = []
    for fwd in (vit.align_fwd_chunk, e_first_design, vit.align_fwd_chunk_reference):
        prev = torch.full((B, A), 1e30, dtype=dtype, device=dev)
        carries, jumps = [], []
        for t0, n in ((0, 25), (25, 6), (31, 29)):
            am = torch.as_tensor(ams[:, t0:t0 + n], dtype=dtype, device=dev).contiguous()
            prev, j = fwd(prev, am, *args, t0, tie_pruned=tie, use_pruning=prune)
            carries.append(prev)
            jumps.append(j)
        results.append((*carries, torch.cat(jumps)))
    torch.cuda.synchronize()
    for name, k, f, p in zip(("carry 25", "carry 31", "carry 60", "jumps"), *results):
        assert same_bits(k, p), name
        assert same_bits(f, p), f"{name} (first design)"
    assert torch.isnan(results[0][1][0]).any()


@pytest.mark.parametrize("N", [33, 212, 1025, 9499])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_i_keeps_a_nan(dev, N, dtype):
    """Kernel I's owner instance at 1 and 4 nodes a lane, its block instance
    (also forced at every size: the first design) and its scratch instance
    (the 9,499-node prefix tree)."""
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.search import tree_decoder as td
    from torch_search_tables import PrefixLexicon, prefix_tdp, random_tree, tree_scores
    f64 = int(dtype == torch.float64)
    if N == 9499:
        lex = PrefixLexicon(2000, 3, max_len=16, branch=4)
        tree = td.TreeTables.build(lex, prefix_tdp(lex), 80.0)
        S, T = lex.num_states, 30
    else:
        tree = random_tree(N, seed=N)
        S, T = None, 40
    assert tree.num_nodes == N
    assert _native.load().sr_tree_scan_instance(N, f64) == {33: 1, 212: 4, 1025: 0, 9499: -1}[N]
    am = tree_scores(4, T, seed=N + 7, dtype=dtype, device=dev) if S is None else None
    if am is None:
        from torch_search_tables import am_scores
        am = am_scores(4, T, S, seed=N, dtype=dtype, device=dev)
    am[0, T // 2, int(tree.state[N // 2])] = float("nan")
    lens = torch.as_tensor(np.minimum(NAN_LENS, T), dtype=torch.int32, device=dev)
    args = tree.device_args(dev, dtype, am.shape[2])
    got = td.tree_scan(am, lens, *args, 45.0, prune=True)
    first, _scratch = td.tree_scan_cuda(am, lens, *args, 45.0, prune=True, first_design=True)
    ref = td.tree_scan_reference(am, lens, *args, 45.0, prune=True)
    torch.cuda.synchronize()
    for name, g, f, r in zip(("score", "word", "bkp"), got, first, ref):
        assert same_bits(g, r) and same_bits(f, r), name
    assert torch.isnan(got[0]).any()


@pytest.mark.parametrize("W,P", [(5, 9), (12, 24), (33, 8), (200, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_j_keeps_a_nan(dev, W, P, dtype):
    """Kernel J's warp instance at 2 and 3 positions a lane, its block
    instance (also forced at every shape: the first design) and its scratch
    instance (200 words of 3 states repeated 8 times)."""
    from speechrecognition_torch.ops import _native
    from speechrecognition_torch.search import ngram_decoder as ng
    from torch_search_tables import random_lm, wide_linear_tables
    f64 = int(dtype == torch.float64)
    if W == 200:
        tables, S = wide_linear_tables(200, 8, 3)
        am = np.random.default_rng(W).uniform(0.0, 40.0, size=(len(NAN_LENS), 40, S))
        am[0, NAN_FRAME, tables.state_table[W - 1, 1]] = np.nan
    else:
        tables, S = nan_lexicon_tables(W, P, seed=W * 5 + P)
        am = nan_scores(tables, S, 1, seed=W + P)
    assert tables.state_table.shape == (W, P)
    assert _native.load().sr_decode_scan_bigram_instance(W, P, f64) == {
        (5, 9): 2, (12, 24): 3, (33, 8): 0, (200, 24): -1}[W, P]
    lm, lm_start = random_lm(W, seed=W + P)
    am = torch.as_tensor(am, dtype=dtype, device=dev)
    lens = torch.as_tensor(NAN_LENS, dtype=torch.int32, device=dev)
    args = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (tables.state_table, tables.last_pos, tables.word_len)]
    args += [torch.as_tensor(a, dtype=dtype, device=dev)
             for a in (tables.tdp_within, tables.entry_pen, lm, lm_start)]
    got = ng.decode_scan_bigram(am, lens, *args, 200.0)
    first, _scratch = ng.decode_scan_bigram_cuda(am, lens, *args, 200.0, first_design=True)
    ref = ng.decode_scan_bigram_reference(am, lens, *args, 200.0)
    torch.cuda.synchronize()
    for name, g, f, r in zip(("book", "bkp", "pred", "offset"), got, first, ref):
        assert same_bits(g, r) and same_bits(f, r), name
    assert torch.isnan(got[0]).any()


@pytest.mark.parametrize("force", [0, 1, 8, 16])
@pytest.mark.parametrize("option", ["pruned", "everything"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_k_keeps_a_nan(dev, force, option, dtype):
    """Kernel K on SieTill, the instance its shape takes (0: the owner
    instance at 16 contexts a thread) and each forced (the block instance,
    the first design; the owner instance at 8 and 16), with the lookahead,
    histogram pruning, transparent silence and the statistics
    ("everything"), two chunks."""
    from speechrecognition_torch.search import wcts

    def kernel(*a, **kw):
        out, outs, _scratch = wcts.wcts_scan_cuda(*a, force=force, **kw)
        return out, outs

    lex, tdp = sietill_search()
    got, ref = wcts_both(dev, lex, tdp, lex.num_states, lex.num_words, WCTS_OPTIONS[option],
                         dtype, 60, (23, 37), SEARCH_LENS, seed=11,
                         kernel=kernel if force else None, nan=(0, 30, 40))
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert same_bits(g, r), k
    assert any(torch.isnan(g).any() for g in got if g.is_floating_point())


@pytest.mark.parametrize("option", ["pruned", "everything"])
def test_kernel_k_keeps_a_nan_in_scratch(dev, option):
    """Kernel K's scratch instance (a 200-word prefix tree, 145,122 slots),
    float32, two chunks."""
    from speechrecognition_torch.search import wcts
    from torch_search_tables import PrefixLexicon, prefix_tdp
    lex = PrefixLexicon(200, 2)
    before = wcts.wcts_scan.SCRATCH_LAUNCHES
    got, ref = wcts_both(dev, lex, prefix_tdp(lex), lex.num_states, lex.num_words,
                         WCTS_OPTIONS[option], torch.float32, 20, (10, 10), [20, 11], seed=3,
                         nan=(0, 12, 5))
    assert wcts.wcts_scan.SCRATCH_LAUNCHES == before + 2
    for k, (g, r) in enumerate(zip(got, ref)):
        assert same_bits(g, r), k


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["lengths-1-2-3", "silence-2", "large"])
def test_kernel_m_keeps_a_nan(dev, name, dtype, prune):
    """Kernel M's warp instance and its first design, forced, on
    tests/torch_linear_tables.py's cases, and the first design's scratch
    instance (299 words of 30 positions); kernel N's words after it."""
    from speechrecognition_torch.search import linear_lvcsr as tl
    from torch_linear_tables import AN4_TDP, random_lm, tied_lexicon
    if name == "large":
        rng = np.random.default_rng(299)
        lex = tied_lexicon([30] * 299 + [3], 3, 40, rng)
        lm, lm_start = random_lm(rng, lex.num_words, 0, 10.0)
        lt = tl.LinearTables.build(AN4_TDP.decoder_tables(lex), lm, lm_start, 0)
        am = torch.as_tensor(rng.uniform(0.0, 6.0, (2, 12, 40)), device=dev).to(dtype)
        args = (am, torch.as_tensor([12, 9], dtype=torch.int32, device=dev),
                *lt.args(dev, dtype, 40))
        thr = 200.0
    else:
        args, thr = linear_inputs(name, dtype, dev)
    am, lens, st = args[0], args[1], args[2]
    b = int(torch.argmax(lens))
    am[b, int(lens[b]) // 2, int(st[min(1, st.shape[0] - 1), 0])] = float("nan")
    got = tl.decode_scan_linear(*args, thr, prune=prune)
    first, _scratch = tl.decode_scan_linear_cuda(*args, thr, prune=prune, first_design=True)
    ref = tl.decode_scan_linear_reference(*args, thr, prune=prune)
    torch.cuda.synchronize()
    for key, g, f, r in zip(tl.OUTPUTS, got, first, ref):
        assert same_bits(g, r) and same_bits(f, r), key
    assert any(torch.isnan(g).any() for g in got if g.is_floating_point())
    words = tl.traceback_linear(*(got[i] for i in (0, 1, 2, 4, 5, 6)), lens)
    ref_words = tl.traceback_linear_reference(*(ref[i] for i in (0, 1, 2, 4, 5, 6)), lens)
    assert torch.equal(words, ref_words)
