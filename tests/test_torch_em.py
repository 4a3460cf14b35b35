"""The port's E-step passes against the JAX package's, on the CPU.

* ``em_pass_sorted`` in f32, f64 (one batched [x², x, 1] · P product per
  block) and df32 (kernel H's plain version): ``w`` bit-equal to the JAX
  ``em_pass_sorted``, xs, x2s and the score total within 1e-12 relative
  (float64 sums of exact terms in another order); the f32 total within 1e-7
  and the f32 sum-mode passes within 1e-6, their scores being float32
  products that torch and XLA round in another order. The df32 pass is held to
  JAX run op by op (``jax.disable_jit``) on four blocks of 256 rows: jitted,
  XLA:CPU contracts one multiply-add of each DF mul (tests/test_torch_df32.py).
  On the demo corpus's sorted blocks it is held to the jitted JAX pass in
  decisions (w) and within 1e-12 in the sums.
* The sum-mode passes (``em_am_score_corpus``, ``em_accumulate_corpus``,
  max-approx=false) within 1e-12 relative in f64.
* Padding the densities to a larger capacity changes no output.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import speechrecognition_tpu.io as jio
import speechrecognition_tpu.models.gmm as jgmm

import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.gmm as tgmm

# One intra-op thread per test process (see tests/test_torch_align.py).
torch.set_num_threads(1)

FIX =Path(__file__).resolve().parent / "fixtures"
RTOL = 1e-12


@pytest.fixture(scope="module")
def demo():
    lex = tlex.build_sietill_lexicon()
    desc = tcorpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = tcorpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                 tfront.SignalAnalysisConfig(),
                                 normalization_path=str(FIX / "normalization-demo.bin"))
    align, _w, _m = tio.read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    return corpus.features, align


def models(path="iter-2.mix", max_approx=True):
    raw_j = jio.read_mixture_set(str(FIX / path), 25)
    raw_t = tio.read_mixture_set(str(FIX / path), 25)
    return (jgmm.MixtureModel.from_raw(raw_j, jgmm.VarianceModel.MIXTURE_POOLING, max_approx),
            tgmm.MixtureModel.from_raw(raw_t, tgmm.VarianceModel.MIXTURE_POOLING, max_approx))


def sorted_inputs(feats, align, block=tgmm.EM_BLOCK):
    frame_idx, block_state, _nb = tgmm.sorted_blocks(align, 106, block=block)
    frames = feats[np.maximum(frame_idx, 0)]
    mask = (frame_idx >= 0).astype(np.float32)
    return frames, mask, block_state


def assert_stats_close(got, want, total_rtol=RTOL):
    total, w, xs, x2s = (np.asarray(t) for t in got)
    jtotal, jw, jxs, jx2s = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(w, jw)
    for g, r in ((xs, jxs), (x2s, jx2s)):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=RTOL * np.abs(r).max())
    assert total.dtype == np.float64
    np.testing.assert_allclose(total, jtotal, rtol=total_rtol)


def pack_pair(jm, tm, kind, cap=None):
    if kind == "df32":
        return jm.pack_df(density_cap=cap), tm.pack_df(density_cap=cap, device="cpu")
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}[kind]
    return jm.pack(dtype=jdt, density_cap=cap), tm.pack(dtype=tdt, density_cap=cap, device="cpu")


@pytest.mark.parametrize("kind", ["f32", "f64", "df32"])
@pytest.mark.parametrize("first_pass", [False, True])
def test_em_pass_sorted_demo_equals_jax(demo, kind, first_pass):
    feats, align = demo
    frames, mask, bs = sorted_inputs(feats, align)
    jm, tm = models()
    jpack, tpack = pack_pair(jm, tm, kind)
    got = tgmm.em_pass_sorted(tpack, torch.as_tensor(frames), torch.as_tensor(mask),
                              torch.as_tensor(bs), first_pass=first_pass)
    want = jgmm.em_pass_sorted(jpack, jnp.asarray(frames), jnp.asarray(mask),
                               jnp.asarray(bs), first_pass=first_pass)
    # f32 frame scores: a float32 product that torch and XLA reduce in
    # another order (ulps of ~30); the decisions and the sums of the frames
    # themselves are held to the f64 tolerance
    assert_stats_close(got, want, total_rtol=1e-7 if kind == "f32" else RTOL)
    assert float(got[1].sum()) == align.shape[0]


def test_em_pass_sorted_df32_bit_level_equals_jax_op_by_op(demo):
    """Four blocks of 256 rows (two of one state, ragged padding) against the
    JAX pass run op by op."""
    feats, align = demo
    rng = np.random.default_rng(0)
    bs = np.array([3, 3, 17, 60], np.int32)
    frames = np.zeros((4, 256, 25), np.float32)
    mask = np.zeros((4, 256), np.float32)
    for b, (s, n) in enumerate(zip(bs, (256, 97, 180, 5))):
        rows = rng.choice(np.nonzero(align == s)[0], size=n, replace=True)
        frames[b, :n] = feats[rows]
        frames[b, n:] = feats[0]
        mask[b, :n] = 1.0
    jm, tm = models()
    got = tgmm.em_pass_sorted(tm.pack_df(device="cpu"), torch.as_tensor(frames), torch.as_tensor(mask),
                              torch.as_tensor(bs))
    with jax.disable_jit():
        want = jgmm.em_pass_sorted(jm.pack_df(), jnp.asarray(frames), jnp.asarray(mask),
                                   jnp.asarray(bs))
    assert_stats_close(got, want)
    # the frame scores themselves, bit for bit: total over one-row blocks
    best, fs64 = tgmm._best_density_df(tm.pack_df(device="cpu"), torch.as_tensor(frames),
                                       torch.as_tensor(mask), torch.as_tensor(bs).long())
    for b in range(4):
        row = frames[b:b + 1, :1]
        with jax.disable_jit():
            one = jgmm.em_pass_sorted(jm.pack_df(), jnp.asarray(row), jnp.ones((1, 1)),
                                      jnp.asarray(bs[b:b + 1]))
        assert float(fs64[b, 0]) == float(one[0])
        assert np.asarray(one[1])[bs[b], int(best[b, 0])] == 1.0


@pytest.mark.parametrize("kind", ["f64", "df32"])
def test_density_padding_changes_nothing(demo, kind):
    """Packs padded to 16 density slots (the reference's fixed capacity)
    give the unpadded pack's statistics in the first slots and zeros after."""
    feats, align = demo
    frames, mask, bs = (torch.as_tensor(a) for a in sorted_inputs(feats, align))
    _jm, tm = models()
    D = tm.max_densities_per_mixture
    _, small = pack_pair(_jm, tm, kind)
    _, big = pack_pair(_jm, tm, kind, cap=16)
    got = tgmm.em_pass_sorted(big, frames, mask, bs)
    want = tgmm.em_pass_sorted(small, frames, mask, bs)
    assert got[1].shape == (106, 16) and want[1].shape == (106, D)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g[:, :D], w) and not g[:, D:].any()


@pytest.fixture(scope="module")
def sum_chunks(demo):
    feats, _ = demo
    align, _w, _m = tio.read_alignment(str(FIX / "sum_mode" / "alignment-2-0.dump"))
    C = 8192
    K = -(-feats.shape[0] // C)
    fp = np.zeros((K * C, 25), np.float32)
    fp[:feats.shape[0]] = feats
    st = np.zeros(K * C, np.int32)
    st[:align.shape[0]] = align
    mask = np.zeros(K * C, np.float32)
    mask[:feats.shape[0]] = 1.0
    return fp.reshape(K, C, 25), st.reshape(K, C), mask.reshape(K, C)


@pytest.mark.parametrize("kind", ["f32", "f64"])
def test_sum_mode_passes_equal_jax(sum_chunks, kind):
    jm, tm = models("sum_mode/iter-2.mix", max_approx=False)
    jpack, tpack = pack_pair(jm, tm, kind)
    targs = tuple(torch.as_tensor(a) for a in sum_chunks)
    jargs = tuple(jnp.asarray(a) for a in sum_chunks)
    total = tgmm.em_am_score_corpus(tpack, *targs)
    jtotal = jgmm.em_am_score_corpus(jpack, *jargs)
    rtol = RTOL if kind == "f64" else 1e-6   # f32 scores: torch and XLA round differently
    np.testing.assert_allclose(float(total), float(jtotal), rtol=rtol)
    stats = tgmm.em_accumulate_corpus(tpack, *targs)
    jstats = jgmm.em_accumulate_corpus(jpack, *jargs, first_pass=False)
    for g, r in zip(stats, jstats):
        r = np.asarray(r)
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol, atol=rtol * np.abs(r).max())


@pytest.mark.parametrize("which", ["max-approx", "df32"])
def test_sum_mode_passes_refuse_other_packs(sum_chunks, which):
    _jm, tm = models(max_approx=True)
    pack = (tm.pack(dtype=torch.float64, device="cpu") if which == "max-approx"
            else tm.pack_df(device="cpu"))
    targs = tuple(torch.as_tensor(a) for a in sum_chunks)
    for fn in (tgmm.em_am_score_corpus, tgmm.em_accumulate_corpus):
        with pytest.raises(NotImplementedError, match="em_pass_sorted"):
            fn(pack, *targs)
