"""The two GMM functions nothing else calls, ``aligned_density_scores_df``
and ``em_score_and_accumulate_corpus`` (speechrecognition_torch/models/
gmm.py), against the JAX package's on the demo corpus and its golden
alignment.

``aligned_density_scores_df`` is bit-equal to JAX's run op by op
(jax.disable_jit: the jitted JAX function contracts products into FMAs on
XLA:CPU, ROADMAP Queue 3 #3). ``em_score_and_accumulate_corpus`` in df32
(max-approx), f64 and f32 (max-approx, with and without the aligned
gather, and the first pass): counts exact, sums within 1e-12 relative (f32
within 1e-6: torch and XLA round the float32 products differently), as
tests/test_torch_em.py holds the other corpus passes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import speechrecognition_tpu.models.gmm as jgmm

import speechrecognition_torch.models.gmm as tgmm
from test_torch_em import FIX, RTOL, models
import speechrecognition_torch.io as tio
from torch_search_tables import demo_setup

torch.set_num_threads(1)
C = 2048                    # frames a chunk


@pytest.fixture(scope="module")
def chunks():
    """The demo corpus's frames with the golden alignment, in chunks of C,
    the tail masked."""
    _lex, corpus, _tdp, _model = demo_setup()
    align, _w, _m = tio.read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    feats = corpus.features
    n = min(feats.shape[0], align.shape[0], 4 * C - 300)
    K = -(-n // C)
    fp = np.zeros((K * C, 25), np.float32)
    fp[:n] = feats[:n]
    st = np.zeros(K * C, np.int32)
    st[:n] = align[:n]
    mask = np.zeros(K * C, np.float32)
    mask[:n] = 1.0
    return fp.reshape(K, C, 25), st.reshape(K, C), mask.reshape(K, C)


def test_aligned_density_scores_df_bit_equal_to_jax(chunks):
    jm, tm = models()
    feats, states, _mask = chunks
    f, s = feats[0][:512], states[0][:512]
    got = tgmm.aligned_density_scores_df(tm.pack_df(device="cpu"), torch.as_tensor(f),
                                         torch.as_tensor(s))
    with jax.disable_jit():
        want = jgmm.aligned_density_scores_df(jm.pack_df(), jnp.asarray(f), jnp.asarray(s))
    for g, w in ((got.hi, want.hi), (got.lo, want.lo)):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the aligned block of the full scores, in the same order
    full = tgmm.density_scores_df_reference(tm.pack_df(device="cpu"), torch.as_tensor(f))
    D = tm.max_densities_per_mixture
    idx = torch.as_tensor(s).long()[:, None] * D + torch.arange(D)[None, :]
    assert torch.equal(full.hi.gather(1, idx), got.hi)
    assert torch.equal(full.lo.gather(1, idx), got.lo)


CASES = {"df32": ("df32", {}), "f64": (torch.float64, {}),
         "f32": (torch.float32, {}), "f32-no-gather": (torch.float32, {"aligned_gather": False}),
         "f64-first-pass": (torch.float64, {"first_pass": True})}


@pytest.mark.parametrize("case", list(CASES))
def test_em_score_and_accumulate_corpus_equals_jax(chunks, case):
    kind, kw = CASES[case]
    jm, tm = models()
    if kind == "df32":
        tpack, jpack = tm.pack_df(device="cpu"), jm.pack_df()
    else:
        jdt = jnp.float64 if kind == torch.float64 else jnp.float32
        tpack, jpack = tm.pack(dtype=kind, device="cpu"), jm.pack(dtype=jdt)
    got = tgmm.em_score_and_accumulate_corpus(tpack, *(torch.as_tensor(a) for a in chunks), **kw)
    want = jgmm.em_score_and_accumulate_corpus(jpack, *(jnp.asarray(a) for a in chunks), **kw)
    rtol = 1e-6 if kind == torch.float32 else RTOL
    total, w, xs, x2s = (t.numpy() for t in got)
    jtotal, jw, jxs, jx2s = (np.asarray(t) for t in want)
    assert all(t.dtype == torch.float64 for t in got)
    np.testing.assert_array_equal(w, jw)
    assert w.sum() == chunks[2].sum()
    for g, r in ((xs, jxs), (x2s, jx2s)):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=RTOL * np.abs(r).max())
    np.testing.assert_allclose(total, jtotal, rtol=rtol)


def test_em_score_and_accumulate_corpus_refuses_sum_mode(chunks):
    _jm, tm = models(max_approx=False)
    with pytest.raises(NotImplementedError):
        tgmm.em_score_and_accumulate_corpus(tm.pack(dtype=torch.float64, device="cpu"),
                                            *(torch.as_tensor(a) for a in chunks))
