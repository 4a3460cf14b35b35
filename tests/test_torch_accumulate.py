"""The port's ``gmm.accumulate_chunk`` (the E-step of weighted aligned
frames) against the JAX package's, on the CPU.

iter-2.mix on the first 4,096 demo frames with alignment-2-0.dump's states,
both packages reading the fixtures: float64 and float32 "mxu" packs and a
float32 "pallas" pack, max-approx and sum mode, with 0/1 weights (a hard
alignment with padding) and with posterior weights in (0, 1]. The port
scores only the aligned mixture's densities where the reference scores all
of them and gathers; the memberships come out the same. Counts are
bit-equal in float64 with 0/1 weights; every sum is within 1e-9 relative,
except float32 sum mode: there the memberships are float32 exponentials of
float32 scores from the [x², x, 1] · P product, whose reduction order
differs between torch and XLA (each loses ~1e-4 relative to cancellation,
gmm.ScorePack; tests/test_torch_align.py holds the f32 costs to 1e-4 for
the same reason), so those sums are held to 1e-4.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.io as jio
import speechrecognition_tpu.models.gmm as jgmm

import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.gmm as tgmm

torch.set_num_threads(1)

FIX = Path(__file__).resolve().parent / "fixtures"
N = 4096


@pytest.fixture(scope="module")
def frames():
    lex = tlex.build_sietill_lexicon()
    desc = tcorpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = tcorpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                 tfront.SignalAnalysisConfig(),
                                 normalization_path=str(FIX / "normalization-demo.bin"))
    align, _w, _m = tio.read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    rng = np.random.default_rng(3)
    hard = np.ones(N, np.float32)
    hard[-100:] = 0.0                           # padding rows
    soft = rng.uniform(0.01, 1.0, N).astype(np.float32)
    return corpus.features[:N], align[:N].astype(np.int32), {"hard": hard, "posterior": soft}


def models(max_approx):
    jm = jgmm.MixtureModel.from_raw(jio.read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                    jgmm.VarianceModel.MIXTURE_POOLING, max_approx=max_approx)
    tm = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                    tgmm.VarianceModel.MIXTURE_POOLING, max_approx=max_approx)
    return jm, tm


PACKS = {"f64": (torch.float64, jnp.float64, "mxu"), "f32": (torch.float32, jnp.float32, "mxu"),
         "f32-pallas": (torch.float32, jnp.float32, "pallas")}


@pytest.mark.parametrize("weights", ["hard", "posterior"])
@pytest.mark.parametrize("mode", ["max-approx", "sum"])
@pytest.mark.parametrize("kind", list(PACKS))
def test_accumulate_chunk_equals_jax(frames, kind, mode, weights):
    feats, states, w = frames
    dt, jdt, method = PACKS[kind]
    jm, tm = models(mode == "max-approx")
    got = tgmm.accumulate_chunk(tm.pack(dtype=dt, method=method, device="cpu"),
                                torch.as_tensor(feats), torch.as_tensor(states),
                                torch.as_tensor(w[weights]), first_pass=False)
    want = jgmm.accumulate_chunk(jm.pack(dtype=jdt, method=method), jnp.asarray(feats),
                                 jnp.asarray(states), jnp.asarray(w[weights]), first_pass=False)
    rtol = 1e-4 if kind != "f64" and mode == "sum" else 1e-9
    for g, ref in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=rtol, atol=rtol)
    if kind == "f64" and weights == "hard" and mode == "max-approx":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert got[0].sum().item() == N - 100


def test_first_pass_assigns_density_zero(frames):
    feats, states, w = frames
    jm, tm = models(True)
    got = tgmm.accumulate_chunk(tm.pack(dtype=torch.float64, device="cpu"),
                                torch.as_tensor(feats), torch.as_tensor(states),
                                torch.as_tensor(w["hard"]), first_pass=True)
    want = jgmm.accumulate_chunk(jm.pack(dtype=jnp.float64), jnp.asarray(feats),
                                 jnp.asarray(states), jnp.asarray(w["hard"]), first_pass=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.all(got[0].numpy()[:, 1:] == 0.0)
    for g, ref in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_memberships_equal_the_full_product(frames):
    """The aligned-mixture scores choose the same density as the reference's
    full [N, S, D] product and gather, in float32 and float64."""
    feats, states, _w = frames
    _jm, tm = models(True)
    for dt in (torch.float32, torch.float64):
        pack = tm.pack(dtype=dt, device="cpu")
        x = torch.as_tensor(feats)
        st = torch.as_tensor(states).long()
        full = tgmm.density_scores(pack, x)[torch.arange(N), st]
        aligned = tgmm.aligned_density_scores(pack, x, st)
        np.testing.assert_array_equal(aligned.argmin(-1).numpy(), full.argmin(-1).numpy())
