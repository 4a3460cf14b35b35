"""Kernel A's plain version against the Pallas Mahalanobis kernel.

The JAX side runs ``mahalanobis_scores(..., interpret=True)``, the Pallas
kernel in interpret mode, as tests/test_pallas_ops.py runs it on the CPU.
Tolerance: max |Δ|/(1+|ref|) ≤ 1e-6 over active slots. Both sides sum the
25 terms in the same order in float32, but the XLA CPU lowering contracts
and orders the multiply-adds differently from PyTorch's separate kernels
(measured: ≤ 3.3e-7). Against the float64 centered form the bound is the
3e-6 of tests/test_pallas_ops.py.

The fused entry (``mahalanobis_min_scores``, each mixture's minimum over its
D slots, capped) is held against JAX's ``am_scores`` on the same "pallas"
pack, the Pallas kernel in interpret mode followed by the max-approximation's
minimum, within the same 1e-6; its plain version is exactly the minimum of
the unfused plain version.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.io as jio
import speechrecognition_tpu.models.gmm as jgmm
from speechrecognition_tpu.ops import mahalanobis as jmaha

import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.gmm as tgmm
from speechrecognition_torch.ops import mahalanobis as tmaha

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
MODELS = {"iter-2": (FIX / "iter-2.mix", "MIXTURE_POOLING"),
          "bench": (REPO / "bench" / "model.mix", "NO_POOLING")}
REL_TOL = 1e-6
F64_TOL = 3e-6


def rel_err(got, ref):
    return np.abs(np.asarray(got, np.float64) - ref) / (1.0 + np.abs(ref))


@pytest.fixture(scope="module")
def demo_feats():
    lex = tlex.build_sietill_lexicon()
    desc = tcorpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = tcorpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                 tfront.SignalAnalysisConfig(),
                                 normalization_path=str(FIX / "normalization-demo.bin"))
    return corpus.features[:2048]


@pytest.fixture(scope="module", params=sorted(MODELS))
def models(request):
    path, pooling = MODELS[request.param]
    j = jgmm.MixtureModel.from_raw(jio.read_mixture_set(str(path), 25),
                                   jgmm.VarianceModel[pooling], max_approx=True)
    t = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(path), 25),
                                   tgmm.VarianceModel[pooling], max_approx=True)
    return j, t


def test_pack_to_mahalanobis_equal(models):
    j, t = models
    for x, y in zip(jmaha.pack_to_mahalanobis(j), tmaha.pack_to_mahalanobis(t)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_reference_matches_pallas_random():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(200, 25)).astype(np.float32)
    mu = rng.normal(size=(300, 25)).astype(np.float32)
    a = rng.uniform(0.1, 2.0, size=(300, 25)).astype(np.float32)
    c = rng.uniform(10.0, 40.0, size=300).astype(np.float32)
    ref = np.asarray(jmaha.mahalanobis_scores(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(a),
                                              jnp.asarray(c), interpret=True), np.float64)
    got = tmaha.mahalanobis_scores_reference(*(torch.from_numpy(v) for v in (x, mu, a, c)))
    assert got.dtype == torch.float32 and got.shape == (200, 300)
    assert rel_err(got.numpy(), ref).max() <= REL_TOL


def test_reference_matches_pallas_demo(models, demo_feats):
    j, t = models
    mu, a, c, active = tmaha.pack_to_mahalanobis(t)
    ref = np.asarray(jmaha.mahalanobis_scores(
        jnp.asarray(demo_feats), jnp.asarray(mu), jnp.asarray(a), jnp.asarray(c),
        interpret=True), np.float64)
    got = tmaha.mahalanobis_scores_reference(
        *(torch.from_numpy(v) for v in (demo_feats, mu, a, c))).numpy()
    mask = np.broadcast_to(active.reshape(-1)[None, :], got.shape)
    assert rel_err(got, ref)[mask].max() <= REL_TOL
    # inactive slots carry the sentinel in both
    np.testing.assert_array_equal(got[:, ~active.reshape(-1)], ref[:, ~active.reshape(-1)])


def test_reference_vs_f64_centered(models, demo_feats):
    _j, t = models
    mu, a, c, active = tmaha.pack_to_mahalanobis(t)
    got = tmaha.mahalanobis_scores_reference(
        *(torch.from_numpy(v) for v in (demo_feats, mu, a, c))).numpy()
    # float64 centered form from the model's float64 parameters
    S, D = active.shape
    mu64 = np.zeros((S * D, t.dim))
    a64 = np.zeros((S * D, t.dim))
    c64 = np.zeros(S * D)
    for s in range(S):
        for d, (mi, vi) in enumerate(t.mixtures[s]):
            if active[s, d]:
                j = s * D + d
                mu64[j], a64[j] = t.means[mi], 0.5 * t.vars_inv[vi]
                c64[j] = t.norm[vi] - t.mean_weights_log[mi]
    exact = tmaha.mahalanobis_scores_reference(
        *(torch.from_numpy(v) for v in (demo_feats.astype(np.float64), mu64, a64, c64))).numpy()
    mask = np.broadcast_to(active.reshape(-1)[None, :], got.shape)
    assert rel_err(got, exact)[mask].max() <= F64_TOL


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((33, 25), (70, 25), (70, 25), (70,))]
    before = tmaha.mahalanobis_scores.LAUNCHES
    assert torch.equal(tmaha.mahalanobis_scores(*args),
                       tmaha.mahalanobis_scores_reference(*args))
    assert tmaha.mahalanobis_scores.LAUNCHES == before


def test_wrapper_refuses_other_devices():
    args = [torch.empty(s, device="meta") for s in ((4, 25), (8, 25), (8, 25), (8,))]
    with pytest.raises(ValueError, match="unsupported device"):
        tmaha.mahalanobis_scores(*args)


# -- the fused entry: each mixture's minimum over its density slots -------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fused_am_scores_match_jax(name, demo_feats, monkeypatch):
    """The port's am_scores on a "pallas" pack goes through
    mahalanobis_min_scores (its plain version on the CPU) and agrees with
    JAX's am_scores on the same pack: iter-2.mix (D = 4) and bench/model.mix
    (D = 16)."""
    path, pooling = MODELS[name]
    j = jgmm.MixtureModel.from_raw(jio.read_mixture_set(str(path), 25),
                                   jgmm.VarianceModel[pooling], max_approx=True)
    t = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(path), 25),
                                   tgmm.VarianceModel[pooling], max_approx=True)
    feats = demo_feats[:1000]
    ref = np.asarray(jgmm.am_scores(j.pack(method="pallas"), jnp.asarray(feats)), np.float64)
    calls = []
    fused = tmaha.mahalanobis_min_scores
    monkeypatch.setattr(tmaha, "mahalanobis_min_scores",
                        lambda *args: calls.append(args[-1]) or fused(*args))
    pack = t.pack(method="pallas", device="cpu")
    got = tgmm.am_scores(pack, torch.from_numpy(feats))
    assert calls == [pack.density_cap] and pack.density_cap == {"iter-2": 4, "bench": 16}[name]
    assert got.dtype == torch.float32 and got.shape == (1000, t.num_mixtures)
    assert rel_err(got.numpy(), ref).max() <= REL_TOL


@pytest.mark.parametrize("n,s,d,dim", [(57, 7, 3, 25), (1, 1, 1, 13), (40, 5, 16, 128)])
def test_min_reference_is_amin_of_plain(n, s, d, dim):
    """Exactly the minimum of the unfused plain version over each run of D
    slots, capped at MIN_SCORE_INIT: slots with the inactive sentinel and a
    mixture with no active slot (capped) included."""
    rng = np.random.default_rng(n + s + d + dim)
    x = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
    mu = torch.from_numpy(rng.normal(size=(s * d, dim)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.1, 2.0, size=(s * d, dim)).astype(np.float32))
    c = torch.from_numpy(rng.uniform(10.0, 40.0, size=s * d).astype(np.float32))
    mu[-d:] = a[-d:] = 0.0
    c[-d:] = 5e17
    if d > 1:
        c[0] = 5e17
    got = tmaha.mahalanobis_min_scores_reference(x, mu, a, c, d)
    plain = tmaha.mahalanobis_scores_reference(x, mu, a, c)
    expect = torch.clamp(plain.reshape(n, s, d).amin(dim=-1), max=tgmm.MIN_SCORE_INIT)
    assert got.shape == (n, s) and torch.equal(got, expect)
    assert torch.equal(got[:, -1], torch.full((n,), 1e10))
    assert tmaha.MIN_SCORE_INIT == tgmm.MIN_SCORE_INIT


def test_max_dim_is_the_pallas_lane_limit():
    """The wrapper takes every dim the JAX package's mahalanobis_scores takes."""
    assert tmaha.MAX_DIM == jmaha.LANES == 128


def test_min_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((33, 25), (72, 25), (72, 25), (72,))]
    before = tmaha.mahalanobis_min_scores.LAUNCHES
    assert torch.equal(tmaha.mahalanobis_min_scores(*args, 8),
                       tmaha.mahalanobis_min_scores_reference(*args, 8))
    assert tmaha.mahalanobis_min_scores.LAUNCHES == before


def test_min_wrapper_checks_the_mixture_layout():
    """J must be S·D; other devices are refused."""
    args = [torch.zeros(s) for s in ((4, 25), (10, 25), (10, 25), (10,))]
    for D in (0, 3, 4):
        with pytest.raises(ValueError, match="S·D"):
            tmaha.mahalanobis_min_scores(*args, D)
    meta = [torch.empty(s, device="meta") for s in ((4, 25), (8, 25), (8, 25), (8,))]
    with pytest.raises(ValueError, match="unsupported device"):
        tmaha.mahalanobis_min_scores(*meta, 4)
