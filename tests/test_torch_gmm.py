"""Port am_scores against the JAX package's am_scores.

Tolerances (relative, |Δ|/(1+|ref|)):
  * "pallas" pack ≤ 1e-6: the same centered f32 sums in another FMA and
    operation order (see test_torch_mahalanobis.py);
  * "mxu" f32 pack ≤ 1e-5: the [x², x, 1]·P expansion cancels terms of
    ~1e3 down to scores of ~1e1, so two f32 BLAS summation orders differ
    by a few ulps of the large terms;
  * float64 "mxu" pack ≤ 1e-12: the same expansion in double precision.
"""

from pathlib import Path

import inspect

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
from speechrecognition_torch.convert import (mixture_model_from_jax, score_pack_df_from_jax,
                                             score_pack_from_jax)

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
MODELS = {"iter-2": (FIX / "iter-2.mix", "MIXTURE_POOLING"),
          "bench": (REPO / "bench" / "model.mix", "NO_POOLING")}
TOL = {("pallas", "float32"): 1e-6, ("mxu", "float32"): 1e-5,
       ("mxu", "float64"): 1e-12}


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref) / (1.0 + np.abs(ref))


@pytest.fixture(scope="module")
def demo_feats():
    lex = tlex.build_sietill_lexicon()
    desc = tcorpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = tcorpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                 tfront.SignalAnalysisConfig(),
                                 normalization_path=str(FIX / "normalization-demo.bin"))
    return corpus.features


def load_models(name, max_approx=True):
    path, pooling = MODELS[name]
    j = jgmm.MixtureModel.from_raw(jio.read_mixture_set(str(path), 25),
                                   jgmm.VarianceModel[pooling], max_approx=max_approx)
    t = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(path), 25),
                                   tgmm.VarianceModel[pooling], max_approx=max_approx)
    return j, t


@pytest.mark.parametrize("method,dtype", sorted(TOL))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_am_scores_match_jax(name, method, dtype, demo_feats):
    j, t = load_models(name)
    feats = demo_feats[:2048]
    jpack = j.pack(dtype=getattr(jnp, dtype), method=method)
    tpack = t.pack(dtype=getattr(torch, dtype), method=method, device="cpu")
    ref = np.asarray(jgmm.am_scores(jpack, jnp.asarray(feats)))
    got = tgmm.am_scores(tpack, torch.from_numpy(feats))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2048, 106)
    assert rel_err(got.numpy(), ref).max() <= TOL[(method, dtype)]


def test_am_scores_chunking(demo_feats):
    """N > AM_CHUNK: frames are scored in chunks of AM_CHUNK."""
    j, t = load_models("iter-2")
    n = tgmm.AM_CHUNK + 1000
    feats = np.resize(demo_feats, (n, 25))
    ref = np.asarray(jgmm.am_scores(j.pack(method="pallas"), jnp.asarray(feats)))
    got = tgmm.am_scores(t.pack(method="pallas", device="cpu"), torch.from_numpy(feats)).numpy()
    assert got.shape == (n, 106)
    assert rel_err(got, ref).max() <= TOL[("pallas", "float32")]
    # chunked scoring equals scoring the tail alone
    tail = tgmm.am_scores(t.pack(method="pallas", device="cpu"),
                          torch.from_numpy(feats[tgmm.AM_CHUNK:])).numpy()
    np.testing.assert_array_equal(got[tgmm.AM_CHUNK:], tail)


def test_am_scores_sum_mode(demo_feats):
    """The −log Σ exp(−score) mixture branch (max_approx=False)."""
    j, t = load_models("iter-2", max_approx=False)
    feats = demo_feats[:512]
    ref = np.asarray(jgmm.am_scores(j.pack(method="pallas"), jnp.asarray(feats)))
    got = tgmm.am_scores(t.pack(method="pallas", device="cpu"), torch.from_numpy(feats)).numpy()
    assert rel_err(got, ref).max() <= TOL[("pallas", "float32")]


@pytest.mark.parametrize("method", ["pallas", "mxu"])
def test_convert_round_trip(method, demo_feats):
    """A JAX pack carried across scores exactly like the port's own pack,
    and a carried model packs to the same tables."""
    j, t = load_models("bench")
    feats = torch.from_numpy(demo_feats[:1024])
    jpack = j.pack(method=method)
    own = t.pack(method=method, device="cpu")
    carried = score_pack_from_jax(jpack, device="cpu")
    assert carried.dtype == torch.float32 and carried.method == method
    assert torch.equal(tgmm.am_scores(carried, feats), tgmm.am_scores(own, feats))
    repacked = mixture_model_from_jax(j).pack(method=method, device="cpu")
    for field in ("P", "active", "mu", "a", "c"):
        x, y = getattr(repacked, field), getattr(own, field)
        assert (x is None and y is None) or torch.equal(x, y), field


def test_pack_rejects_unknown_method():
    _j, t = load_models("iter-2")
    with pytest.raises(ValueError, match="unknown scoring method"):
        t.pack(method="dense", device="cpu")


@pytest.mark.parametrize("fn", ["pack", "pack_df", "score_pack_from_jax",
                                "score_pack_df_from_jax"])
def test_packs_default_to_the_card(fn, monkeypatch):
    """The four pack builders default to device="cuda"; with no CUDA device
    they raise rather than fall back to the CPU, and an explicit
    device="cpu" gives CPU tables equal to the JAX package's."""
    j, t = load_models("iter-2")
    is_df = "df" in fn
    jpack = j.pack_df() if is_df else j.pack(method="pallas")
    target, build = {
        "pack": (tgmm.MixtureModel.pack, lambda **kw: t.pack(method="pallas", **kw)),
        "pack_df": (tgmm.MixtureModel.pack_df, lambda **kw: t.pack_df(**kw)),
        "score_pack_from_jax": (score_pack_from_jax,
                                lambda **kw: score_pack_from_jax(jpack, **kw)),
        "score_pack_df_from_jax": (score_pack_df_from_jax,
                                   lambda **kw: score_pack_df_from_jax(jpack, **kw)),
    }[fn]
    assert inspect.signature(target).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    pack = build(device="cpu")
    if is_df:
        fields = {f"{k}.{w}": (getattr(getattr(pack, k), w), getattr(getattr(jpack, k), w))
                  for k in ("mu", "iv", "norm", "logw") for w in ("hi", "lo")}
    else:
        fields = {k: (getattr(pack, k), getattr(jpack, k)) for k in ("P", "mu", "a", "c")}
    fields["active"] = (pack.active, jpack.active)
    for name, (got, want) in fields.items():
        assert got.device.type == "cpu", name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
