"""The port's int8 quantized scorer (speechrecognition_torch/models/
quantized.py) against the JAX package's on the same models and features.

``build_quant_pack`` gives JAX's arrays (means, squares, constants, scale,
activity, and with preselection the k-means centers and cluster map), and
``convert.quant_pack_from_jax`` carries JAX's pack into the port unchanged;
the plain version of kernel O and its parts (``quantize_features``,
``quantized_distances``, ``_select_mask``, ``am_scores_q``) are bit-equal to
JAX's: on the committed AN4 model (bench/an4/am.mix: 501 mixtures, 4,623
densities padded to 16, dim 45) with 64 frames near its means, and with
preselection on small synthetic pooled models (the AN4-size k-means costs
about 740 MB a Lloyd iteration on the host; chip_smoke.py builds it), with
a select-all case and ties at the selection threshold.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu import io as jio
from speechrecognition_tpu.models import gmm as jgmm
from speechrecognition_tpu.models import quantized as jq

from speechrecognition_torch import convert
from speechrecognition_torch.io import read_mixture_set
from speechrecognition_torch.models import gmm as tgmm
from speechrecognition_torch.models import quantized as tq
from torch_linear_tables import pooled_model, pooled_raw

torch.set_num_threads(1)

AN4_MIX = "bench/an4/am.mix"
AN4_DIM = 45
PACK_ARRAYS = ("qmeans", "qmeans_sq", "consts", "inv_sqrt_var", "active", "qcenters",
               "qcenters_sq", "cluster_of")


def jax_model(raw):
    jraw = jio.RawMixtureSet(**{k: getattr(raw, k) for k in (
        "dim", "mean_acc", "mean_weight", "var_acc", "var_weight", "densities", "mixtures")})
    return jgmm.MixtureModel.from_raw(jraw, jgmm.VarianceModel.GLOBAL_POOLING, max_approx=True)


@pytest.fixture(scope="module")
def an4():
    raw = read_mixture_set(AN4_MIX, AN4_DIM)
    model = tgmm.MixtureModel.from_raw(raw, tgmm.VarianceModel.GLOBAL_POOLING, max_approx=True)
    jm = jax_model(raw)
    rng = np.random.RandomState(0)
    mi = rng.randint(0, model.means.shape[0], 64)
    x = (model.means[mi] + rng.randn(64, AN4_DIM) * np.sqrt(model.vars[0]) * 0.5)
    x = np.nan_to_num(x).astype(np.float32)
    return model, jm, jq.build_quant_pack(jm), x


def synthetic(seed, S=40, D=6, dim=13, empty=0.1):
    raw = pooled_raw(np.random.default_rng(seed), S, D, dim, empty_share=empty)
    return pooled_model(raw), jax_model(raw)


def frames(model, n, seed, spread=2.0):
    rng = np.random.default_rng(seed)
    mi = rng.integers(0, model.means.shape[0], n)
    x = model.means[mi] + rng.standard_normal((n, model.dim)) * np.sqrt(model.vars[0]) * spread
    return np.nan_to_num(x).astype(np.float32)


def assert_pack_equal(jp, tp):
    for name in PACK_ARRAYS:
        a, b = getattr(jp, name), getattr(tp, name)
        if a is None:
            assert b is None, name
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("scale2x", "num_mixtures", "density_cap", "dim", "n_selected", "backoff"):
        assert getattr(jp, name) == getattr(tp, name), name


def assert_scores_equal(jp, tp, x):
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    jqx, tqx = jq.quantize_features(jp, jx), tq.quantize_features(tp, tx)
    np.testing.assert_array_equal(np.asarray(jqx), tqx.numpy())
    jd, td = np.asarray(jq.quantized_distances(jp, jqx)), tq.quantized_distances(tp, tqx).numpy()
    assert jd.dtype == td.dtype == np.int32
    np.testing.assert_array_equal(jd, td)
    if jp.qcenters is not None:
        np.testing.assert_array_equal(np.asarray(jq._select_mask(jp, jqx)),
                                      tq._select_mask(tp, tqx).numpy())
    js, ts = np.asarray(jq.am_scores_q(jp, jx)), tq.am_scores_q(tp, tx).numpy()
    assert js.dtype == ts.dtype == np.float32
    np.testing.assert_array_equal(js, ts)
    return ts


def test_an4_pack_equals_jax(an4):
    model, _jm, jp, _x = an4
    tp = tq.build_quant_pack(model, device="cpu")
    assert_pack_equal(jp, tp)
    assert (tp.num_mixtures, tp.density_cap, tp.dim) == (501, 16, 45)


def test_an4_pack_from_jax_equals_port(an4):
    model, _jm, jp, x = an4
    carried = convert.quant_pack_from_jax(jp, device="cpu")
    built = tq.build_quant_pack(model, device="cpu")
    assert_pack_equal(jp, carried)
    for name in PACK_ARRAYS[:5]:
        assert torch.equal(getattr(carried, name), getattr(built, name)), name
    assert torch.equal(tq.am_scores_q(carried, torch.as_tensor(x)),
                       tq.am_scores_q(built, torch.as_tensor(x)))


def test_an4_scores_bit_equal(an4):
    model, _jm, jp, x = an4
    tp = tq.build_quant_pack(model, device="cpu")
    scores = assert_scores_equal(jp, tp, x)
    assert scores.shape == (64, 501) and np.isfinite(scores).all()


def test_an4_integers_match_the_reference_formula(an4):
    """The port's distances are Σ (qx − qm)² in int64 (the reference's
    definition), on every density."""
    model, _jm, _jp, x = an4
    tp = tq.build_quant_pack(model, device="cpu")
    qx = tq.quantize_features(tp, torch.as_tensor(x))
    d = tq.quantized_distances(tp, qx).numpy().astype(np.int64)
    qx64, qm = qx.numpy().astype(np.int64), tp.qmeans.numpy().astype(np.int64)
    want = ((qx64[:, None, :] - qm[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(d, want)


def test_an4_chunked_equals_unchunked(an4):
    """Chunks score row for row as one call, and as JAX's am_scores_q run op
    by op. (JAX's am_scores_q_chunked, under lax.map, and any jit of
    am_scores_q let XLA turn the division by 2·scale² into a multiply by
    its reciprocal, an ulp off the quotient on about 40 % of the AN4
    scores; the port divides, as the op-by-op function and the reference's
    fillScoreCacheTpl do.)"""
    model, _jm, jp, x = an4
    tp = tq.build_quant_pack(model, device="cpu")
    xx = np.concatenate([x, x[::-1], x[:7]])
    got = tq.am_scores_q_chunked(tp, torch.as_tensor(xx), chunk=50)
    np.testing.assert_array_equal(got.numpy(), tq.am_scores_q(tp, torch.as_tensor(xx)).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jq.am_scores_q(jp, jnp.asarray(xx))))



@pytest.mark.parametrize("preselection", [False, True])
def test_non_finite_and_half_way_frames_bit_equal(preselection):
    """Frames that are NaN (an inactive density's mean, drawn without
    nan_to_num), ±inf, or land half way between two integers quantize as
    JAX's do: NaN to 0, ±inf to ±127/-128, halves to even; the scores
    agree bit for bit."""
    model, jm = synthetic(4, empty=0.3)
    assert np.isnan(model.means).any()
    kw = dict(preselection=True, num_clusters=8, n_selected=2) if preselection else {}
    jp = jq.build_quant_pack(jm, **kw)
    tp = tq.build_quant_pack(model, device="cpu", **kw)
    rng = np.random.default_rng(8)
    x = (model.means[rng.integers(0, model.means.shape[0], 40)]
         + rng.standard_normal((40, model.dim)) * np.sqrt(model.vars[0])).astype(np.float32)
    x[3, 2], x[5, :] = np.inf, -np.inf
    x[7, 0] = np.nan
    half = (np.arange(model.dim) - 6.5) / tp.inv_sqrt_var.numpy()
    x[9] = half.astype(np.float32)
    qx = tq.quantize_features(tp, torch.as_tensor(x)).numpy()
    assert np.isnan(x).any(axis=1).sum() > 1 and (qx[np.isnan(x)] == 0).all()
    assert (qx[3, 2], qx[5, 0]) == (127, -128)
    assert_scores_equal(jp, tp, x)

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("clusters,selected", [(16, 4), (8, 1), (24, 24)])
def test_preselection_bit_equal(seed, clusters, selected):
    """k-means centers and cluster map, the selection mask (ties at the
    n_selected-th distance admit every tied cluster), the backoff cells;
    (24, 24) selects every cluster."""
    model, jm = synthetic(seed)
    jp = jq.build_quant_pack(jm, preselection=True, num_clusters=clusters, n_selected=selected)
    tp = tq.build_quant_pack(model, preselection=True, num_clusters=clusters,
                             n_selected=selected, device="cpu")
    assert_pack_equal(jp, tp)
    scores = assert_scores_equal(jp, tp, frames(model, 96, seed + 10))
    backoff = scores == np.float32(tq.BACKOFF_SCORE)
    if selected < clusters:
        assert backoff.any()
    carried = convert.quant_pack_from_jax(jp, device="cpu")
    assert_pack_equal(jp, carried)


def test_preselection_ties_at_the_threshold():
    """Means drawn from a palette of 5 vectors give the 12 k-means centers
    duplicates, so every frame ties distances at its n_selected-th: the
    port admits the same superset of clusters as JAX's top_k threshold."""
    raw = pooled_raw(np.random.default_rng(5), 30, 4, 6, palette=5)
    model, jm = pooled_model(raw), jax_model(raw)
    jp = jq.build_quant_pack(jm, preselection=True, num_clusters=12, n_selected=3)
    tp = tq.build_quant_pack(model, preselection=True, num_clusters=12, n_selected=3,
                             device="cpu")
    assert_pack_equal(jp, tp)
    x = frames(model, 48, 9, spread=0.3)
    tqx = tq.quantize_features(tp, torch.as_tensor(x))
    cd = (tq._sq_norms(tqx)[:, None] - 2 * tq._int_products(tqx, tp.qcenters)
          + tp.qcenters_sq[None, :])
    kth = torch.topk(cd, 3, dim=1, largest=False).values[:, -1]
    assert ((cd <= kth[:, None]).sum(1) > 3).any()        # ties admit extra clusters
    assert_scores_equal(jp, tp, x)


def test_select_all_is_no_preselection():
    """n_selected == clusters: every density is scored, so the scores equal
    the pack without preselection wherever a mixture has an active
    density."""
    model, _jm = synthetic(7, empty=0.5)
    x = torch.as_tensor(frames(model, 64, 3))
    qp = tq.build_quant_pack(model, device="cpu")
    plain = tq.am_scores_q(qp, x)
    every = tq.am_scores_q(tq.build_quant_pack(model, preselection=True, num_clusters=16,
                                               n_selected=16, device="cpu"), x)
    live = plain < float(tq.INACTIVE_INT) / qp.scale2x * 0.5
    assert live.any() and not live.all()
    assert torch.equal(plain[live], every[live])
    assert (every[~live] == tq.BACKOFF_SCORE).all()


def test_rejects_a_pack_that_is_not_pooled():
    raw = read_mixture_set("tests/fixtures/iter-2.mix", 25)
    model = tgmm.MixtureModel.from_raw(raw, tgmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    with pytest.raises(ValueError, match="globally pooled"):
        tq.build_quant_pack(model, device="cpu")


def test_the_card_is_the_default(monkeypatch):
    """Without a card the pack is not built unless the caller asks for the
    CPU (nothing falls back)."""
    model, _jm = synthetic(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.build_quant_pack(model)
    with pytest.raises(ValueError, match="one CUDA device"):
        tq.am_scores_q_cuda(tq.build_quant_pack(model, device="cpu"),
                            torch.zeros((2, model.dim)))


def test_kernel_tables_reject_bad_packs():
    """Kernel O's operands are checked once a pack: a cluster id past the
    centers or tables of another shape raise before any launch; a good
    pack's means are zero-padded to 16 bytes (dim 13) for the first design,
    and to 64 bytes and D 6 to 8 densities a mixture for the tensor-core
    design."""
    model, _jm = synthetic(2)
    good = tq.build_quant_pack(model, preselection=True, num_clusters=8, n_selected=2,
                               device="cpu")
    kt = tq._kernel_tables(good, first_design=True)
    assert kt["qmeans"].shape == (good.qmeans.shape[0], 4) and kt["row_bytes"] == 16
    padded = kt["qmeans"].view(torch.int8)
    assert torch.equal(padded[:, :13], good.qmeans) and not padded[:, 13:].any()
    kt = tq._kernel_tables(good)
    S = good.num_mixtures
    assert kt["qmeans"].shape == (S * 8, 16) and kt["row_bytes"] == 64
    padded = kt["qmeans"].view(torch.int8).reshape(S, 8, 64)
    assert torch.equal(padded[:, :6, :13].reshape(S * 6, 13), good.qmeans)
    assert not padded[:, 6:].any() and not padded[:, :, 13:].any()
    bad = tq.build_quant_pack(model, preselection=True, num_clusters=8, n_selected=2,
                              device="cpu")
    bad.cluster_of = bad.cluster_of.clone()
    bad.cluster_of[3] = 8
    with pytest.raises(ValueError, match="cluster_of"):
        tq._kernel_tables(bad)
    short = tq.build_quant_pack(model, device="cpu")
    short.consts = short.consts[:-1]
    with pytest.raises(ValueError, match="shapes"):
        tq._kernel_tables(short)
