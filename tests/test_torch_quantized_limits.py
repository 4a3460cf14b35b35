"""The port's int8 quantized scorer past kernel O's first design's limits:
feature dims past 128 and more than 256 clusters, which JAX's
``am_scores_q`` and ``build_quant_pack(num_clusters=...)`` take.

The JAX package builds each pack from a seeded pooled model
(tests/torch_linear_tables.py's ``pooled_raw``) and
``convert.quant_pack_from_jax`` carries it into the port unchanged; the
port's plain ``am_scores_q`` (and its parts) then equal JAX's op-by-op
``am_scores_q`` bit for bit:

* at dims 129, 200 and 256, with and without preselection;
* at 257, 512 and 1,000 clusters: some selected, ties at the threshold
  (means from a palette of 5 vectors, so the centers repeat), and every
  cluster selected.

``_kernel_tables`` builds the tensor-core design's padded words for these
shapes (a dim past 128 in 256-byte rows, D rounded up to 8 densities, the
centers to 8 rows) and refuses the first design for them; the shapes that
stay invalid raise.
"""

import numpy as np
import pytest
import torch

from speechrecognition_tpu.models import quantized as jq

from speechrecognition_torch import convert
from speechrecognition_torch.models import quantized as tq
from test_torch_quantized import assert_scores_equal, frames, jax_model
from torch_linear_tables import pooled_model, pooled_raw

torch.set_num_threads(1)


def packs(seed, S, D, dim, empty=0.1, palette=0, **kw):
    """(port model, JAX pack, the port's pack carried from it)."""
    raw = pooled_raw(np.random.default_rng(seed), S, D, dim, empty_share=empty, palette=palette)
    model = pooled_model(raw)
    jp = jq.build_quant_pack(jax_model(raw), **kw)
    return model, jp, convert.quant_pack_from_jax(jp, device="cpu")


@pytest.mark.parametrize("preselection", [False, True])
@pytest.mark.parametrize("dim", [129, 200, 256])
def test_dims_past_128_bit_equal(dim, preselection):
    kw = dict(preselection=True, num_clusters=16, n_selected=4) if preselection else {}
    model, jp, tp = packs(dim, 30, 6, dim, **kw)
    assert tp.dim == dim and (tp.qcenters is not None) == preselection
    scores = assert_scores_equal(jp, tp, frames(model, 48, dim + 1))
    assert scores.shape == (48, 30) and np.isfinite(scores).all()


@pytest.mark.parametrize("case", ["some", "ties", "all"])
@pytest.mark.parametrize("clusters", [257, 512, 1000])
def test_clusters_past_256_bit_equal(clusters, case):
    """400 mixtures of up to 6 densities (about 1,260 live) in dim 8, so
    every cluster count is below the live densities; ``ties`` draws the
    means from 5 vectors, so centers repeat and tie at the n_selected-th
    distance; ``all`` selects every cluster, so only a mixture without an
    active density reads the backoff score."""
    selected = {"some": clusters // 8, "ties": 3, "all": clusters}[case]
    model, jp, tp = packs(clusters, 400, 6, 8, empty=0.05, palette=5 if case == "ties" else 0,
                          preselection=True, num_clusters=clusters, n_selected=selected)
    assert tp.qcenters.shape == (clusters, 8) and tp.n_selected == selected
    x = frames(model, 40, clusters + 3, spread=0.3 if case == "ties" else 2.0)
    if case == "ties":
        qx = tq.quantize_features(tp, torch.as_tensor(x))
        cd = (tq._sq_norms(qx)[:, None] - 2 * tq._int_products(qx, tp.qcenters)
              + tp.qcenters_sq[None, :])
        kth = torch.topk(cd, selected, dim=1, largest=False).values[:, -1]
        assert ((cd <= kth[:, None]).sum(1) > selected).all()   # every frame ties
    scores = assert_scores_equal(jp, tp, x)
    backoff = scores == np.float32(tq.BACKOFF_SCORE)
    live = tp.active.numpy().any(axis=1)            # mixtures with an active density
    assert not backoff[:, live].all() and (case != "all" or not backoff[:, live].any())


@pytest.mark.parametrize("dim,clusters", [(129, 0), (200, 257), (256, 300)])
def test_kernel_tables_past_the_first_design(dim, clusters):
    """The tensor-core design's operands: 256-byte rows (the bytes past dim
    zero), D 6 padded to 8 densities a mixture (the padding's tables 0), the
    centers padded to a multiple of 8 rows; the first design refuses the
    shape."""
    S = 200 if clusters else 30
    kw = dict(preselection=True, num_clusters=clusters, n_selected=32) if clusters else {}
    _model, _jp, tp = packs(dim, S, 6, dim, empty=0.05, **kw)
    assert tp.density_cap == 6 and tq.kernel_row_bytes(dim) == 256
    kt = tq._kernel_tables(tp)
    assert kt["row_bytes"] == 256 and kt["qmeans"].dtype == torch.int32
    means = kt["qmeans"].view(torch.int8).reshape(S, 8, 256)
    assert torch.equal(means[:, :6, :dim].reshape(S * 6, dim), tp.qmeans)
    assert not means[:, 6:].any() and not means[:, :, dim:].any()
    for name in ("qmeans_sq", "consts"):
        padded = kt[name].reshape(S, 8)
        assert torch.equal(padded[:, :6].reshape(-1), getattr(tp, name))
        assert not padded[:, 6:].any()
    if clusters:
        C8 = -(-clusters // 8) * 8
        centers = kt["qcenters"].view(torch.int8)
        assert centers.shape == (C8, 256) and torch.equal(centers[:clusters, :dim], tp.qcenters)
        assert not centers[clusters:].any() and not centers[:, dim:].any()
        assert torch.equal(kt["qcenters_sq"][:clusters], tp.qcenters_sq)
        assert torch.equal(kt["cluster_of"].reshape(S, 8)[:, :6].reshape(-1), tp.cluster_of)
    with pytest.raises(ValueError, match="first design"):
        tq._kernel_tables(tp, first_design=True)


def test_kernel_tables_reject_invalid_shapes():
    """What stays invalid raises before any launch: no densities, a
    selection of 0 or of more clusters than there are, a cluster id past
    the centers, centers of another width."""
    def fresh():
        return packs(7, 40, 6, 150, preselection=True, num_clusters=300,
                     n_selected=8)[2]

    for change, match in ((lambda p: setattr(p, "density_cap", 0), "densities"),
                          (lambda p: setattr(p, "n_selected", 0), "selected"),
                          (lambda p: setattr(p, "n_selected", 301), "selected"),
                          (lambda p: p.cluster_of.__setitem__(5, 300), "cluster_of"),
                          (lambda p: setattr(p, "qcenters", p.qcenters[:, :-1]), "preselection")):
        tp = fresh()
        change(tp)
        with pytest.raises(ValueError, match=match):
            tq._kernel_tables(tp)
