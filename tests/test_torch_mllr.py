"""The port's MLLR adaptation against the JAX package's, on the CPU.

tests/test_mllr.py's synthetic set-up (six states around random centres,
one EM pass), split once so that the Viterbi density selection chooses
between two densities a mixture; the JAX model carried across with
``convert.mixture_model_from_jax``. The port's RegressionTree takes the
JAX tree's four arrays as they are. Against JAX, in float64: the trees, the
selected densities (equal), the full and shift estimators' transforms and
node counts (with weights, a starved leaf backing off to the root, a
starved root giving the identity) and ``adapt_model``'s means in both
modes, within 1e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.models.gmm as jgmm
import speechrecognition_tpu.train.mllr as jmllr

import speechrecognition_torch.models.gmm as tgmm
import speechrecognition_torch.train.mllr as tmllr
from speechrecognition_torch import convert

torch.set_num_threads(1)

S, DIM = 6, 4


@pytest.fixture(scope="module")
def setup():
    """Both models, and adaptation data around the means shifted by an
    affine map: feats, states, weights."""
    rng = np.random.default_rng(0)
    jm = jgmm.MixtureModel(DIM, S, jgmm.VarianceModel.NO_POOLING, max_approx=True)
    centers = rng.normal(0, 4, (S, DIM))
    feats = np.concatenate([centers[s] + rng.normal(0, 0.5, (400, DIM)) for s in range(S)])
    states = np.repeat(np.arange(S), 400).astype(np.int32)
    w, xs, x2s = jgmm.accumulate_chunk(jm.pack(dtype=jnp.float64), jnp.asarray(feats),
                                       jnp.asarray(states), jnp.ones(len(feats)), True)
    jm.apply_statistics(np.asarray(w), np.asarray(xs), np.asarray(x2s))
    jm.finalize()
    jm.split(1.0)
    w, xs, x2s = jgmm.accumulate_chunk(jm.pack(dtype=jnp.float64), jnp.asarray(feats),
                                       jnp.asarray(states), jnp.ones(len(feats)), False)
    jm.apply_statistics(np.asarray(w), np.asarray(xs), np.asarray(x2s))
    jm.finalize()
    tm = convert.mixture_model_from_jax(jm)
    A = np.eye(DIM) * 0.8
    A[0, 1] = 0.3
    b = np.array([0.5, -1.0, 0.25, 2.0])
    adapt = np.concatenate([jm.means[jm.mixtures[s][d][0]] @ A.T + b
                            + rng.normal(0, 0.3, (150, DIM))
                            for s in range(S) for d in range(2)])
    adapt_states = np.repeat(np.arange(S), 300).astype(np.int32)
    weights = rng.uniform(0.2, 1.0, len(adapt))
    return jm, tm, adapt, adapt_states, weights


def trees():
    """(port tree, JAX tree) pairs: one class, two leaves, five leaves."""
    maps = {1: np.zeros(S, np.int64), 2: np.array([0, 0, 0, 1, 1, 1]),
            5: np.array([0, 1, 2, 3, 4, 4])}
    out = []
    for n, m in maps.items():
        jt = jmllr.RegressionTree.balanced(n, m)
        out.append((tmllr.RegressionTree(jt.parent, jt.children, jt.leaves, jt.leaf_of_mixture),
                    jt))
    return out


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9, atol=1e-9)


def test_trees_equal_jax():
    for n in (1, 2, 3, 5):
        m = np.arange(S) % n
        t, j = tmllr.RegressionTree.balanced(n, m), jmllr.RegressionTree.balanced(n, m)
        for name in ("parent", "children", "leaves", "leaf_of_mixture"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        np.testing.assert_array_equal(t.descendants_matrix(), j.descendants_matrix())
    t = tmllr.RegressionTree.single_class(S)
    assert t.num_nodes == 1 and t.num_leaves == 1


def test_viterbi_density_means_equal_jax(setup):
    jm, tm, feats, states, _w = setup
    got = tmllr.viterbi_density_means(tm, tm.pack(dtype=torch.float64, device="cpu"), feats,
                                      states)
    want = jmllr.viterbi_density_means(jm, jm.pack(dtype=jnp.float64), feats, states)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # both densities of a mixture are chosen somewhere
    assert len({tuple(r) for r in got[0]}) > S


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["full", "shift"])
def test_estimators_equal_jax(setup, mode, weighted):
    jm, tm, feats, states, weights = setup
    means, variances = tmllr.viterbi_density_means(
        tm, tm.pack(dtype=torch.float64, device="cpu"), feats, states)
    w = weights if weighted else None
    for t, j in trees():
        for min_obs in (100.0, 400.0, 1e9):
            if mode == "full":
                est, jest = (tmllr.FullMllrEstimator(t, DIM, min_obs),
                             jmllr.FullMllrEstimator(j, DIM, min_obs))
                est.accumulate(feats, states, means, w)
                jest.accumulate(feats, states, means, w)
            else:
                est, jest = (tmllr.ShiftMllrEstimator(t, DIM, min_obs),
                             jmllr.ShiftMllrEstimator(j, DIM, min_obs))
                est.accumulate(feats, states, means, variances, w)
                jest.accumulate(feats, states, means, variances, w)
            per_leaf, counts = est.estimate()
            jper_leaf, jcounts = jest.estimate()
            np.testing.assert_array_equal(counts, jcounts)
            assert sorted(per_leaf) == sorted(jper_leaf)
            for leaf in per_leaf:
                close(per_leaf[leaf], jper_leaf[leaf])
            if min_obs == 1e9:   # a starved root: identity / no shift
                ident = (np.concatenate([np.zeros((DIM, 1)), np.eye(DIM)], axis=1)
                         if mode == "full" else np.zeros(DIM))
                for leaf in per_leaf:
                    np.testing.assert_array_equal(per_leaf[leaf], ident)


@pytest.mark.parametrize("mode", ["full", "shift"])
def test_adapt_model_equals_jax(setup, mode):
    jm, tm, feats, states, weights = setup
    pack = tm.pack(dtype=torch.float64, device="cpu")
    t, j = trees()[1]
    before = tm.means.copy()
    got = tmllr.adapt_model(tm, pack, feats, states, t, mode=mode, min_observations=100,
                            weights=weights)
    want = jmllr.adapt_model(jm, jm.pack(dtype=jnp.float64), feats, states, j, mode=mode,
                             min_observations=100, weights=weights)
    close(got.means, want.means)
    np.testing.assert_array_equal(tm.means, before)      # the original is untouched

    def score(m):
        am = tgmm.am_scores(m.pack(dtype=torch.float64, device="cpu"),
                            torch.as_tensor(feats)).numpy()
        return float(am[np.arange(len(states)), states].mean())

    assert score(got) < score(tm) - 1.0


def test_unknown_mode_raises(setup):
    _jm, tm, feats, states, _w = setup
    with pytest.raises(ValueError, match="unknown mode"):
        tmllr.adapt_model(tm, tm.pack(dtype=torch.float64, device="cpu"), feats, states,
                          mode="affine")
