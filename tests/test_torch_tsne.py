"""The port's t-SNE (speechrecognition_torch/tools/tsne.py) against the JAX
package's, on the CPU.

The perplexity search is the same numpy code in both packages: bit-equal.
The gradient loop runs in float64 in both, and XLA and torch round its sums
differently in the last bits. From a spread-out start, 100 steps agree
within 1e-9 of the embedding's scale; from t-SNE's own start (points within
1e-4 of each other, exaggerated affinities) the first 10 steps agree within
1e-12, but that phase multiplies a difference about tenfold every three
steps (6e-16 after one step, 1e-4 after 50, measured on this input) and
settles in one of several local optima (costs KL(P‖Q) from 1.79 to 2.64
on this input when X moves by 1e-12). So the whole 100-iteration embedding
is held to JAX's by what it shows: in both, every point's nearest neighbour
lies in its own cluster.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.config as jcfg
import speechrecognition_tpu.models.nn as jnn
import speechrecognition_tpu.tools.tsne as jtsne

import speechrecognition_torch.config as tcfg
import speechrecognition_torch.models.nn as tnn
import speechrecognition_torch.tools.tsne as ttsne

torch.set_num_threads(1)

SPREAD_RTOL = 1e-9
EARLY_RTOL = 1e-12


def clusters(n=60, d=10, seed=0):
    """Three well-separated Gaussian clusters of activations."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4.0, (3, d))
    return centers[np.arange(n) % 3] + rng.normal(0, 1.0, (n, d))


def affinities(X, perplexity=15.0):
    """tsne's symmetric P."""
    X = X - X.mean(axis=0)
    sq = (X * X).sum(axis=1)
    D = np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0)
    P = jtsne.binary_search_perplexity(D, perplexity)
    return (P + P.T) / P.sum()


def nearest_cluster(Y):
    d = ((Y[:, None] - Y[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    return (np.arange(len(Y)) % 3)[d.argmin(axis=1)]


def test_binary_search_perplexity_bit_equal():
    X = clusters()
    sq = (X * X).sum(axis=1)
    D = np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0)
    for perplexity in (5.0, 30.0):
        got = ttsne.binary_search_perplexity(D, perplexity)
        np.testing.assert_array_equal(got, jtsne.binary_search_perplexity(D, perplexity))
        np.testing.assert_allclose(got.sum(axis=1), 1.0)


@pytest.mark.parametrize("start", ["spread", "early"])
def test_tsne_steps_equal_jax(start):
    X = clusters()
    P = affinities(X)
    if start == "spread":       # JAX's own embedding; plain P; 100 steps
        Y0, n, rtol = jtsne.tsne(X, perplexity=15.0, n_iter=100, seed=3), 100, SPREAD_RTOL
    else:                       # tsne's start; exaggerated P; 10 steps
        Y0, n, rtol = np.random.default_rng(3).normal(0, 1e-4, (60, 2)), 10, EARLY_RTOL
        P = 4.0 * P
    ref = np.asarray(jtsne._tsne_optimize(jnp.asarray(P), jnp.asarray(Y0), n_iter=n))
    got = ttsne._tsne_optimize(torch.tensor(P), torch.tensor(Y0), n_iter=n).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


def test_tsne_equals_jax():
    X = clusters()
    got = ttsne.tsne(X, perplexity=15.0, n_iter=100, seed=3, device="cpu")
    ref = jtsne.tsne(X, perplexity=15.0, n_iter=100, seed=3)
    assert got.shape == (60, 2) and got.dtype == np.float64 and np.isfinite(got).all()
    truth = np.arange(60) % 3
    np.testing.assert_array_equal(nearest_cluster(got), truth)
    np.testing.assert_array_equal(nearest_cluster(ref), truth)


def test_dump_activations_equals_jax(tmp_path):
    layers = {"layers": [
        {"layer-name": "hidden-layer1", "num-outputs": 20, "type": "feed-forward",
         "nonlinearity": "sigmoid", "input": ["data"]},
        {"layer-name": "output-layer", "num-outputs": 106, "type": "output",
         "input": ["hidden-layer1"]}]}
    j = jnn.MLP(jnn.layer_specs_from_config(jcfg.Configuration(layers)), input_dim=75)
    t = tnn.MLP(tnn.layer_specs_from_config(tcfg.Configuration(layers)), input_dim=75,
                device="cpu")
    jp, tp = j.init_params(np.random.default_rng(0)), t.init_params(np.random.default_rng(0))
    feats = np.random.default_rng(1).normal(size=(50, 75)).astype(np.float32)
    names = ["hidden-layer1", "output-layer"]
    jtsne.dump_activations(j, jp, feats, names, str(tmp_path / "jax"))
    ttsne.dump_activations(t, tp, feats, names, str(tmp_path / "port"))
    for name, width in zip(names, (20, 106)):
        got = np.fromfile(tmp_path / "port" / f"{name}.activations", np.float32)
        ref = np.fromfile(tmp_path / "jax" / f"{name}.activations", np.float32)
        assert got.size == 50 * width
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_tsne_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttsne.tsne(clusters(n=9), perplexity=2.0, n_iter=2)
