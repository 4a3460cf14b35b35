"""The port's batched feature front end (speechrecognition_torch/features/
frontend.py::extract_features_batch) against the JAX package's
``extract_features_batch_jax`` and against the numpy ``extract_features``.

Inputs are synthetic int16 batches made from a numpy seed: B 4, a few
thousand samples, ragged lengths with one signal of 1 sample or of none,
and full-scale square waves whose differences saturate the pre-emphasis's
int16 range. On the CPU in float64 the port equals JAX within
max |a − b| / (1 + |b|) < 1e-9 over every frame (the two differ only in
the summation order of their products), and on each signal's valid frames
it is within 1e-6 of the numpy path after rounding to float32, the bound of
tests/test_frontend.py's batch test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.features.frontend import extract_features_batch_jax

from speechrecognition_torch.features import (SignalAnalysisConfig, extract_features,
                                              extract_features_batch)

torch.set_num_threads(1)

CFG = SignalAnalysisConfig()
#: valid lengths of each test batch (samples); S_max is the batch's largest
BATCHES = {"ragged": [4000, 2713, 1, 3217], "empty": [3001, 0, 2999, 17],
           "one-frame": [80, 79, 81, 160]}


def synthetic_batch(lengths, seed):
    """int16 [B, S_max] (zero past each length) and the lengths: tones,
    noise and a full-scale square wave, whose jumps of 65,535 clip."""
    rng = np.random.default_rng(seed)
    S = max(lengths)
    t = np.arange(S) / CFG.sample_rate
    out = np.zeros((len(lengths), S), np.int16)
    for b, n in enumerate(lengths):
        f0, f1 = rng.uniform(100.0, 3500.0, size=2)
        x = 6000 * np.sin(2 * np.pi * f0 * t) + 2500 * np.sin(2 * np.pi * f1 * t)
        x += rng.normal(0.0, 400.0, size=S)
        if b % 2 == 0:
            sq = x[S // 3: S // 3 + 400]
            sq[:] = np.where((np.arange(len(sq)) // 20) % 2 == 0, 32767, -32768)
        out[b, :n] = np.clip(np.round(x[:n]), -32768, 32767).astype(np.int16)
    return out, np.asarray(lengths, np.int64)


def frames_of(n):
    return (n + CFG.window_shift - 1) // CFG.window_shift


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batch_equals_jax_f64(name):
    samples, lens = synthetic_batch(BATCHES[name], seed=len(name))
    got = extract_features_batch(samples, lens, CFG, device="cpu")
    want = np.asarray(extract_features_batch_jax(jnp.asarray(samples), jnp.asarray(lens), CFG))
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (len(lens), frames_of(samples.shape[1]), 12)
    assert np.isfinite(got).all()
    assert np.max(np.abs(got - want) / (1.0 + np.abs(want))) < 1e-9


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_valid_frames_match_numpy_path(name):
    samples, lens = synthetic_batch(BATCHES[name], seed=len(name))
    got = extract_features_batch(torch.from_numpy(samples), torch.from_numpy(lens), CFG,
                                 device="cpu").numpy()
    for b, n in enumerate(lens):
        ref = extract_features(samples[b, :n], CFG)
        assert ref.shape == (frames_of(n), 12)
        mine = got[b, :ref.shape[0]].astype(np.float32)
        if ref.size:
            assert np.max(np.abs(mine - ref) / (1.0 + np.abs(ref))) < 1e-6


def test_float32_products_stay_full_precision():
    """dtype float32 gives float32 cepstra and sets full-float32 products for
    its own products only: the caller's TF32 setting comes back unchanged."""
    samples, lens = synthetic_batch(BATCHES["ragged"], seed=3)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = extract_features_batch(samples, lens, CFG, dtype=torch.float32, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert out.dtype == torch.float32 and out.shape == (4, frames_of(4000), 12)
    assert torch.isfinite(out).all()


def test_card_is_the_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the smoke run checks the card path")
    samples, lens = synthetic_batch(BATCHES["ragged"], seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extract_features_batch(samples, lens, CFG)


def test_shapes_are_checked():
    with pytest.raises(ValueError, match="num_samples"):
        extract_features_batch(np.zeros((2, 100), np.int16), np.array([100]), CFG, device="cpu")
