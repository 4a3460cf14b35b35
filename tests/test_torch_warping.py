"""The port's VTLN warping (speechrecognition_torch/features/warping.py)
against the JAX package's speechrecognition_tpu/features/warping.py on the
cases of tests/test_warping.py: the piecewise-linear warps (their segments,
values, inverses and derivatives), the warped and stacked filterbanks, the
warped extraction, the ML warping-factor estimator and the declaration
grammar. Both are numpy float64 code, so every array is bit-equal.
"""

import numpy as np
import pytest

import speechrecognition_tpu.features.frontend as jfront
import speechrecognition_tpu.features.warping as jwarp

import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.features.warping as twarp

MAX_F = 4000.0
X = np.linspace(0.0, MAX_F, 2001)


def assert_same_function(f, g):
    assert (f.limits, f.a, f.b) == (g.limits, g.a, g.b)
    np.testing.assert_array_equal(f.value(X), g.value(X))
    np.testing.assert_array_equal(f.derivative(X), g.derivative(X))


@pytest.mark.parametrize("alpha", [0.8, 0.85, 0.9, 1.0, 1.1, 1.15, 1.2, 1.25])
def test_two_piece_linear_and_inverse_equal_jax(alpha):
    f, g = twarp.two_piece_linear(alpha, 0.875, MAX_F), jwarp.two_piece_linear(alpha, 0.875, MAX_F)
    assert_same_function(f, g)
    assert_same_function(f.invert(), g.invert())
    np.testing.assert_array_equal(f.invert().value(f.value(X)), g.invert().value(g.value(X)))


@pytest.mark.parametrize("alpha", [0.9, 1.0, 1.1])
def test_three_piece_affine_equals_jax(alpha):
    assert_same_function(twarp.three_piece_affine(alpha, 200.0, 0.1, 0.8, MAX_F),
                         jwarp.three_piece_affine(alpha, 200.0, 0.1, 0.8, MAX_F))


def test_argument_checks_match_jax():
    for mod in (twarp, jwarp):
        with pytest.raises(ValueError, match="positive"):
            mod.two_piece_linear(0.0, 0.875, MAX_F)
        with pytest.raises(ValueError, match="limit"):
            mod.two_piece_linear(1.0, 1.0, MAX_F)
        with pytest.raises(ValueError, match="lower"):
            mod.three_piece_affine(1.0, 200.0, 0.8, 0.1, MAX_F)


@pytest.mark.parametrize("alpha", [None, 0.9, 1.0, 1.1])
def test_warped_filterbank_equals_jax(alpha):
    cfg_t, cfg_j = tfront.SignalAnalysisConfig(), jfront.SignalAnalysisConfig()
    wt = None if alpha is None else twarp.two_piece_linear(alpha, 0.875, MAX_F)
    wj = None if alpha is None else jwarp.two_piece_linear(alpha, 0.875, MAX_F)
    got = twarp.warped_mel_filterbank_matrix(cfg_t, wt)
    np.testing.assert_array_equal(got, jwarp.warped_mel_filterbank_matrix(cfg_j, wj))
    if alpha in (None, 1.0):
        np.testing.assert_array_equal(got, tfront.mel_filterbank_matrix(cfg_t))


def test_filterbank_stack_equals_jax():
    alphas = [0.88, 0.9, 1.0, 1.1, 1.12]
    got = twarp.vtln_filterbank_stack(tfront.SignalAnalysisConfig(), alphas)
    want = jwarp.vtln_filterbank_stack(jfront.SignalAnalysisConfig(), alphas)
    assert got.shape == (5, 513, 15)
    np.testing.assert_array_equal(got, want)


def two_tone_audio(seed=7, seconds=2):
    """tests/test_warping.py's audio: two tones and noise, int16."""
    rng = np.random.RandomState(seed)
    t = np.arange(8000 * seconds) / 8000
    return (3000 * np.sin(2 * np.pi * 700 * t) + 2000 * np.sin(2 * np.pi * 1500 * t)
            + 300 * rng.randn(t.size)).astype(np.int16)


@pytest.mark.parametrize("alpha", [0.9, 1.0, 1.05])
def test_warped_extraction_equals_jax(alpha):
    audio = two_tone_audio()
    cfg_t, cfg_j = tfront.SignalAnalysisConfig(), jfront.SignalAnalysisConfig()
    fb = twarp.vtln_filterbank_stack(cfg_t, [alpha])[0]
    got = twarp.extract_features_warped(audio, cfg_t, fb)
    assert got.dtype == np.float32 and got.shape == (200, 12)
    np.testing.assert_array_equal(got, jwarp.extract_features_warped(audio, cfg_j, fb))
    if alpha == 1.0:
        np.testing.assert_array_equal(got, tfront.extract_features(audio, cfg_t))


def test_ml_estimator_equals_jax():
    """The ML estimator picks the same factor with the same scores as JAX's,
    and recovers the factor that made the target (tests/test_warping.py)."""
    audio = two_tone_audio()
    alphas = [0.9, 0.95, 1.0, 1.05, 1.1]
    choices = []
    for front, warp in ((tfront, twarp), (jfront, jwarp)):
        est = warp.MaximumLikelihoodWarpingEstimator(front.SignalAnalysisConfig(), alphas=alphas)
        target = warp.extract_features_warped(audio, est.cfg, est.filterbanks[3])
        mu, var = target.mean(axis=0), target.var(axis=0) + 1e-3
        choices.append(est.estimate(
            [audio], lambda f: float(0.5 * (((f - mu) ** 2) / var).sum())))
    got, want = choices
    assert got.alpha == want.alpha == 1.05
    assert got.score == want.score and got.scores == want.scores


@pytest.mark.parametrize("decl,env", [
    ("mel", None), ("linear-2(0.9, 0.875)", None), ("affine-3(1.1, 200, 0.1, 0.8)", None),
    ("nest(linear-2($input(warping-factor), 0.875), mel)", {"warping-factor": 0.9}),
    ("nest(affine-3(0.95, 100, 0.2, 0.7), mel)", None)])
def test_warping_grammar_equals_jax(decl, env):
    got = twarp.parse_warping_function(decl, MAX_F, env=env)
    want = jwarp.parse_warping_function(decl, MAX_F, env=env)
    np.testing.assert_array_equal(got(X), want(X))


def test_warping_grammar_rejects_what_jax_rejects():
    for mod in (twarp, jwarp):
        with pytest.raises(ValueError, match="cannot parse"):
            mod.parse_warping_function("bogus(1)", MAX_F)
        with pytest.raises(ValueError, match="expected 2 arguments"):
            mod.parse_warping_function("linear-2(0.9)", MAX_F)
