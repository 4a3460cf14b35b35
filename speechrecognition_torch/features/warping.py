"""Vocal-tract-length normalization: analytic frequency-warping functions
and warped mel filterbanks — counterpart of
speechrecognition_tpu/features/warping.py (numpy, unchanged in behaviour).

Replicates the reference's warping machinery semantics:
  * ``PiecewiseLinear`` mirrors Math::PiecewiseLinearFunction
    (rwth-asr-0.5/src/Math/PiecewiseLinearFunction.cc:25-57): segments are
    (limit, a, b) with y = a·x + b, ``add`` keeps continuity, ``normalize``
    appends a last segment mapping ``limit`` to itself, ``invert`` flips
    each segment analytically.
  * ``two_piece_linear`` / ``three_piece_affine`` mirror the factory
    constructors behind the config strings ``linear-2(α, limit)`` and
    ``affine-3(α, shift, lo, hi)``
    (rwth-asr-0.5/src/Math/AnalyticFunctionFactory.cc:421-510) including
    the α>1 build-the-inverse-then-invert trick.
  * ``warped_mel_filterbank_matrix`` realizes the FilterBank semantics of
    "filters equidistant over the warped axis" for the warping declaration
    ``nest(linear-2(α, limit), mel)``
    (rwth-asr-0.5/src/Signal/Filterbank.hh:30-38, :128-134): each FFT bin
    frequency is warped before the mel triangle lookup, so filter centers
    stay equidistant in mel of the *warped* frequency.
  * ``MaximumLikelihoodWarpingEstimator`` is the Bayes-classification
    style speaker warping-factor selection
    (rwth-asr-0.5/src/Signal/BayesClassification.cc): score each candidate
    α's feature stream under an acoustic model, pick the ML factor.

Device notes: warping only changes the static [n_bins, n_mel] filterbank
matrix, so the batched front-end path (``frontend.extract_features_batch``)
stays three matrix products; per-speaker VTLN is a gather over a stacked
[n_alphas, n_bins, n_mel] tensor, so a whole corpus with mixed warping
factors still runs as one batched product.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from .frontend import SignalAnalysisConfig, dct_matrix, hamming_window, \
    mel_filterbank_matrix, pre_emphasis, _frame_signal

_INF = float("inf")


def mel_scale(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def inverse_mel_scale(m):
    return 700.0 * (np.power(10.0, np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


class PiecewiseLinear:
    """y = a_i·x + b_i on x ≤ limit_i (Math::PiecewiseLinearFunction)."""

    def __init__(self):
        self.limits: list[float] = []
        self.a: list[float] = []
        self.b: list[float] = []

    def _append(self, limit: float, a: float, b: float) -> None:
        assert not self.limits or limit > self.limits[-1]
        self.limits.append(limit)
        self.a.append(a)
        self.b.append(b)

    def add(self, limit: float, a: float) -> None:
        if not self.limits:
            self._append(limit, a, 0.0)
        else:
            last = self.limits[-1]
            self._append(limit, a, self.value(last) - a * last)

    def normalize(self, limit: float) -> None:
        """Append the last segment so that ``limit`` maps to itself
        (PiecewiseLinearFunction.cc:33-40)."""
        if not self.limits:
            self.add(_INF, 1.0)
        else:
            last = self.limits[-1]
            assert limit > last
            self.add(_INF, (limit - self.value(last)) / (limit - last))

    def _index(self, x):
        # first segment whose limit >= x (std::map::lower_bound semantics)
        return np.searchsorted(np.asarray(self.limits[:-1]), x, side="left")

    def value(self, x):
        x = np.asarray(x, dtype=np.float64)
        i = self._index(x)
        return np.asarray(self.a)[i] * x + np.asarray(self.b)[i]

    def derivative(self, x):
        return np.asarray(self.a)[self._index(np.asarray(x, dtype=np.float64))]

    def invert(self) -> "PiecewiseLinear":
        out = PiecewiseLinear()
        for limit, a, b in zip(self.limits, self.a, self.b):
            lim = a * limit + b if math.isfinite(limit) else _INF
            out._append(lim, 1.0 / a, -b / a)
        return out

    def __call__(self, x):
        return self.value(x)


def two_piece_linear(warping_factor: float, limit: float,
                     max_arg: float) -> PiecewiseLinear:
    """``linear-2(α, limit)`` over [0, max_arg]
    (AnalyticFunctionFactory.cc:421-439): slope α up to limit·max_arg, then
    linear to map max_arg onto itself. α>1 builds the 1/α inverse and
    inverts it so the function never exceeds max_arg."""
    if warping_factor <= 0:
        raise ValueError("warping factor must be positive")
    if not 0.0 < limit < 1.0:
        raise ValueError("limit must lie in (0, 1)")
    f = PiecewiseLinear()
    if warping_factor <= 1.0:
        f.add(limit * max_arg, warping_factor)
        f.normalize(max_arg)
        return f
    f.add(limit * max_arg, 1.0 / warping_factor)
    f.normalize(max_arg)
    return f.invert()


def three_piece_affine(warping_factor: float, a_shift: float,
                       lower_limit: float, upper_limit: float,
                       max_arg: float) -> PiecewiseLinear:
    """``affine-3(α, shift, lo, hi)`` (AnalyticFunctionFactory.cc:486-510)."""
    if not (0.0 < lower_limit < upper_limit < 1.0 and a_shift >= 0.0):
        raise ValueError("need 0 < lower < upper < 1 and shift >= 0")
    f = PiecewiseLinear()
    if warping_factor <= 1.0:
        lo = lower_limit * max_arg
        f.add(lo, (warping_factor * lo + a_shift * (warping_factor - 1.0)) / lo)
        f.add(upper_limit * max_arg, warping_factor)
        f.normalize(max_arg)
        return f
    inv = 1.0 / warping_factor
    lo = lower_limit * max_arg
    f.add(lo, (inv * lo + a_shift * (inv - 1.0)) / lo)
    f.add(upper_limit * max_arg, inv)
    f.normalize(max_arg)
    return f.invert()


def warped_mel_filterbank_matrix(cfg: SignalAnalysisConfig,
                                 warp: Callable[[np.ndarray], np.ndarray],
                                 ) -> np.ndarray:
    """f64 [n_bins, n_mel] triangular filters with bin frequencies warped
    before the mel triangle lookup — the ``nest(<warp>, mel)`` declaration.
    ``warp=None`` or identity reproduces ``mel_filterbank_matrix`` exactly."""
    n_bins = cfg.dft_length // 2 + 1
    max_freq = float(cfg.sample_rate // 2)
    max_mel = mel_scale(max_freq)
    d = max_mel / (cfg.n_mel_filters + 1)
    centers = np.arange(cfg.n_mel_filters, dtype=np.float64) * d
    freq_step = max_freq / n_bins
    freqs = np.arange(n_bins, dtype=np.float64) * freq_step
    mel_freqs = mel_scale(warp(freqs) if warp is not None else freqs)
    dist = np.abs(mel_freqs[:, None] - centers[None, :])
    return np.where(dist >= d, 0.0, 1.0 - dist / d)


def vtln_filterbank_stack(cfg: SignalAnalysisConfig,
                          alphas: Sequence[float],
                          limit: float = 0.875) -> np.ndarray:
    """f64 [n_alphas, n_bins, n_mel]: one warped filterbank per candidate
    warping factor. On device this is a single stacked constant; selecting a
    speaker's factor is a gather, so mixed-α corpora batch into one einsum."""
    max_freq = float(cfg.sample_rate // 2)
    return np.stack([
        warped_mel_filterbank_matrix(
            cfg, two_piece_linear(a, limit, max_freq)) for a in alphas])


def extract_features_warped(samples: np.ndarray,
                            cfg: SignalAnalysisConfig,
                            filterbank: np.ndarray) -> np.ndarray:
    """Audio → float32 [frames, 12] cepstra using a (warped) filterbank.
    Identical math to ``frontend.extract_features`` otherwise."""
    samples = pre_emphasis(samples)
    frames = _frame_signal(samples, cfg) * hamming_window(cfg.window_size)[None, :]
    padded = np.zeros((frames.shape[0], cfg.dft_length), dtype=np.float64)
    padded[:, : cfg.window_size] = frames
    spec = np.abs(np.fft.rfft(padded, axis=1)) / np.sqrt(cfg.dft_length)
    fb = 1e-10 + spec @ filterbank
    return (np.log(fb) @ dct_matrix(cfg)).astype(np.float32)


def parse_warping_function(declaration: str, max_arg: float,
                           env: dict | None = None):
    """Parse a Sprint warping-function declaration into a callable.

    Supports the grammar used by the filterbank configs
    (rwth-asr-0.5/src/Signal/Filterbank.hh:128-134,
    Math/AnalyticFunctionFactory.cc:421-510):
      * ``mel``                     — the mel scale
      * ``linear-2(α, limit)``      — two-piece linear warp
      * ``affine-3(α, shift, lo, hi)`` — three-piece affine warp
      * ``nest(f, g)``              — composition g(f(x))
      * ``$input(name)``            — placeholder substituted from ``env``
    Returns a vectorized ``f(x) -> warped x``.
    """
    env = env or {}
    s = declaration.strip()

    def parse(expr: str):
        expr = expr.strip()
        if expr == "mel":
            return mel_scale
        if expr.startswith("nest(") and expr.endswith(")"):
            inner, outer = _split_args(expr[5:-1], 2)
            f, g = parse(inner), parse(outer)
            return lambda x: g(f(x))
        if expr.startswith("linear-2(") and expr.endswith(")"):
            a, lim = (_num(v, env) for v in _split_args(expr[9:-1], 2))
            return two_piece_linear(a, lim, max_arg)
        if expr.startswith("affine-3(") and expr.endswith(")"):
            a, sh, lo, hi = (_num(v, env) for v in _split_args(expr[9:-1], 4))
            return three_piece_affine(a, sh, lo, hi, max_arg)
        raise ValueError(f"cannot parse warping function: {expr!r}")

    return parse(s)


def _split_args(text: str, n: int) -> list:
    """Split on top-level commas (respecting nested parentheses)."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    if len(parts) != n:
        raise ValueError(f"expected {n} arguments in {text!r}")
    return parts


def _num(token: str, env: dict) -> float:
    token = token.strip()
    if token.startswith("$input(") and token.endswith(")"):
        return float(env[token[7:-1].strip()])
    return float(token)


@dataclass
class WarpingChoice:
    alpha: float
    score: float
    scores: dict


class MaximumLikelihoodWarpingEstimator:
    """Grid-search ML warping-factor selection per speaker/segment cluster.

    ``scorer(features) -> total -log likelihood`` is typically the trained
    GMM's corpus score (models/gmm.py) under a fixed alignment or the
    text-independent min-density score; the estimator picks the α whose
    warped feature stream scores best, mirroring the Bayes-classification
    warping selection (Signal/BayesClassification.cc).
    """

    def __init__(self, cfg: SignalAnalysisConfig,
                 alphas: Sequence[float] = tuple(
                     round(0.88 + 0.02 * i, 2) for i in range(13)),
                 limit: float = 0.875):
        self.cfg = cfg
        self.alphas = list(alphas)
        self.filterbanks = vtln_filterbank_stack(cfg, self.alphas, limit)

    def estimate(self, audio_segments: Sequence[np.ndarray],
                 scorer: Callable[[np.ndarray], float]) -> WarpingChoice:
        scores = {}
        for alpha, fb in zip(self.alphas, self.filterbanks):
            feats = [extract_features_warped(s, self.cfg, fb)
                     for s in audio_segments]
            scores[alpha] = float(sum(scorer(f) for f in feats))
        best = min(scores, key=scores.get)
        return WarpingChoice(alpha=best, score=scores[best], scores=scores)
