"""MFCC front-end: pre-emphasis → Hamming → |FFT| → mel(15) → log → DCT(12)
→ Δ/ΔΔ-energy → CMVN → energy-max normalization.

Numerically replicates the reference pipeline (src/sietill/SignalAnalysis.cpp)
including its idiosyncrasies — int16-saturated pre-emphasis (::120-131),
1/√N-scaled FFT (::167-168), mel filter centers starting at mel=0 with a
1e-10 floor (::241-285), the unscaled DCT-II (::307-316), the clamped Δ
windows (::320-336) and the two-step float32 rounding of CMVN (::390-392).

Two implementations, as in speechrecognition_tpu/features/frontend.py:
  * the numpy float64 reference path (bit-parity with the C++ within f32
    rounding);
  * a batched device path, ``extract_features_batch``, where the whole frame
    loop is an index gather and the DFT, the mel filterbank and the DCT are
    three matrix products (``torch.matmul``; no hand kernel: the reference
    leaves them to XLA outside any Pallas kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class SignalAnalysisConfig:
    """Front-end constants (reference defaults: SignalAnalysis.cpp:46-56)."""

    sample_rate: int = 8000
    window_shift_ms: int = 10
    window_size_ms: int = 25
    dft_length: int = 1024
    n_mel_filters: int = 15
    n_features_in_file: int = 12
    n_features_first: int = 12
    n_features_second: int = 1
    deriv_step: int = 3
    energy_max_norm: bool = True

    @property
    def window_shift(self) -> int:
        return self.window_shift_ms * self.sample_rate // 1000

    @property
    def window_size(self) -> int:
        return self.window_size_ms * self.sample_rate // 1000

    @property
    def n_features_total(self) -> int:
        return self.n_features_in_file + self.n_features_first + self.n_features_second

    @staticmethod
    def from_config(config) -> "SignalAnalysisConfig":
        from ..config import ParameterBool, ParameterInt
        return SignalAnalysisConfig(
            sample_rate=ParameterInt("sample-rate", 8000)(config),
            window_shift_ms=ParameterInt("window-shift", 10)(config),
            window_size_ms=ParameterInt("window-size", 25)(config),
            dft_length=ParameterInt("dft-length", 1024)(config),
            n_mel_filters=ParameterInt("n-mel-filters", 15)(config),
            n_features_in_file=ParameterInt("n-features-file", 12)(config),
            n_features_first=ParameterInt("n-features-first", 12)(config),
            n_features_second=ParameterInt("n-features-second", 1)(config),
            deriv_step=ParameterInt("deriv-step", 3)(config),
            energy_max_norm=ParameterBool("energy-max-norm", True)(config),
        )


# -- static analysis matrices ------------------------------------------------


def hamming_window(size: int) -> np.ndarray:
    i = np.arange(size, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (size - 1))


def mel_filterbank_matrix(cfg: SignalAnalysisConfig) -> np.ndarray:
    """f64 [n_bins, n_mel]: triangular filters over |spectrum|.

    Centers sit at i·d for i=0..n-1 with d = mel(f_nyq)/(n+1) — the first
    filter is a half-triangle at mel 0 (reference: SignalAnalysis.cpp:249-274).
    """
    n_bins = cfg.dft_length // 2 + 1
    max_freq = float(cfg.sample_rate // 2)
    max_mel = 2595.0 * np.log10(1.0 + max_freq / 700.0)
    d = max_mel / (cfg.n_mel_filters + 1)
    centers = np.arange(cfg.n_mel_filters, dtype=np.float64) * d
    freq_step = max_freq / n_bins
    mel_freqs = 2595.0 * np.log10(1.0 + (np.arange(n_bins) * freq_step) / 700.0)
    dist = np.abs(mel_freqs[:, None] - centers[None, :])
    weights = np.where(dist >= d, 0.0, 1.0 - dist / d)
    return weights


def dct_matrix(cfg: SignalAnalysisConfig) -> np.ndarray:
    """f64 [n_mel, n_cepstra]: unscaled DCT-II, c[m]=Σᵢ cos(πm(i+.5)/I)·x[i]."""
    I = cfg.n_mel_filters
    m = np.arange(cfg.n_features_in_file, dtype=np.float64)
    i = np.arange(I, dtype=np.float64)
    return np.cos(np.pi * m[None, :] * (i[:, None] + 0.5) / I)


# -- extraction (audio → 12 cepstra per frame) -------------------------------


def pre_emphasis(samples: np.ndarray) -> np.ndarray:
    """x[i] ← sat16(x[i] − x[i−1]), x[0] unchanged (SignalAnalysis.cpp:120-131)."""
    s = samples.astype(np.int32)
    out = s.copy()
    out[1:] = np.clip(s[1:] - s[:-1], -32768, 32767)
    return out.astype(np.int16)


def _frame_signal(samples: np.ndarray, cfg: SignalAnalysisConfig) -> np.ndarray:
    """f64 [num_frames, window_size]: zero-padded frames every window_shift."""
    num_frames = (len(samples) + cfg.window_shift - 1) // cfg.window_shift
    padded = np.zeros(num_frames * cfg.window_shift + cfg.window_size, dtype=np.float64)
    padded[: len(samples)] = samples
    idx = (np.arange(num_frames)[:, None] * cfg.window_shift
           + np.arange(cfg.window_size)[None, :])
    return padded[idx]


def extract_features(samples: np.ndarray,
                     cfg: SignalAnalysisConfig = SignalAnalysisConfig(),
                     ) -> np.ndarray:
    """Audio → float32 [num_frames, 12] cepstra (the .mm2 content)."""
    samples = pre_emphasis(samples)
    frames = _frame_signal(samples, cfg) * hamming_window(cfg.window_size)[None, :]
    padded = np.zeros((frames.shape[0], cfg.dft_length), dtype=np.float64)
    padded[:, : cfg.window_size] = frames
    spec = np.abs(np.fft.rfft(padded, axis=1)) / np.sqrt(cfg.dft_length)
    fb = 1e-10 + spec @ mel_filterbank_matrix(cfg)
    cepstra = np.log(fb) @ dct_matrix(cfg)
    return cepstra.astype(np.float32)


def extract_features_batch(samples, num_samples,
                           cfg: SignalAnalysisConfig = SignalAnalysisConfig(),
                           dtype: torch.dtype = torch.float64,
                           device="cuda") -> torch.Tensor:
    """Batched device path: int16 [B, S_max] (+ valid lengths [B]) →
    [B, T_max, 12] cepstra in ``dtype`` on ``device``; the counterpart of
    ``extract_features_batch_jax``, step for step.

    The pre-emphasis takes the int32 difference clipped to int16's range,
    zeroed past each signal's length; frames are an index gather, windowed
    by the Hamming window; the DFT is two [window, bins] products with cos
    and sin matrices scaled by 1/√dft_length (built in numpy float64), then
    the magnitude, 1e-10 + the mel product, the log and the DCT product.
    float64 (the default) reproduces the reference's double pipeline to
    ~1e-9; float32 runs its products in full float32 (never TF32), set for
    this call only, and loses the low-energy bins to cancellation (~1e-2 in
    the cepstra). Frames past a signal's ``ceil(num_samples / window_shift)``
    hold garbage that callers mask.

    ``samples`` and ``num_samples`` are numpy arrays or tensors. Runs on the
    card unless ``device="cpu"``; a CUDA device that is not there raises."""
    from ..models.gmm import _full_f32_matmul, pack_device
    dev = pack_device(device, "extract_features_batch")
    s = torch.as_tensor(samples, device=dev).to(torch.int32)
    n = torch.as_tensor(num_samples, device=dev)
    if s.dim() != 2 or n.shape != (s.shape[0],):
        raise ValueError(f"extract_features_batch: samples [B, S] and num_samples [B], got "
                         f"{tuple(s.shape)} and {tuple(n.shape)}")
    d = torch.clamp(s[:, 1:] - s[:, :-1], -32768, 32767)
    # zero the differences past each signal so that padded tails stay silent
    pos = torch.arange(1, s.shape[1], device=dev)[None, :]
    d = torch.where(pos < n[:, None], d, torch.zeros_like(d))
    emph = torch.cat([s[:, :1], d], dim=1).to(dtype)

    B, S = emph.shape
    num_frames_max = (S + cfg.window_shift - 1) // cfg.window_shift
    pad = num_frames_max * cfg.window_shift + cfg.window_size - S
    emph = torch.nn.functional.pad(emph, (0, pad))
    idx = (torch.arange(num_frames_max, device=dev)[:, None] * cfg.window_shift
           + torch.arange(cfg.window_size, device=dev)[None, :])
    frames = emph[:, idx] * torch.as_tensor(hamming_window(cfg.window_size), dtype=dtype,
                                            device=dev)

    n_bins = cfg.dft_length // 2 + 1
    t = np.arange(cfg.window_size, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * t * k / cfg.dft_length
    scale = 1.0 / np.sqrt(cfg.dft_length)

    def const(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    with _full_f32_matmul():
        re = frames @ const(np.cos(ang) * scale)
        im = frames @ const(np.sin(ang) * scale)
        spec = torch.sqrt(re * re + im * im)
        fb = 1e-10 + spec @ const(mel_filterbank_matrix(cfg))
        return torch.log(fb) @ const(dct_matrix(cfg))


# -- load-path processing (12 cepstra → 25-dim normalized features) ----------


def add_deltas(feats: np.ndarray, cfg: SignalAnalysisConfig = SignalAnalysisConfig(),
               ) -> np.ndarray:
    """f32 [T, 12] → f32 [T, 25] with clamped-step Δ and ΔΔ-energy.

    Δ[t]  = c[max(t,k)] − c[max(t,k)−k]           (k = deriv_step)
    ΔΔ[t] = Δc₀[min(t,T−1−k)+k] − Δc₀[t]
    (reference: SignalAnalysis.cpp:320-336; all arithmetic in float32)
    """
    T = feats.shape[0]
    k = cfg.deriv_step
    nf = cfg.n_features_in_file
    out = np.zeros((T, cfg.n_features_total), dtype=np.float32)
    out[:, :nf] = feats

    t = np.arange(T)
    hi = np.maximum(t, k)
    out[:, nf: nf + cfg.n_features_first] = (
        out[hi, : cfg.n_features_first] - out[hi - k, : cfg.n_features_first])

    u = np.minimum(t, T - 1 - k) + k
    d_col = nf
    out[:, nf + cfg.n_features_first] = out[u, d_col] - out[t, d_col]
    return out


def apply_normalization(feats: np.ndarray, mean: np.ndarray, stddev: np.ndarray,
                        ) -> np.ndarray:
    """(x−μ)/σ with the reference's two-step f32 rounding
    (SignalAnalysis.cpp:390-392: subtract→store f32, divide→store f32)."""
    centered = (feats.astype(np.float64) - mean[None, :]).astype(np.float32)
    return (centered.astype(np.float64) / stddev[None, :]).astype(np.float32)


def energy_max_normalization(feats: np.ndarray) -> np.ndarray:
    """Subtract per-utterance max of the energy column (col 0), in f32."""
    out = feats.copy()
    out[:, 0] = out[:, 0] - out[:, 0].max()
    return out


def process_features(feats12: np.ndarray,
                     mean: np.ndarray | None,
                     stddev: np.ndarray | None,
                     cfg: SignalAnalysisConfig = SignalAnalysisConfig(),
                     ) -> np.ndarray:
    """The full load path (reference: SignalAnalysis.cpp:379-399):
    deltas → corpus mean/σ normalization → energy-max normalization."""
    feats = add_deltas(np.asarray(feats12, dtype=np.float32).reshape(-1, cfg.n_features_in_file), cfg)
    if mean is not None:
        feats = apply_normalization(feats, mean, stddev)
    if cfg.energy_max_norm:
        feats = energy_max_normalization(feats)
    return feats


def compute_normalization_stats(all_feats25: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Corpus mean/σ over post-delta features (SignalAnalysis.cpp:353-360)."""
    x = all_feats25.astype(np.float64)
    n = x.shape[0]
    mean = x.sum(axis=0) / n
    sqr = (x * x).sum(axis=0)
    std = np.sqrt(sqr / n - mean * mean)
    return mean, std
