"""Plain reader of the reference's ``.mix`` mixture files and the M-step that
turns their accumulators into a model (src/sietill/Mixtures.cpp:374-461,
748-830), in NumPy float64.

The traffic generator draws features near the model's means with it, and the
plain references score with it. It imports nothing of the program.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import List

import numpy as np

MAGIC = b"MIXSET\x00\x00"
VERSION = 2
#: the per-mixture score cap of the max-approximation (Mixtures.cpp:699)
SCORE_CAP = 1e10


@dataclass
class Model:
    """A finalized diagonal GMM, densities laid out mixture-major and padded
    to the widest mixture: ``active[s, d]`` marks a real density with a
    finite mean, variance and weight."""

    dim: int
    means: np.ndarray      # f64 [S, D, dim]
    variances: np.ndarray  # f64 [S, D, dim]
    log_weights: np.ndarray  # f64 [S, D]
    norms: np.ndarray      # f64 [S, D]: (dim·log 2π + Σ log var) / 2
    active: np.ndarray     # bool [S, D]

    @property
    def num_mixtures(self) -> int:
        return self.means.shape[0]

    @property
    def num_densities(self) -> int:
        return int(self.active.sum())


def _accumulator(f, dim: int):
    (size,) = struct.unpack("<I", f.read(4))
    sums = np.empty((size, dim))
    weights = np.empty(size)
    for i in range(size):
        (d,) = struct.unpack("<I", f.read(4))
        if d != dim:
            raise ValueError(f"accumulator of dimension {d}, expected {dim}")
        sums[i] = np.frombuffer(f.read(8 * dim), dtype="<f8")
        (weights[i],) = struct.unpack("<d", f.read(8))
    return sums, weights


def read_model(path: str, dim: int, pooling: str) -> Model:
    """Read a ``.mix`` file and finalize it under ``pooling`` ("none": a
    variance a density; "global": one pooled variance)."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path}: not a mixture file")
        version, file_dim = struct.unpack("<II", f.read(8))
        if version != VERSION or file_dim != dim:
            raise ValueError(f"{path}: version {version}, dim {file_dim}")
        mean_acc, mean_w = _accumulator(f, dim)
        var_acc, var_w = _accumulator(f, dim)
        (n,) = struct.unpack("<I", f.read(4))
        dens = np.frombuffer(f.read(8 * n), dtype="<u4").reshape(n, 2).astype(np.int64)
        (n_mix,) = struct.unpack("<I", f.read(4))
        mixtures: List[List[int]] = []
        for _ in range(n_mix):
            (nd,) = struct.unpack("<I", f.read(4))
            ids = []
            for _d in range(nd):
                (idx,) = struct.unpack("<I", f.read(4))
                f.read(8)
                ids.append(idx)
            mixtures.append(ids)
    return finalize(dim, mean_acc, mean_w, var_acc, var_w, dens, mixtures, pooling)


def finalize(dim, mean_acc, mean_w, var_acc, var_w, dens, mixtures, pooling) -> Model:
    """The M-step: means, mixture weights and variances from accumulators."""
    S = len(mixtures)
    D = max(len(m) for m in mixtures)
    means = np.zeros((S, D, dim))
    variances = np.ones((S, D, dim))
    logw = np.zeros((S, D))
    norms = np.zeros((S, D))
    active = np.zeros((S, D), bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        all_means = mean_acc / mean_w[:, None]
        if pooling == "global":
            gmean = mean_acc.sum(0) / mean_w.sum()
            pooled = var_acc[0] / var_w[0] - gmean * gmean
        elif pooling != "none":
            raise ValueError(f"unknown pooling {pooling!r}")
        for s, ids in enumerate(mixtures):
            m_idx = dens[ids, 0]
            total = mean_w[m_idx].sum()
            for d, (mi, vi) in enumerate(dens[ids]):
                mu = all_means[mi]
                if pooling == "global":
                    var = pooled
                else:
                    var = var_acc[vi] / var_w[vi] - mu * mu
                lw = math.log(mean_w[mi] / total) if mean_w[mi] > 0 else -math.inf
                nrm = (dim * math.log(2 * math.pi) + np.log(var).sum()) / 2.0
                ok = (np.isfinite(mu).all() and np.isfinite(var).all() and (var > 0).all()
                      and np.isfinite(lw) and np.isfinite(nrm))
                if not ok:
                    continue
                means[s, d], variances[s, d], logw[s, d], norms[s, d] = mu, var, lw, nrm
                active[s, d] = True
    return Model(dim, means, variances, logw, norms, active)
