"""LDA front-end: Sprint XML matrix reader + sliding-window projection.

The Sprint recognition front-end concatenates a sliding window of base
features (e.g. 9×16 MFCC) and projects with an LDA matrix
(Signal/ScatterTransform, applied via the cache.lda.flow network with
``lda-window.max-size``/``right`` parameters). Here the whole corpus
transform is one batched matmul.

Port: a copy of speechrecognition_tpu/sprint/lda.py (host code).
"""

from __future__ import annotations

import gzip
import re
from typing import Tuple

import numpy as np


def read_matrix_xml(path: str) -> np.ndarray:
    """Parse Sprint's <matrix-f32 nRows=... nColumns=...> text format."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="latin-1") as f:
        text = f.read()
    m = re.search(r'<matrix-f32\s+nRows="(\d+)"\s+nColumns="(\d+)"\s*>', text)
    if not m:
        raise ValueError(f"{path}: no matrix-f32 element")
    rows, cols = int(m.group(1)), int(m.group(2))
    body = text[m.end(): text.find("</matrix-f32>")]
    vals = np.array(body.split(), dtype=np.float64)
    if vals.size != rows * cols:
        raise ValueError(f"{path}: expected {rows*cols} values, got {vals.size}")
    return vals.reshape(rows, cols)


class SlidingWindowLDA:
    """window of (max_size) frames with (right) future frames, flattened in
    temporal order and projected: out[t] = A · concat(x[t-left..t+right]).

    Edge frames repeat the boundary frame (Sprint's signal window node
    default behaviour)."""

    def __init__(self, matrix: np.ndarray, max_size: int, right: int):
        self.matrix = matrix.astype(np.float32)
        self.max_size = max_size
        self.right = right
        self.left = max_size - 1 - right

    @property
    def input_dim(self) -> int:
        return self.matrix.shape[1] // self.max_size

    @property
    def output_dim(self) -> int:
        return self.matrix.shape[0]

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        """f32 [T, base_dim] → f32 [T, output_dim]."""
        T, D = feats.shape
        if D * self.max_size != self.matrix.shape[1]:
            raise ValueError(f"feature dim {D} × window {self.max_size} != "
                             f"matrix cols {self.matrix.shape[1]}")
        idx = np.clip(np.arange(T)[:, None]
                      + np.arange(-self.left, self.right + 1)[None, :], 0, T - 1)
        window = feats[idx].reshape(T, self.max_size * D)
        return window @ self.matrix.T


class ScatterMatricesEstimator:
    """Between/within/total class-scatter estimation
    (Signal/ScatterEstimator.cc:86-304).

    Accumulates per-class first moments and the global second moment; the
    batched formulation replaces the reference's per-frame lower-triangle
    loop with batched reductions

        vectorSquareSum = X^T X                     (one [D,T]x[T,D] matmul)
        vectorSums[c]   = segment-sum of X by class

    finalize() reproduces ScatterMatricesEstimator::finalize exactly:
        total-mean-part = s s^T / n         (s = total sum)
        class-mean-part = sum_c s_c s_c^T / n_c
        Between = class-mean-part - total-mean-part
        Within  = X^T X - class-mean-part
        Total   = X^T X - total-mean-part
    all optionally normalized by the total count (shall-normalize).
    """

    def __init__(self, num_classes: int, dim: int):
        self.num_classes = num_classes
        self.dim = dim
        self.counts = np.zeros(num_classes)
        self.sums = np.zeros((num_classes, dim))
        self.sqsum = np.zeros((dim, dim))

    def accumulate(self, features: np.ndarray, classes: np.ndarray) -> None:
        """features f* [T, D], classes int [T]."""
        x = np.asarray(features, np.float64)
        c = np.asarray(classes, np.int64)
        self.sqsum += x.T @ x
        self.counts += np.bincount(c, minlength=self.num_classes)
        np.add.at(self.sums, c, x)

    def merge(self, other: "ScatterMatricesEstimator") -> None:
        """Cross-shard combination (accumulate(const Estimator&)); under a
        mesh this is the psum of (counts, sums, sqsum)."""
        self.counts += other.counts
        self.sums += other.sums
        self.sqsum += other.sqsum

    def finalize(self, normalize: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """→ (between, within, total) scatter matrices."""
        n = self.counts.sum()
        if n == 0:
            raise ValueError("no observations accumulated")
        s = self.sums.sum(axis=0)
        total_mean_part = np.outer(s, s) / n
        nz = self.counts > 0
        class_mean_part = np.einsum(
            "cd,ce->de", self.sums[nz] / self.counts[nz, None], self.sums[nz])
        between = class_mean_part - total_mean_part
        within = self.sqsum - class_mean_part
        total = self.sqsum - total_mean_part
        if normalize:
            between, within, total = between / n, within / n, total / n
        return between, within, total


def solve_generalized_eigen(between: np.ndarray, within: np.ndarray,
                            regularize: float = 0.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric generalized eigenproblem  B v = lambda W v, eigenvalues
    descending (Math/Lapack EigenvalueProblem::solveSymmetricAndFinalize as
    used by Signal/EigenTransform.cc:165-200).  Solved by Cholesky
    whitening: W = L L^T, eig(L^-1 B L^-T) = (lambda, u), v = L^-T u —
    mathematically identical to LAPACK's sygv driver."""
    W = np.asarray(within, np.float64)
    Bm = np.asarray(between, np.float64)
    if regularize:
        W = W + regularize * np.eye(W.shape[0])
    L = np.linalg.cholesky(W)
    Linv = np.linalg.inv(L)
    M = Linv @ Bm @ Linv.T
    M = 0.5 * (M + M.T)
    vals, vecs = np.linalg.eigh(M)
    order = np.argsort(-vals)
    vals = vals[order]
    v = Linv.T @ vecs[:, order]
    # normalize v^T W v = I (LAPACK sygv convention)
    norms = np.sqrt(np.einsum("di,de,ei->i", v, within
                              + (regularize * np.eye(W.shape[0])
                                 if regularize else 0.0), v))
    v = v / norms[None, :]
    return vals, v


def estimate_lda(between: np.ndarray, within: np.ndarray,
                 reduced_dim: int = 0, eigenvalue_threshold: float = 0.0,
                 regularize: float = 0.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """LDA projector from scatter matrices (Signal/EigenTransform.cc:
    createProjector): transform = top eigenvectors transposed, reduced to
    `reduced_dim` rows, or by dropping eigenvalues below the threshold
    ('reduced-dimesion-threshold' parameter — sic).  Returns (eigenvalues,
    transform [reduced_dim, D]) ready for SlidingWindowLDA."""
    vals, vecs = solve_generalized_eigen(between, within, regularize)
    D = vecs.shape[1]
    if reduced_dim and eigenvalue_threshold:
        raise ValueError("give reduced_dim or eigenvalue_threshold, not both")
    if eigenvalue_threshold:
        reduced_dim = int((vals >= eigenvalue_threshold).sum())
    if reduced_dim == 0 or reduced_dim > D:
        reduced_dim = D
    return vals, vecs.T[:reduced_dim]


def estimate_sliding_window_lda(features_per_segment, classes_per_segment,
                                num_classes: int, max_size: int, right: int,
                                reduced_dim: int, regularize: float = 0.0
                                ) -> "SlidingWindowLDA":
    """End-to-end LDA estimation as the reference pipeline runs it
    (Speech/ScatterMatricesEstimator + lda-window flow): windowed features
    labeled by the per-frame alignment classes → scatter matrices →
    generalized eigen → SlidingWindowLDA projector."""
    first = np.asarray(features_per_segment[0])
    D = first.shape[1] * max_size
    est = ScatterMatricesEstimator(num_classes, D)
    left = max_size - 1 - right
    for feats, cls in zip(features_per_segment, classes_per_segment):
        feats = np.asarray(feats)
        T = feats.shape[0]
        idx = np.clip(np.arange(T)[:, None]
                      + np.arange(-left, right + 1)[None, :], 0, T - 1)
        window = feats[idx].reshape(T, D)
        est.accumulate(window, np.asarray(cls))
    between, within, _total = est.finalize()
    _vals, transform = estimate_lda(between, within, reduced_dim,
                                    regularize=regularize)
    return SlidingWindowLDA(transform, max_size, right)
