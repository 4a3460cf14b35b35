"""BIC segment clustering (speaker clustering over segments).

Capability parity with Signal/SegmentClustering.{hh,cc}: each segment is
modeled by a single full-covariance Gaussian; agglomerative clustering
merges the pair with the smallest generalized likelihood ratio (GLR /
Gish distance)

    GLR(x, y) = ½·(N·log|Σ_xy| − N_x·log|Σ_x| − N_y·log|Σ_y|)
                                    (SegmentClustering.cc:94-124)

and stops via the BIC criterion: merge while

    GLR_best ≤ threshold + λ·P·log(N_total),
    P = ½·(d + d·(d+1)/2)           (SegmentClustering.cc:493-502,
                                     SegmentClustering.hh:126-131)

λ=1 is the textbook BIC; `threshold` shifts the stop point
(SegmentClustering.cc:905). Typical downstream use: per-cluster CMVN /
VTLN warping factors (features/warping.py).

Batched notes: the hot part — candidate-pair GLR scores — is evaluated as one
batched ``slogdet`` over a [P, d, d] stack of merged scatter matrices, so
each agglomeration round is a single vectorized call rather than a python
pair loop; cluster bookkeeping (argmin, merge) is tiny host control flow.

Port: a copy of speechrecognition_tpu/sprint/segment_clustering.py (host code).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class GaussianStats:
    """Sufficient statistics of one full-covariance Gaussian segment model
    (FullCovMonoGaussianModel: frame count, feature sum, scatter sum)."""

    n: float
    sum: np.ndarray       # [d]
    scatter: np.ndarray   # [d, d] = Σ x xᵀ

    @staticmethod
    def from_features(feats: np.ndarray) -> "GaussianStats":
        f = np.asarray(feats, np.float64)
        return GaussianStats(n=float(f.shape[0]), sum=f.sum(axis=0),
                             scatter=f.T @ f)

    def merge(self, other: "GaussianStats") -> "GaussianStats":
        return GaussianStats(n=self.n + other.n, sum=self.sum + other.sum,
                             scatter=self.scatter + other.scatter)

    def covariance(self, floor: float = 1e-8) -> np.ndarray:
        mean = self.sum / self.n
        cov = self.scatter / self.n - np.outer(mean, mean)
        d = cov.shape[0]
        return cov + floor * np.eye(d)

    def log_likelihood(self) -> float:
        """N·log|Σ| (FullCovMonoGaussianModel::computeL,
        SegmentClustering.cc:94-97)."""
        sign, logdet = np.linalg.slogdet(self.covariance())
        return float(self.n * logdet)


def _pairwise_glr(stats: List[GaussianStats]) -> np.ndarray:
    """[K, K] upper-triangular GLR matrix, batched slogdet over all pairs."""
    K = len(stats)
    d = stats[0].sum.shape[0]
    ll = np.asarray([s.log_likelihood() for s in stats])
    iu, ju = np.triu_indices(K, k=1)
    if iu.size == 0:
        return np.full((K, K), np.inf)
    merged_cov = np.empty((iu.size, d, d))
    merged_n = np.empty(iu.size)
    for p, (i, j) in enumerate(zip(iu, ju)):
        m = stats[i].merge(stats[j])
        merged_cov[p] = m.covariance()
        merged_n[p] = m.n
    _, logdets = np.linalg.slogdet(merged_cov)   # one batched call
    glr_flat = 0.5 * (merged_n * logdets - ll[iu] - ll[ju])
    glr = np.full((K, K), np.inf)
    glr[iu, ju] = glr_flat
    return glr


def bic_penalty(dim: int, total_frames: float, lambda_: float = 1.0) -> float:
    """λ·P·log(N), P = ½(d + d(d+1)/2) (SegmentClustering.hh:126-131)."""
    p = 0.5 * (dim + 0.5 * dim * (dim + 1))
    return lambda_ * p * np.log(total_frames)


@dataclass
class ClusterResult:
    assignment: np.ndarray        # [num_segments] cluster id per segment
    num_clusters: int
    merge_scores: List[float]     # GLR (minus stop score) of each merge taken


def cluster_segments(segment_features: Sequence[np.ndarray],
                     lambda_: float = 1.0,
                     threshold: float = 0.0,
                     min_clusters: int = 1,
                     max_clusters: Optional[int] = None) -> ClusterResult:
    """Agglomerative BIC clustering of segments.

    Merges the lowest-GLR pair while GLR − (threshold + BIC penalty) ≤ 0
    (SegmentClustering.cc:493-502,677) or while more than ``max_clusters``
    clusters remain; never merges below ``min_clusters``.
    """
    stats = [GaussianStats.from_features(f) for f in segment_features]
    K = len(stats)
    assignment = np.arange(K)
    total_frames = sum(s.n for s in stats)
    dim = stats[0].sum.shape[0]
    stop = threshold + bic_penalty(dim, total_frames, lambda_)

    active = list(range(K))
    merge_scores: List[float] = []
    while len(active) > min_clusters:
        sub = [stats[i] for i in active]
        glr = _pairwise_glr(sub)
        a, b = np.unravel_index(np.argmin(glr), glr.shape)
        score = glr[a, b] - stop
        over_max = max_clusters is not None and len(active) > max_clusters
        if score > 0 and not over_max:
            break
        i, j = active[a], active[b]
        stats[i] = stats[i].merge(stats[j])
        assignment[assignment == j] = i
        active.pop(b)
        merge_scores.append(float(score))

    # compact cluster ids to 0..C-1
    ids = {c: k for k, c in enumerate(dict.fromkeys(assignment.tolist()))}
    return ClusterResult(
        assignment=np.asarray([ids[c] for c in assignment]),
        num_clusters=len(ids),
        merge_scores=merge_scores,
    )
