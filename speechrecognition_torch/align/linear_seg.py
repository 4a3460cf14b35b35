"""Linear segmentation: initial speech/silence boundaries from frame energy.

Counterpart of speechrecognition_tpu/align/linear_seg.py, host numpy, line
for line. It replicates the reference's running-sum formulation with
*float32* prefix sums (deliberately — the reference accumulates
`cost_sum`/`square_cost_sum` as float, Training.cpp:366-367,437-452) and the
3-iteration coordinate-descent approximation that is the default path
(Training.cpp:429-510).

The segment score is the unnormalized energy variance
    seg(a, b) = Σ²(a..b) − (Σ(a..b))²/(b−a+1)
computed in float64 from the float32 prefix sums (Training.cpp:549-558).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _prefix_sums(energy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    e32 = energy.astype(np.float32)
    cost = np.add.accumulate(e32, dtype=np.float32)
    sq = np.add.accumulate(e32 * e32, dtype=np.float32)
    return cost, sq


def _segment_scores(cost: np.ndarray, sq: np.ndarray,
                    begin: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Vectorized seg(begin, end) for arrays of boundaries (begin ≥ 1)."""
    tmp = (cost[end] - cost[begin - 1]).astype(np.float64)
    score = (sq[end] - sq[begin - 1]).astype(np.float64)
    return score - tmp * tmp / (end - begin + 1)


def linear_segmentation_approximation(energy: np.ndarray) -> Tuple[int, int]:
    """3-iteration coordinate descent on the two boundaries.

    energy: f32 [N] (feature column 0). Returns (b1, b2) frame indices.
    Candidate ranges, tie-breaking (strict <, smallest candidate wins) and
    the 1e10 initialization match Training.cpp:455-503.
    """
    N = energy.shape[0]
    cost, sq = _prefix_sums(energy)
    b1 = N // 2 - 1
    b2 = N // 2

    for _ in range(3):
        # boundary 1: candidates n in [1, b2-2]
        if b2 - 1 > 1:
            n = np.arange(1, b2 - 1)
            costs = (_segment_scores(cost, sq, np.ones_like(n), n)
                     + _segment_scores(cost, sq, n + 1, np.full_like(n, b2)))
            if costs.min() < 1e10:
                b1 = int(n[np.argmin(costs)])
        # boundary 2: candidates n in [b1+1, N-2]
        if N - 1 > b1 + 1:
            n = np.arange(b1 + 1, N - 1)
            costs = (_segment_scores(cost, sq, np.full_like(n, b1 + 1), n)
                     + _segment_scores(cost, sq, n + 1, np.full_like(n, N - 1)))
            if costs.min() < 1e10:
                b2 = int(n[np.argmin(costs)])
    return b1, b2


def linear_segmentation_running_sums(energy: np.ndarray) -> Tuple[int, int]:
    """Exact K=4 DP over boundary positions (Training.cpp:350-425).

    Vectorized over the whole [N, N] (n, n') candidate matrix per k —
    same arithmetic (f32 prefix differences cast to f64, strict-< with
    ascending-n' first-minimum tie-breaking) without the per-(k, n)
    Python loop that dominated full-corpus setup time."""
    N = energy.shape[0]
    cost, sq = _prefix_sums(energy)
    K = 4
    costs_matrix = np.full((K, N), 1e10, dtype=np.float32)
    backprop = np.zeros((K, N), dtype=np.int64)
    costs_matrix[0, 0] = 0.0

    n = np.arange(N)
    lower = n[:, None] > n[None, :]          # n' < n
    tmp = (cost[:, None] - cost[None, :]).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        local = ((sq[:, None] - sq[None, :]).astype(np.float64)
                 - tmp * tmp / (n[:, None] - n[None, :]))
    for k in range(1, K):
        cand = costs_matrix[k - 1][None, :].astype(np.float64) + local
        cand = np.where(lower, cand, np.inf)
        j = np.argmin(cand, axis=1)          # first minimum per row
        best = cand[n, j]
        upd = best < costs_matrix[k]         # rows n ≥ 1 with a real path
        costs_matrix[k, upd] = best[upd]
        backprop[k, upd] = j[upd]
    b2 = int(backprop[K - 1, N - 1])
    b1 = int(backprop[K - 2, b2])
    return b1, b2


def linear_segmentation_full_dp(energy: np.ndarray,
                                next_energy: float = 0.0) -> Tuple[int, int]:
    """Third variant: the exact O(K·N²) DP with precomputed per-segment
    means (Training.cpp:257-348) — the reference's cross-validation twin
    of the running-sums DP (same objective, different rounding path).

    Quirks kept: segment means accumulate in float32
    (``CostMatrix = vector<vector<float>>``, Training.cpp:273-299); local
    costs re-accumulate (e[t] − mean)² in float64 (:320-327); the cost
    matrix stores float32 with strict-> updates, so the earliest n' wins
    ties (:330-334).

    ``next_energy``: the reference fills segment_means[N−1][N−1] from
    ``**feature_end`` (Training.cpp:301) — one past the segment, i.e. the
    *next* segment's first energy in the flat corpus store (undefined
    memory for the last segment). Pass that value for bug-compatible
    boundaries; the default 0.0 gives the intended semantics.
    """
    N = energy.shape[0]
    e32 = energy.astype(np.float32)
    e64 = e32.astype(np.float64)
    K = 4

    # mean[a, b] = f32-accumulated mean of e[a..b] (row-wise running sums)
    means = np.zeros((N, N), np.float32)
    for a in range(N - 1):
        run = np.add.accumulate(e32[a:], dtype=np.float32)
        counts = np.arange(1, N - a + 1, dtype=np.float32)
        means[a, a:] = run / counts
        means[a, a] = e32[a]
    means[N - 1, N - 1] = np.float32(next_energy)

    # prefix sums for the f64 local-cost expansion
    ps = np.concatenate([[0.0], np.add.accumulate(e64)])
    ps2 = np.concatenate([[0.0], np.add.accumulate(e64 * e64)])

    costs = np.full((K, N), 1e10, np.float32)
    backs = np.zeros((K, N), np.int64)
    costs[0, 0] = 0.0
    n_idx = np.arange(N)
    for k in range(1, K):
        for n in range(1, N):
            npr = n_idx[:n]
            m = means[npr + 1, n].astype(np.float64)
            cnt = (n - npr).astype(np.float64)
            # Σ_{t=n'+1..n} (e[t] − m)²  expanded around the f32 mean
            local = (ps2[n + 1] - ps2[npr + 1]
                     - 2.0 * m * (ps[n + 1] - ps[npr + 1]) + cnt * m * m)
            cand = costs[k - 1, :n].astype(np.float64) + local
            j = int(np.argmin(cand))
            if costs[k, n] > cand[j]:
                costs[k, n] = np.float32(cand[j])
                backs[k, n] = j
    b2 = int(backs[K - 1, N - 1])
    b1 = int(backs[K - 2, b2])
    return b1, b2


def linear_alignment_mapping(automaton_states: np.ndarray, num_frames: int,
                             b1: int, b2: int) -> np.ndarray:
    """Frame → automaton state, linear between the boundaries
    (Training.cpp:513-546; note the float32 slope cast)."""
    A = automaton_states.shape[0]
    spv = np.float64(np.float32(A) / np.float32(b2 - b1))
    n = np.arange(num_frames)
    idx = np.where(
        n <= b1, 0,
        np.where(n > b2, A - 1, (spv * (n - b1 - 1)).astype(np.int64)))
    return automaton_states[idx].astype(np.int32)
