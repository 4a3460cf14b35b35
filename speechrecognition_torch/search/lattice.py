"""Word lattices from the word-conditioned decoder — counterpart of
speechrecognition_tpu/search/lattice.py (host numpy, copied).

Counterpart of the reference's lattice machinery
(rwth-asr-0.5/src/Lattice/ + Flf best/posterior/n-best): the bigram
decoder's per-frame word-end books [T, B, W] already contain every word
hypothesis that survived pruning, with its best boundary frame. This
module turns them into explicit DAGs and implements the classic lattice
operations on the host (the arrays are tiny once off-device):

  * build: arcs (start_frame → end_frame, word, score) from all finite
    word-end hypotheses; scores are de-renormalized back to absolute
    −log-likelihoods using the per-frame beam offsets;
  * best_path: Viterbi over the lattice (must equal the decoder 1-best);
  * n_best: exact N-best paths via repeated best-successor DP;
  * forward_backward: arc posterior scores for confidence/pruning;
  * oracle_wer: lowest achievable WER over the lattice (Levenshtein DP
    against the reference, the standard lattice quality metric).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Arc:
    start: int       # start frame (word begins at start+1)
    end: int         # end frame (1-based, word ends here)
    word: int
    score: float     # absolute path-score increment (−log)


@dataclass
class WordLattice:
    """Arcs grouped by end frame; frame 0 is the initial node."""

    num_frames: int
    arcs: List[Arc]
    silence: int = 0
    #: optional node-id → time map for lattices whose nodes are NOT
    #: frames (e.g. products from Flf composition); None = nodes are
    #: frames, time(node) == node.
    times: Optional[Dict[int, int]] = None
    _by_end: Optional[Dict[int, List[Arc]]] = field(default=None, repr=False)
    _by_start: Optional[Dict[int, List[Arc]]] = field(default=None, repr=False)

    def time_of(self, node: int) -> int:
        return node if self.times is None else self.times[node]

    def by_end(self) -> Dict[int, List[Arc]]:
        if self._by_end is None:
            d: Dict[int, List[Arc]] = {}
            for a in self.arcs:
                d.setdefault(a.end, []).append(a)
            self._by_end = d
        return self._by_end

    def by_start(self) -> Dict[int, List[Arc]]:
        if self._by_start is None:
            d: Dict[int, List[Arc]] = {}
            for a in self.arcs:
                d.setdefault(a.start, []).append(a)
            self._by_start = d
        return self._by_start

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_books(scores: np.ndarray, bkps: np.ndarray, offsets: np.ndarray,
                   num_frames: int, silence: int = 0,
                   big: float = 1e29) -> "WordLattice":
        """scores/bkps: [T, W] word-end books for ONE utterance (already
        sliced from the batch); offsets: [T] per-frame renormalization
        subtractions. Arc score = absolute score difference between its end
        node and its boundary node's best book."""
        T = num_frames
        cum = np.concatenate([[0.0], np.cumsum(offsets[:T])])
        # absolute best word-end score per frame (for arc-score baselines)
        finite = scores[:T] < big
        abs_scores = np.where(finite, scores[:T] + cum[1:][:, None], np.inf)
        frame_best = np.concatenate([[0.0], abs_scores.min(axis=1)])
        arcs: List[Arc] = []
        for t in range(1, T + 1):
            for w in np.nonzero(finite[t - 1])[0]:
                start = int(bkps[t - 1, w])
                base = frame_best[start] if start > 0 else 0.0
                if not np.isfinite(base):
                    continue
                arcs.append(Arc(start=start, end=t, word=int(w),
                                score=float(abs_scores[t - 1, w] - base)))
        return WordLattice(num_frames=T, arcs=arcs, silence=silence)

    # -- operations ----------------------------------------------------------

    def best_path(self) -> Tuple[List[int], float]:
        """Viterbi over the lattice → (word sequence incl. silence, score)."""
        best = np.full(self.num_frames + 1, np.inf)
        best[0] = 0.0
        back: List[Optional[Arc]] = [None] * (self.num_frames + 1)
        for t in range(1, self.num_frames + 1):
            for a in self.by_end().get(t, []):
                cand = best[a.start] + a.score
                if cand < best[t]:
                    best[t] = cand
                    back[t] = a
        words: List[Arc] = []
        t = self.num_frames
        while t > 0 and back[t] is not None:
            words.append(back[t])
            t = back[t].start
        words.reverse()
        return [a.word for a in words], float(best[self.num_frames])

    def n_best(self, n: int) -> List[Tuple[List[int], float]]:
        """Exact N-best distinct paths (A* over partial paths from the
        final node backwards, using the Viterbi forward scores as an
        admissible heuristic)."""
        fwd = np.full(self.num_frames + 1, np.inf)
        fwd[0] = 0.0
        for t in range(1, self.num_frames + 1):
            for a in self.by_end().get(t, []):
                fwd[t] = min(fwd[t], fwd[a.start] + a.score)
        if not np.isfinite(fwd[self.num_frames]):
            return []
        # A*: states are (priority, suffix_cost, node, suffix_words)
        out: List[Tuple[List[int], float]] = []
        heap = [(fwd[self.num_frames], 0.0, self.num_frames, ())]
        while heap and len(out) < n:
            prio, suffix, node, words = heapq.heappop(heap)
            if node == 0:
                out.append((list(words), suffix))
                continue
            for a in self.by_end().get(node, []):
                cost = suffix + a.score
                est = fwd[a.start] + cost
                if np.isfinite(est):
                    heapq.heappush(heap, (est, cost, a.start,
                                          (a.word,) + words))
        return out

    def forward_backward(self) -> Tuple[np.ndarray, Dict[Arc, float]]:
        """−log posterior per arc under the lattice's score distribution.
        Returns (node −log forward+backward mass, arc posterior dict)."""
        def logadd(a: float, b: float) -> float:
            if math.isinf(a):
                return b
            if math.isinf(b):
                return a
            m = min(a, b)
            return m - math.log1p(math.exp(-(abs(a - b))))

        fwd = np.full(self.num_frames + 1, np.inf)
        fwd[0] = 0.0
        for t in range(1, self.num_frames + 1):
            for a in self.by_end().get(t, []):
                fwd[t] = logadd(fwd[t], fwd[a.start] + a.score)
        bwd = np.full(self.num_frames + 1, np.inf)
        bwd[self.num_frames] = 0.0
        for t in range(self.num_frames - 1, -1, -1):
            for a in self.by_start().get(t, []):
                bwd[t] = logadd(bwd[t], bwd[a.end] + a.score)
        total = fwd[self.num_frames]
        post = {a: (fwd[a.start] + a.score + bwd[a.end]) - total
                for a in self.arcs}
        return fwd + bwd, post

    def posterior_prune(self, threshold: float) -> "WordLattice":
        """Keep arcs whose −log posterior ≤ threshold (Flf prune)."""
        _, post = self.forward_backward()
        kept = [a for a in self.arcs if post[a] <= threshold]
        return WordLattice(num_frames=self.num_frames, arcs=kept,
                           silence=self.silence)

    def oracle_wer(self, reference: Sequence[int]) -> Tuple[int, int]:
        """(minimum edit errors achievable, reference length): DP over
        (frame, reference position); silence arcs are free."""
        R = len(reference)
        INF = 10 ** 9
        # cost[t][r] = min errors for a path reaching frame t having
        # consumed r reference words
        cost = np.full((self.num_frames + 1, R + 1), INF, dtype=np.int64)
        cost[0, 0] = 0
        order = sorted(self.arcs, key=lambda a: a.end)
        # deletions of reference words are applied at the end / via
        # substitution accounting below
        for t in range(1, self.num_frames + 1):
            for a in self.by_end().get(t, []):
                for r in range(R + 1):
                    c = cost[a.start, r]
                    if c >= INF:
                        continue
                    if a.word == self.silence:
                        if c < cost[t, r]:
                            cost[t, r] = c
                        continue
                    # consume reference word r (match or substitution)
                    if r < R:
                        nc = c + (0 if a.word == reference[r] else 1)
                        if nc < cost[t, r + 1]:
                            cost[t, r + 1] = nc
                    # insertion (hyp word without reference word)
                    if c + 1 < cost[t, r]:
                        cost[t, r] = c + 1
        final = cost[self.num_frames]
        best = min(int(final[r]) + (R - r) for r in range(R + 1))
        return best, R

    def word_arcs(self) -> List[Arc]:
        return [a for a in self.arcs if a.word != self.silence]
