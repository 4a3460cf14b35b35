"""Search-derived word lattices with predecessor contexts and exact arc
scores — counterpart of speechrecognition_tpu/search/context_lattice.py
(host numpy, copied).

Counterpart of the reference's real lattice generation
(Lattice/Lattice.hh word-boundary lattices; Flf/FlfCore/Lattice.hh): the
WCTS scan retains, for every frame t, predecessor word c, and word w, the
best hypothesis of w ending at t whose predecessor word ended at the
boundary frame recorded in the backpointer. De-renormalized with the
per-frame offsets, each surviving tuple becomes an arc

    (start, c) --[w : am, lm]--> (end, w)

whose score is EXACTLY the within-word Viterbi increment the decoder
computed — no difference approximation (as WordLattice.from_books makes).

Ops (the Flf processor verbs these lattices support):
  * best_path       — must reproduce the decoder 1-best (tested)
  * lm_rescore      — replace per-arc LM scores from a new bigram matrix
                      (Lattice rescoring, Lattice/Rescore.cc)
  * forward_backward / posterior_prune — arc posteriors + pruning
                      (Lattice/Posterior.cc, Flf prune)
  * oracle_wer      — lattice quality metric
  * time_align      — per-arc state-level forced alignment
                      (Flf time alignment; Speech/AlignmentNode.cc)
  * to_word_lattice — collapse contexts for CN building / SLF interop
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BIG = 1e29


@dataclass(frozen=True)
class CArc:
    start: int    # predecessor's end frame (0 = sentence start)
    pred: int     # predecessor word index; == start_context marks <s>
    end: int      # this word's end frame (1-based)
    word: int
    am: float     # acoustic + TDP increment (−log), exact from the search
    lm: float     # LM score charged at generation time (−log)

    @property
    def score(self) -> float:
        return self.am + self.lm


@dataclass
class ContextLattice:
    """Nodes are (frame, word) pairs; (0, start_context) is initial, every
    (num_frames, w) node is final with cost 0."""

    num_frames: int
    num_contexts: int          # C = vocabulary + 1 (virtual start row)
    arcs: List[CArc]
    silence: int = 0

    @property
    def start_context(self) -> int:
        return self.num_contexts - 1

    # -- construction ----------------------------------------------------------

    @staticmethod
    def from_wcts(books: np.ndarray, cands: np.ndarray, ebkps: np.ndarray,
                  offsets: np.ndarray, num_frames: int, lm_ext: np.ndarray,
                  silence: int) -> "ContextLattice":
        """books [T, W]; cands/ebkps [T, C, W] pre-recombination word-end
        books + boundaries; offsets [T] per-frame renormalizations
        (all for ONE utterance). Absolute scores: x + cum(t)."""
        T = num_frames
        C, W = lm_ext.shape
        cum = np.concatenate([[0.0], np.cumsum(offsets[:T])])
        abs_book = np.where(books[:T] < BIG, books[:T] + cum[1:][:, None],
                            np.inf)                      # [T, W]
        arcs: List[CArc] = []
        for t in range(1, T + 1):
            finite = cands[t - 1] < BIG                   # [C, W]
            for c, w in zip(*np.nonzero(finite)):
                start = int(ebkps[t - 1, c, w])
                if c == C - 1:                            # virtual start
                    if start != 0:
                        continue
                    base = 0.0
                else:
                    base = abs_book[start - 1, c] if start > 0 else np.inf
                if not np.isfinite(base):
                    continue
                total = cands[t - 1, c, w] + cum[t] - base
                lm = float(lm_ext[c, w])
                arcs.append(CArc(start=start, pred=int(c), end=int(t),
                                 word=int(w), am=float(total - lm), lm=lm))
        return ContextLattice(num_frames=T, num_contexts=C, arcs=arcs,
                              silence=silence)

    # -- indexing ----------------------------------------------------------------

    def arcs_into(self) -> Dict[Tuple[int, int], List[CArc]]:
        d: Dict[Tuple[int, int], List[CArc]] = {}
        for a in self.arcs:
            d.setdefault((a.end, a.word), []).append(a)
        return d

    def arcs_out_of(self) -> Dict[Tuple[int, int], List[CArc]]:
        d: Dict[Tuple[int, int], List[CArc]] = {}
        for a in self.arcs:
            d.setdefault((a.start, a.pred), []).append(a)
        return d

    def nodes(self) -> List[Tuple[int, int]]:
        ns = {(0, self.start_context)}
        for a in self.arcs:
            ns.add((a.start, a.pred))
            ns.add((a.end, a.word))
        return sorted(ns)

    # -- core DP -------------------------------------------------------------------

    def _viterbi(self, lm_of=None) -> Tuple[Dict[Tuple[int, int], float],
                                            Dict[Tuple[int, int], Optional[CArc]]]:
        """Best cost to every node; lm_of(arc) overrides the LM score."""
        best: Dict[Tuple[int, int], float] = {(0, self.start_context): 0.0}
        back: Dict[Tuple[int, int], Optional[CArc]] = {
            (0, self.start_context): None}
        for a in sorted(self.arcs, key=lambda a: a.end):
            src = (a.start, a.pred)
            if src not in best:
                continue
            lm = a.lm if lm_of is None else lm_of(a)
            cand = best[src] + a.am + lm
            dst = (a.end, a.word)
            if cand < best.get(dst, np.inf):
                best[dst] = cand
                back[dst] = a
        return best, back

    def best_path(self, lm_of=None) -> Tuple[List[int], float]:
        """(word sequence incl. silence, absolute score) — identical to the
        decoder's 1-best when lm_of is None."""
        best, back = self._viterbi(lm_of)
        finals = [(s, n) for n, s in best.items() if n[0] == self.num_frames]
        if not finals:
            return [], float("inf")
        score, node = min(finals)
        words: List[CArc] = []
        while back.get(node) is not None:
            a = back[node]
            words.append(a)
            node = (a.start, a.pred)
        words.reverse()
        return [a.word for a in words], float(score)

    def best_words(self, lm_of=None) -> List[int]:
        """1-best with silence removed (decoder transcript convention)."""
        seq, _ = self.best_path(lm_of)
        return [w for w in seq if w != self.silence]

    # -- operations ------------------------------------------------------------------

    def lm_rescore(self, lm_ext: np.ndarray) -> "ContextLattice":
        """Replace every arc's LM score from a new extended bigram matrix
        [C, W] (rows: predecessor word, last row = sentence start) —
        lattice LM rescoring (Lattice/Rescore.cc semantics: same arcs,
        new grammar scores)."""
        arcs = [replace(a, lm=float(lm_ext[a.pred, a.word]))
                for a in self.arcs]
        return ContextLattice(num_frames=self.num_frames,
                              num_contexts=self.num_contexts,
                              arcs=arcs, silence=self.silence)

    def forward_backward(self) -> Dict[CArc, float]:
        """Arc posterior −log probabilities (sum semiring over full paths,
        Lattice/Posterior.cc)."""
        def logadd(x: float, y: float) -> float:
            if x == np.inf:
                return y
            if y == np.inf:
                return x
            m = min(x, y)
            return m - math.log1p(math.exp(m - max(x, y)))

        fwd: Dict[Tuple[int, int], float] = {(0, self.start_context): 0.0}
        for a in sorted(self.arcs, key=lambda a: a.end):
            src = (a.start, a.pred)
            if src not in fwd:
                continue
            dst = (a.end, a.word)
            fwd[dst] = logadd(fwd.get(dst, np.inf), fwd[src] + a.score)
        bwd: Dict[Tuple[int, int], float] = {}
        for n in fwd:
            if n[0] == self.num_frames:
                bwd[n] = 0.0
        for a in sorted(self.arcs, key=lambda a: -a.end):
            dst = (a.end, a.word)
            if dst not in bwd:
                continue
            src = (a.start, a.pred)
            bwd[src] = logadd(bwd.get(src, np.inf), a.score + bwd[dst])
        total = np.inf
        for n, s in fwd.items():
            if n[0] == self.num_frames and n in bwd:
                total = logadd(total, s)
        post: Dict[CArc, float] = {}
        for a in self.arcs:
            f = fwd.get((a.start, a.pred), np.inf)
            b = bwd.get((a.end, a.word), np.inf)
            post[a] = f + a.score + b - total
        return post

    def posterior_prune(self, threshold: float) -> "ContextLattice":
        """Keep arcs whose posterior −log prob is within ``threshold`` of
        the best (0.0) — Flf posterior pruning. The 1-best always has
        posterior cost ≤ any other path's and survives."""
        post = self.forward_backward()
        kept = [a for a in self.arcs if post[a] <= threshold + 1e-9]
        return ContextLattice(num_frames=self.num_frames,
                              num_contexts=self.num_contexts,
                              arcs=kept, silence=self.silence)

    def oracle_wer(self, reference: Sequence[int]) -> Tuple[int, int]:
        """(minimum edit distance over all lattice paths, reference length)
        — the standard lattice quality metric. Silence arcs are free."""
        R = len(reference)
        INF = 10 ** 9
        # dp[node] = vector over reference positions 0..R of best edit cost
        dp: Dict[Tuple[int, int], np.ndarray] = {}
        init = np.full(R + 1, INF, np.int64)
        # deletions of leading reference words
        init[:] = np.arange(R + 1)
        dp[(0, self.start_context)] = init
        for a in sorted(self.arcs, key=lambda a: a.end):
            src = (a.start, a.pred)
            if src not in dp:
                continue
            cur = dp[src]
            if a.word == self.silence:
                new = cur.copy()
            else:
                new = np.full(R + 1, INF, np.int64)
                # insertion (consume arc word, no reference word)
                np.minimum(new, cur + 1, out=new)
                # substitution / match against reference[j-1]
                sub = cur[:-1] + (np.asarray(reference) != a.word)
                np.minimum(new[1:], sub, out=new[1:])
            # deletions (consume reference words without arcs) — applied
            # as a forward min-scan
            for j in range(1, R + 1):
                if new[j - 1] + 1 < new[j]:
                    new[j] = new[j - 1] + 1
            dst = (a.end, a.word)
            if dst in dp:
                dp[dst] = np.minimum(dp[dst], new)
            else:
                dp[dst] = new
        best = INF
        for n, v in dp.items():
            if n[0] == self.num_frames:
                best = min(best, int(v[R]))
        return best, R

    def time_align(self, arc: CArc, am_frames: np.ndarray,
                   automaton_states: np.ndarray,
                   tdp_table: np.ndarray) -> List[int]:
        """State-level forced alignment of one arc: Viterbi of the word's
        automaton over the arc's frame span (start+1..end), the lattice
        analogue of the Flf time-alignment op. am_frames: [end−start, S]
        acoustic scores for exactly those frames; tdp_table [A, 3]
        penalties into each position by jump. Returns per-frame automaton
        positions."""
        T, _ = am_frames.shape
        A = automaton_states.shape[0]
        INF = np.inf
        cost = np.full(A, INF)
        cost[0] = am_frames[0, automaton_states[0]]
        back = np.zeros((T, A), np.int8)
        for t in range(1, T):
            prev = cost
            cost = np.full(A, INF)
            for a in range(A):
                cands = []
                for j in range(3):
                    if a - j >= 0 and np.isfinite(prev[a - j]) \
                            and np.isfinite(tdp_table[a, j]):
                        cands.append((prev[a - j] + tdp_table[a, j], j))
                if cands:
                    sc, j = min(cands)
                    cost[a] = sc + am_frames[t, automaton_states[a]]
                    back[t, a] = j
        pos = int(np.argmin(cost))
        out = [pos]
        for t in range(T - 1, 0, -1):
            pos -= int(back[t, pos])
            out.append(pos)
        out.reverse()
        return out

    def to_word_lattice(self):
        """Collapse predecessor contexts: arcs (start, end, word) keep the
        best combined score — the projection WordLattice/CN tooling uses."""
        from .lattice import Arc, WordLattice

        best: Dict[Tuple[int, int, int], float] = {}
        for a in self.arcs:
            key = (a.start, a.end, a.word)
            if a.score < best.get(key, np.inf):
                best[key] = a.score
        arcs = [Arc(start=s, end=e, word=w, score=sc)
                for (s, e, w), sc in sorted(best.items())]
        return WordLattice(num_frames=self.num_frames, arcs=arcs,
                           silence=self.silence)
