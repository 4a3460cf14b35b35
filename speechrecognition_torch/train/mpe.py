"""MPE-style discriminative training: approximate-accuracy lattices feeding
sign-split EBW statistics — counterpart of speechrecognition_tpu/train/mpe.py.

The reference's accuracy-FSA machinery, on the host in float64 over the
pruned word lattices:
  * approximate word accuracy per lattice arc —
    Lattice/Accuracy.cc:351-369 (ApproximateAccuracyAutomaton::accuracy):
    for a hypothesis arc h and the reference intervals r that overlap it,

        acc(h) = max_r  (−1 + 2·ov)  if label(r) == label(h)
                        (−1 +   ov)  otherwise,
        ov     = |[h.start, h.end] ∩ [r.start, r.end]| / |r|

    and 0 when no reference interval overlaps. Short-pause (silence)
    hypothesis arcs carry no accuracy payload (Accuracy.cc:348).
  * reference intervals from the numerator forced alignment —
    Speech/AccuracyFsaBuilder.hh:66-117.
  * MPE occupancies: with arc posteriors γ(q) and the average accuracy
    c(q) of lattice paths through q,

        γ^MPE(q) = γ(q) · (c(q) − c_avg)        (Povey 2002)

    by an accuracy-weighted forward-backward pass. Arcs with positive
    γ^MPE accumulate as numerator-side statistics, negative as
    denominator-side, and the M-step is the shared EBW update (train/ebw.py;
    the arcs' alignment and accumulation run on the trainer's device).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..corpus import Corpus
from ..lexicon import Lexicon
from ..search.lattice import Arc, WordLattice
from .ebw import EbwTrainer


@dataclass(frozen=True)
class RefInterval:
    word: int
    start: int    # frame interval (start, end], matching lattice arcs
    end: int


def state_to_word_table(lexicon: Lexicon) -> np.ndarray:
    """int32 [num_states] global HMM state → word index."""
    table = np.zeros(lexicon.num_states, np.int32)
    for w in range(lexicon.num_words):
        for st in lexicon.get_automaton_for_word(w).states:
            table[int(st)] = w
    return table


def reference_intervals(alignment: np.ndarray, lexicon: Lexicon,
                        ) -> List[RefInterval]:
    """Word time intervals of a forced alignment (one segment's states,
    int [T]); silence is excluded (short pause). A new occurrence of the
    same word starts where the aligned state index decreases (the 0-1-2
    topology only moves forward within one occurrence)."""
    table = state_to_word_table(lexicon)
    out: List[RefInterval] = []
    cur_word, cur_start = -1, 0
    prev_state = -1
    for t, st in enumerate(np.asarray(alignment, np.int64)):
        w = int(table[st])
        new_occurrence = (w != cur_word) or (st < prev_state)
        if new_occurrence:
            if cur_word >= 0 and cur_word != lexicon.silence_idx:
                out.append(RefInterval(cur_word, cur_start, t))
            cur_word, cur_start = w, t
        prev_state = st
    if cur_word >= 0 and cur_word != lexicon.silence_idx:
        out.append(RefInterval(cur_word, cur_start, len(alignment)))
    return out


def approximate_word_accuracy(arc: Arc, refs: Sequence[RefInterval],
                              silence: int) -> float:
    """Lattice/Accuracy.cc:351-369, word labels."""
    if arc.word == silence:
        return 0.0
    best = None
    for r in refs:
        ov = min(arc.end, r.end) - max(arc.start, r.start)
        if ov < 0:
            continue
        ov /= (r.end - r.start)
        acc = (-1.0 + 2.0 * ov) if r.word == arc.word else (-1.0 + ov)
        best = acc if best is None else max(best, acc)
    return 0.0 if best is None else best


def mpe_arc_gammas(lat: WordLattice, acc: Dict[Arc, float],
                   ) -> Tuple[Dict[Arc, float], float]:
    """Accuracy-weighted forward-backward: γ^MPE(q) = γ(q)·(c(q) − c_avg).

    Returns ({arc: γ^MPE}, c_avg). c(q) = E[path accuracy | path ∋ q]
    accumulates as normalized prefix/suffix accuracy means alongside the
    probability recursions (host DAGs, already pruned)."""
    T = lat.num_frames

    def logadd(a: float, b: float) -> float:
        if math.isinf(a):
            return b
        if math.isinf(b):
            return a
        m = min(a, b)
        return m - math.log1p(math.exp(-abs(a - b)))

    fwd = np.full(T + 1, np.inf)
    fwd[0] = 0.0
    c_fwd = np.zeros(T + 1)       # E[prefix accuracy | reach node]
    for t in range(1, T + 1):
        terms = []
        for a in lat.by_end().get(t, []):
            if math.isinf(fwd[a.start]):
                continue
            terms.append((fwd[a.start] + a.score, c_fwd[a.start] + acc[a]))
            fwd[t] = logadd(fwd[t], fwd[a.start] + a.score)
        if terms and not math.isinf(fwd[t]):
            c_fwd[t] = sum(math.exp(fwd[t] - s) * c for s, c in terms)
    bwd = np.full(T + 1, np.inf)
    bwd[T] = 0.0
    c_bwd = np.zeros(T + 1)
    for t in range(T - 1, -1, -1):
        terms = []
        for a in lat.by_start().get(t, []):
            if math.isinf(bwd[a.end]):
                continue
            terms.append((a.score + bwd[a.end], c_bwd[a.end] + acc[a]))
            bwd[t] = logadd(bwd[t], a.score + bwd[a.end])
        if terms and not math.isinf(bwd[t]):
            c_bwd[t] = sum(math.exp(bwd[t] - s) * c for s, c in terms)
    total = fwd[T]
    c_avg = c_fwd[T]
    out: Dict[Arc, float] = {}
    for a in lat.arcs:
        lp = fwd[a.start] + a.score + bwd[a.end] - total
        if math.isinf(lp) or lp > 50.0:
            out[a] = 0.0
            continue
        gamma = math.exp(-lp)
        c_q = c_fwd[a.start] + acc[a] + c_bwd[a.end]
        out[a] = gamma * (c_q - c_avg)
    return out, c_avg


class MpeTrainer(EbwTrainer):
    """MPE iteration over word lattices; shares the lattice decode and the
    EBW M-step with the MMI trainer."""

    def _expected_accuracy(self, corpus: Corpus, alignment: np.ndarray, s: int,
                           lat: WordLattice) -> Tuple[Dict[Arc, float], float]:
        """Segment s's γ^MPE and expected accuracy against its alignment."""
        o = int(corpus.feature_offsets[s])
        L = int(corpus.lengths[s])
        refs = reference_intervals(alignment[o:o + L], self.lexicon)
        acc = {a: approximate_word_accuracy(a, refs, self.lexicon.silence_idx)
               for a in lat.arcs}
        return mpe_arc_gammas(lat, acc)

    def mpe_statistics(self, corpus: Corpus, alignment: np.ndarray,
                       lattices: Sequence[WordLattice],
                       ) -> Tuple[tuple, tuple, float]:
        """Sign-split γ^MPE statistics. Returns (num, den, total expected
        accuracy)."""
        t0 = time.perf_counter()
        pos_jobs, neg_jobs = [], []
        total_acc = 0.0
        for s, lat in enumerate(lattices):
            gmpe, c_avg = self._expected_accuracy(corpus, alignment, s, lat)
            total_acc += c_avg
            for a, g in gmpe.items():
                if g > 1e-8:
                    pos_jobs.append((s, a.start, a.end, a.word, float(g)))
                elif g < -1e-8:
                    neg_jobs.append((s, a.start, a.end, a.word, float(-g)))
        self.phase_seconds["lattices"] += time.perf_counter() - t0
        num = self.arc_statistics(corpus, pos_jobs)
        den = self.arc_statistics(corpus, neg_jobs)
        return num, den, total_acc

    def iterate(self, corpus: Corpus, alignment: np.ndarray,
                compute_after: bool = True) -> dict:
        """One MPE iteration; returns expected-accuracy diagnostics.
        ``compute_after=False`` skips the post-update lattice pass (a
        multi-iteration run reads iteration k's after-accuracy as
        iteration k+1's before-accuracy instead of decoding twice)."""
        lats = self.decode_lattices(corpus)
        num, den, acc_before = self.mpe_statistics(corpus, alignment, lats)
        # I-smoothing toward the ML statistics (the reference smooths the
        # MPE numerator with ML counts, Mm/ISmoothingMixtureSetEstimator):
        if self.cfg.i_smoothing_tau > 0:
            ml = self.numerator_statistics(corpus, alignment)
            tau = self.cfg.i_smoothing_tau
            w_n, x_n, x2_n = [a.copy() for a in num]
            nz = ml[0] > 0
            lam = tau / np.where(nz, ml[0], 1.0)
            w_n = w_n + np.where(nz, tau, 0.0)
            x_n = x_n + lam[:, :, None] * ml[1]
            x2_n = x2_n + lam[:, :, None] * ml[2]
            num = (w_n, x_n, x2_n)
        tau_saved, self.cfg.i_smoothing_tau = self.cfg.i_smoothing_tau, 0.0
        try:
            self.ebw_update(num, den)
        finally:
            self.cfg.i_smoothing_tau = tau_saved
        acc_after = float("nan")
        if compute_after:
            lats_after = self.decode_lattices(corpus)
            t0 = time.perf_counter()
            acc_after = 0.0
            for s, lat in enumerate(lats_after):
                acc_after += self._expected_accuracy(corpus, alignment, s, lat)[1]
            self.phase_seconds["lattices"] += time.perf_counter() - t0
        return {"expected_accuracy_before": acc_before,
                "expected_accuracy_after": acc_after,
                "num_mass": float(num[0].sum()),
                "den_mass": float(den[0].sum())}
