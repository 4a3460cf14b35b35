"""Additional Sprint language-model variants: zerogram, FSA-grammar LM,
and class LM.

Counterparts of rwth-asr-0.5/src/Lm/Zerogram.cc, Lm/FsaLm.cc
and Lm/ClassLm.cc.  All scores are −ln p (framework convention); every
variant exposes the same dense ``score_table(histories, words)`` surface
the decoders consume (see search/ngram_decoder.py), so grammar decoding
and class-based recombination ride the identical min-plus matmul path on
device.

Port: a copy of speechrecognition_tpu/lm/variants.py (host code).
"""

from __future__ import annotations

import gzip
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fsa.automaton import Automaton, EPS

INF = float("inf")


class Zerogram:
    """Uniform LM: −ln(1/V) for every word (Lm/Zerogram.cc:31-44)."""

    def __init__(self, vocab_size: int):
        if vocab_size <= 0:
            raise ValueError("zerogram needs a non-empty vocabulary")
        self.vocab_size = vocab_size
        self._score = math.log(vocab_size)

    def score(self, word: int, history: Sequence[int] = ()) -> float:
        return self._score

    def score_table(self, histories: Sequence[Sequence[int]],
                    words: Sequence[int]) -> np.ndarray:
        return np.full((len(histories), len(words)), self._score)


#: FsaLm.cc:27 — histories that left the grammar get a dedicated invalid
#: state whose every score is +inf.
INVALID_HISTORY = -1


class FsaLM:
    """Grammar LM backed by a weighted acceptor (Lm/FsaLm.cc).

    A history is an automaton state id.  ``score``/``extended_history``
    follow the reference's semantics exactly (FsaLm.cc:100-179):

    - look for an arc with the requested input label; if found, the score
      is the accumulated epsilon weight plus that arc's weight;
    - otherwise follow the state's *first* arc if it is an epsilon arc,
      accumulating its weight, and retry from its target;
    - if neither exists the history becomes invalid (score +inf).

    Sentence end follows epsilon arcs until a final state and charges the
    final weight (FsaLm.cc:158-179).
    """

    def __init__(self, fsa: Automaton):
        self.fsa = fsa
        # per-state arc index, sorted by input label with epsilon arcs
        # first (Fsa::SortTypeByInput puts Epsilon lowest, FsaLm.cc:85)
        self._arcs: List[np.ndarray] = []
        for s in range(fsa.num_states):
            idx = np.nonzero(fsa.src == s)[0]
            order = np.argsort(fsa.ilabel[idx], kind="stable")
            self._arcs.append(idx[order])

    # -- history handling (state ids) ------------------------------------
    def start_history(self) -> int:
        return self.fsa.initial

    def _find(self, state: int, word: int) -> Tuple[Optional[int], Optional[int]]:
        """(matching arc id, first-eps arc id) for `state`."""
        match = eps = None
        for a in self._arcs[state]:
            lab = int(self.fsa.ilabel[a])
            if lab == word:
                match = int(a)
                break
        first = self._arcs[state]
        if len(first) and int(self.fsa.ilabel[first[0]]) == EPS:
            eps = int(first[0])
        return match, eps

    def extended_history(self, history: int, word: int) -> int:
        if history == INVALID_HISTORY:
            return INVALID_HISTORY
        state = history
        while True:
            match, eps = self._find(state, word)
            if match is not None:
                return int(self.fsa.dst[match])
            if eps is None:
                return INVALID_HISTORY
            state = int(self.fsa.dst[eps])

    def score(self, word: int, history) -> float:
        """−ln p of `word` given `history` (a state id, or a sequence whose
        last element is the state id for score_table compatibility)."""
        if isinstance(history, (list, tuple, np.ndarray)):
            history = int(history[-1]) if len(history) else self.start_history()
        if history == INVALID_HISTORY:
            return INF
        state, acc = history, 0.0
        while True:
            match, eps = self._find(state, word)
            if match is not None:
                return acc + float(self.fsa.weight[match])
            if eps is None:
                return INF
            acc += float(self.fsa.weight[eps])
            state = int(self.fsa.dst[eps])

    def sentence_end_score(self, history: int) -> float:
        if history == INVALID_HISTORY:
            return INF
        state, acc = history, 0.0
        while True:
            if np.isfinite(self.fsa.final[state]):
                return acc + float(self.fsa.final[state])
            _match, eps = self._find(state, -2)  # only eps can help
            if eps is None:
                return INF
            acc += float(self.fsa.weight[eps])
            state = int(self.fsa.dst[eps])

    def sentence_score(self, words: Sequence[int]) -> float:
        h, total = self.start_history(), 0.0
        for w in words:
            s = self.score(w, h)
            if not np.isfinite(s):
                return INF
            total += s
            h = self.extended_history(h, w)
        end = self.sentence_end_score(h)
        return total + end

    def score_table(self, histories: Sequence[int],
                    words: Sequence[int]) -> np.ndarray:
        """Dense [num_histories, num_words] −ln p table over state-id
        histories — the grammar-decoding analogue of the ARPA table."""
        out = np.empty((len(histories), len(words)))
        for i, h in enumerate(histories):
            hh = int(h[-1]) if isinstance(h, (list, tuple, np.ndarray)) else int(h)
            for j, w in enumerate(words):
                out[i, j] = self.score(int(w), hh)
        return out


@dataclass
class ClassMapping:
    """Word → (class, −ln q(word|class)) mapping (Lm/ClassLm.cc:56-130).

    Class file format (ClassLm.hh:87-93)::

        # comment                (also ';')
        <token> <class> [q]      q defaults to 1.0, normalized per class

    Tokens absent from the file get identity classes with q=1
    (ClassLm.cc:98-119); emission scores are −ln(q / Σ_class q)
    (ClassLm.cc:120-133).
    """

    classes: List[str]                       # class id → class name
    class_of: np.ndarray                     # int32 [V] word id → class id
    emission: np.ndarray                     # f64 [V] −ln q(word|class)
    class2int: Dict[str, int]

    @staticmethod
    def load(path: str, vocab: Sequence[str]) -> "ClassMapping":
        word2int = {w: i for i, w in enumerate(vocab)}
        raw_q = np.full(len(vocab), np.nan)
        class_of = np.full(len(vocab), -1, np.int32)
        classes: List[str] = []
        class2int: Dict[str, int] = {}

        def class_id(name: str) -> int:
            i = class2int.get(name)
            if i is None:
                i = class2int[name] = len(classes)
                classes.append(name)
            return i

        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0][0] in "#;":
                    continue
                word = parts[0]
                cls = parts[1] if len(parts) > 1 else word
                q = float(parts[2]) if len(parts) > 2 else 1.0
                wid = word2int.get(word)
                if wid is None:
                    continue  # reference warns on unknown tokens
                if class_of[wid] >= 0:
                    continue  # reference errors on duplicates, keeps first
                class_of[wid] = class_id(cls)
                raw_q[wid] = q
        # identity mappings for unmapped words (ClassLm.cc:98-119)
        for wid, word in enumerate(vocab):
            if class_of[wid] < 0:
                class_of[wid] = class_id(word)
                raw_q[wid] = 1.0
        # per-class normalization → −ln(q/sum) (ClassLm.cc:120-133)
        sums = np.zeros(len(classes))
        np.add.at(sums, class_of, raw_q)
        emission = -np.log(raw_q / sums[class_of])
        return ClassMapping(classes, class_of, emission, class2int)


class ClassLM:
    """p(w|h) = q(w|class(w))^scale · p(class(w) | class(h))
    (ClassLm.hh:28-30, scale from ClassLm::paramClassEmissionScale).

    `base_lm` is any LM over *class ids* with the standard
    ``score(word, history)`` surface (ArpaLM / CountLM / Zerogram /
    FsaLM)."""

    def __init__(self, mapping: ClassMapping, base_lm, emission_scale: float = 1.0):
        self.mapping = mapping
        self.base_lm = base_lm
        self.emission_scale = emission_scale

    def score(self, word: int, history: Sequence[int]) -> float:
        m = self.mapping
        cls_hist = [int(m.class_of[h]) for h in history]
        return (self.emission_scale * float(m.emission[word])
                + self.base_lm.score(int(m.class_of[word]), cls_hist))

    def score_table(self, histories: Sequence[Sequence[int]],
                    words: Sequence[int]) -> np.ndarray:
        out = np.empty((len(histories), len(words)))
        for i, h in enumerate(histories):
            for j, w in enumerate(words):
                out[i, j] = self.score(w, h)
        return out
