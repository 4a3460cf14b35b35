"""ARPA back-off n-gram language model reader and scorer.

Counterpart of the Sprint ARPA reader
(rwth-asr-0.5/src/Lm/ArpaLm.cc, BackingOff.cc): parses the \\data\\ /
\\N-grams: sections (log10 probabilities + back-off weights) and scores
with standard Katz back-off:

    p(w|h) = p*(w|h)                  if (h,w) listed
           = bow(h) · p(w|h̄)          otherwise

Scores are returned as −ln p to match the framework's score convention.
A dense per-history score table (``score_table``) serves the decoder's
LM-lookahead and recombination on device.
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LN10 = math.log(10.0)


class ArpaLM:
    def __init__(self, path: str, unk: str = "<unk>"):
        self.order = 0
        self.unk = unk
        # (word_id tuple) → (log10 prob, log10 backoff)
        self.ngrams: List[Dict[Tuple[int, ...], Tuple[float, float]]] = []
        self.word2int: Dict[str, int] = {}
        self.int2word: List[str] = []
        self._parse(path)

    def _intern(self, w: str) -> int:
        i = self.word2int.get(w)
        if i is None:
            i = self.word2int[w] = len(self.int2word)
            self.int2word.append(w)
        return i

    def _parse(self, path: str) -> None:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8", errors="replace") as f:
            section = 0  # 0=preamble, n>0 = n-grams
            counts: Dict[int, int] = {}
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line == "\\data\\":
                    section = 0
                    continue
                if line.startswith("ngram "):
                    spec, n = line[6:].split("=")
                    counts[int(spec)] = int(n)
                    continue
                if line.endswith("-grams:") and line.startswith("\\"):
                    section = int(line[1:].split("-")[0])
                    while len(self.ngrams) < section:
                        self.ngrams.append({})
                    continue
                if line == "\\end\\":
                    break
                if section > 0:
                    parts = line.split()
                    logp = float(parts[0])
                    words = tuple(self._intern(w) for w in parts[1: 1 + section])
                    bow = float(parts[1 + section]) if len(parts) > 1 + section else 0.0
                    self.ngrams[section - 1][words] = (logp, bow)
        self.order = len(self.ngrams)

    # -- scoring -------------------------------------------------------------

    def index(self, word: str) -> int:
        i = self.word2int.get(word)
        if i is None:
            i = self.word2int.get(self.unk)
            if i is None:
                raise KeyError(f"word '{word}' not in LM and no {self.unk}")
        return i

    def _log10_prob(self, ids: Tuple[int, ...]) -> float:
        n = len(ids)
        entry = self.ngrams[n - 1].get(ids)
        if entry is not None:
            return entry[0]
        if n == 1:
            unk_id = self.word2int.get(self.unk)
            if unk_id is not None and (unk_id,) in self.ngrams[0]:
                return self.ngrams[0][(unk_id,)][0]
            return -99.0
        hist = self.ngrams[n - 2].get(ids[:-1])
        bow = hist[1] if hist is not None else 0.0
        return bow + self._log10_prob(ids[1:])

    def score(self, word: int, history: Sequence[int]) -> float:
        """−ln p(word | history)."""
        h = tuple(history)[-(self.order - 1):] if self.order > 1 else ()
        return -self._log10_prob(h + (word,)) * LN10

    def score_str(self, word: str, history: Sequence[str]) -> float:
        return self.score(self.index(word), [self.index(w) for w in history])

    def sentence_score(self, words: Sequence[str], bos: str = "<s>",
                       eos: str = "</s>") -> float:
        """Σ −ln p over the sentence incl. </s>, conditioned on <s>."""
        ids = [self.index(bos)] + [self.index(w) for w in words] + [self.index(eos)]
        total = 0.0
        for i in range(1, len(ids)):
            total += self.score(ids[i], ids[max(0, i - self.order + 1): i])
        return total

    def perplexity(self, sentences: Sequence[Sequence[str]]) -> float:
        total = 0.0
        n = 0
        for s in sentences:
            total += self.sentence_score(s)
            n += len(s) + 1
        return math.exp(total / n)

    # -- dense tables for device-side decoding -------------------------------

    def score_table(self, histories: Sequence[Sequence[int]],
                    words: Sequence[int]) -> np.ndarray:
        """−ln p table [num_histories, num_words] (e.g. bigram recombination
        or LM-lookahead upper bounds, Search/LanguageModelLookahead.cc)."""
        out = np.empty((len(histories), len(words)))
        for i, h in enumerate(histories):
            for j, w in enumerate(words):
                out[i, j] = self.score(w, h)
        return out
