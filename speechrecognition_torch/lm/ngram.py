"""Count-based n-gram language model with absolute discounting.

Replicates the reference Python-2 toolkit
(src/language-model/{LanguageModel,PrefixTree,Vocabulary}.py): a counted
prefix trie over word ids with <s>/</s>/<unk> specials, per-order absolute
discounts d = n₁/(n₁ + 2·n₂), and the recursive interpolated score

    p(w | h) = max(c(h,w) − d, 0)/c(h) + d·N₊(h)/c(h) · p(w | h̄)

with the base case p(w | ε) = max(c(w) − d₀, 0)/c(ε)
+ d₀·N₊(ε)/(c(ε)·V) (LanguageModel.py:275-316). An important counting
quirk is kept: *every suffix* of a sentence is inserted (the trailing
slices shorter than n, LanguageModel.py:162-164), so the root count is
the number of inserted positions, not the number of full n-grams.

Scoring is dict-based on the host — the trie is built once and the
decoder consumes per-word score *tables* (see ``score_matrix``), which is
the device-friendly contract: the LM lives on the host, dense score tables
live on the device.

Port: a copy of speechrecognition_tpu/lm/ngram.py (host code).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class Vocabulary:
    """Word↔id maps with <s>/<//s>/<unk> specials (Vocabulary.py)."""

    def __init__(self, vocabulary_file: Optional[str] = None):
        self.word2int: Dict[str, int] = {}
        self.int2word: List[str] = []
        self.word_frequencies: List[int] = []
        for w in ("<s>", "</s>", "<unk>"):
            self.add_symbol(w)
        if vocabulary_file:
            with open(vocabulary_file) as f:
                for line in f:
                    self.add_symbol(line.strip())

    def add_symbol(self, word: str) -> int:
        if word not in self.word2int:
            self.word2int[word] = len(self.int2word)
            self.int2word.append(word)
            self.word_frequencies.append(1)
        else:
            self.word_frequencies[self.word2int[word]] += 1
        return self.word2int[word]

    @property
    def unk(self) -> int:
        return self.word2int["<unk>"]

    @property
    def start(self) -> int:
        return self.word2int["<s>"]

    @property
    def end(self) -> int:
        return self.word2int["</s>"]

    def size(self) -> int:
        return len(self.int2word)

    def index(self, word: str) -> int:
        return self.word2int.get(word, self.unk)

    def symbol(self, idx: int) -> str:
        return self.int2word[idx] if 0 <= idx < len(self.int2word) else "<unk>"


class _TrieNode:
    __slots__ = ("children", "count")

    def __init__(self):
        self.children: Optional[Dict[int, "_TrieNode"]] = None
        self.count = 0

    def add(self, ngram: Sequence[int]) -> None:
        self.count += 1
        if not len(ngram):
            return
        if self.children is None:
            self.children = {}
        child = self.children.get(ngram[0])
        if child is None:
            child = self.children[ngram[0]] = _TrieNode()
        child.add(ngram[1:])

    def get(self, ngram: Sequence[int]) -> Optional["_TrieNode"]:
        node = self
        for w in ngram:
            if node.children is None or w not in node.children:
                return None
            node = node.children[w]
        return node

    def num_children(self) -> int:
        return len(self.children) if self.children else 0


class CountLM:
    """Interpolated absolute-discounting n-gram LM (default trigram)."""

    def __init__(self, order: int = 3, vocabulary: Optional[Vocabulary] = None):
        self.order = order
        self.vocabulary = vocabulary or Vocabulary()
        self.root = _TrieNode()
        self.discounts: List[float] = []
        self.num_running_words = 0
        self.num_sentences = 0
        self.sentence_lengths: Dict[int, int] = defaultdict(int)
        self.oov_words = 0

    # -- training ------------------------------------------------------------

    def add_sentence(self, words: Sequence[str], grow_vocab: bool = False) -> None:
        if grow_vocab:
            ids = [self.vocabulary.add_symbol(w) for w in words]
        else:
            ids = [self.vocabulary.index(w) for w in words]
        self.oov_words += sum(1 for i in ids if i == self.vocabulary.unk)
        seq = [self.vocabulary.start] + ids + [self.vocabulary.end]
        for i in range(len(seq)):  # includes the short trailing suffixes
            self.root.add(seq[i: i + self.order])
        self.num_sentences += 1
        self.num_running_words += len(words)
        self.sentence_lengths[len(words)] += 1

    def train(self, corpus_file: str, grow_vocab: bool = True) -> None:
        with open(corpus_file) as f:
            for line in f:
                self.add_sentence(line.strip().split(" "), grow_vocab=grow_vocab)
        self.estimate_discounts()

    def estimate_discounts(self) -> None:
        """d_k = n₁/(n₁ + 2·n₂) per order (LanguageModel.py:238-273)."""
        self.discounts = []
        level = [self.root]
        for _k in range(self.order):
            singletons = doubletons = 0
            nxt: List[_TrieNode] = []
            for node in level:
                if node.children:
                    for child in node.children.values():
                        nxt.append(child)
                        if child.count == 1:
                            singletons += 1
                        elif child.count == 2:
                            doubletons += 1
            denom = singletons + 2.0 * doubletons
            # tiny corpora may have no singletons/doubletons at some order;
            # fall back to no discounting (pure ML) instead of dividing by 0
            # — a semantics divergence from LanguageModel.py:238-273 (which
            # would divide by zero), so make it loud
            if denom <= 0:
                import warnings

                warnings.warn(
                    f"n-gram order {len(self.discounts) + 1}: no singleton/"
                    f"doubleton counts — absolute discount falls back to 0 "
                    f"(pure ML), diverging from the reference's d=n1/(n1+2n2)",
                    stacklevel=2)
            self.discounts.append(singletons / denom if denom > 0 else 0.0)
            level = nxt

    # -- scoring -------------------------------------------------------------

    def prob(self, word: int, history: Sequence[int]) -> float:
        """p(word | history), interpolated back-off (LanguageModel.py:275-316)."""
        history = list(history)[-(self.order - 1):]
        if len(history) == 0:
            d = self.discounts[0]
            p = d / (float(self.root.count) * self.vocabulary.size())
            p *= self.root.num_children()
            if word != self.vocabulary.unk:
                node = self.root.get([word])
                if node is not None:
                    p += max((node.count - d) / float(self.root.count), 0.0)
            return p

        hnode = self.root.get(history)
        if hnode is None:
            return self.prob(word, history[1:])
        d = self.discounts[len(history)]
        p = d * hnode.num_children() / float(hnode.count)
        p *= self.prob(word, history[1:])
        wnode = hnode.get([word])
        if wnode is not None:
            p += max((wnode.count - d) / float(hnode.count), 0.0)
        return p

    def score(self, word: int, history: Sequence[int]) -> float:
        """−log p, the decoder-facing convention (inf for zero probability)."""
        p = self.prob(word, history)
        return -math.log(p) if p > 0.0 else float("inf")

    def score_matrix(self, histories: Sequence[Sequence[int]],
                     words: Optional[Sequence[int]] = None) -> np.ndarray:
        """Dense −log p table [num_histories, num_words] for device use
        (e.g. bigram recombination tables in the tree decoder)."""
        words = list(words) if words is not None else list(range(self.vocabulary.size()))
        out = np.empty((len(histories), len(words)))
        for i, h in enumerate(histories):
            for j, w in enumerate(words):
                out[i, j] = self.score(w, h)
        return out

    # -- evaluation ----------------------------------------------------------

    def perplexity(self, corpus_file: str, order: Optional[int] = None) -> float:
        """Bigram-evaluated perplexity, matching the reference's evaluation
        loop (LanguageModel.py:319-344: scores each word given only its
        single predecessor, </s> included, OOVs scored as <unk>)."""
        ll = 0.0
        n_words = 0
        with open(corpus_file) as f:
            for line in f:
                words = line.strip().split(" ")
                ids = [self.vocabulary.start] + [self.vocabulary.index(w) for w in words]
                for i in range(1, len(ids)):
                    ll += math.log(self.prob(ids[i], [ids[i - 1]]))
                ll += math.log(self.prob(self.vocabulary.end, [ids[-1]]))
                n_words += len(words) + 1
        return math.exp(-ll / n_words)

    @property
    def oov_rate(self) -> float:
        return self.oov_words / max(1, self.num_running_words)
