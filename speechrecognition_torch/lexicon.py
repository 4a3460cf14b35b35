"""Word lexicon and HMM state automata.

TPU-first representation: instead of the reference's per-word
``MarkovAutomaton`` objects (src/sietill/MarkovAutomaton.hpp,
Lexicon.cpp:70-85) we build *static padded index tables* so the decoder and
aligner can address every (word, position) pair as a dense tensor slot.

State numbering matches the reference exactly: global emitting-state
indices are assigned word by word; each word has ``num_states`` distinct
emitting states, each repeated ``repetitions`` times in its automaton, so
``automaton[w]`` is the sequence [s0,s0,s1,s1,...] of global state ids.
The SieTill digit lexicon yields 106 global states with silence = state 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np


@dataclass
class MarkovAutomaton:
    """Sequence of global HMM state indices (0-1-2 topology)."""

    states: np.ndarray  # int32 [num_positions]

    @staticmethod
    def from_word(start: int, num: int, repetitions: int) -> "MarkovAutomaton":
        s = np.repeat(np.arange(start, start + num, dtype=np.int32), repetitions)
        return MarkovAutomaton(states=s)

    @property
    def first_state(self) -> int:
        return int(self.states[0])

    @property
    def last_state(self) -> int:
        return int(self.states[-1])

    @property
    def num_states(self) -> int:
        return int(self.states.shape[0])

    @staticmethod
    def concat(automata: Sequence["MarkovAutomaton"]) -> "MarkovAutomaton":
        return MarkovAutomaton(states=np.concatenate([a.states for a in automata]))


@dataclass
class Lexicon:
    """Word inventory with per-word automata and dense index tables."""

    orth: List[str] = field(default_factory=list)
    automata: List[MarkovAutomaton] = field(default_factory=list)
    silence: int = -1

    def add_word(self, orth: str, num_states: int, repetitions: int,
                 silence: bool = False) -> int:
        word_idx = len(self.automata)
        if silence:
            self.silence = word_idx
        start = 0 if not self.automata else self.automata[-1].last_state + 1
        self.orth.append(orth)
        self.automata.append(MarkovAutomaton.from_word(start, num_states, repetitions))
        return word_idx

    # -- reference-compatible accessors -------------------------------------

    @property
    def num_states(self) -> int:
        return self.automata[-1].last_state + 1

    @property
    def num_words(self) -> int:
        return len(self.automata)

    @property
    def silence_idx(self) -> int:
        return self.silence

    @property
    def silence_state(self) -> int:
        return self.automata[self.silence].first_state

    def word_idx(self, orth: str) -> int:
        try:
            return self.orth.index(orth)
        except ValueError:
            raise KeyError(f"unknown word: '{orth}'")

    def get_automaton_for_word(self, w: int) -> MarkovAutomaton:
        return self.automata[w]

    def get_silence_automaton(self) -> MarkovAutomaton:
        return self.automata[self.silence]

    # -- dense tables for the TPU decoder -----------------------------------

    @property
    def max_positions(self) -> int:
        """Longest automaton (positions, incl. repetitions)."""
        return max(a.num_states for a in self.automata)

    def state_table(self) -> np.ndarray:
        """int32 [num_words, max_positions]: global state id at each slot.

        Padded slots replicate the word's last state (they are masked out of
        all recursions, so the value is only used to keep gathers in-bounds).
        """
        W, P = self.num_words, self.max_positions
        tbl = np.zeros((W, P), dtype=np.int32)
        for w, a in enumerate(self.automata):
            tbl[w, : a.num_states] = a.states
            tbl[w, a.num_states:] = a.last_state
        return tbl

    def word_lengths(self) -> np.ndarray:
        """int32 [num_words]: automaton length (positions) per word."""
        return np.array([a.num_states for a in self.automata], dtype=np.int32)

    def orth_of(self, words: Sequence[int]) -> str:
        return " ".join(self.orth[w] for w in words)


def build_sietill_lexicon() -> Lexicon:
    """The hard-coded German digit lexicon (reference: Lexicon.cpp:70-85)."""
    lex = Lexicon()
    lex.add_word("[silence]", 1, 1, silence=True)
    lex.add_word("eins", 9, 2)
    lex.add_word("zwei", 9, 2)
    lex.add_word("drei", 9, 2)
    lex.add_word("vier", 9, 2)
    lex.add_word("fuenf", 12, 2)
    lex.add_word("sechs", 9, 2)
    lex.add_word("sieben", 12, 2)
    lex.add_word("acht", 9, 2)
    lex.add_word("neun", 9, 2)
    lex.add_word("null", 9, 2)
    lex.add_word("zwo", 9, 2)
    return lex


def build_segment_automaton(lexicon: Lexicon, words: Sequence[int]) -> MarkovAutomaton:
    """silence · w1 · silence · w2 · ... · silence (reference: Training.cpp:239-253)."""
    parts: List[MarkovAutomaton] = []
    sil = lexicon.get_silence_automaton()
    for w in words:
        parts.append(sil)
        parts.append(lexicon.get_automaton_for_word(w))
    parts.append(sil)
    return MarkovAutomaton.concat(parts)
