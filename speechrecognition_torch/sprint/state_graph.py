"""Allophone-state graph construction: orthography → alignment automata/FSAs.

Counterpart of Speech/AllophoneStateGraphBuilder.cc and
Am/ClassicTransducerBuilder.cc: maps a transcription through the Bliss
lexicon's pronunciations and the CART tying into

  * a dense ``MarkovAutomaton`` chain over tied state classes with optional
    silence between/around words — the input of the batched Viterbi /
    Baum-Welch aligners (align/viterbi.py, align/baumwelch.py), and
  * a weighted FSA over the same states with loop/forward/skip arcs carrying
    the TransitionModel penalties (the "allophone-state acceptor with arc
    weights" of rwth-asr Search/Aligner.hh:140-153), plus alignment-FSA
    exports for Viterbi (linear chain) and Baum-Welch (posterior sausage)
    results.

Where Sprint builds an on-demand Fsa and composes lemma/phoneme/allophone
transducers lazily, this design flattens everything to dense tables once
per transcription; the search/alignment machinery then runs as batched
scans with no pointer chasing.

Port: a copy of speechrecognition_tpu/sprint/state_graph.py (host code).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..fsa.automaton import Automaton, linear_acceptor
from ..lexicon import MarkovAutomaton
from .am import AllophoneStateModel, StateTypeTdp, TransitionModel


@dataclass
class AllophoneStateGraphBuilder:
    """Builds per-transcription alignment graphs (orth → tied-state chain).

    ``model`` supplies pronunciations + CART tying; ``transition`` supplies
    the per-state-type TDPs used for FSA arc weights.  The first
    pronunciation of each lemma is used (the aligner's usual choice; Sprint
    expands all pronunciations into a lattice — multi-pronunciation lemmas
    can be aligned per-variant and the best kept).
    """

    model: AllophoneStateModel
    transition: Optional[TransitionModel] = None

    def _pron_states(self, orth: str) -> List[int]:
        lemma = self.model.bliss.lemma_of(orth)
        if lemma is None or not lemma.pronunciations:
            raise KeyError(f"no pronunciation for orthography {orth!r}")
        return self.model.tied_states_for_pron(lemma.pronunciations[0])

    def _silence_states(self) -> List[int]:
        sil = self.model.bliss.silence_lemma
        if sil is None or not sil.pronunciations:
            return []
        return self.model.tied_states_for_pron(sil.pronunciations[0])

    def chain_for_orth(self, words: Sequence[str],
                       silence_between: bool = True) -> MarkovAutomaton:
        """sil·w1·sil·w2…sil chain of tied state classes — the utterance
        automaton the batched aligners consume (the same shape sietill
        builds for its digit strings, Training.cpp:239-253)."""
        sil = self._silence_states() if silence_between else []
        states: List[int] = list(sil)
        for w in words:
            states.extend(self._pron_states(w))
            states.extend(sil)
        return MarkovAutomaton(states=np.asarray(states, np.int32))

    def _state_types(self, words: Sequence[str], silence_between: bool,
                     ) -> List[bool]:
        """is-silence flag per chain position (for per-type TDP rows)."""
        sil = self._silence_states() if silence_between else []
        flags: List[bool] = [True] * len(sil)
        for w in words:
            flags.extend([False] * len(self._pron_states(w)))
            flags.extend([True] * len(sil))
        return flags

    def build_fsa(self, words: Sequence[str], silence_between: bool = True,
                  ) -> Automaton:
        """Allophone-state acceptor with 0-1-2 topology and TDP arc weights
        (Am/ClassicTransducerBuilder applyTransitionModel): labels are tied
        state classes; loop arcs stay, forward/skip advance; the final
        state's exit TDP lands on the final weight."""
        chain = self.chain_for_orth(words, silence_between)
        flags = self._state_types(words, silence_between)
        n = chain.num_states
        tm = self.transition or TransitionModel(
            default=StateTypeTdp(), silence=StateTypeTdp(),
            entry_m1=StateTypeTdp(), entry_m2=StateTypeTdp())

        def tdp(i: int) -> StateTypeTdp:
            return tm.silence if flags[i] else tm.default

        arcs: List[Tuple[int, int, int, float]] = []
        for i in range(n):
            lab = int(chain.states[i])
            t = tdp(i)
            arcs.append((i, i, lab, tm.scale * t.loop))
            if i + 1 < n:
                arcs.append((i, i + 1, int(chain.states[i + 1]),
                             tm.scale * tdp(i + 1).forward))
            if i + 2 < n:
                arcs.append((i, i + 2, int(chain.states[i + 2]),
                             tm.scale * tdp(i + 2).skip))
        final = {n - 1: tm.scale * tdp(n - 1).exit}
        # entry arc convention: state 0 is entered for free at t=0 by the
        # aligner (its emission is charged there), matching the banded DP's
        # init (align/viterbi.py); an explicit super-initial state would
        # only add an epsilon.
        return Automaton.build(n, arcs, final)

    # -- alignment exports (Search/Aligner.hh getAlignmentFsa /
    #    getAlignmentPosteriorFsa) -------------------------------------

    @staticmethod
    def alignment_fsa(states: np.ndarray, scores: Optional[np.ndarray] = None,
                      ) -> Automaton:
        """Viterbi alignment as a linear acceptor: one arc per frame labeled
        with the aligned state, optionally weighted with per-frame acoustic
        scores (Search/Aligner.hh:144-146)."""
        return linear_acceptor([int(s) for s in states],
                               None if scores is None else list(scores))

    @staticmethod
    def alignment_posterior_fsa(gamma: np.ndarray, states_tbl: np.ndarray,
                                weight_threshold: float = 1e-4) -> Automaton:
        """Baum-Welch alignment as a frame-synchronous sausage: between
        frame nodes t and t+1 there is one arc per surviving lattice
        position, labeled with its state and weighted −log posterior
        (Search/Aligner.hh:150-153).

        gamma f [T, A] posteriors of ONE utterance (rows of padding frames
        all-zero); states_tbl int [A]."""
        T = int(np.sum(gamma.sum(axis=1) > 0))
        arcs: List[Tuple[int, int, int, float]] = []
        for t in range(T):
            live = np.nonzero(gamma[t] >= weight_threshold)[0]
            for a in live:
                arcs.append((t, t + 1, int(states_tbl[a]),
                             float(-np.log(gamma[t, a]))))
        return Automaton.build(T + 1, arcs, {T: 0.0})


def aligner_tables_for_orths(builder: AllophoneStateGraphBuilder,
                             transcriptions: Sequence[Sequence[str]],
                             tdp_table_fn=None,
                             pad_to: Optional[int] = None):
    """Batch a set of transcriptions into AlignerTables (align/viterbi.py).

    The per-position TDP rows use the TransitionModel's silence/default
    loop/forward/skip (source-state typed rows are folded into the banded
    DP's into-position convention the same way TdpModel.table_for_states
    does for the flat model)."""
    from ..align.viterbi import AlignerTables

    chains = [builder.chain_for_orth(ws) for ws in transcriptions]
    flag_rows = [builder._state_types(ws, True) for ws in transcriptions]
    B = len(chains)
    A = pad_to or max(c.num_states for c in chains)
    states = np.zeros((B, A), np.int32)
    lengths = np.zeros(B, np.int32)
    tdp = np.zeros((B, A, 3))
    tm = builder.transition or TransitionModel(
        default=StateTypeTdp(), silence=StateTypeTdp(),
        entry_m1=StateTypeTdp(), entry_m2=StateTypeTdp())
    for i, (c, flags) in enumerate(zip(chains, flag_rows)):
        n = c.num_states
        states[i, :n] = c.states
        states[i, n:] = c.last_state
        lengths[i] = n
        for a in range(A):
            t = tm.silence if flags[min(a, n - 1)] else tm.default
            tdp[i, a] = [tm.scale * t.loop, tm.scale * t.forward,
                         tm.scale * t.skip]
    return AlignerTables(states=states, lengths=lengths, tdp=tdp)
