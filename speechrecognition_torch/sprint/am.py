"""Acoustic-model assembly: the Sprint per-state-type transition model and
the allophone-state model.

``StateTypeTdp`` and ``TransitionModel``: TDPs {entry-m1, entry-m2,
silence, phone0, phone1} x {loop, forward, skip, exit}
(Am/TransitionModel.hh:64-76), read from a SprintConfig's
``acoustic-model.tdp`` block, and the decoder tables they give a lexicon,
built with numpy on the host in the port's ``search.decoder.DecoderTables``
and ``search.tree_decoder.TreeTables``. ``AllophoneStateModel``: a Bliss
lexicon and a CART tree mapped to per-word automata over tied mixture
indices (states-per-phone x state-repetitions, triphone context within the
word, ``#`` across word boundaries), in the port's ``Lexicon`` and
``MarkovAutomaton``.

Port: counterpart of speechrecognition_tpu/sprint/am.py; the same tables,
host code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..lexicon import Lexicon, MarkovAutomaton
from .bliss import BlissLexicon
from .cart import DecisionTree
from .config import SprintConfig


@dataclass(frozen=True)
class StateTypeTdp:
    loop: float = 0.0
    forward: float = 0.0
    skip: float = 0.0
    exit: float = 0.0


@dataclass
class TransitionModel:
    """Per-state-type TDPs: {entry-m1, entry-m2, silence, phone0, phone1}
    × {loop, forward, skip, exit} (Am/TransitionModel.hh:64-76).

    ``default`` is phone0 (config select "state-0",
    GlobalTransitionModel ctor TransitionModel.cc:677-687); ``phone1``
    ("state-1") applies to odd repetition sub-states
    (classify() = phone0 + subState, TransitionModel.hh:120-124) and
    falls back to phone0 when not configured. entry-m2 is parsed and
    range-checked like the reference, whose Applicator only ever
    assigns entry-m1 weights to word-start states
    (TransitionModel.cc:395,564,615) — so it influences nothing here
    either, by fidelity rather than omission."""

    default: StateTypeTdp
    silence: StateTypeTdp
    entry_m1: StateTypeTdp
    entry_m2: StateTypeTdp
    scale: float = 1.0
    phone1: Optional[StateTypeTdp] = None

    def state_tdp(self, state_type: str) -> StateTypeTdp:
        return {"silence": self.silence, "entry-m1": self.entry_m1,
                "entry-m2": self.entry_m2,
                "phone1": self.phone1 or self.default}.get(
                    state_type, self.default)

    def _slot_tdp(self, is_silence_word: bool, slot: int,
                  state_repetitions: int) -> StateTypeTdp:
        """TDP row of a source slot: silence states → silence; phone
        states → phone0/phone1 by repetition sub-state."""
        if is_silence_word:
            return self.silence
        if state_repetitions > 1 and (slot % state_repetitions) == 1:
            return self.phone1 or self.default
        return self.default

    def decoder_tables(self, lexicon: Lexicon,
                       state_repetitions: int = 1) -> "object":
        """Dense decoder tables with Sprint transition semantics
        (Am/TransitionModel.cc:540-640): loop/forward/skip penalties are
        charged per the *source* state's type, word entry charges the
        entry-m1 forward/skip TDPs, and the per-type exit TDP is charged
        when leaving the word's last state (search.decoder exit_pen) —
        unlike the SieTill decoder, which charges a flat word penalty at
        entry (Recognizer.cpp:133-158).

        State types: every state of the silence word is `silence`; other
        states are phone0/phone1 by repetition sub-state
        (Am/TransitionModel.hh:120-124 — phone0 + subState). phone1 falls
        back to `default` unless distinct TDPs were configured.
        """
        from ..search.decoder import BIG, DecoderTables

        W, P = lexicon.num_words, lexicon.max_positions
        state_table = lexicon.state_table()
        word_len = lexicon.word_lengths()
        last_pos = word_len - 1
        first_state = state_table[:, 0].copy()
        scale = self.scale

        def clean(v: float) -> float:
            return float(BIG) if not np.isfinite(v) else scale * v

        # per-slot source-state TDP rows [W, P, 3]
        src_tdp = np.full((W, P, 3), float(BIG))
        for w in range(W):
            for s in range(int(word_len[w])):
                t = self._slot_tdp(w == lexicon.silence_idx, s,
                                   state_repetitions)
                src_tdp[w, s] = [clean(t.loop), clean(t.forward), clean(t.skip)]

        # charge into slot s via jump j from source slot s-j
        tdp_within = np.full((W, P, 3), float(BIG))
        for j in range(3):
            s = np.arange(P)
            p = s - j
            # Sprint topology: the last state may loop (the exit is scored
            # separately at word-end bookkeeping), so unlike the SieTill
            # pruned decoder nothing excludes last_pos as a loop source;
            # forward/skip out of the word fall outside the valid mask.
            valid = (p >= 0) & (s < word_len[:, None])
            for w in range(W):
                for si in np.nonzero(valid[w])[0]:
                    tdp_within[w, si, j] = src_tdp[w, si - j, j]

        entry = self.entry_m1
        entry_pen = np.full((W, 2), float(BIG))
        for w in range(W):
            entry_pen[w, 0] = clean(entry.forward)
            if word_len[w] > 1:
                entry_pen[w, 1] = clean(entry.skip)

        exit_pen = np.zeros(W)
        for w in range(W):
            # the exit TDP is charged when leaving the word's LAST state,
            # with that state's own type (Applicator::doExit weight(current,
            # exit), TransitionModel.cc:557-566)
            t = self._slot_tdp(w == lexicon.silence_idx,
                               int(word_len[w]) - 1, state_repetitions)
            exit_pen[w] = clean(t.exit)

        return DecoderTables(
            state_table=state_table, word_len=word_len, last_pos=last_pos,
            first_state=first_state, tdp_within=tdp_within,
            entry_pen=entry_pen, num_words=W, max_pos=P, exit_pen=exit_pen)

    def tree_tables(self, lexicon: Lexicon,
                    state_repetitions: int = 1) -> "object":
        """Prefix-tree tables with Sprint transition semantics: per-node
        loop by the node's own type, forward/skip by the *source* node's
        type, word entries via entry-m1 forward/skip, and per-type exit
        TDPs at word-end nodes — the tree-search analogue of
        decoder_tables (consumed by search.tree_decoder /
        search.wcts)."""
        from ..search.decoder import BIG
        from ..search.tree_decoder import TreeTables

        base = TreeTables.build(lexicon, _ZeroTdp(), word_penalty=0.0)
        N = base.num_nodes
        scale = self.scale

        def clean(v: float) -> float:
            return float(BIG) if not np.isfinite(v) else scale * v

        # per-node state type from the word/slot that created each node:
        # walk every word's path again (shared prefixes agree on depth,
        # hence on repetition sub-state; silence shares with nobody)
        node_type: List[Optional[StateTypeTdp]] = [None] * N
        children = _tree_children(base)
        for w in range(lexicon.num_words):
            seq = lexicon.get_automaton_for_word(w).states
            node = 0
            for slot, s in enumerate(seq):
                node = children[node][int(s)]
                node_type[node] = self._slot_tdp(
                    w == lexicon.silence_idx, slot, state_repetitions)

        tdp = np.full((N, 3), float(BIG))
        exit_pen = np.zeros(N)
        for n in range(1, N):
            own = node_type[n]
            tdp[n, 0] = clean(own.loop)
            if base.depth[n] == 1:
                tdp[n, 1] = clean(self.entry_m1.forward)   # entry
            else:
                tdp[n, 1] = clean(node_type[base.parent[n]].forward)
            if base.depth[n] == 2:
                tdp[n, 2] = clean(self.entry_m1.skip)      # entry skip
            elif base.depth[n] > 2:
                tdp[n, 2] = clean(node_type[base.grand[n]].skip)
            if base.end_word[n] >= 0:
                exit_pen[n] = clean(own.exit)
        # Sprint topology: every emitting state may loop, including word
        # ends (the exit TDP is charged separately) — unlike SieTill's
        # pruned decoder which parks word-end hypotheses
        loop_allowed = np.ones(N, bool)
        loop_allowed[0] = False
        return TreeTables(
            state=base.state, parent=base.parent, grand=base.grand,
            depth=base.depth, tdp=tdp, loop_allowed=loop_allowed,
            end_word=base.end_word, exit_penalty=exit_pen,
            num_nodes=N, num_words=base.num_words, end_node=base.end_node)

    @staticmethod
    def from_config(cfg: SprintConfig, prefix: str = "x.acoustic-model.tdp",
                    ) -> "TransitionModel":
        def read(name: str) -> StateTypeTdp:
            base = f"{prefix}.{name}" if name else prefix
            return StateTypeTdp(
                loop=cfg.get_float(f"{base}.loop", 0.0),
                forward=cfg.get_float(f"{base}.forward", 0.0),
                skip=cfg.get_float(f"{base}.skip", 0.0),
                exit=cfg.get_float(f"{base}.exit", 0.0))
        return TransitionModel(
            # config selects per GlobalTransitionModel
            # (TransitionModel.cc:677-687); wildcard [*.tdp.*] rows
            # resolve identically for state-0/state-1
            default=read("state-0"),
            silence=read("silence"),
            entry_m1=read("entry-m1"),
            entry_m2=read("entry-m2"),
            phone1=read("state-1"),
            scale=cfg.get_float(f"{prefix}.scale", 1.0))


class _ZeroTdp:
    """Placeholder TdpModel for structural TreeTables builds (the Sprint
    TDP rows are overwritten afterwards)."""

    def table_for_states(self, states: np.ndarray) -> np.ndarray:
        return np.zeros(states.shape + (3,), np.float64)


def _tree_children(tables) -> List[Dict[int, int]]:
    """Rebuild the child maps of a flattened TreeTables trie."""
    children: List[Dict[int, int]] = [dict() for _ in range(tables.num_nodes)]
    for n in range(1, tables.num_nodes):
        children[int(tables.parent[n])][int(tables.state[n])] = n
    return children


@dataclass
class AllophoneStateModel:
    """Lexicon + CART → tied-state word automata."""

    bliss: BlissLexicon
    tree: DecisionTree
    states_per_phone: int = 3
    state_repetitions: int = 1
    silence_class: Optional[int] = None

    def tied_states_for_pron(self, phonemes: Sequence[str],
                             boundary_lemma: bool = True) -> List[int]:
        """Tied mixture ids for one pronunciation, with within-word triphone
        context and '#' at word boundaries (across-word-model = no)."""
        out: List[int] = []
        n = len(phonemes)
        for i, ph in enumerate(phonemes):
            hist = phonemes[i - 1] if i > 0 else "#"
            fut = phonemes[i + 1] if i < n - 1 else "#"
            if n == 1:
                boundary = "single-phoneme-lemma"
            elif i == 0:
                boundary = "begin-of-lemma"
            elif i == n - 1:
                boundary = "end-of-lemma"
            else:
                boundary = "within-lemma"
            for s in range(self.states_per_phone):
                cls = self.tree.classify({
                    "central": ph, "history[0]": hist, "future[0]": fut,
                    "hmm-state": str(s), "boundary": boundary})
                out.extend([cls] * self.state_repetitions)
        return out

    def build_search_lexicon(self) -> Tuple[Lexicon, List[str], np.ndarray]:
        """Flatten the Bliss lexicon into the dense Lexicon structure used by
        the decoders: one automaton per (lemma, pronunciation), global state
        ids = tied CART classes. Returns (lexicon, orth list, tied-class map
        int32 [num_slots] mapping automaton slots → mixture ids).

        Unlike the SieTill digits (distinct states per word), LVCSR words
        share tied states — the decoder's state_table carries mixture ids
        directly, so the Lexicon here stores tied classes as 'states'.
        """
        lex = Lexicon()
        orths: List[str] = []
        sil = self.bliss.silence_lemma
        # silence first (decoder convention: silence_idx with free entry)
        if sil is not None and sil.pronunciations:
            states = self.tied_states_for_pron(sil.pronunciations[0])
            lex.orth.append(sil.orth[0])
            lex.automata.append(MarkovAutomaton(
                states=np.asarray(states, np.int32)))
            lex.silence = 0
            orths.append(sil.orth[0])
        for lemma in self.bliss.lemmas:
            if lemma.special is not None:
                continue
            for pron in lemma.pronunciations:
                if not pron:
                    continue
                states = self.tied_states_for_pron(pron)
                lex.orth.append(lemma.orth[0])
                lex.automata.append(MarkovAutomaton(
                    states=np.asarray(states, np.int32)))
                orths.append(lemma.orth[0])
        tied = np.concatenate([a.states for a in lex.automata])
        return lex, orths, tied

    @property
    def num_classes(self) -> int:
        return self.tree.max_leaf_id() + 1
