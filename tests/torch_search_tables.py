"""Inputs shared by the search tier's CPU tests, its card tests and
chip_smoke.py: lexica whose words share prefixes (so the prefix tree has
depth-1 and depth-2 nodes with several children, word ends inside the tree
and homophones), the tables every scan reads, and random bigram LMs.

A plain module (no pytest, no jax), so chip_smoke.py loads it by path and
the tests import it from tests/. The lexica are duck-typed (num_words,
silence_idx, silence_state, get_automaton_for_word), which both packages'
TreeTables.build take.
"""

import json
from pathlib import Path

import numpy as np
import torch

from speechrecognition_torch.lexicon import Lexicon
from speechrecognition_torch.search.decoder import BIG, DecoderTables
from speechrecognition_torch.search.tree_decoder import TreeTables
from speechrecognition_torch.search.wcts import LookaheadTables, WctsTables
from speechrecognition_torch.tdp import TdpModel


class _Automaton:
    def __init__(self, states):
        self.states = np.asarray(states, np.int32)


class PrefixLexicon:
    """``num_words`` words; word 0 is a one-state silence (state 0). The
    others have 2..max_len states, position k drawn from ``branch`` states of
    its own (1 + k*branch + j), so words share prefixes; a state may repeat,
    and every tenth word is a prefix of an earlier one (a word end inside
    the tree) or a copy of one (a homophone)."""

    def __init__(self, num_words: int, seed: int, max_len: int = 12, branch: int = 3):
        rng = np.random.default_rng(seed)
        self.silence_idx = 0
        self.silence_state = 0
        self.num_states = 1 + max_len * branch
        words = [[0]]
        while len(words) < num_words:
            w = len(words)
            if w % 10 == 5 and len(words) > 2:
                src = words[int(rng.integers(1, len(words)))]
                words.append(list(src[:max(1, len(src) - 1)]) if w % 20 == 5 else list(src))
                continue
            L = int(rng.integers(2, max_len + 1))
            seq = []
            for k in range(L):
                if seq and rng.random() < 0.2:
                    seq.append(seq[-1])                      # a repeated state
                else:
                    seq.append(1 + len(seq) * branch + int(rng.integers(0, branch)))
                if len(seq) >= max_len:
                    break
            words.append(seq)
        self._words = [_Automaton(s) for s in words]

    @property
    def num_words(self) -> int:
        return len(self._words)

    def get_automaton_for_word(self, w: int):
        return self._words[w]


def prefix_tdp(lex) -> TdpModel:
    return TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)


def random_lm(W: int, seed: int, silence: int = 0):
    """A [W, W] bigram matrix and a [W] start row of −log scores (silence
    free to enter, as the demo LM)."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(0.0, 25.0, size=(W, W))
    lm[:, silence] = 0.0
    return lm, rng.uniform(0.0, 25.0, size=W)


def wcts_inputs(lex, tdp, lm, lm_start, lookahead: bool, word_penalty: float = 0.0):
    """(TreeTables, WctsTables) for a lexicon and an LM."""
    tables = TreeTables.build(lex, tdp, word_penalty)
    la = LookaheadTables.build(tables) if lookahead else None
    return tables, WctsTables.build(tables, tdp, lm, lm_start, la)


def repetition1_lexicon(seed: int = 11, words: int = 7) -> Lexicon:
    """A linear lexicon with one position a state (entries at depth 2 land in
    the word's second state, not its first)."""
    rng = np.random.default_rng(seed)
    lex = Lexicon()
    lex.add_word("[silence]", 1, 1, silence=True)
    for w in range(words):
        lex.add_word(f"w{w}", int(rng.integers(2, 13)), 1)
    return lex


def wide_linear_tables(words: int, states: int, reps: int):
    """DecoderTables of a linear lexicon of ``words`` words, each of
    ``states`` states repeated ``reps`` times (a lattice of words x
    states*reps slots), and its number of states."""
    lex = Lexicon()
    lex.add_word("[silence]", 1, 1, silence=True)
    for w in range(words - 1):
        lex.add_word(f"w{w}", states, reps)
    tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    return DecoderTables.build(lex, tdp, 0.0), lex.num_states


#: states of random_tree's scores
TREE_STATES = 23


def random_tree(N: int, seed: int, ties: bool = False) -> TreeTables:
    """An N-node prefix tree built directly as arrays from a seed (kernel I's
    edge cases; node 0 the root). A node's parent is mostly the node before
    it (chains), else an earlier node; depth, grandparent and the root's row
    follow TreeTables.build's rules (the root BIG and never looping). Leaves
    and every seventh inner node end a word; every ninth node from 5 on is a
    homophone: a copy of the node before it (same parent, state, TDPs and
    exit penalty), both ending words, so the two always tie and the first
    node must win. ``ties``: zero TDPs and exit penalties of 0 or 1
    (integer scores then tie across skip, forward and loop)."""
    rng = np.random.default_rng(seed)
    parent = np.zeros(N, np.int32)
    depth = np.zeros(N, np.int32)
    state = rng.integers(0, TREE_STATES, size=N).astype(np.int32)
    state[0] = 0
    tdp = np.zeros((N, 3)) if ties else rng.uniform(0.0, 6.0, size=(N, 3))
    loop_allowed = rng.random(N) < 0.8
    copy = np.zeros(N, bool)
    for n in range(1, N):
        if n % 9 == 5:
            copy[n] = True
            parent[n], state[n], tdp[n] = parent[n - 1], state[n - 1], tdp[n - 1]
            loop_allowed[n] = loop_allowed[n - 1]
        else:
            parent[n] = n - 1 if rng.random() < 0.7 else int(rng.integers(0, n))
        depth[n] = depth[parent[n]] + 1
    tdp[0] = BIG
    loop_allowed[0] = False
    has_children = np.zeros(N, bool)
    has_children[parent[1:]] = True
    ends = np.flatnonzero(~has_children | (np.arange(N) % 7 == 3) | copy | np.roll(copy, -1))
    ends = ends[ends > 0]
    end_word = np.full(N, -1, np.int32)
    end_word[ends] = np.arange(len(ends), dtype=np.int32)
    pen = (rng.integers(0, 2, size=N).astype(np.float64) if ties
           else rng.uniform(0.0, 20.0, size=N))
    pen[copy] = pen[np.flatnonzero(copy) - 1]
    exit_penalty = np.where(end_word >= 0, pen, 0.0)
    return TreeTables(state=state, parent=parent, grand=parent[parent], depth=depth, tdp=tdp,
                      loop_allowed=loop_allowed, end_word=end_word, exit_penalty=exit_penalty,
                      num_nodes=N, num_words=max(len(ends), 1))


def tree_scores(B: int, T: int, seed: int, ties: bool = False, dtype=torch.float64,
                device="cpu"):
    """Scores [B, T, TREE_STATES] for random_tree: uniform in [0, 40), or
    with ``ties`` integers 0, 1 and 2."""
    rng = np.random.default_rng(seed)
    am = (rng.integers(0, 3, size=(B, T, TREE_STATES)).astype(np.float64) if ties
          else rng.uniform(0.0, 40.0, size=(B, T, TREE_STATES)))
    return torch.as_tensor(am, dtype=dtype, device=device)


def am_scores(B: int, T: int, S: int, seed: int, dtype=torch.float64, device="cpu"):
    """Random acoustic scores [B, T, S] in [0, 40)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.0, 40.0, size=(B, T, S)), dtype=dtype, device=device)


REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
#: the golden demo decode's settings (demo_recognition.json: iter-2.mix, TDP
#: 3-0-30, word penalty 80, threshold 200)
DEMO_SETTINGS = {"am-threshold": 200.0, "word-penalty": 80.0, "pruned-search": True,
                 "max-recognition-runs": 10000}


def demo_setup():
    """The port's SieTill lexicon, the 35-utterance demo corpus
    (tests/fixtures), the demo TDPs and iter-2.mix."""
    from speechrecognition_torch.corpus import Corpus, CorpusDescription
    from speechrecognition_torch.features.frontend import SignalAnalysisConfig
    from speechrecognition_torch.io import read_mixture_set
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.models import gmm
    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(str(FIXTURES / "demo_corpus.json"), lex)
    corpus = Corpus.read(desc, str(FIXTURES / "demo_features") + "/", SignalAnalysisConfig(),
                         normalization_path=str(FIXTURES / "normalization-demo.bin"),
                         use_native=False)
    tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    model = gmm.MixtureModel.from_raw(read_mixture_set(str(FIXTURES / "iter-2.mix"), 25),
                                      gmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    return lex, corpus, tdp, model


def demo_bigram_lm():
    """tests/fixtures/demo_bigram_lm.json: (lm [12, 12], lm_start [12]) in
    float64, CountLM(order=2) on the demo transcripts, scale 8."""
    with open(FIXTURES / "demo_bigram_lm.json") as f:
        d = json.load(f)
    return np.asarray(d["lm"], np.float64), np.asarray(d["lm_start"], np.float64)


def uniform_lm(lex, word_penalty: float = 80.0):
    """The zerogram LM: every word costs the word penalty, silence nothing."""
    W = lex.num_words
    lm = np.full((W, W), word_penalty)
    lm[:, lex.silence_idx] = 0.0
    return lm, lm[0].copy()
