"""Inputs with one NaN acoustic score, shared by tests/test_torch_cuda.py's
NaN tests and chip_smoke.py's NaN phase (which loads this file by path):
a word-loop lattice whose last word fills its P positions, seeded scores
with the NaN in utterance 0 mid-way through its frames, and the bit
comparison that counts a NaN equal to a NaN. Imports numpy, torch and the
port only."""

import numpy as np
import torch

from speechrecognition_torch.lexicon import Lexicon
from speechrecognition_torch.search.decoder import DecoderTables
from speechrecognition_torch.tdp import TdpModel

#: utterance lengths of the word-loop and bigram cases (frames: 40)
NAN_LENS = [40, 23, 0, 39]
#: the NaN's frame, in utterance 0
NAN_FRAME = 20


def nan_lexicon_tables(W, P, seed):
    """Silence plus W - 1 words of 2..P states with repetition 1, the last of
    P states (its last position is the lattice's last cell):
    (DecoderTables, number of states)."""
    rng = np.random.default_rng(seed)
    lex = Lexicon()
    lex.add_word("[silence]", P if W == 1 else 1, 1, silence=True)
    for w in range(W - 1):
        lex.add_word(f"w{w}", P if w == W - 2 else int(rng.integers(2, P + 1)), 1)
    tdp = TdpModel(silence_state=lex.silence_state, loop=2.0, forward=0.5, skip=9.0)
    tables = DecoderTables.build(lex, tdp, 15.0)
    assert tables.state_table.shape == (W, P) and tables.word_len[W - 1] == P
    return tables, lex.num_states


def nan_scores(tables, S, position, seed, frames=40):
    """Scores [len(NAN_LENS), frames, S] in [0, 40), float64, the state of
    the last word's ``position`` NaN in utterance 0 at frame NAN_FRAME."""
    W = tables.state_table.shape[0]
    am = np.random.default_rng(seed).uniform(0.0, 40.0, size=(len(NAN_LENS), frames, S))
    am[0, NAN_FRAME, tables.state_table[W - 1, position]] = np.nan
    return am


def same_bits(got, want):
    """Equal bit for bit, every NaN counted equal to a NaN (the card writes
    one NaN, and torch.equal holds a NaN unequal to itself)."""
    nan = torch.isnan(want) if want.is_floating_point() else torch.zeros_like(want, dtype=bool)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[want.dtype]
    zero = torch.zeros((), dtype=want.dtype, device=want.device)
    return torch.equal(torch.where(nan, zero, got).view(ints),
                       torch.where(nan, zero, want).view(ints))
