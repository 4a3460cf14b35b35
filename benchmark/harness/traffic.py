"""The one traffic generator: seeded corpora of spoken word strings and their
features, from a traffic mix's parameters and a configuration's lexicon and
model.

A mix file (``benchmark/traffic/<name>.json``) gives the utterance count, the
length distribution (a scaled beta between ``length_min`` and ``length_max``
with mean ``length_mean``, drawn once from ``sizes_seed``, so that every run
seed decodes the same set of lengths in another order), the words an
utterance speaks, the frames a state position lasts, the share of silences
between words, and the noise of a feature around its density's mean. A run
seed draws the order, the word strings, the durations, the densities and the
noise. Features are drawn as tests/torch_linear_tables.py's
``features_near_means`` draws them (a density of the frame's state, its mean
plus ``noise`` standard deviations of Gaussian noise), on the card with a
``torch.Generator``.

Imports NumPy and PyTorch only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .mixfile import Model


@dataclass
class Lexicon:
    """Word inventory as plain arrays: ``states[w]`` the global state of each
    position of word w; word ``silence`` is the silence."""

    orth: List[str]
    states: List[np.ndarray]
    silence: int

    @property
    def num_words(self) -> int:
        return len(self.states)


def lexicon_from_config(spec: dict, model: Model) -> Lexicon:
    """``kind`` "words": ``words`` lists (orth, states, repetitions), each
    word's states numbered after the previous word's (the SieTill lexicon,
    src/sietill/Lexicon.cpp:70-85). ``kind`` "tied": AN4's shape as
    tests/torch_linear_tables.py's ``an4_lexicon`` draws it (``num_words``
    words of 1-10 whole phones, 3 states a phone, and a silence of
    ``silence_positions`` classes of its own), but over the tied classes
    whose mixture the model trained (has a density), as a CART tree's
    leaves are."""
    if spec["kind"] == "words":
        orth, states, start = [], [], 0
        for name, n, reps in spec["words"]:
            orth.append(name)
            states.append(np.repeat(np.arange(start, start + n, dtype=np.int32), reps))
            start += n
        return Lexicon(orth, states, int(spec["silence"]))
    if spec["kind"] == "tied":
        rng = np.random.default_rng(spec["seed"])
        trained = np.nonzero(model.active.any(1))[0]
        phones = np.clip(1 + rng.poisson(spec["extra_phones_mean"], spec["num_words"]), 1,
                         spec["phones_max"])
        phones[0], phones[1] = spec["phones_max"], 1
        sil = trained[rng.integers(0, len(trained), spec["silence_positions"])].astype(np.int32)
        classes = np.setdiff1d(trained, sil)
        words = [classes[rng.integers(0, len(classes), int(3 * n))].astype(np.int32)
                 for n in phones]
        return Lexicon(["[SILENCE]"] + [f"W{i:03d}" for i in range(len(words))],
                       [sil] + words, 0)
    raise ValueError(f"unknown lexicon kind {spec['kind']!r}")


def fixed_lengths(mix: dict) -> np.ndarray:
    """The mix's utterance lengths in frames, the same for every run seed."""
    rng = np.random.default_rng(mix["sizes_seed"])
    lo, hi, mean, n = mix["length_min"], mix["length_max"], mix["length_mean"], mix["utterances"]
    m = (mean - lo) / (hi - lo)
    a = mix["length_shape"]
    u = rng.beta(a, a * (1 - m) / m, n)
    return np.round(lo + u * (hi - lo)).astype(np.int64)


@dataclass
class Corpus:
    """Features of a drawn corpus, flat, with offsets and the words spoken."""

    features: np.ndarray   # f32 [frames, dim]
    offsets: np.ndarray    # i64 [n + 1]
    words: List[List[int]]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def _frame_states(rng, lex: Lexicon, L: int, mix: dict, n_words: int, draws) -> tuple:
    """The state of each of L frames and the words spoken: silence, the words
    (silence between two words with the mix's share), silence."""
    words, sil_after, dur = draws
    sil = lex.states[lex.silence]
    keep = list(words[:n_words])
    while True:
        segs = [sil]
        for i, w in enumerate(keep):
            segs.append(lex.states[w])
            if i + 1 < len(keep) and sil_after[i]:
                segs.append(sil)
        segs.append(sil)
        n_sil = sum(s is sil for s in segs)
        speech = sum(len(s) for s in segs) - n_sil * len(sil)
        if speech + n_sil * len(sil) <= L or len(keep) == 1:
            break
        keep.pop()
    is_sil = np.concatenate([np.full(len(s), s is sil) for s in segs])
    states = np.concatenate(segs)
    d = np.ones(len(states), np.int64)
    d[~is_sil] = dur[: int((~is_sil).sum())]
    excess = int(d.sum()) - L
    while excess > 0 and (d[~is_sil] > 1).any():
        long_ = np.nonzero((d > 1) & ~is_sil)[0][:excess]
        d[long_] -= 1
        excess -= len(long_)
    spare = L - int(d.sum())
    if spare > 0:
        d[is_sil] += rng.multinomial(spare, np.full(int(is_sil.sum()), 1.0 / is_sil.sum()))
    return np.repeat(states, d)[:L], keep


def draw_corpus(seed: int, mix: dict, lex: Lexicon, model: Model, device,
                lengths: np.ndarray = None) -> Corpus:
    """A corpus of ``mix`` drawn from ``seed`` (``lengths`` defaults to the
    mix's fixed set, in an order drawn from the seed)."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = fixed_lengths(mix)
        lengths = lengths[rng.permutation(len(lengths))]
    n, kmax = len(lengths), mix["words_max"]
    pmax = max(len(s) for s in lex.states)
    n_words = rng.integers(mix["words_min"], kmax + 1, n)
    real = np.asarray([w for w in range(lex.num_words) if w != lex.silence])
    word_ids = real[rng.integers(0, len(real), (n, kmax))]
    sil_after = rng.uniform(size=(n, kmax)) < mix["silence_between"]
    durs = rng.integers(1, mix["max_duration"] + 1, (n, kmax * pmax))
    states, spoken = [], []
    for i, L in enumerate(lengths):
        s, w = _frame_states(rng, lex, int(L), mix, int(n_words[i]),
                             (word_ids[i], sil_after[i], durs[i]))
        states.append(s)
        spoken.append([int(x) for x in w])
    states = np.concatenate(states)

    # a density of each frame's mixture (any active density for a mixture
    # without one), then its mean plus Gaussian noise on the card
    S, D = model.active.shape
    n_act = model.active.sum(1)
    order = np.argsort(~model.active, axis=1, kind="stable")
    flat_active = np.nonzero(model.active.reshape(-1))[0]
    u = rng.uniform(size=len(states))
    pick = np.where(n_act[states] > 0,
                    states * D + order[states, np.minimum((u * n_act[states]).astype(np.int64),
                                                          np.maximum(n_act[states] - 1, 0))],
                    flat_active[(u * len(flat_active)).astype(np.int64) % len(flat_active)])
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    idx = torch.as_tensor(pick, device=dev)
    mu = torch.as_tensor(model.means.reshape(S * D, -1), dtype=torch.float32, device=dev)
    sd = torch.as_tensor(np.sqrt(model.variances.reshape(S * D, -1)), dtype=torch.float32,
                         device=dev)
    noise = torch.randn((len(states), model.dim), generator=gen, device=dev)
    x = mu[idx] + float(mix["noise"]) * sd[idx] * noise
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    return Corpus(x.cpu().numpy(), offsets, spoken)
