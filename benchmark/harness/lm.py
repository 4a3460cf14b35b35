"""The seeded bigram ARPA LM of the LVCSR configuration (a copy of
tests/torch_linear_tables.py's ``arpa_text``), and a plain reader that turns
its text into the search's word-boundary costs.

Imports NumPy only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

LN10 = math.log(10.0)


def arpa_text(words, seed: int = 0, bigram_share: float = 0.3) -> str:
    """A seeded bigram ARPA LM over ``words`` plus <s>, </s> and <unk>:
    every unigram with a back-off weight, and a random share of the
    bigrams (the rest back off)."""
    rng = np.random.default_rng(seed)
    vocab = ["<s>", "</s>", "<unk>"] + list(words)
    uni = rng.uniform(-4.0, -1.0, len(vocab))
    uni[0] = -99.0
    bows = rng.uniform(-1.0, 0.0, len(vocab))
    hist = ["<s>"] + list(words)
    pairs = [(h, w) for h in hist for w in list(words) + ["</s>"]
             if rng.uniform() < bigram_share]
    lines = ["\\data\\", f"ngram 1={len(vocab)}", f"ngram 2={len(pairs)}", "",
             "\\1-grams:"]
    lines += [f"{uni[i]:.6f} {w} {bows[i]:.6f}" for i, w in enumerate(vocab)]
    lines += ["", "\\2-grams:"]
    lines += [f"{rng.uniform(-3.0, -0.05):.6f} {h} {w}" for h, w in pairs]
    lines += ["", "\\end\\", ""]
    return "\n".join(lines)


def parse_bigram(text: str) -> Tuple[Dict[str, Tuple[float, float]], Dict[Tuple[str, str], float]]:
    """(unigram → (log10 p, log10 back-off), (history, word) → log10 p)."""
    uni: Dict[str, Tuple[float, float]] = {}
    bi: Dict[Tuple[str, str], float] = {}
    section = 0
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("\\") and line.endswith("-grams:"):
            section = int(line[1])
        elif line and section and not line.startswith("\\"):
            p = line.split()
            if section == 1:
                uni[p[1]] = (float(p[0]), float(p[2]) if len(p) > 2 else 0.0)
            else:
                bi[(p[1], p[2])] = float(p[0])
    return uni, bi


def boundary_costs(text: str, orth: List[str], silence: int, lm_scale: float,
                   word_exit: float, sil_exit: float):
    """lm [W, W] and lm_start [W]: entering word w after word v (after the
    sentence start) costs lm_scale · (−ln p(w | v)) plus the word's exit;
    silence is transparent and costs its exit only (its row is unused)."""
    uni, bi = parse_bigram(text)

    def cost(w: str, h: str) -> float:
        lp = bi.get((h, w))
        if lp is None:
            lp = uni[h][1] + uni[w][0]
        return -lp * LN10

    W = len(orth)
    lm, start = np.zeros((W, W)), np.zeros(W)
    for w in range(W):
        if w == silence:
            continue
        start[w] = lm_scale * cost(orth[w], "<s>") + word_exit
        for v in range(W):
            if v != silence:
                lm[v, w] = lm_scale * cost(orth[w], orth[v]) + word_exit
    lm[:, silence] = sil_exit
    start[silence] = sil_exit
    return lm, start
