"""Kernel M (csrc/linear_lvcsr_scan.cu): the linear-lexicon bigram scan in
float32. Per real frame of an utterance: per live (word, position) slot and
silence-copy slot five adds and seven compares; per (predecessor, word) pair
the min-plus product's add and compare; per word end and silence-copy end
four. Bytes: the scores read once and the per-frame books written."""

NAMES = ("linear_scan",)
PEAK = "fp32"
SLOT_OPS, PAIR_OPS, END_OPS = 12, 2, 4


def count(work):
    if not {"frames", "word_len", "silence_positions", "mixtures"} <= work.keys():
        return None
    n, wl, Ps, S = work["frames"], work["word_len"], work["silence_positions"], work["mixtures"]
    W = len(wl)
    V = W + 1
    ops = n * ((sum(wl) + V * Ps) * SLOT_OPS + V * W * PAIR_OPS + (W + V) * END_OPS)
    nbytes = n * (4 * S + W * (4 + 4 + 4 + 1) + V * (4 + 4 + 4) + 4)
    return ops, nbytes
