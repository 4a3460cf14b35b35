"""Kernel K (csrc/wcts_scan.cu): the word-conditioned tree search with LM
lookahead in float32, both instances. The work any exact implementation of
this pruned search must do, per real frame of an utterance: per hypothesis
alive after pruning (the statistics' ``active_states``) the recursion's
three transition adds, its two compares, the emission's add, the compare
with the entry, the renormalising subtract and the frame minimum's compare,
and the lookahead's add and compare; per live word end (``word_ends``) the
``lm_ext`` add and the recombination compare. Bytes: the frame's score row
read, and each live hypothesis's score and backpointer read and written
once. The dense C × N slots are not counted: a design that skips the
pruned ones does less work, not more."""

NAMES = ("wcts_scan_kernel", "wcts_owner_kernel")
PEAK = "fp32"
LIVE_OPS, END_OPS = 11, 2
LIVE_BYTES = 2 * (4 + 4)


def count(work):
    if not {"frames", "mixtures", "active_states", "word_ends"} <= work.keys():
        return None
    n, S = work["frames"], work["mixtures"]
    live, ends = work["active_states"], work["word_ends"]
    return live * LIVE_OPS + ends * END_OPS, n * 4 * S + live * LIVE_BYTES
