"""Time-synchronous word-loop Viterbi decoder over a dense (word, position)
lattice — counterpart of speechrecognition_tpu/search/decoder.py.

The reference decoder (src/sietill/Recognizer.cpp:103-232) walks per-frame
hypothesis arrays indexed (word, in-word position) with threshold pruning,
word-entry expansion from the best word-end of the previous frame, and a
per-frame traceback of the best ending word. Because pruning is
threshold-only, a *dense masked lattice* reproduces it exactly:

    hyp[b, w, s]  — best path score ending at frame t in position s of word w
    book[t, b]    — best word-END at frame t (score, word, start frame)

One time chunk of that recursion is ``decode_scan`` (float32 or float64
scores): on CUDA tensors it launches the hand-written kernel
``csrc/decode_scan.cu`` (kernel B), on CPU tensors it runs the plain
PyTorch version ``decode_scan_reference``. Both follow the reference's
``_decode_scan`` step for step, including its tie-breaking (larger jumps win
within-word ties, entries win ties against within-word hypotheses, word ends
resolve to the smallest word index) and its entry emission rule: an entry
into position 0 or 1 is charged the acoustic score of the ENTERED position's
state.

The production path scores in double-float (``decode_batch_df``): every
path score is a (hi, lo) float32 pair (ops/doublefloat.py) with exact
comparisons, reproducing the reference's float64 decisions.
``decode_scan_df`` launches kernel D (``csrc/decode_scan_df.cu``) on CUDA
tensors and runs ``decode_scan_df_reference`` on CPU tensors; both follow
the reference's ``_decode_scan_df``, whose entries are charged the word's
FIRST state (the two rules agree wherever positions 0 and 1 share a state,
as in SieTill, and differ on repetition-1 lexica).

The unpruned variant (Recognizer.cpp:234-328) differs in two ways — no
pruning, and a word's last position may loop within the word — exposed via
``prune``/``exclude_last_pred``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..config import (Configuration, Parameter, ParameterBool, ParameterFloat,
                      ParameterInt)
from ..lexicon import Lexicon
from ..tdp import TdpModel
from ..models import gmm as gmm_mod
from ..ops import _native
from ..ops import doublefloat as dfm

BIG = np.float64(1e30)


@dataclass
class DecoderTables:
    """Static lexicon/TDP tables for the dense (word, position) lattice."""

    state_table: np.ndarray   # int32 [W, P] global state per slot
    word_len: np.ndarray      # int32 [W]
    last_pos: np.ndarray      # int32 [W]
    first_state: np.ndarray   # int32 [W]
    tdp_within: np.ndarray    # f64 [W, P, 3] penalty into slot s via jump j (BIG=invalid)
    entry_pen: np.ndarray     # f64 [W, 2] word-penalty + entry TDP (BIG=invalid)
    num_words: int
    max_pos: int
    #: f64 [W] penalty charged when *leaving* a word's last state (Sprint's
    #: per-state-type exit TDP, Am/TransitionModel.hh:64-76). None for the
    #: SieTill semantics where the word penalty is charged at entry instead.
    exit_pen: Optional[np.ndarray] = None

    @staticmethod
    def build(lexicon: Lexicon, tdp: TdpModel, word_penalty,
              exclude_last_pred: bool = True) -> "DecoderTables":
        """word_penalty: scalar (silence exempt, reference semantics) or a
        per-word array [W] (e.g. Sprint exit penalties per state type)."""
        W, P = lexicon.num_words, lexicon.max_positions
        state_table = lexicon.state_table()
        word_len = lexicon.word_lengths()
        last_pos = word_len - 1
        first_state = state_table[:, 0].copy()

        tdp_target = tdp.table_for_states(state_table)  # [W, P, 3]
        tdp_within = np.full((W, P, 3), float(BIG))
        s = np.arange(P)[None, :]
        for j in range(3):
            p = s - j
            valid = (p >= 0) & (s < word_len[:, None])
            if exclude_last_pred:
                valid &= (p != last_pos[:, None])
            tdp_within[:, :, j] = np.where(valid, tdp_target[:, :, j], float(BIG))

        if np.isscalar(word_penalty):
            wp_vec = np.where(np.arange(W) == lexicon.silence_idx,
                              0.0, float(word_penalty))
        else:
            wp_vec = np.asarray(word_penalty, dtype=np.float64)
        entry_pen = np.full((W, 2), float(BIG))
        for w in range(W):
            for init_state in range(2):
                if init_state < word_len[w]:
                    entry_pen[w, init_state] = wp_vec[w] + tdp.score(
                        int(first_state[w]), init_state + 1)
        return DecoderTables(state_table=state_table, word_len=word_len,
                             last_pos=last_pos, first_state=first_state,
                             tdp_within=tdp_within, entry_pen=entry_pen,
                             num_words=W, max_pos=P)


Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _init_carry(B: int, W: int, P: int, dtype: torch.dtype, device) -> Carry:
    return (torch.full((B, W, P), float(BIG), dtype=dtype, device=device),
            torch.zeros((B, W, P), dtype=torch.int32, device=device),
            torch.zeros((B,), dtype=dtype, device=device))


def decode_scan_reference(am: torch.Tensor, feat_len: torch.Tensor,
                          state_table: torch.Tensor, last_pos: torch.Tensor,
                          word_len: torch.Tensor, first_state: torch.Tensor,
                          tdp_within: torch.Tensor, entry_pen: torch.Tensor,
                          am_threshold, prune: bool = True,
                          carry_in: Optional[Carry] = None, t0: int = 0,
                          exit_pen: Optional[torch.Tensor] = None,
                          ) -> Tuple[Carry, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of ``decode_scan``, one frame per loop step
    (any float dtype, any device). Same contract as ``decode_scan``."""
    B, T, S = am.shape
    dtype, device = am.dtype, am.device
    W, P = state_table.shape
    big = torch.tensor(float(BIG), dtype=dtype, device=device)
    half_big = big * 0.5

    st = state_table.to(device=device, dtype=torch.long)
    lp = last_pos.to(device=device, dtype=torch.long)
    tdpw = tdp_within.to(device=device, dtype=dtype)       # [W, P, 3]
    entp = entry_pen.to(device=device, dtype=dtype)        # [W, 2]
    xpen = None if exit_pen is None else exit_pen.to(device=device, dtype=dtype)
    thr = torch.tensor(float(am_threshold), dtype=dtype, device=device)
    lens = feat_len.to(device)
    slot_valid = (torch.arange(P, device=device)[None, :]
                  < word_len.to(device)[:, None])          # [W, P]
    words_idx = torch.arange(W, device=device)

    hyp, bkp, book = (carry_in if carry_in is not None
                      else _init_carry(B, W, P, dtype, device))
    big_col = big.expand(B, W, 1)
    big_tail = big.expand(B, W, P - 2)
    zero_bkp = torch.zeros((B, W, 2), dtype=torch.int32, device=device)

    scores, words, bkps = [], [], []
    for i in range(T):
        t = t0 + i + 1                                     # 1-based frame
        ams = am[:, i][:, st]                              # [B, W, P]
        # within-word 0-1-2 recursion (shift along the position axis)
        c0 = hyp + tdpw[None, :, :, 0]
        c1 = torch.cat([big_col, hyp[:, :, :-1] + tdpw[None, :, 1:, 1]], dim=2)
        c2 = torch.cat([big_col, big_col, hyp[:, :, :-2] + tdpw[None, :, 2:, 2]], dim=2)
        b0 = torch.cat([zero_bkp[:, :, :1], bkp[:, :, :-1]], dim=2)
        b00 = torch.cat([zero_bkp, bkp[:, :, :-2]], dim=2)
        # larger jumps win ties (first writer in ascending predecessor scan)
        within, wbkp = c2, b00
        for c, b in ((c1, b0), (c0, bkp)):
            take = c < within
            within = torch.where(take, c, within)
            wbkp = torch.where(take, b, wbkp)
        within = within + ams

        # word entry into positions {0, 1}, charged the entered state's score
        entry = (book[:, None, None] + entp[None, :, :]) + ams[:, :, :2]
        entry = torch.cat([entry, big_tail], dim=2)

        take_entry = entry <= within                       # entries win ties
        new = torch.where(take_entry, entry, within)
        new_bkp = torch.where(take_entry, torch.tensor(t - 1, dtype=torch.int32,
                                                       device=device), wbkp)
        new = torch.where(slot_valid[None, :, :], new, big)
        new = torch.minimum(new, big)

        # renormalize by the per-frame best (a shared offset: decisions are
        # invariant, and the f32 carry stays O(threshold))
        best = new.amin(dim=(1, 2), keepdim=True)
        best = torch.where(best >= half_big, torch.zeros_like(best), best)
        new = torch.where(new >= half_big, big, new - best)
        if prune:
            new = torch.where(new > thr, big, new)

        # traceback: best word end, the smallest word index winning ties
        end_scores = new[:, words_idx, lp]                 # [B, W]
        if xpen is not None:
            end_scores = end_scores + xpen[None, :]
        end_bkp = new_bkp[:, words_idx, lp]
        # (the first NaN where one ends a word, as jnp.argmin takes it)
        least = end_scores.amin(dim=1, keepdim=True)
        is_min = (end_scores == least) | (end_scores.isnan() & least.isnan())
        book_word = torch.where(is_min, words_idx, W).amin(dim=1)
        book_score = end_scores.gather(1, book_word[:, None])[:, 0]
        book_bkp = end_bkp.gather(1, book_word[:, None])[:, 0]
        book_score = torch.where(book_score >= half_big, big, book_score)

        # freeze utterances that already ended
        alive = t <= lens                                  # [B]
        hyp = torch.where(alive[:, None, None], new, hyp)
        bkp = torch.where(alive[:, None, None], new_bkp, bkp)
        book = torch.where(alive, book_score, book)
        scores.append(book_score)
        words.append(book_word.to(torch.int32))
        bkps.append(book_bkp)
    return (hyp, bkp, book), (torch.stack(scores), torch.stack(words),
                              torch.stack(bkps))


def decode_scan(am: torch.Tensor, feat_len: torch.Tensor,
                state_table: torch.Tensor, last_pos: torch.Tensor,
                word_len: torch.Tensor, first_state: torch.Tensor,
                tdp_within: torch.Tensor, entry_pen: torch.Tensor,
                am_threshold, prune: bool = True,
                carry_in: Optional[Carry] = None, t0: int = 0,
                exit_pen: Optional[torch.Tensor] = None,
                ) -> Tuple[Carry, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One time chunk of the word-loop Viterbi.

    am [B, T, S]; feat_len int32 [B]; tables as in DecoderTables (as
    tensors). Returns (carry_out, (score [T, B], word [T, B], bkp [T, B]))
    covering frames t0+1..t0+T (output index i ↔ frame t0+i+1); the carry
    (hyp [B, W, P], bkp int32 [B, W, P], book [B]) streams long utterances
    through fixed-length chunks.

    CPU tensors take the plain version; CUDA tensors launch kernel B
    (float32 or float64; counted in ``decode_scan.LAUNCHES``), whose C entry
    chooses its instance from the lattice's shape alone
    (``sr_decode_scan_instance``: the warp instance for W, P <= 32, else
    the block instance): any [W, P] with P >= 2 is taken, as the reference
    takes it (it builds a [B, W, P - 2] tail). Launches whose lattice lives
    in device scratch (W*P > 1024) are also counted in
    ``SCRATCH_LAUNCHES``."""
    if am.device.type == "cpu":
        return decode_scan_reference(am, feat_len, state_table, last_pos,
                                     word_len, first_state, tdp_within,
                                     entry_pen, am_threshold, prune=prune,
                                     carry_in=carry_in, t0=t0, exit_pen=exit_pen)
    if am.device.type != "cuda":
        raise ValueError(f"decode_scan: unsupported device {am.device}")
    if am.dtype not in _SCAN_ENTRY:
        raise TypeError(f"decode_scan: the CUDA kernel runs float32 or float64, "
                        f"got {am.dtype}")
    dtype = am.dtype
    if am.dim() != 3 or not am.is_contiguous():
        raise ValueError("decode_scan: am must be a contiguous [B, T, S] tensor")
    B, T, S = am.shape
    W, P = state_table.shape
    if P < 2:
        raise ValueError(f"decode_scan: a lattice of {P} position(s); the scan needs 2 or more")
    device = am.device
    tables = {"feat_len": feat_len, "state_table": state_table,
              "last_pos": last_pos, "word_len": word_len,
              "tdp_within": tdp_within, "entry_pen": entry_pen}
    if exit_pen is not None:
        tables["exit_pen"] = exit_pen
    for name, t in tables.items():
        if t.device != device:
            raise ValueError(f"decode_scan: {name} on {t.device}, am on {device}")
    # the kernel indexes am and its shared word-end table with these
    if bool((state_table.min() < 0) | (state_table.max() >= S)
            | (last_pos.min() < 0) | (last_pos.max() >= P)):
        raise ValueError(f"decode_scan: state_table outside [0, {S}) or "
                         f"last_pos outside [0, {P})")
    # the tables in the kernel's types (the reference casts them the same way)
    i32 = {k: tables[k].to(torch.int32).contiguous()
           for k in ("feat_len", "state_table", "last_pos", "word_len")}
    tdpw = tdp_within.to(dtype).contiguous()
    entp = entry_pen.to(dtype).contiguous()
    xpen = None if exit_pen is None else exit_pen.to(dtype).contiguous()
    for name, t, shape in (("feat_len", i32["feat_len"], (B,)),
                           ("last_pos", i32["last_pos"], (W,)),
                           ("word_len", i32["word_len"], (W,)),
                           ("tdp_within", tdpw, (W, P, 3)),
                           ("entry_pen", entp, (W, 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"decode_scan: {name} has shape {tuple(t.shape)}, expected {shape}")
    if xpen is not None and tuple(xpen.shape) != (W,):
        raise ValueError(f"decode_scan: exit_pen has shape {tuple(xpen.shape)}, expected {(W,)}")

    hyp, bkp, book = (carry_in if carry_in is not None
                      else _init_carry(B, W, P, dtype, device))
    for name, t, shape, dt in (("hyp", hyp, (B, W, P), dtype),
                               ("bkp", bkp, (B, W, P), torch.int32),
                               ("book", book, (B,), dtype)):
        if t.device != device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"decode_scan: carry {name} must be a contiguous "
                             f"{dt} {shape} tensor on {device}")

    hyp_out = torch.empty_like(hyp)
    bkp_out = torch.empty_like(bkp)
    book_out = torch.empty_like(book)
    score = torch.empty((T, B), dtype=dtype, device=device)
    word = torch.empty((T, B), dtype=torch.int32, device=device)
    wbkp = torch.empty((T, B), dtype=torch.int32, device=device)
    thr = float(torch.tensor(float(am_threshold), dtype=dtype))
    lib = _native.load()
    # the block instance past 1,024 slots keeps the lattice in device
    # memory: two buffers of scores, then two of int32 backpointers
    scratch = (torch.empty(2 * B * W * P * (hyp.element_size() + 4), dtype=torch.uint8,
                           device=device)
               if lib.sr_decode_scan_instance(W, P) < 0 else None)
    err = getattr(lib, _SCAN_ENTRY[dtype])(
        am.data_ptr(), i32["feat_len"].data_ptr(), i32["state_table"].data_ptr(),
        i32["last_pos"].data_ptr(), i32["word_len"].data_ptr(), tdpw.data_ptr(),
        entp.data_ptr(), None if xpen is None else xpen.data_ptr(),
        hyp.data_ptr(), bkp.data_ptr(), book.data_ptr(), hyp_out.data_ptr(),
        bkp_out.data_ptr(), book_out.data_ptr(), score.data_ptr(),
        word.data_ptr(), wbkp.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, T, S, W, P, int(t0), thr,
        int(bool(prune)), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "decode_scan")
    decode_scan.LAUNCHES += 1
    decode_scan.SCRATCH_LAUNCHES += scratch is not None
    return (hyp_out, bkp_out, book_out), (score, word, wbkp)


decode_scan.LAUNCHES = decode_scan.SCRATCH_LAUNCHES = 0

#: kernel B's C entry point for each score type
_SCAN_ENTRY = {torch.float32: "sr_decode_scan", torch.float64: "sr_decode_scan_f64"}

CarryDF = Tuple[dfm.DF, torch.Tensor, dfm.DF]


def _init_carry_df(B: int, W: int, P: int, device) -> CarryDF:
    """hyp = (BIG, 0), bkp = 0, book = (0, 0), as decode_batch_df starts."""
    zeros = torch.zeros((B, W, P), dtype=torch.float32, device=device)
    return (dfm.DF(torch.full((B, W, P), float(BIG), dtype=torch.float32,
                              device=device), zeros),
            torch.zeros((B, W, P), dtype=torch.int32, device=device),
            dfm.DF(torch.zeros((B,), dtype=torch.float32, device=device),
                   torch.zeros((B,), dtype=torch.float32, device=device)))


def decode_scan_df_reference(am: dfm.DF, feat_len: torch.Tensor,
                             state_table: torch.Tensor, last_pos: torch.Tensor,
                             word_len: torch.Tensor, first_state: torch.Tensor,
                             tdp: dfm.DF, entry: dfm.DF, am_threshold,
                             prune: bool = True,
                             carry_in: Optional[CarryDF] = None, t0: int = 0,
                             ) -> Tuple[CarryDF, Tuple[torch.Tensor, torch.Tensor,
                                                       torch.Tensor]]:
    """Plain PyTorch version of ``decode_scan_df``, one frame per loop step
    (any device), following the reference's ``_decode_scan_df`` op by op.
    Same contract as ``decode_scan_df``."""
    dfm.require_f32("decode_scan_df", am.hi, am.lo, tdp.hi, tdp.lo,
                    entry.hi, entry.lo)
    B, T, S = am.hi.shape
    device = am.hi.device
    W, P = state_table.shape
    big = float(np.float32(BIG))
    half_big = big * 0.5          # exact in float32 and in float64
    thr = dfm.df(float(np.float32(am_threshold)), device=device)

    st = state_table.to(device=device, dtype=torch.long)
    fs = first_state.to(device=device, dtype=torch.long)
    lp = last_pos.to(device=device, dtype=torch.long)
    lens = feat_len.to(device)
    slot_valid = (torch.arange(P, device=device)[None, :]
                  < word_len.to(device)[:, None])          # [W, P]

    def dfull(shape, hi_val=0.0):
        return dfm.DF(torch.full(shape, hi_val, dtype=torch.float32, device=device),
                      torch.zeros(shape, dtype=torch.float32, device=device))

    def shift(x: dfm.DF, k: int, tdp_j: dfm.DF) -> dfm.DF:
        """hyp shifted k positions right along P, plus the jump-k TDP
        (tdp_j covers target slots k..P-1)."""
        if k == 0:
            return dfm.add(x, dfm.DF(tdp_j.hi[None], tdp_j.lo[None]))
        moved = dfm.add(dfm.DF(x.hi[:, :, :-k], x.lo[:, :, :-k]),
                        dfm.DF(tdp_j.hi[None], tdp_j.lo[None]))
        pad = dfull((B, W, k), big)
        return dfm.DF(torch.cat([pad.hi, moved.hi], dim=2),
                      torch.cat([pad.lo, moved.lo], dim=2))

    if carry_in is None:
        carry_in = _init_carry_df(B, W, P, device)
    hyp, bkp, book_prev = carry_in
    zero_bkp = torch.zeros((B, W, P), dtype=torch.int32, device=device)
    bigdf = dfull((B, W, P), big)
    bigb = dfull((B,), big)
    padP = dfull((B, W, P - 2), big)
    thr_full = dfm.DF(thr.hi.expand(B, W, P), thr.lo.expand(B, W, P))
    tdp0 = dfm.DF(tdp.hi[:, :, 0], tdp.lo[:, :, 0])
    tdp1 = dfm.DF(tdp.hi[:, 1:, 1], tdp.lo[:, 1:, 1])
    tdp2 = dfm.DF(tdp.hi[:, 2:, 2], tdp.lo[:, 2:, 2])
    entp = dfm.DF(entry.hi[None], entry.lo[None])           # [1, W, 2]

    scores, words, bkps = [], [], []
    for i in range(T):
        t = t0 + i + 1                                     # 1-based frame
        am_t = dfm.DF(am.hi[:, i], am.lo[:, i])            # [B, S]
        ams = dfm.DF(am_t.hi[:, st], am_t.lo[:, st])       # [B, W, P]
        c0 = shift(hyp, 0, tdp0)
        c1 = shift(hyp, 1, tdp1)
        c2 = shift(hyp, 2, tdp2)
        b0 = torch.cat([zero_bkp[:, :, :1], bkp[:, :, :-1]], dim=2)
        b00 = torch.cat([zero_bkp[:, :, :2], bkp[:, :, :-2]], dim=2)
        # larger jumps win ties (first writer in ascending predecessor scan)
        within, wbkp = c2, b00
        for c, b in ((c1, b0), (c0, bkp)):
            take = dfm.less(c, within)
            within = dfm.where(take, c, within)
            wbkp = torch.where(take, b, wbkp)
        within = dfm.add(within, ams)

        # word entry into positions {0, 1}, charged the FIRST state's score
        am_first = dfm.DF(am_t.hi[:, fs], am_t.lo[:, fs])  # [B, W]
        entry2 = dfm.add(
            dfm.add(dfm.DF(book_prev.hi[:, None, None], book_prev.lo[:, None, None]),
                    entp),
            dfm.DF(am_first.hi[:, :, None], am_first.lo[:, :, None]))
        ent = dfm.DF(torch.cat([entry2.hi, padP.hi], dim=2),
                     torch.cat([entry2.lo, padP.lo], dim=2))

        take_entry = dfm.less_equal(ent, within)           # entries win ties
        new = dfm.where(take_entry, ent, within)
        new_bkp = torch.where(take_entry, torch.tensor(t - 1, dtype=torch.int32,
                                                       device=device), wbkp)
        new = dfm.where(slot_valid[None, :, :], new, bigdf)
        new = dfm.where(new.hi >= big, bigdf, new)

        # renormalize by the per-frame best (shared offset: decisions
        # invariant, carry magnitude stays O(threshold))
        best = dfm.min_axis(new, (1, 2))
        dead = best.hi >= half_big
        best = dfm.DF(torch.where(dead, 0.0, best.hi)[:, None, None],
                      torch.where(dead, 0.0, best.lo)[:, None, None])
        shifted = dfm.sub(new, dfm.DF(best.hi.expand(B, W, P), best.lo.expand(B, W, P)))
        new = dfm.where(new.hi >= half_big, bigdf, shifted)

        if prune:
            new = dfm.where(~dfm.less_equal(new, thr_full), bigdf, new)

        # traceback: the first word index attaining the lexicographic minimum
        end = dfm.DF(new.hi[:, torch.arange(W, device=device), lp],
                     new.lo[:, torch.arange(W, device=device), lp])      # [B, W]
        end_bkp = new_bkp[:, torch.arange(W, device=device), lp]
        m = dfm.min_axis(end, 1)
        is_best = (end.hi == m.hi[:, None]) & (end.lo == m.lo[:, None])
        book_word = torch.argmax(is_best.to(torch.uint8), dim=1)
        book_score = dfm.DF(end.hi.gather(1, book_word[:, None])[:, 0],
                            end.lo.gather(1, book_word[:, None])[:, 0])
        book_bkp = end_bkp.gather(1, book_word[:, None])[:, 0]
        book_score = dfm.where(book_score.hi >= half_big, bigb, book_score)

        # freeze utterances that already ended
        alive = t <= lens                                  # [B]
        hyp = dfm.where(alive[:, None, None], new, hyp)
        bkp = torch.where(alive[:, None, None], new_bkp, bkp)
        book_prev = dfm.where(alive, book_score, book_prev)
        scores.append(book_score.hi)
        words.append(book_word.to(torch.int32))
        bkps.append(book_bkp)
    return (hyp, bkp, book_prev), (torch.stack(scores), torch.stack(words),
                                   torch.stack(bkps))


def decode_scan_df(am: dfm.DF, feat_len: torch.Tensor,
                   state_table: torch.Tensor, last_pos: torch.Tensor,
                   word_len: torch.Tensor, first_state: torch.Tensor,
                   tdp: dfm.DF, entry: dfm.DF, am_threshold, prune: bool = True,
                   carry_in: Optional[CarryDF] = None, t0: int = 0,
                   ) -> Tuple[CarryDF, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """One time chunk of the double-float word-loop Viterbi.

    am DF [B, T, S]; feat_len int32 [B]; the lexicon tables as in
    DecoderTables; tdp DF [W, P, 3] and entry DF [W, 2] are the float64
    tables split on the host (``dfm.from_f64``). Returns (carry_out,
    (score hi [T, B], word [T, B], bkp [T, B])) for frames t0+1..t0+T; the
    carry is (hyp DF [B, W, P], bkp int32 [B, W, P], book DF [B]).

    CPU tensors take the plain version; CUDA tensors launch kernel D
    (counted in ``decode_scan_df.LAUNCHES``), whose C entry chooses its
    instance from the lattice's shape alone (``sr_decode_scan_df_instance``):
    any [W, P] is taken. Launches whose lattice lives in device scratch
    (past 1,024 slots outside the warp instance) are also counted in
    ``SCRATCH_LAUNCHES``."""
    device = am.hi.device
    if device.type == "cpu":
        return decode_scan_df_reference(am, feat_len, state_table, last_pos,
                                        word_len, first_state, tdp, entry,
                                        am_threshold, prune=prune,
                                        carry_in=carry_in, t0=t0)
    if device.type != "cuda":
        raise ValueError(f"decode_scan_df: unsupported device {device}")
    if am.hi.dim() != 3:
        raise ValueError("decode_scan_df: am must be a [B, T, S] pair")
    B, T, S = am.hi.shape
    W, P = state_table.shape
    ints = {"feat_len": (feat_len, (B,)), "state_table": (state_table, (W, P)),
            "last_pos": (last_pos, (W,)), "word_len": (word_len, (W,)),
            "first_state": (first_state, (W,))}
    hyp, bkp, book = (carry_in if carry_in is not None
                      else _init_carry_df(B, W, P, device))
    floats = {"am": (am, (B, T, S)), "tdp": (tdp, (W, P, 3)),
              "entry": (entry, (W, 2)), "hyp": (hyp, (B, W, P)),
              "book": (book, (B,))}
    for name, (t, shape) in ints.items():
        if t.device != device or tuple(t.shape) != shape:
            raise ValueError(f"decode_scan_df: {name} must be a {shape} tensor on {device}")
    if bkp.device != device or bkp.dtype != torch.int32 or tuple(bkp.shape) != (B, W, P) \
            or not bkp.is_contiguous():
        raise ValueError(f"decode_scan_df: carry bkp must be a contiguous int32 "
                         f"{(B, W, P)} tensor on {device}")
    for name, (pair, shape) in floats.items():
        for t in pair:
            if t.device != device or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"decode_scan_df: {name} must be a contiguous "
                                 f"{shape} pair on {device}")
        dfm.require_f32(f"decode_scan_df: {name}", *pair)
    # the kernel indexes am and its shared word-end table with these
    if bool((state_table.min() < 0) | (state_table.max() >= S)
            | (first_state.min() < 0) | (first_state.max() >= S)
            | (last_pos.min() < 0) | (last_pos.max() >= P)):
        raise ValueError(f"decode_scan_df: state tables outside [0, {S}) or "
                         f"last_pos outside [0, {P})")
    i32 = {k: t.to(torch.int32).contiguous() for k, (t, _s) in ints.items()}

    hyp_out = dfm.DF(torch.empty_like(hyp.hi), torch.empty_like(hyp.lo))
    bkp_out = torch.empty_like(bkp)
    book_out = dfm.DF(torch.empty_like(book.hi), torch.empty_like(book.lo))
    score = torch.empty((T, B), dtype=torch.float32, device=device)
    word = torch.empty((T, B), dtype=torch.int32, device=device)
    wbkp = torch.empty((T, B), dtype=torch.int32, device=device)
    thr = float(np.float32(am_threshold))
    lib = _native.load()
    # the block instance keeps the lattice in device scratch past 1,024
    # slots: two buffers of (hi, lo) pairs, two of int32 backpointers and
    # the buffers of its NaN fold
    scratch = None
    if lib.sr_decode_scan_df_instance(W, P) < 0:
        per_utt = lib.sr_decode_scan_df_scratch(W, P)
        if per_utt < 0:
            raise ValueError(f"decode_scan_df: a {W} x {P} lattice is past the scratch's size")
        scratch = torch.empty(B * per_utt, dtype=torch.float32, device=device)
    err = lib.sr_decode_scan_df(
        am.hi.data_ptr(), am.lo.data_ptr(), i32["feat_len"].data_ptr(),
        i32["state_table"].data_ptr(), i32["last_pos"].data_ptr(),
        i32["word_len"].data_ptr(), i32["first_state"].data_ptr(),
        tdp.hi.data_ptr(), tdp.lo.data_ptr(), entry.hi.data_ptr(),
        entry.lo.data_ptr(), hyp.hi.data_ptr(), hyp.lo.data_ptr(),
        bkp.data_ptr(), book.hi.data_ptr(), book.lo.data_ptr(),
        hyp_out.hi.data_ptr(), hyp_out.lo.data_ptr(), bkp_out.data_ptr(),
        book_out.hi.data_ptr(), book_out.lo.data_ptr(), score.data_ptr(),
        word.data_ptr(), wbkp.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, T, S, W, P, int(t0), thr, int(bool(prune)), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "decode_scan_df")
    decode_scan_df.LAUNCHES += 1
    decode_scan_df.SCRATCH_LAUNCHES += scratch is not None
    return (hyp_out, bkp_out, book_out), (score, word, wbkp)


decode_scan_df.LAUNCHES = decode_scan_df.SCRATCH_LAUNCHES = 0

#: time-chunk length: one (B, CHUNK) scan shape serves utterances of any
#: length by streaming chunks through the carried lattice state
DECODE_CHUNK = 320


def _traceback_host(words_np: np.ndarray, bkps_np: np.ndarray,
                    feat_len: np.ndarray, silence_idx: int,
                    ) -> List[List[int]]:
    """Host-side traceback over [T, B] (word, bkp) tables, skipping
    silence in the output (Recognizer.cpp:222-231)."""
    out: List[List[int]] = []
    for b in range(words_np.shape[1]):
        t = int(feat_len[b])
        seq: List[int] = []
        while t > 0:
            w = int(words_np[t - 1, b])
            if w != silence_idx:
                seq.append(w)
            t = int(bkps_np[t - 1, b])
        seq.reverse()
        out.append(seq)
    return out


def decode_batch_tables(pack: gmm_mod.ScorePack, feats, feat_len: np.ndarray,
                        tables: DecoderTables, am_threshold: float, prune: bool = True,
                        dtype: torch.dtype = torch.float32, am: Optional[torch.Tensor] = None,
                        chunk: int = DECODE_CHUNK):
    """The scan's per-frame tables of a padded batch: (score [T, B] in
    ``dtype``, word [T, B], bkp [T, B] int32) on the device.

    feats f32 [B, T, dim] (numpy, or a tensor on the pack's device);
    feat_len int [B]. ``am`` may be passed to reuse precomputed [B, T, S]
    acoustic scores (the NN scorer's; ``pack`` may then be None). Everything
    runs on the pack's device, or with ``am`` on its device; acoustic
    scoring and the scan go chunk by chunk."""
    device = pack.device if am is None else am.device
    B, T, dim = feats.shape
    n_chunks = -(-T // chunk)
    Tp = n_chunks * chunk
    if am is not None:
        am = am.to(device=device, dtype=dtype)
        if T < Tp:
            am = torch.nn.functional.pad(am, (0, 0, 0, Tp - T))
    else:
        feats = torch.as_tensor(feats, dtype=torch.float32, device=device)
        if T < Tp:
            feats = torch.nn.functional.pad(feats, (0, 0, 0, Tp - T))

    lens = torch.as_tensor(np.asarray(feat_len), dtype=torch.int32, device=device)
    args = tuple(torch.as_tensor(a, device=device) for a in (
        tables.state_table, tables.last_pos, tables.word_len,
        tables.first_state, tables.tdp_within, tables.entry_pen))
    exit_pen = (None if tables.exit_pen is None
                else torch.as_tensor(tables.exit_pen, device=device))
    W, P = tables.state_table.shape
    carry = _init_carry(B, W, P, dtype, device)
    outs = []
    for ci in range(n_chunks):
        if am is not None:
            am_c = am[:, ci * chunk:(ci + 1) * chunk].contiguous()
        else:
            fl = feats[:, ci * chunk:(ci + 1) * chunk].reshape(B * chunk, dim)
            am_c = gmm_mod.am_scores(pack, fl).reshape(
                B, chunk, pack.num_mixtures).to(dtype)
        carry, o = decode_scan(
            am_c, lens, *args, am_threshold, prune=prune,
            carry_in=carry, t0=ci * chunk, exit_pen=exit_pen)
        outs.append(o)
    return tuple(torch.cat([o[k] for o in outs])[:T] for k in range(3))


def decode_batch(pack: gmm_mod.ScorePack, feats, feat_len: np.ndarray,
                 tables: DecoderTables, am_threshold: float, silence_idx: int,
                 prune: bool = True, dtype: torch.dtype = torch.float32,
                 am: Optional[torch.Tensor] = None,
                 chunk: int = DECODE_CHUNK) -> List[List[int]]:
    """Decode a padded batch → word sequences (silence removed):
    ``decode_batch_tables``, then the traceback tables come to the host
    once, at the end."""
    _s, words, bkps = decode_batch_tables(pack, feats, feat_len, tables, am_threshold,
                                          prune=prune, dtype=dtype, am=am, chunk=chunk)
    return _traceback_host(words.cpu().numpy(), bkps.cpu().numpy(), np.asarray(feat_len),
                           silence_idx)


def decode_batch_df_tables(packdf: gmm_mod.ScorePackDF, feats, feat_len: np.ndarray,
                           tables: DecoderTables, am_threshold: float, prune: bool = True,
                           chunk: int = DECODE_CHUNK):
    """``decode_batch_tables`` on the double-float path: df32 acoustic
    scores (models/gmm.am_scores_df) and the df32 scan, chunk by chunk on
    the pack's device → (score hi [T, B], word [T, B], bkp [T, B])."""
    device = packdf.device
    B, T, dim = feats.shape
    n_chunks = -(-T // chunk)
    Tp = n_chunks * chunk
    feats = torch.as_tensor(feats, dtype=torch.float32, device=device)
    if T < Tp:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, Tp - T))
    S = packdf.num_mixtures

    lens = torch.as_tensor(np.asarray(feat_len), dtype=torch.int32, device=device)
    args = (*(torch.as_tensor(a, device=device) for a in (
        tables.state_table, tables.last_pos, tables.word_len, tables.first_state)),
        dfm.from_f64(tables.tdp_within, device), dfm.from_f64(tables.entry_pen, device))
    W, P = tables.state_table.shape
    carry = _init_carry_df(B, W, P, device)
    outs = []
    for ci in range(n_chunks):
        with tracing.span("decode.scores"):
            fl = feats[:, ci * chunk:(ci + 1) * chunk].reshape(B * chunk, dim)
            am = gmm_mod.am_scores_df(packdf, fl)
            am = dfm.DF(am.hi.reshape(B, chunk, S), am.lo.reshape(B, chunk, S))
        with tracing.span("decode.scan"):
            carry, o = decode_scan_df(am, lens, *args, am_threshold,
                                      prune=prune, carry_in=carry, t0=ci * chunk)
        outs.append(o)
    return tuple(torch.cat([o[k] for o in outs])[:T] for k in range(3))


def decode_batch_df(packdf: gmm_mod.ScorePackDF, feats, feat_len: np.ndarray,
                    tables: DecoderTables, am_threshold: float, silence_idx: int,
                    prune: bool = True, chunk: int = DECODE_CHUNK) -> List[List[int]]:
    """decode_batch on the double-float path: df32 acoustic scores
    (models/gmm.am_scores_df) and the df32 scan — the reference's float64
    decisions with float32 arithmetic only. Runs on the pack's device, chunk
    by chunk; the traceback tables come to the host once, at the end."""
    _s, words, bkps = decode_batch_df_tables(packdf, feats, feat_len, tables, am_threshold,
                                             prune=prune, chunk=chunk)
    with tracing.span("decode.to_host"):
        words, bkps = words.cpu().numpy(), bkps.cpu().numpy()
    with tracing.span("decode.traceback"):
        return _traceback_host(words, bkps, np.asarray(feat_len), silence_idx)


class DeviceCorpus:
    """Device-resident corpus features: the flat [total_frames, dim] array
    and the segment offsets go to the device once; each batch is then one
    gather on the device (zero-padded tails, as Corpus.padded_batch)."""

    def __init__(self, corpus, device):
        self.flat = torch.as_tensor(corpus.features, device=device)
        self.offsets = torch.as_tensor(
            np.asarray(corpus.feature_offsets), dtype=torch.long, device=device)

    def batch(self, seg_ids, T: int) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(seg_ids), dtype=torch.long,
                              device=self.flat.device)
        o = self.offsets[ids]
        l = self.offsets[ids + 1] - o
        pos = torch.arange(T, device=self.flat.device)[None, :]
        idx = o[:, None] + torch.minimum(pos, (l - 1)[:, None])
        feats = self.flat[idx]
        return torch.where((pos < l[:, None])[:, :, None], feats,
                           torch.zeros((), dtype=feats.dtype, device=feats.device))


class Recognizer:
    """Corpus-level recognition driver with WER/SER/RTF reporting
    (reference: Recognizer.cpp:38-92). Runs on the pack's device.

    ``dtype`` is torch.float32 or torch.float64 with a ScorePack
    (``model.pack(dtype=...)``), or ``"df32"`` with a ScorePackDF
    (``model.pack_df()``), the production path. The packs are built on the
    card unless the caller asks for the CPU, as in
    ``Recognizer(cfg, lex, tdp, model.pack_df(device="cpu"), dtype="df32")``.

    The hybrid path sets ``nn_scorer`` (models/nn.NNScorer; ``pack`` may be
    None): the MLP scores each batch on the scorer's device and kernel B
    decodes those scores in ``dtype``, float32 or float64. df32 has no NN
    path and raises (the reference package's df32 branch decodes with the
    GMM pack and ignores its ``nn_scorer``).

    ``search-type=tree`` decodes with the prefix-tree search
    (search/tree_decoder.py, kernel I) in float32 or float64, with the GMM
    pack or the NN scorer; df32 has no tree path and raises (the reference
    package's df32 branch decodes with the word loop whatever the search
    type)."""

    def __init__(self, config: Configuration, lexicon: Lexicon,
                 tdp: TdpModel, pack=None,
                 dtype=torch.float32):
        if dtype == "df32" and not isinstance(pack, gmm_mod.ScorePackDF):
            raise TypeError("df32 decoding needs a ScorePackDF (model.pack_df())")
        self.lexicon = lexicon
        self.pack = pack
        self.dtype = dtype
        self.am_threshold = ParameterFloat("am-threshold", 20.0)(config)
        self.word_penalty = ParameterFloat("word-penalty", 10.0)(config)
        self.pruned_search = ParameterBool("pruned-search", True)(config)
        self.max_runs = ParameterInt("max-recognition-runs", 1000)(config)
        self.search_type = Parameter("search-type", "word-loop", str)(config)
        if self.search_type == "tree" and dtype == "df32":
            raise ValueError("df32 has no tree path: search-type=tree decodes in float32 "
                             "or float64")
        self.tables = DecoderTables.build(
            lexicon, tdp, self.word_penalty,
            exclude_last_pred=self.pruned_search)
        self.tree_tables = None
        if self.search_type == "tree":
            from .tree_decoder import TreeTables
            self.tree_tables = TreeTables.build(lexicon, tdp, self.word_penalty)
        #: optional hybrid scorer (models.nn.NNScorer); when set, acoustic
        #: scores come from the MLP + prior instead of the GMM pack
        #: (reference: SieTill.cpp:122-127 picks the scorer the same way)
        self.nn_scorer = None
        self._device_corpus = None

    @property
    def device(self) -> torch.device:
        return self.pack.device if self.nn_scorer is None else self.nn_scorer.device

    def _decode(self, feats, lens: np.ndarray) -> List[List[int]]:
        am = None
        if self.nn_scorer is not None:
            if self.dtype == "df32":
                raise ValueError("the NN scorer decodes in float32 or float64; df32 has "
                                 "no NN path")
            am = self.nn_scorer.am_batch(feats).to(self.dtype)
        if self.tree_tables is not None:
            from .tree_decoder import decode_batch_tree
            return decode_batch_tree(self.pack, feats, lens, self.tree_tables,
                                     self.am_threshold, self.lexicon.silence_idx,
                                     prune=self.pruned_search, dtype=self.dtype, am=am)
        if am is not None:
            return decode_batch(self.pack, feats, lens, self.tables,
                                self.am_threshold, self.lexicon.silence_idx,
                                prune=self.pruned_search, dtype=self.dtype, am=am)
        if self.dtype == "df32":
            return decode_batch_df(self.pack, feats, lens, self.tables,
                                   self.am_threshold, self.lexicon.silence_idx,
                                   prune=self.pruned_search)
        return decode_batch(self.pack, feats, lens, self.tables,
                            self.am_threshold, self.lexicon.silence_idx,
                            prune=self.pruned_search, dtype=self.dtype)

    #: padding buckets (multiples of DECODE_CHUNK) — instances may override
    buckets = (320, 640, 960, 1280, 1600)

    def _bucket(self, length: int) -> int:
        """Pad sequence lengths to a small fixed set of batch shapes."""
        for b in self.buckets:
            if length <= b:
                return b
        return -(-length // self.buckets[-1]) * self.buckets[-1]

    def warmup(self, corpus, batch_size: int = 512) -> None:
        """Build the kernels (on a CUDA pack) and decode one dummy batch."""
        if self.device.type == "cuda":
            _native.load()
        T = self.buckets[0]
        dim = self.pack.dim if self.nn_scorer is None else self.nn_scorer.base_dim
        feats = np.zeros((batch_size, T, dim), np.float32)
        lens = np.full(batch_size, T, np.int32)
        self._decode(feats, lens)

    @tracing.span("decode.corpus")
    def recognize_corpus(self, corpus, batch_size: int = 128,
                         max_segments: Optional[int] = None,
                         deadline_s: Optional[float] = None,
                         log=None) -> dict:
        """Decode the corpus (longest-first batches) and score WER/SER/RTF.

        ``deadline_s``: optional wall-clock budget for the decode loop — if
        the projected time of the next batch would cross it, stop and score
        the utterances decoded so far (the result carries ``coverage`` <
        1.0). RTF is throughput-defined (decode seconds / decoded audio
        seconds), so partial coverage measures the same quantity."""
        from .edit_distance import EDAccumulator, edit_distance
        import time

        n = min(corpus.num_segments, max_segments or self.max_runs)
        acc = EDAccumulator()
        ref_total = 0
        sentence_errors = 0
        hyps: dict = {}
        device_corpus = self._device_corpus
        if device_corpus is None or device_corpus.flat.shape[0] != \
                corpus.features.shape[0]:
            device_corpus = DeviceCorpus(corpus, self.device)
            self._device_corpus = device_corpus
        t0 = time.perf_counter()
        order = np.argsort(corpus.lengths[:n], kind="stable")
        last_batch = 0.0
        # batches stay length-sorted internally (tight padding), but are
        # visited in golden-ratio-strided order so a deadline-truncated
        # prefix samples all utterance lengths ~uniformly
        starts = list(range(0, n, batch_size))
        starts.sort(key=lambda s: ((s // batch_size) * 0.6180339887498949) % 1.0)
        for i in starts:
            if deadline_s is not None:
                elapsed = time.perf_counter() - t0
                if elapsed + 1.2 * last_batch > deadline_s and hyps:
                    if log:
                        log(f"deadline: stopping after {len(hyps)}/{n} "
                            f"utterances ({elapsed:.1f}s elapsed)")
                    break
            tb = time.perf_counter()
            ids = order[i: i + batch_size].tolist()
            n_real = len(ids)
            while len(ids) < batch_size:     # keep shapes static across batches
                ids.append(ids[-1])
            T = self._bucket(max(corpus.seq_length(s) for s in ids))
            with tracing.span("decode.gather"):
                feats = device_corpus.batch(ids, T)
            lens = np.asarray([corpus.seq_length(s) for s in ids], np.int32)
            # padded duplicate slots are masked out (feat_len 0 freezes
            # their lattice immediately)
            lens[n_real:] = 0
            if tracing.enabled():
                tracing.count("decode.frames_real", int(lens.sum()))
                tracing.count("decode.frames_padded", len(ids) * T)
            with tracing.span("decode.batch"):
                results = self._decode(feats, lens)
            for b, s in enumerate(ids[:n_real]):
                hyps[s] = results[b]
            last_batch = time.perf_counter() - tb
        elapsed = time.perf_counter() - t0

        decoded = sorted(hyps)
        with tracing.span("decode.wer"):
            for s in decoded:
                ed = edit_distance(corpus.orths[s], hyps[s])
                acc += ed
                ref_total += len(corpus.orths[s])
                if ed.total_count > 0:
                    sentence_errors += 1

        audio_seconds = float(
            corpus.lengths[decoded].sum()) * corpus.frame_duration
        return {
            "coverage": len(decoded) / n,
            "num_decoded": len(decoded),
            "wer": 100.0 * acc.total_count / ref_total,
            "ser": 100.0 * sentence_errors / len(decoded),
            "substitutions": acc.substitute_count,
            "insertions": acc.insert_count,
            "deletions": acc.delete_count,
            "time": elapsed,
            "rtf": elapsed / audio_seconds,
            "audio_seconds": audio_seconds,
            "hyps": hyps,
        }
