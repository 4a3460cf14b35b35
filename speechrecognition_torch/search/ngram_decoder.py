"""Word-conditioned time-synchronous decoder with bigram LM recombination —
counterpart of speechrecognition_tpu/search/ngram_decoder.py.

The reference lab decoder (rwth-asr-0.5/src/Teaching/LinearSearch.cc:211-436):
a linear word lexicon whose word entries are conditioned on the predecessor
word through bigram scores, with exact recombination at word boundaries.
Per frame:

    entry[b, w]  = min_v (book_prev[b, v] + lm[v, w])      (min-plus product)
    hyp[b, w, s] = 0-1-2 recursion + entry into positions {0, 1}
    book[b, w]   = hyp[b, w, last(w)]                      (per-WORD word end)

The per-word book carries the bigram context; the traceback records the
boundary frame and the predecessor word of each entry. With a uniform LM
(lm[v, w] = wp(w)) this reduces to the word-loop decoder.

``decode_scan_bigram`` is one scan over a batch: on CUDA tensors it launches
the hand-written kernel J (``csrc/decode_scan_bigram.cu``), on CPU tensors
it runs the plain PyTorch version ``decode_scan_bigram_reference``. Both
follow the reference's ``_decode_scan_bigram`` step for step: larger jumps
win within-word ties, entries win ties (<=), the start row wins only when
strictly better, and every argmin takes the first predecessor.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import gmm as gmm_mod
from ..ops import _native
from .decoder import BIG, DecoderTables


def decode_scan_bigram_reference(am: torch.Tensor, feat_len: torch.Tensor,
                                 state_table: torch.Tensor, last_pos: torch.Tensor,
                                 word_len: torch.Tensor, tdp_within: torch.Tensor,
                                 entry_tdp: torch.Tensor, lm: torch.Tensor,
                                 lm_start: torch.Tensor, am_threshold, prune: bool = True,
                                 ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``decode_scan_bigram``, one frame per loop
    step (any float dtype, any device). Same contract."""
    B, T, S = am.shape
    dtype, device = am.dtype, am.device
    W, P = state_table.shape
    big = torch.tensor(float(BIG), dtype=dtype, device=device)
    half_big = big * 0.5
    st = state_table.to(device=device, dtype=torch.long)
    lp = last_pos.to(device=device, dtype=torch.long)
    tdpw = tdp_within.to(device=device, dtype=dtype)
    entp = entry_tdp.to(device=device, dtype=dtype)          # [W, 2]
    lm = lm.to(device=device, dtype=dtype)
    lm_start = lm_start.to(device=device, dtype=dtype)
    thr = torch.tensor(float(am_threshold), dtype=dtype, device=device)
    lens = feat_len.to(device)
    slot_valid = torch.arange(P, device=device)[None, :] < word_len.to(device)[:, None]
    words_idx = torch.arange(W, device=device)

    hyp = big.expand(B, W, P).clone()
    bkp = torch.zeros((B, W, P), dtype=torch.int32, device=device)
    pred = torch.full((B, W, P), -1, dtype=torch.int32, device=device)
    book = big.expand(B, W).clone()                        # no word has ended yet
    big_col = big.expand(B, W, 1)
    big_tail = big.expand(B, W, P - 2)
    zero_b = torch.zeros((B, W, 2), dtype=torch.int32, device=device)
    neg_p = torch.full((B, W, 2), -1, dtype=torch.int32, device=device)

    books, bkps, preds, offsets = [], [], [], []
    for i in range(T):
        t = i + 1
        ams = am[:, i][:, st]                              # [B, W, P]
        c0 = hyp + tdpw[None, :, :, 0]
        c1 = torch.cat([big_col, hyp[:, :, :-1] + tdpw[None, :, 1:, 1]], dim=2)
        c2 = torch.cat([big_col, big_col, hyp[:, :, :-2] + tdpw[None, :, 2:, 2]], dim=2)
        b0 = torch.cat([zero_b[:, :, :1], bkp[:, :, :-1]], dim=2)
        b00 = torch.cat([zero_b, bkp[:, :, :-2]], dim=2)
        p0 = torch.cat([neg_p[:, :, :1], pred[:, :, :-1]], dim=2)
        p00 = torch.cat([neg_p, pred[:, :, :-2]], dim=2)
        within, wbkp, wpred = c2, b00, p00
        for c, b, p in ((c1, b0, p0), (c0, bkp, pred)):
            take = c < within
            within = torch.where(take, c, within)
            wbkp = torch.where(take, b, wbkp)
            wpred = torch.where(take, p, wpred)
        within = within + ams

        # bigram recombination (min-plus product; the first predecessor at
        # the minimum), and the sentence-start row at the first frame
        cand = book[:, :, None] + lm[None, :, :]            # [B, v, w]
        rec = cand.amin(dim=1)
        rec_pred = cand.argmin(dim=1).to(torch.int32)
        start = lm_start[None, :].expand(B, W) if t == 1 else big.expand(B, W)
        take_start = start < rec
        entry_base = torch.where(take_start, start, rec)
        entry_pred = torch.where(take_start, torch.tensor(-1, dtype=torch.int32,
                                                          device=device), rec_pred)

        # the ENTERED position's own state's emission
        entry = (entry_base[:, :, None] + entp[None, :, :]) + ams[:, :, :2]
        entry = torch.cat([entry, big_tail], dim=2)
        entry_pred3 = torch.cat([entry_pred[:, :, None].expand(B, W, 2),
                                 torch.full((B, W, P - 2), -1, dtype=torch.int32,
                                            device=device)], dim=2)
        take_entry = entry <= within
        new = torch.where(take_entry, entry, within)
        new_bkp = torch.where(take_entry, torch.tensor(t - 1, dtype=torch.int32,
                                                       device=device), wbkp)
        new_pred = torch.where(take_entry, entry_pred3, wpred)
        new = torch.where(slot_valid[None, :, :], new, big)
        new = torch.minimum(new, big)

        best = new.amin(dim=(1, 2), keepdim=True)
        best = torch.where(best >= half_big, torch.zeros_like(best), best)
        new = torch.where(new >= half_big, big, new - best)
        if prune:
            new = torch.where(new > thr, big, new)

        end_scores = new[:, words_idx, lp]
        end_bkp = new_bkp[:, words_idx, lp]
        end_pred = new_pred[:, words_idx, lp]
        end_scores = torch.where(end_scores >= half_big, big, end_scores)

        alive = t <= lens
        hyp = torch.where(alive[:, None, None], new, hyp)
        bkp = torch.where(alive[:, None, None], new_bkp, bkp)
        pred = torch.where(alive[:, None, None], new_pred, pred)
        book = torch.where(alive[:, None], end_scores, book)
        books.append(end_scores)
        bkps.append(end_bkp)
        preds.append(end_pred)
        offsets.append(torch.where(alive, best[:, 0, 0], torch.zeros_like(best[:, 0, 0])))
    return torch.stack(books), torch.stack(bkps), torch.stack(preds), torch.stack(offsets)


def decode_scan_bigram(am: torch.Tensor, feat_len: torch.Tensor, state_table: torch.Tensor,
                       last_pos: torch.Tensor, word_len: torch.Tensor,
                       tdp_within: torch.Tensor, entry_tdp: torch.Tensor, lm: torch.Tensor,
                       lm_start: torch.Tensor, am_threshold, prune: bool = True,
                       ) -> Tuple[torch.Tensor, ...]:
    """The bigram word-loop Viterbi over a batch, from frame 1.

    am [B, T, S]; feat_len int32 [B]; the lexicon tables as in DecoderTables
    (entry_tdp [W, 2] without the word penalty); lm [W, W] = −log p(w|v);
    lm_start [W] = −log p(w|start). Returns per-frame (book [T, B, W], book
    backpointer [T, B, W], predecessor [T, B, W] (−1: the sentence start),
    offset [T, B]: the renormalisation subtracted, 0 once an utterance
    ended).

    CPU tensors take the plain version; CUDA tensors launch kernel J
    (float32 or float64; counted in ``decode_scan_bigram.LAUNCHES``), whose C
    entry chooses its instance from the shape (``sr_decode_scan_bigram_instance``):
    the warp instance for W <= 32 and P <= 32 with every slot in registers,
    else the block instance with the lattice in shared memory up to its limit
    and past it in device scratch (counted in ``SCRATCH_LAUNCHES``). Any [W, P] with P >= 2
    is taken, as the reference takes it. The indices are not range-checked
    here (``check_decoder_tables`` does that once, on the host)."""
    if am.device.type == "cpu":
        return decode_scan_bigram_reference(am, feat_len, state_table, last_pos, word_len,
                                            tdp_within, entry_tdp, lm, lm_start,
                                            am_threshold, prune=prune)
    outs, in_scratch = decode_scan_bigram_cuda(am, feat_len, state_table, last_pos, word_len,
                                               tdp_within, entry_tdp, lm, lm_start,
                                               am_threshold, prune=prune)
    decode_scan_bigram.LAUNCHES += 1
    decode_scan_bigram.SCRATCH_LAUNCHES += in_scratch
    return outs


decode_scan_bigram.LAUNCHES = decode_scan_bigram.SCRATCH_LAUNCHES = 0


def decode_scan_bigram_cuda(am: torch.Tensor, feat_len: torch.Tensor,
                            state_table: torch.Tensor, last_pos: torch.Tensor,
                            word_len: torch.Tensor, tdp_within: torch.Tensor,
                            entry_tdp: torch.Tensor, lm: torch.Tensor, lm_start: torch.Tensor,
                            am_threshold, prune: bool = True, first_design: bool = False):
    """Kernel J's launch on CUDA tensors, as ``decode_scan_bigram`` makes it
    but not counted: returns (outs, whether the lattice lived in device
    scratch). ``first_design`` launches the block instance whatever the
    shape, so that it can be timed beside the warp instance."""
    if am.device.type != "cuda":
        raise ValueError(f"decode_scan_bigram: unsupported device {am.device}")
    if am.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"decode_scan_bigram: the CUDA kernel runs float32 or float64, "
                        f"got {am.dtype}")
    if am.dim() != 3 or not am.is_contiguous():
        raise ValueError("decode_scan_bigram: am must be a contiguous [B, T, S] tensor")
    B, T, S = am.shape
    W, P = state_table.shape
    if P < 2:
        raise ValueError(f"decode_scan_bigram: a lattice of {P} position(s); the scan needs 2 "
                         f"or more")
    dtype, device = am.dtype, am.device
    ints = _native.typed_args("decode_scan_bigram", device, torch.int32,
                              feat_len=(feat_len, (B,)), state_table=(state_table, (W, P)),
                              last_pos=(last_pos, (W,)), word_len=(word_len, (W,)))
    fl = _native.typed_args("decode_scan_bigram", device, dtype,
                            tdp_within=(tdp_within, (W, P, 3)), entry_tdp=(entry_tdp, (W, 2)),
                            lm=(lm, (W, W)), lm_start=(lm_start, (W,)))
    book = torch.empty((T, B, W), dtype=dtype, device=device)
    bkp = torch.empty((T, B, W), dtype=torch.int32, device=device)
    pred = torch.empty((T, B, W), dtype=torch.int32, device=device)
    offset = torch.empty((T, B), dtype=dtype, device=device)
    lib = _native.load()
    f64 = int(dtype == torch.float64)
    scratch = _native.scratch(B, lib.sr_decode_scan_bigram_scratch(W, P, f64), device)
    err = lib.sr_decode_scan_bigram(
        f64, am.data_ptr(), ints["feat_len"].data_ptr(), ints["state_table"].data_ptr(),
        ints["last_pos"].data_ptr(), ints["word_len"].data_ptr(),
        fl["tdp_within"].data_ptr(), fl["entry_tdp"].data_ptr(), fl["lm"].data_ptr(),
        fl["lm_start"].data_ptr(), book.data_ptr(), bkp.data_ptr(), pred.data_ptr(),
        offset.data_ptr(), _native.ptr(scratch), B, T, S, W, P, float(am_threshold),
        int(bool(prune)), int(bool(first_design)), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "decode_scan_bigram")
    return (book, bkp, pred, offset), scratch is not None


def check_decoder_tables(tables: DecoderTables, num_states: int) -> None:
    """Raise unless the lexicon tables index inside am and the lattice (once,
    on the host, before they go to a device)."""
    W, P = tables.state_table.shape
    if W and (tables.state_table.min() < 0 or tables.state_table.max() >= num_states):
        raise ValueError(f"DecoderTables.state_table outside [0, {num_states})")
    if W and (tables.last_pos.min() < 0 or tables.last_pos.max() >= P):
        raise ValueError(f"DecoderTables.last_pos outside [0, {P})")


def decode_batch_bigram(pack, feats, feat_len: np.ndarray, tables: DecoderTables,
                        lm_matrix: np.ndarray, lm_start: np.ndarray, am_threshold: float,
                        silence_idx: int, prune: bool = True,
                        dtype: torch.dtype = torch.float32,
                        am: Optional[torch.Tensor] = None) -> List[List[int]]:
    """Bigram decode → word sequences (silence removed).

    Build ``tables`` with word_penalty=0: word costs live in lm_matrix /
    lm_start (−log p). ``am`` may carry precomputed [B, T, S] acoustic
    scores (``pack`` is then unused). Runs on the pack's device, or with
    ``am`` on its device."""
    device = pack.device if am is None else am.device
    B, T, dim = feats.shape
    if am is None:
        flat = torch.as_tensor(feats, dtype=torch.float32, device=device).reshape(B * T, dim)
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
    am = am.to(device=device, dtype=dtype).contiguous()
    check_decoder_tables(tables, am.shape[2])
    args = [torch.as_tensor(np.asarray(a, np.int32), device=device)
            for a in (tables.state_table, tables.last_pos, tables.word_len)]
    args += [torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)
             for a in (tables.tdp_within, tables.entry_pen, lm_matrix, lm_start)]
    lens = torch.as_tensor(np.asarray(feat_len), dtype=torch.int32, device=device)
    scores, bkps, preds, _offsets = decode_scan_bigram(am, lens, *args, am_threshold,
                                                       prune=prune)
    scores_np = scores.cpu().numpy()   # [T, B, W]
    bkps_np = bkps.cpu().numpy()
    preds_np = preds.cpu().numpy()
    out: List[List[int]] = []
    for b in range(B):
        t = int(feat_len[b])
        if t == 0 or not np.isfinite(scores_np[t - 1, b]).any() \
                or scores_np[t - 1, b].min() >= BIG * 0.5:
            out.append([])
            continue
        w = int(np.argmin(scores_np[t - 1, b]))
        seq: List[int] = []
        while t > 0 and w >= 0:
            if w != silence_idx:
                seq.append(w)
            t, w = int(bkps_np[t - 1, b, w]), int(preds_np[t - 1, b, w])
        seq.reverse()
        out.append(seq)
    return out
