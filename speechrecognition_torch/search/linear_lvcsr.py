"""Linear-lexicon LVCSR decode: time-synchronous Viterbi with bigram
recombination and per-predecessor transparent-silence copies —
counterpart of speechrecognition_tpu/search/linear_lvcsr.py.

The reference's complete teaching decoder (rwth-asr-0.5/src/Teaching/
LinearSearch.cc:211-436): a linear word lexicon, bigram recombination at
word boundaries, beam pruning and one silence copy per predecessor word,
so that the LM history passes through silence; Sprint transition
semantics come from ``sprint.am.TransitionModel.decoder_tables``. The
word-entry matrix ``lm_ext[v, w]`` carries everything charged at the v→w
boundary (LM score and word w's exit TDP, as
``tools.an4_system.build_lm_matrices`` builds it); a silence end charges
only ``sil_exit``.

Two device loops, each with its plain PyTorch version in this module:

* ``decode_scan_linear`` (kernel M, ``csrc/linear_lvcsr_scan.cu``): the
  whole scan over T, the reference's ``_decode_scan_linear_ts``;
* ``traceback_linear`` (kernel N, ``csrc/linear_traceback.cu``): the
  backward word walk over the scan's books, the reference's
  ``_traceback_device``; only [MAX_TRACE_WORDS, B] word ids leave the
  device.

CPU tensors take the plain versions; CUDA tensors launch the kernels. Both
follow the reference step for step: larger jumps win within-word ties, word
and silence entries win ties (<=), the predecessor minimum and the
traceback's argmins take the first index, a finished utterance freezes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..models import gmm as gmm_mod
from ..ops import _native
from .decoder import BIG, DecoderTables

#: words the device traceback walks back, at most (the reference's cap)
MAX_TRACE_WORDS = 128

#: the scan's per-frame outputs, in this order, each [T, B, ...]
OUTPUTS = ("book", "bkp", "pred", "via", "origin", "silend", "silorg", "offset")


def decode_scan_linear_reference(am: torch.Tensor, feat_len: torch.Tensor,
                                 state_table: torch.Tensor, last_pos: torch.Tensor,
                                 word_len: torch.Tensor, tdp_within: torch.Tensor,
                                 entry_pen: torch.Tensor, sil_states: torch.Tensor,
                                 sil_tdp: torch.Tensor, sil_entry_pen: torch.Tensor,
                                 sil_exit, lm_ext: torch.Tensor, am_threshold,
                                 prune: bool = True) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``decode_scan_linear``, one frame per loop
    step (float32 or float64, any device). Same contract."""
    B, T, S = am.shape
    dtype, device = am.dtype, am.device
    W, P = state_table.shape
    V = W + 1
    Ps = sil_states.shape[0]

    def cast(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float64))
        return x.to(device=device, dtype=dtype)

    big = cast(float(BIG))
    half = big * 0.5
    tdpw, entp = cast(tdp_within), cast(entry_pen)
    stdp, sentp = cast(sil_tdp), cast(sil_entry_pen)
    sexit, lm = cast(sil_exit), cast(lm_ext)
    thr = cast(am_threshold)
    st = state_table.to(device=device, dtype=torch.long)
    lp = last_pos.to(device=device, dtype=torch.long)
    sst = sil_states.to(device=device, dtype=torch.long)
    lens = feat_len.to(device)
    slot_valid = torch.arange(P, device=device)[None, :] < word_len.to(device)[:, None]
    widx = torch.arange(W, device=device)
    ne = min(2, Ps)

    def ints(shape, value):
        return torch.full(shape, value, dtype=torch.int32, device=device)

    hyp = big.expand(B, W, P).clone()
    bkp = ints((B, W, P), 0)
    pred = ints((B, W, P), W)
    shyp = big.expand(B, V, Ps).clone()
    sorg = ints((B, V, Ps), 0)
    book = big.expand(B, W).clone()
    silend = big.expand(B, V).clone()
    silorg = ints((B, V), 0)
    big_col, sbig_col = big.expand(B, W, 1), big.expand(B, V, 1)
    zero_w, pred0_w, zero_v = ints((B, W, 2), 0), ints((B, W, 2), W), ints((B, V, 2), 0)

    outs = {k: [] for k in OUTPUTS}
    for i in range(T):
        t = i + 1
        am_t = am[:, i]
        # real-word within-word 0-1-2 recursion
        ams = am_t[:, st]                                   # [B, W, P]
        c0 = hyp + tdpw[None, :, :, 0]
        c1 = torch.cat([big_col, hyp[:, :, :-1] + tdpw[None, :, 1:, 1]], dim=2)
        c2 = torch.cat([big_col, big_col, hyp[:, :, :-2] + tdpw[None, :, 2:, 2]], dim=2)
        b0 = torch.cat([zero_w[:, :, :1], bkp[:, :, :-1]], dim=2)
        b00 = torch.cat([zero_w, bkp[:, :, :-2]], dim=2)
        p0 = torch.cat([pred0_w[:, :, :1], pred[:, :, :-1]], dim=2)
        p00 = torch.cat([pred0_w, pred[:, :, :-2]], dim=2)
        within, wbkp, wpred = c2, b00, p00
        for c, b, p in ((c1, b0, p0), (c0, bkp, pred)):
            take = c < within
            within = torch.where(take, c, within)
            wbkp = torch.where(take, b, wbkp)
            wpred = torch.where(take, p, wpred)
        within = within + ams

        # effective predecessor books: the word end or its trailing silence
        # (the start context opens at the first frame)
        start_col = (torch.zeros((B, 1), dtype=dtype, device=device) if t == 1
                     else big.expand(B, 1))
        ebook = torch.cat([book, start_col], dim=1)          # [B, V]
        via_prev = silend < ebook
        ebook = torch.minimum(ebook, silend)
        origin_prev = torch.where(via_prev, silorg, ints((B, V), t - 1))

        # bigram recombination: min-plus over predecessors, the first at the
        # minimum
        cand = ebook[:, :, None] + lm[None, :, :]            # [B, V, W]
        entry_base = cand.amin(dim=1)
        entry_pred = cand.argmin(dim=1).to(torch.int32)
        entry = (entry_base[:, :, None] + entp[None, :, :]) + am_t[:, st[:, :2]]
        entry = torch.cat([entry, big.expand(B, W, P - 2)], dim=2)
        entry_pred3 = torch.cat([entry_pred[:, :, None].expand(B, W, 2),
                                 ints((B, W, P - 2), W)], dim=2)
        take_entry = entry <= within
        new = torch.where(take_entry, entry, within)
        nbkp = torch.where(take_entry, ints((), t - 1), wbkp)
        npred = torch.where(take_entry, entry_pred3, wpred)
        new = torch.where(slot_valid[None, :, :], new, big)
        new = torch.minimum(new, big)

        # silence copies, one per predecessor (LM-transparent)
        sams = am_t[:, sst][:, None, :]                      # [B, 1, Ps]
        s0 = shyp + stdp[None, None, :, 0]
        s1 = torch.cat([sbig_col, shyp[:, :, :-1] + stdp[None, None, 1:, 1]], dim=2)[:, :, :Ps]
        s2 = torch.cat([sbig_col, sbig_col, shyp[:, :, :-2] + stdp[None, None, 2:, 2]],
                       dim=2)[:, :, :Ps]
        so0 = torch.cat([zero_v[:, :, :1], sorg[:, :, :-1]], dim=2)[:, :, :Ps]
        so00 = torch.cat([zero_v, sorg[:, :, :-2]], dim=2)[:, :, :Ps]
        swithin, sworg = s2, so00
        for c, o in ((s1, so0), (s0, sorg)):
            take = c < swithin
            swithin = torch.where(take, c, swithin)
            sworg = torch.where(take, o, sworg)
        swithin = swithin + sams
        sentry = (ebook[:, :, None] + sentp[None, None, :ne]) + am_t[:, sst[:ne]][:, None, :]
        if Ps > ne:
            sentry = torch.cat([sentry, big.expand(B, V, Ps - ne)], dim=2)
        stake = sentry <= swithin
        snew = torch.where(stake, sentry, swithin)
        snorg = torch.where(stake, origin_prev[:, :, None].expand(B, V, Ps), sworg)
        snew = torch.minimum(snew, big)

        # renormalise and prune over the joint hypothesis set
        best = torch.minimum(new.amin(dim=(1, 2)), snew.amin(dim=(1, 2)))
        best = torch.where(best >= half, torch.zeros_like(best), best)[:, None, None]
        new = torch.where(new >= half, big, new - best)
        snew = torch.where(snew >= half, big, snew - best)
        if prune:
            new = torch.where(new > thr, big, new)
            snew = torch.where(snew > thr, big, snew)

        # books: word ends (boundary costs were charged at entry) and
        # silence ends with their exit
        ends = new[:, widx, lp]
        book_new = torch.where(ends >= half, big, ends)
        book_bkp = nbkp[:, widx, lp]
        book_pred = npred[:, widx, lp]
        sil_ends = snew[:, :, Ps - 1]
        silend_new = torch.where(sil_ends >= half, big, sil_ends + sexit)
        silorg_new = snorg[:, :, Ps - 1]

        alive = t <= lens
        a3, a2 = alive[:, None, None], alive[:, None]
        hyp = torch.where(a3, new, hyp)
        bkp = torch.where(a3, nbkp, bkp)
        pred = torch.where(a3, npred, pred)
        shyp = torch.where(a3, snew, shyp)
        sorg = torch.where(a3, snorg, sorg)
        book = torch.where(a2, book_new, book)
        silend = torch.where(a2, silend_new, silend)
        silorg = torch.where(a2, silorg_new, silorg)

        for k, v in (("book", book_new), ("bkp", book_bkp), ("pred", book_pred),
                     ("via", via_prev.gather(1, book_pred.long())), ("origin", origin_prev),
                     ("silend", silend_new), ("silorg", silorg_new),
                     ("offset", torch.where(alive, best[:, 0, 0], torch.zeros_like(best[:, 0, 0])))):
            outs[k].append(v)
    if T == 0:
        shapes = {"book": (W,), "bkp": (W,), "pred": (W,), "via": (W,), "origin": (V,),
                  "silend": (V,), "silorg": (V,), "offset": ()}
        types = {"via": torch.bool, "book": dtype, "silend": dtype, "offset": dtype}
        return tuple(torch.empty((0, B) + shapes[k], dtype=types.get(k, torch.int32),
                                 device=device) for k in OUTPUTS)
    return tuple(torch.stack(outs[k]) for k in OUTPUTS)


def decode_scan_linear(am: torch.Tensor, feat_len: torch.Tensor, state_table: torch.Tensor,
                       last_pos: torch.Tensor, word_len: torch.Tensor,
                       tdp_within: torch.Tensor, entry_pen: torch.Tensor,
                       sil_states: torch.Tensor, sil_tdp: torch.Tensor,
                       sil_entry_pen: torch.Tensor, sil_exit, lm_ext: torch.Tensor,
                       am_threshold, prune: bool = True) -> Tuple[torch.Tensor, ...]:
    """The linear-lexicon LVCSR Viterbi over a batch, from frame 1.

    am [B, T, S]; feat_len int32 [B]. Real-word tables [W, P] (silence not on
    the word axis): state_table, last_pos [W], word_len [W], tdp_within
    [W, P, 3], entry_pen [W, 2]; the silence's sil_states [Ps], sil_tdp
    [Ps, 3], sil_entry_pen [2] and sil_exit (charged at a silence end);
    lm_ext [W+1, W]: the boundary cost v→w, last row the sentence start.
    Every cost is cast to am's type. Returns the eight per-frame tensors of
    ``OUTPUTS``: book [T, B, W] (word w ended at this frame, renormalised),
    bkp [T, B, W] (its entry boundary), pred [T, B, W] (its predecessor, W:
    the sentence start), via [T, B, W] bool (that predecessor was reached
    through its trailing silence), origin [T, B, W+1] (per silence copy: the
    frame its predecessor's real word ended), silend [T, B, W+1] (silence
    copy ends with the exit), silorg [T, B, W+1], offset [T, B] (the
    renormalisation, 0 once the utterance ended).

    CPU tensors take the plain version; CUDA tensors launch kernel M (float32
    or float64; counted in ``decode_scan_linear.LAUNCHES``): one block an
    utterance. Its warp instance (the lexicon's predecessors over a warp's
    lanes, the positions in parallel, two barriers a frame) takes every
    lexicon whose state fits in shared memory (AN4's 130 words); past it
    the first design, its lattice in shared memory or, past that, in device
    scratch (counted in ``SCRATCH_LAUNCHES``). The indices are not
    range-checked here (``LinearTables.args`` does that once, on the host)."""
    if am.device.type == "cpu":
        return decode_scan_linear_reference(am, feat_len, state_table, last_pos, word_len,
                                            tdp_within, entry_pen, sil_states, sil_tdp,
                                            sil_entry_pen, sil_exit, lm_ext, am_threshold,
                                            prune=prune)
    outs, in_scratch = decode_scan_linear_cuda(am, feat_len, state_table, last_pos, word_len,
                                               tdp_within, entry_pen, sil_states, sil_tdp,
                                               sil_entry_pen, sil_exit, lm_ext, am_threshold,
                                               prune=prune)
    decode_scan_linear.LAUNCHES += 1
    decode_scan_linear.SCRATCH_LAUNCHES += in_scratch
    return outs


decode_scan_linear.LAUNCHES = decode_scan_linear.SCRATCH_LAUNCHES = 0


def decode_scan_linear_cuda(am: torch.Tensor, feat_len: torch.Tensor, state_table: torch.Tensor,
                            last_pos: torch.Tensor, word_len: torch.Tensor,
                            tdp_within: torch.Tensor, entry_pen: torch.Tensor,
                            sil_states: torch.Tensor, sil_tdp: torch.Tensor,
                            sil_entry_pen: torch.Tensor, sil_exit, lm_ext: torch.Tensor,
                            am_threshold, prune: bool = True, first_design: bool = False):
    """Kernel M's launch on CUDA tensors, as ``decode_scan_linear`` makes it
    but not counted: returns (outs, whether the lattice lived in device
    scratch). ``first_design=True`` launches the first design (a thread a
    word, the lattice updated in place) for timing in turns."""
    if am.device.type != "cuda":
        raise ValueError(f"decode_scan_linear: unsupported device {am.device}")
    if am.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"decode_scan_linear: the CUDA kernel runs float32 or float64, "
                        f"got {am.dtype}")
    if am.dim() != 3 or not am.is_contiguous():
        raise ValueError("decode_scan_linear: am must be a contiguous [B, T, S] tensor")
    B, T, S = am.shape
    W, P = state_table.shape
    Ps = sil_states.shape[0]
    V = W + 1
    if P < 2 or Ps < 1:
        raise ValueError(f"decode_scan_linear: a lattice of {P} position(s) and a silence of "
                         f"{Ps}; the scan needs 2 or more and 1 or more")
    dtype, device = am.dtype, am.device
    ints = _native.typed_args("decode_scan_linear", device, torch.int32,
                              feat_len=(feat_len, (B,)), state_table=(state_table, (W, P)),
                              last_pos=(last_pos, (W,)), word_len=(word_len, (W,)),
                              sil_states=(sil_states, (Ps,)))
    fl = _native.typed_args("decode_scan_linear", device, dtype,
                            tdp_within=(tdp_within, (W, P, 3)), entry_pen=(entry_pen, (W, 2)),
                            sil_tdp=(sil_tdp, (Ps, 3)), sil_entry_pen=(sil_entry_pen, (2,)),
                            lm_ext=(lm_ext, (V, W)))
    outs = {
        "book": torch.empty((T, B, W), dtype=dtype, device=device),
        "bkp": torch.empty((T, B, W), dtype=torch.int32, device=device),
        "pred": torch.empty((T, B, W), dtype=torch.int32, device=device),
        "via": torch.empty((T, B, W), dtype=torch.bool, device=device),
        "origin": torch.empty((T, B, V), dtype=torch.int32, device=device),
        "silend": torch.empty((T, B, V), dtype=dtype, device=device),
        "silorg": torch.empty((T, B, V), dtype=torch.int32, device=device),
        "offset": torch.empty((T, B), dtype=dtype, device=device),
    }
    lib = _native.load()
    f64 = int(dtype == torch.float64)
    warp = not first_design and lib.sr_linear_scan_instance(W, P, Ps, S, T, f64) == 1
    scratch = (None if warp else
               _native.scratch(B, lib.sr_linear_scan_scratch(W, P, Ps, S, f64), device))
    # the cast to the score type, as the plain version's
    sexit = float(torch.tensor(float(sil_exit), dtype=torch.float64).to(dtype))
    thr = float(torch.tensor(float(am_threshold), dtype=torch.float64).to(dtype))
    err = lib.sr_linear_scan(
        f64, am.data_ptr(), ints["feat_len"].data_ptr(), ints["state_table"].data_ptr(),
        ints["last_pos"].data_ptr(), ints["word_len"].data_ptr(), fl["tdp_within"].data_ptr(),
        fl["entry_pen"].data_ptr(), ints["sil_states"].data_ptr(), fl["sil_tdp"].data_ptr(),
        fl["sil_entry_pen"].data_ptr(), fl["lm_ext"].data_ptr(),
        *(outs[k].data_ptr() for k in OUTPUTS), _native.ptr(scratch), B, T, S, W, P, Ps,
        sexit, thr, int(bool(prune)), int(bool(first_design)), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "decode_scan_linear")
    return tuple(outs[k] for k in OUTPUTS), scratch is not None


def traceback_linear_reference(book: torch.Tensor, bkp: torch.Tensor, pred: torch.Tensor,
                               origin: torch.Tensor, silend: torch.Tensor,
                               silorg: torch.Tensor, feat_len: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``traceback_linear`` (any device). Same
    contract. ``argmin`` picks the first index of the least value, and the
    first NaN where a row holds one (its silence test is then false), as
    JAX's ``jnp.argmin`` and ``min`` do."""
    T, B, W = book.shape
    device = book.device
    if T == 0:
        return torch.full((MAX_TRACE_WORDS, B), -1, dtype=torch.int32, device=device)
    bi = torch.arange(B, device=device)
    lens = feat_len.to(device=device, dtype=torch.int64)
    tb = lens.clamp(min=1)
    tl = (tb - 1).clamp(max=T - 1)          # the reference's gathers clamp
    fb = book[tl, bi]                       # [B, W]
    fsil = silend[tl, bi]                   # [B, V]
    w_best = fb.argmin(dim=1)
    sil_v = fsil.argmin(dim=1)
    use_sil = fsil.amin(dim=1) < fb[bi, w_best]
    cur = torch.where(use_sil, sil_v, w_best)
    t = torch.where(use_sil, silorg[tl, bi, sil_v].long(), tb)
    done = (cur >= W) | (t <= 0) | (lens == 0)
    words = []
    for _ in range(MAX_TRACE_WORDS):
        words.append(torch.where(done, torch.full_like(cur, -1), cur))
        tc = (t - 1).clamp(0, T - 1)
        cc = cur.clamp(0, W - 1)
        boundary = bkp[tc, bi, cc].long()
        v = pred[tc, bi, cc].long()
        t_next = origin[boundary.clamp(0, T - 1), bi, v.clamp(0, W)].long()
        new_done = done | (v >= W) | (t_next <= 0)
        cur = torch.where(done, cur, v)
        t = torch.where(done, t, t_next)
        done = new_done
    return torch.stack(words).to(torch.int32)


def traceback_linear(book: torch.Tensor, bkp: torch.Tensor, pred: torch.Tensor,
                     origin: torch.Tensor, silend: torch.Tensor, silorg: torch.Tensor,
                     feat_len: torch.Tensor) -> torch.Tensor:
    """The backward word walk over ``decode_scan_linear``'s outputs →
    int32 [MAX_TRACE_WORDS, B] real-word indices in reverse order (−1
    padding).

    The walk starts at the best of the last frame's word ends and silence
    copy ends (a silence copy only when strictly better), and steps from a
    word to its predecessor at its entry boundary, through that
    predecessor's silence copy's origin; it stops at the sentence start, at
    frame 0 or after MAX_TRACE_WORDS words. CPU tensors take the plain
    version; CUDA tensors launch kernel N's warp design (counted in
    ``traceback_linear.LAUNCHES``), a warp an utterance."""
    if book.device.type == "cpu":
        return traceback_linear_reference(book, bkp, pred, origin, silend, silorg, feat_len)
    words = traceback_linear_cuda(book, bkp, pred, origin, silend, silorg, feat_len)
    traceback_linear.LAUNCHES += 1
    return words


traceback_linear.LAUNCHES = 0


def traceback_linear_cuda(book: torch.Tensor, bkp: torch.Tensor, pred: torch.Tensor,
                          origin: torch.Tensor, silend: torch.Tensor, silorg: torch.Tensor,
                          feat_len: torch.Tensor, first_design: bool = False) -> torch.Tensor:
    """Kernel N's launch on CUDA tensors, as ``traceback_linear`` makes it
    but not counted. ``first_design`` launches the first design (a thread
    an utterance, all MAX_TRACE_WORDS steps) in place of the warp design,
    for timing the two in turns; only this argument launches it."""
    if book.device.type != "cuda":
        raise ValueError(f"traceback_linear: unsupported device {book.device}")
    if book.dtype not in (torch.float32, torch.float64) or silend.dtype != book.dtype:
        raise TypeError("traceback_linear: book and silend must be float32 or float64 alike")
    T, B, W = book.shape
    V = W + 1
    device = book.device
    ints = _native.typed_args("traceback_linear", device, torch.int32,
                              bkp=(bkp, (T, B, W)), pred=(pred, (T, B, W)),
                              origin=(origin, (T, B, V)), silorg=(silorg, (T, B, V)),
                              feat_len=(feat_len, (B,)))
    fl = _native.typed_args("traceback_linear", device, book.dtype,
                            book=(book, (T, B, W)), silend=(silend, (T, B, V)))
    if T == 0:
        return torch.full((MAX_TRACE_WORDS, B), -1, dtype=torch.int32, device=device)
    words = torch.empty((MAX_TRACE_WORDS, B), dtype=torch.int32, device=device)
    err = _native.load().sr_linear_traceback(
        int(book.dtype == torch.float64), fl["book"].data_ptr(), ints["bkp"].data_ptr(),
        ints["pred"].data_ptr(), ints["origin"].data_ptr(), fl["silend"].data_ptr(),
        ints["silorg"].data_ptr(), ints["feat_len"].data_ptr(), words.data_ptr(), B, T, W,
        MAX_TRACE_WORDS, int(bool(first_design)), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "traceback_linear")
    return words


@dataclass
class LinearTables:
    """Everything ``decode_scan_linear`` reads besides am and the lengths:
    the real words' tables (silence taken off the word axis), the silence's,
    and the boundary matrix with its start row, built once on the host as
    the reference's ``decode_batch_linear_lvcsr`` builds them."""

    real: np.ndarray            # int32 [W]: lexicon index of each real word
    state_table: np.ndarray
    last_pos: np.ndarray
    word_len: np.ndarray
    tdp_within: np.ndarray
    entry_pen: np.ndarray
    sil_states: np.ndarray
    sil_tdp: np.ndarray
    sil_entry_pen: np.ndarray
    #: the silence exit, rounded to float32 as the reference passes it (its
    #: float64 scan then widens the float32 value)
    sil_exit: float
    lm_ext: np.ndarray          # [W+1, W]

    @staticmethod
    def build(tables: DecoderTables, lm_matrix: np.ndarray, lm_start: np.ndarray,
              silence_idx: int) -> "LinearTables":
        real = np.asarray([w for w in range(tables.num_words) if w != silence_idx], np.int32)
        sl = int(tables.word_len[silence_idx])
        lm_matrix = np.asarray(lm_matrix)
        lm_r = lm_matrix[np.ix_(real, real)]
        return LinearTables(
            real=real, state_table=tables.state_table[real], last_pos=tables.last_pos[real],
            word_len=tables.word_len[real], tdp_within=tables.tdp_within[real],
            entry_pen=tables.entry_pen[real],
            sil_states=tables.state_table[silence_idx, :sl],
            sil_tdp=tables.tdp_within[silence_idx, :sl],
            sil_entry_pen=tables.entry_pen[silence_idx],
            sil_exit=float(np.float32(lm_matrix[real[0], silence_idx])),
            lm_ext=np.concatenate([lm_r, np.asarray(lm_start)[real][None, :]], axis=0))

    def args(self, device, dtype: torch.dtype, num_states: int) -> Tuple:
        """decode_scan_linear's arguments after am and feat_len, on
        ``device`` in the scan's types; raises unless every state index is
        inside [0, num_states) and every last position inside the lattice."""
        W, P = self.state_table.shape
        for name, a in (("state_table", self.state_table), ("sil_states", self.sil_states)):
            if a.size and (a.min() < 0 or a.max() >= num_states):
                raise ValueError(f"LinearTables.{name} outside [0, {num_states})")
        if W and (self.last_pos.min() < 0 or self.last_pos.max() >= P):
            raise ValueError(f"LinearTables.last_pos outside [0, {P})")

        def ints(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        def floats(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

        return (ints(self.state_table), ints(self.last_pos), ints(self.word_len),
                floats(self.tdp_within), floats(self.entry_pen), ints(self.sil_states),
                floats(self.sil_tdp), floats(self.sil_entry_pen), self.sil_exit,
                floats(self.lm_ext))


@tracing.span("lvcsr.decode")
def decode_batch_linear_lvcsr(pack, feats, feat_len: np.ndarray, tables: DecoderTables,
                              lm_matrix: np.ndarray, lm_start: np.ndarray,
                              am_threshold: float, silence_idx: int, prune: bool = True,
                              am: Optional[torch.Tensor] = None,
                              dtype: torch.dtype = torch.float32) -> List[List[int]]:
    """Decode → word sequences (silence removed; word indices are the
    lexicon's).

    ``tables`` from ``TransitionModel.decoder_tables`` over the full lexicon;
    lm_matrix / lm_start as ``tools.an4_system.build_lm_matrices`` builds
    them (boundary costs, LM·scale + the target word's exit, on the full
    word axis, with lm[:, silence] the silence exit). ``am`` may carry
    precomputed [B, T, S] acoustic scores (``pack`` is then unused). Runs on
    the pack's device, or with ``am`` on its device: the scan (kernel M) and
    the traceback (kernel N) on the card, and only the [MAX_TRACE_WORDS, B]
    word ids come back."""
    device = pack.device if am is None else am.device
    B, T, dim = feats.shape
    feat_len = np.asarray(feat_len)
    if tracing.enabled():
        tracing.count("lvcsr.frames_real", int(feat_len.sum()))
        tracing.count("lvcsr.frames_padded", B * T)
    if am is None:
        flat = torch.as_tensor(np.asarray(feats), dtype=torch.float32,
                               device=device).reshape(B * T, dim)
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
    am = am.to(device=device, dtype=dtype).contiguous()
    with tracing.span("lvcsr.tables"):
        lt = LinearTables.build(tables, lm_matrix, lm_start, silence_idx)
    # the first blocking copy waits for what the stream holds before it
    with tracing.span("lvcsr.tables_to_device"):
        args = lt.args(device, dtype, am.shape[2])
        lens = torch.as_tensor(feat_len, dtype=torch.int32, device=device)
    with tracing.span("lvcsr.scan"):
        outs = decode_scan_linear(am, lens, *args, am_threshold, prune=prune)
    book, bkp, pred, _via, origin, silend, silorg, _offset = outs
    with tracing.span("lvcsr.traceback"):
        words = traceback_linear(book, bkp, pred, origin, silend, silorg, lens)
    with tracing.span("lvcsr.words_to_host"):
        words = words.cpu().numpy()
    with tracing.span("lvcsr.results"):
        results = word_lists(words, lt.real)
        if tracing.enabled():
            tracing.count("lvcsr.words_out", sum(map(len, results)))
    return results


def word_lists(words: np.ndarray, real: np.ndarray) -> List[List[int]]:
    """Kernel N's [MAX_TRACE_WORDS, B] word ids (reverse order, −1 empty)
    → one list of lexicon indices ``real[id]`` an utterance, in spoken
    order, the −1 slots left out wherever they lie. One numpy pass and one
    ``tolist()``; the flat list is cut at each utterance's count."""
    spoken = words.T[:, ::-1]
    keep = spoken >= 0
    flat = real[spoken[keep]].tolist()
    results: List[List[int]] = []
    start = 0
    for end in np.cumsum(keep.sum(axis=1)).tolist():
        results.append(flat[start:end])
        start = end
    return results
