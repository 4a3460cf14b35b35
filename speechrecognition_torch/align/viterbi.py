"""Batched Viterbi forced alignment over a dense [B, A] position lattice —
counterpart of speechrecognition_tpu/align/viterbi.py.

The reference aligns one utterance at a time with per-frame beam maps
(src/sietill/Alignment.cpp:149-288). Here the whole batch advances one frame
per step over a dense [B, A] position lattice; beam pruning is a per-row
threshold mask, so the result is exactly the reference's pruned semantics.

Tie-breaking: the reference's pruned aligner inserts hypotheses in ascending
predecessor order with strict-< updates, so on equal scores the smallest
predecessor (largest jump) wins (Alignment.cpp:173-207); the full DP prefers
the loop (Alignment.cpp:96-113). Both orders are provided (``tie_pruned``).

Final state: the pruned aligner backtracks from the highest reached position
in the last frame (Alignment.cpp:248-256); the full DP forces the last one.

The DP runs in time chunks of ALIGN_CHUNK frames through a carried cost row:

  * ``align_fwd_chunk`` (float32 or float64): kernel E, ``csrc/align_scan.cu``;
  * ``align_fwd_chunk_df`` (double-float pairs): kernel F,
    ``csrc/align_scan_df.cu``;
  * ``align_backtrack`` (final position, backward walk over every chunk,
    position → state): kernel G, ``csrc/align_backtrack.cu``.

Each takes its plain PyTorch version (``*_reference``) for CPU tensors and
launches its kernel for CUDA tensors; there is no fallback from one to the
other. The plain versions follow the reference package's ``_align_fwd_chunk``,
``_align_fwd_chunk_df``, ``_final_pos_dev``, ``_align_bwd_chunk`` and
``_states_from_positions`` operation by operation, so both are bit-equal to
it. States come back as int32 (the reference's int16 only narrowed a
host transfer).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..lexicon import MarkovAutomaton
from ..models import gmm as gmm_mod
from ..ops import _native
from ..ops import doublefloat as dfm
from ..tdp import TdpModel

BIG = np.float64(1e30)  # pseudo-infinity that stays NaN-free under adds
#: frames per forward chunk: one (B, ALIGN_CHUNK) step serves utterances of
#: any length by streaming chunks through the carried cost row
ALIGN_CHUNK = 320


@dataclass
class AlignerTables:
    """Static per-batch tables for a set of segment automata."""

    states: np.ndarray   # int32 [B, A_max] global state per position (padded w/ last)
    lengths: np.ndarray  # int32 [B] automaton positions
    tdp: np.ndarray      # f64 [B, A_max, 3] penalty into position a with jump j

    @staticmethod
    def build(automata: List[MarkovAutomaton], tdp_model: TdpModel,
              pad_to: Optional[int] = None) -> "AlignerTables":
        B = len(automata)
        A = pad_to or max(a.num_states for a in automata)
        states = np.zeros((B, A), dtype=np.int32)
        lengths = np.zeros(B, dtype=np.int32)
        for i, a in enumerate(automata):
            states[i, : a.num_states] = a.states
            states[i, a.num_states:] = a.last_state
            lengths[i] = a.num_states
        tdp = tdp_model.table_for_states(states)
        return AlignerTables(states=states, lengths=lengths, tdp=tdp)

    def rows(self, ids) -> "AlignerTables":
        return AlignerTables(states=self.states[ids], lengths=self.lengths[ids],
                             tdp=self.tdp[ids])


# -- kernel E: one forward chunk, float32 / float64 ------------------------------


def _shift(x: torch.Tensor, k: int, tdp_k: torch.Tensor, big: torch.Tensor) -> torch.Tensor:
    """x[:, a-k] + tdp_k[:, a] for a >= k, BIG below (the jump-k candidate)."""
    B, A = x.shape
    if k == 0:
        return x + tdp_k
    if k >= A:
        return big.expand(B, A)
    return torch.cat([big.expand(B, k), x[:, :A - k] + tdp_k[:, k:]], dim=1)


def align_fwd_chunk_reference(prev: torch.Tensor, ams: torch.Tensor, tdp: torch.Tensor,
                              pos_valid: torch.Tensor, feat_len: torch.Tensor,
                              pruning_threshold, t0: int, tie_pruned: bool = True,
                              use_pruning: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``align_fwd_chunk``, one frame per loop step
    (any float dtype, any device). Same contract."""
    B, C, A = ams.shape
    dtype, device = ams.dtype, ams.device
    big = torch.tensor(float(BIG), dtype=dtype, device=device)
    half_big = big * 0.5
    thr = torch.tensor(float(pruning_threshold), dtype=dtype, device=device)
    tdp = tdp.to(device=device, dtype=dtype)
    invalid = ~pos_valid.to(device=device, dtype=torch.bool)
    first = (torch.arange(A, device=device) == 0)[None, :] & ~invalid
    lens = feat_len.to(device)
    jumps = torch.empty((C, B, A), dtype=torch.int8, device=device)
    for i in range(C):
        t = t0 + i
        am_t = ams[:, i]
        cands = [(_shift(prev, j, tdp[:, :, j], big), j) for j in range(3)]
        if tie_pruned:    # largest jump wins ties (first writer)
            cands.reverse()
        best, j0 = cands[0]
        jump = torch.full((B, A), j0, dtype=torch.int8, device=device)
        for c, j in cands[1:]:
            take = c < best
            best = torch.where(take, c, best)
            jump = jump.masked_fill(take, j)
        cost = torch.where(invalid, big, best + am_t)
        cost = torch.minimum(cost, big)
        # renormalize per frame: decisions are invariant under a shared
        # offset, and the float32 carry stays O(threshold)
        row_best = cost.amin(dim=1, keepdim=True)
        row_best = torch.where(row_best >= half_big, torch.zeros_like(row_best), row_best)
        cost = torch.where(cost >= half_big, big, cost - row_best)
        if use_pruning:
            cost = torch.where(cost > thr, big, cost)
        if t == 0:        # fresh init at position 0, no renorm or prune
            cost = torch.where(first, am_t, big)
        prev = torch.where((t < lens)[:, None], cost, prev)
        jumps[i] = jump
    return prev, jumps


def align_fwd_chunk(prev: torch.Tensor, ams: torch.Tensor, tdp: torch.Tensor,
                    pos_valid: torch.Tensor, feat_len: torch.Tensor, pruning_threshold,
                    t0: int, tie_pruned: bool = True,
                    use_pruning: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward chunk of the banded (0-1-2) Viterbi DP.

    prev [B, A] cost row entering the chunk (ignored when t0 == 0); ams
    [B, C, A] emission scores per position; tdp [B, A, 3]; pos_valid bool
    [B, A]; feat_len int [B]. Global frame t0+i is initialised, not recursed,
    at t == 0; rows with t >= feat_len keep their carry. Returns (cost row
    after the chunk [B, A], jumps int8 [C, B, A]).

    CPU tensors take the plain version; CUDA tensors launch kernel E
    (float32 or float64; counted in ``align_fwd_chunk.LAUNCHES``), whose C
    entry chooses its instance from A alone (``sr_align_fwd_warps``,
    ``sr_align_fwd_positions``): any A is taken, as the reference takes it.
    Launches whose row lives in device scratch (A > 1024) are also counted
    in ``SCRATCH_LAUNCHES``."""
    if ams.device.type == "cpu":
        return align_fwd_chunk_reference(prev, ams, tdp, pos_valid, feat_len,
                                         pruning_threshold, t0, tie_pruned, use_pruning)
    out, jumps, in_scratch = align_fwd_chunk_cuda(prev, ams, tdp, pos_valid, feat_len,
                                                  pruning_threshold, t0, tie_pruned, use_pruning)
    align_fwd_chunk.LAUNCHES += 1
    align_fwd_chunk.SCRATCH_LAUNCHES += in_scratch
    return out, jumps


def align_fwd_chunk_cuda(prev: torch.Tensor, ams: torch.Tensor, tdp: torch.Tensor,
                         pos_valid: torch.Tensor, feat_len: torch.Tensor, pruning_threshold,
                         t0: int, tie_pruned: bool = True, use_pruning: bool = True,
                         first_design: bool = False) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Kernel E's launch on CUDA tensors, as ``align_fwd_chunk`` makes it
    but not counted: returns (the cost row, the jumps, whether the row lived
    in device scratch). ``first_design`` launches the block instance with
    its row in shared memory where the wide instance runs (128 < A <=
    1024), so that the two can be timed in turns; it changes nothing at
    other A."""
    device = ams.device
    if device.type != "cuda":
        raise ValueError(f"align_fwd_chunk: unsupported device {device}")
    dtype = ams.dtype
    if dtype not in _FWD_ENTRY:
        raise TypeError(f"align_fwd_chunk: the CUDA kernel runs float32 or float64, got {dtype}")
    if ams.dim() != 3 or not ams.is_contiguous():
        raise ValueError("align_fwd_chunk: ams must be a contiguous [B, C, A] tensor")
    B, C, A = ams.shape
    for name, t, shape, dt in (("prev", prev, (B, A), dtype), ("tdp", tdp, (B, A, 3), dtype)):
        if t.device != device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"align_fwd_chunk: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {device}")
    pv, lens = _check_tables("align_fwd_chunk", pos_valid, feat_len, B, A, device)
    out = torch.empty_like(prev)
    jumps = torch.empty((C, B, A), dtype=torch.int8, device=device)
    lib = _native.load()
    # the block instance keeps the row in device scratch past A = 1024
    scratch = (torch.empty(2 * B * A, dtype=dtype, device=device)
               if lib.sr_align_fwd_warps(A) < 0 else None)
    thr = float(torch.tensor(float(pruning_threshold), dtype=dtype))
    err = getattr(lib, _FWD_ENTRY[dtype])(
        prev.data_ptr(), ams.data_ptr(), tdp.data_ptr(), pv.data_ptr(), lens.data_ptr(),
        out.data_ptr(), jumps.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, C, A, int(t0), thr, int(bool(tie_pruned)), int(bool(use_pruning)),
        int(bool(first_design)), device.index, torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "align_fwd_chunk")
    return out, jumps, scratch is not None


align_fwd_chunk.LAUNCHES = align_fwd_chunk.SCRATCH_LAUNCHES = 0

#: kernel E's C entry point for each score type
_FWD_ENTRY = {torch.float32: "sr_align_fwd", torch.float64: "sr_align_fwd_f64"}


def _check_tables(what: str, pos_valid: torch.Tensor, feat_len: torch.Tensor, B: int,
                  A: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos_valid and feat_len in the kernels' types (uint8 [B, A], int32 [B])."""
    for name, t, shape in (("pos_valid", pos_valid, (B, A)), ("feat_len", feat_len, (B,))):
        if t.device != device or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be a {shape} tensor on {device}")
    return (pos_valid.to(torch.uint8).contiguous(), feat_len.to(torch.int32).contiguous())


# -- kernel F: one forward chunk in double-float ---------------------------------


def align_fwd_chunk_df_reference(prev: dfm.DF, ams: dfm.DF, tdp: dfm.DF,
                                 pos_valid: torch.Tensor, feat_len: torch.Tensor,
                                 thr: dfm.DF, t0: int, tie_pruned: bool = True,
                                 use_pruning: bool = True) -> Tuple[dfm.DF, torch.Tensor]:
    """Plain PyTorch version of ``align_fwd_chunk_df`` (any device), the
    reference's ``_align_fwd_chunk_df`` op by op. Same contract."""
    dfm.require_f32("align_fwd_chunk_df", prev.hi, prev.lo, ams.hi, ams.lo, tdp.hi, tdp.lo,
                    thr.hi, thr.lo)
    B, C, A = ams.hi.shape
    device = ams.hi.device
    bigf = float(np.float32(BIG))
    half_big = bigf * 0.5          # exact in float32 and in float64
    big = dfm.DF(torch.full((B, A), bigf, device=device),
                 torch.zeros((B, A), device=device))
    big_t = torch.tensor(bigf, device=device)
    invalid = ~pos_valid.to(device=device, dtype=torch.bool)
    first = (torch.arange(A, device=device) == 0)[None, :] & ~invalid
    lens = feat_len.to(device)
    thr_full = dfm.DF(thr.hi.expand(B, A), thr.lo.expand(B, A))

    def cand(x: dfm.DF, k: int) -> dfm.DF:
        """x shifted k positions right plus the jump-k TDP, (BIG, 0) below k."""
        if k >= A:
            return big
        moved = dfm.add(dfm.DF(x.hi[:, :A - k], x.lo[:, :A - k]),
                        dfm.DF(tdp.hi[:, k:, k], tdp.lo[:, k:, k]))
        if k == 0:
            return moved
        return dfm.DF(torch.cat([big_t.expand(B, k), moved.hi], dim=1),
                      torch.cat([torch.zeros((B, k), device=device), moved.lo], dim=1))

    jumps = torch.empty((C, B, A), dtype=torch.int8, device=device)
    for i in range(C):
        t = t0 + i
        am_t = dfm.DF(ams.hi[:, i], ams.lo[:, i])
        cands = [(cand(prev, j), j) for j in range(3)]
        if tie_pruned:    # largest jump wins ties (first writer)
            cands.reverse()
        best, j0 = cands[0]
        jump = torch.full((B, A), j0, dtype=torch.int8, device=device)
        for c, j in cands[1:]:
            take = dfm.less(c, best)
            best = dfm.where(take, c, best)
            jump = jump.masked_fill(take, j)
        cost = dfm.where(invalid, big, dfm.add(best, am_t))
        cost = dfm.where(cost.hi >= half_big, big, cost)
        row_best = dfm.min_axis(cost, 1)
        dead = row_best.hi >= half_big
        row_best = dfm.DF(torch.where(dead, 0.0, row_best.hi)[:, None],
                          torch.where(dead, 0.0, row_best.lo)[:, None])
        shifted = dfm.sub(cost, dfm.DF(row_best.hi.expand(B, A), row_best.lo.expand(B, A)))
        cost = dfm.where(cost.hi >= half_big, big, shifted)
        if use_pruning:
            cost = dfm.where(~dfm.less_equal(cost, thr_full), big, cost)
        if t == 0:        # fresh init at position 0, no renorm or prune
            cost = dfm.where(first, am_t, big)
        prev = dfm.where((t < lens)[:, None], cost, prev)
        jumps[i] = jump
    return prev, jumps


def align_fwd_chunk_df(prev: dfm.DF, ams: dfm.DF, tdp: dfm.DF, pos_valid: torch.Tensor,
                       feat_len: torch.Tensor, thr: dfm.DF, t0: int, tie_pruned: bool = True,
                       use_pruning: bool = True) -> Tuple[dfm.DF, torch.Tensor]:
    """Double-float twin of ``align_fwd_chunk``: prev DF [B, A], ams DF
    [B, C, A], tdp DF [B, A, 3] (the float64 table split on the host), thr a
    DF scalar. Returns (DF cost row after the chunk, jumps int8 [C, B, A]).

    CPU tensors take the plain version; CUDA tensors launch kernel F
    (counted in ``align_fwd_chunk_df.LAUNCHES``), whose C entry chooses its
    instance from A alone (``sr_align_fwd_df_warps``,
    ``sr_align_fwd_df_positions``): any A is taken. Launches whose row
    lives in device scratch (A > 1024) are also counted in
    ``SCRATCH_LAUNCHES``."""
    device = ams.hi.device
    if device.type == "cpu":
        return align_fwd_chunk_df_reference(prev, ams, tdp, pos_valid, feat_len, thr, t0,
                                            tie_pruned, use_pruning)
    out, jumps, in_scratch = align_fwd_chunk_df_cuda(prev, ams, tdp, pos_valid, feat_len, thr,
                                                     t0, tie_pruned, use_pruning)
    align_fwd_chunk_df.LAUNCHES += 1
    align_fwd_chunk_df.SCRATCH_LAUNCHES += in_scratch
    return out, jumps


def align_fwd_chunk_df_cuda(prev: dfm.DF, ams: dfm.DF, tdp: dfm.DF, pos_valid: torch.Tensor,
                            feat_len: torch.Tensor, thr: dfm.DF, t0: int,
                            tie_pruned: bool = True, use_pruning: bool = True,
                            first_design: bool = False) -> Tuple[dfm.DF, torch.Tensor, bool]:
    """Kernel F's launch on CUDA tensors, as ``align_fwd_chunk_df`` makes it
    but not counted: returns (the cost row, the jumps, whether the row lived
    in device scratch). ``first_design`` launches the block instance with
    its row in shared memory where the wide instance runs (128 < A <=
    1024), so that the two can be timed in turns; it changes nothing at
    other A."""
    device = ams.hi.device
    if device.type != "cuda":
        raise ValueError(f"align_fwd_chunk_df: unsupported device {device}")
    if ams.hi.dim() != 3:
        raise ValueError("align_fwd_chunk_df: ams must be a [B, C, A] pair")
    B, C, A = ams.hi.shape
    for name, (pair, shape) in {"prev": (prev, (B, A)), "ams": (ams, (B, C, A)),
                                "tdp": (tdp, (B, A, 3))}.items():
        for t in pair:
            if t.device != device or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"align_fwd_chunk_df: {name} must be a contiguous "
                                 f"{shape} pair on {device}")
        dfm.require_f32(f"align_fwd_chunk_df: {name}", *pair)
    dfm.require_f32("align_fwd_chunk_df: thr", thr.hi, thr.lo)
    pv, lens = _check_tables("align_fwd_chunk_df", pos_valid, feat_len, B, A, device)
    out = dfm.DF(torch.empty_like(prev.hi), torch.empty_like(prev.lo))
    jumps = torch.empty((C, B, A), dtype=torch.int8, device=device)
    lib = _native.load()
    # the block instance keeps the row's pairs (and its NaN fold's) in device
    # scratch past A = 1024
    scratch = (torch.empty(2 * B * lib.sr_align_fwd_df_scratch(A), dtype=torch.float32,
                           device=device)
               if lib.sr_align_fwd_df_warps(A) < 0 else None)
    err = lib.sr_align_fwd_df(
        prev.hi.data_ptr(), prev.lo.data_ptr(), ams.hi.data_ptr(), ams.lo.data_ptr(),
        tdp.hi.data_ptr(), tdp.lo.data_ptr(), pv.data_ptr(), lens.data_ptr(),
        out.hi.data_ptr(), out.lo.data_ptr(), jumps.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, C, A, int(t0),
        float(thr.hi), float(thr.lo), int(bool(tie_pruned)), int(bool(use_pruning)),
        int(bool(first_design)), device.index, torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "align_fwd_chunk_df")
    return out, jumps, scratch is not None


align_fwd_chunk_df.LAUNCHES = align_fwd_chunk_df.SCRATCH_LAUNCHES = 0


# -- kernel G: final position, backward walk, position → state --------------------


def align_backtrack_reference(final_hi: torch.Tensor, aut_len: torch.Tensor,
                              jumps: torch.Tensor, feat_len: torch.Tensor,
                              states_tbl: torch.Tensor, T: int,
                              tie_pruned: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``align_backtrack`` (any device). Same contract."""
    Tp, B, A = jumps.shape
    device = jumps.device
    if tie_pruned:    # highest reached finite position (Alignment.cpp:248-253)
        finite = final_hi.to(torch.float32) < float(np.float32(BIG * 0.5))
        pos = torch.where(finite, torch.arange(A, device=device)[None, :], -1).amax(dim=1)
        final_pos = pos.clamp(min=0).to(torch.int32)
    else:             # forced last position
        final_pos = (aut_len.to(device) - 1).to(torch.int32)
    lens = feat_len.to(device=device, dtype=torch.long)
    tbl = states_tbl.to(device=device, dtype=torch.long)
    fp = final_pos.long()
    cur = fp
    out = torch.empty((T, B), dtype=torch.int32, device=device)
    for t in range(Tp - 1, -1, -1):
        idx = _wrap(cur, A)[:, None]
        if t < T:
            out[t] = tbl.gather(1, idx)[:, 0].to(torch.int32)
        if t == 0:
            break
        prev_pos = cur - jumps[t].long().gather(1, idx)[:, 0]
        cur = torch.where(t <= lens - 1, prev_pos, fp)
    return out.t().contiguous(), final_pos


def _wrap(cur: torch.Tensor, A: int) -> torch.Tensor:
    """Column index of position ``cur``: a negative one counts from the end,
    once, as the reference's take_along_axis does; clamped to the row so a
    path through an unreachable forced final position stays defined."""
    return torch.where(cur < 0, cur + A, cur).clamp(0, A - 1)


def align_backtrack(final_hi: torch.Tensor, aut_len: torch.Tensor, jumps: torch.Tensor,
                    feat_len: torch.Tensor, states_tbl: torch.Tensor, T: int,
                    tie_pruned: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The alignment from the forward jumps of every chunk.

    final_hi float32 [B, A]: the cost row after the last chunk (its hi words
    on the df32 path); aut_len int [B]; jumps int8 [Tp, B, A] for global
    frames 0..Tp-1; feat_len int [B]; states_tbl int [B, A]. The final
    position is the highest finite one (``tie_pruned``) or aut_len - 1;
    frames past feat_len - 1 emit the current position and reset it to the
    final one; frame 0 keeps it. Returns (states int32 [B, T], final
    position int32 [B]).

    CPU tensors take the plain version; CUDA tensors launch kernel G
    (counted in ``align_backtrack.LAUNCHES``), one warp an utterance walking
    its jump rows out of shared memory a tile at a time, for any A
    (``sr_align_backtrack_tile`` gives the frames a tile)."""
    device = jumps.device
    if device.type == "cpu":
        return align_backtrack_reference(final_hi, aut_len, jumps, feat_len, states_tbl, T,
                                         tie_pruned)
    if device.type != "cuda":
        raise ValueError(f"align_backtrack: unsupported device {device}")
    if jumps.dim() != 3 or jumps.dtype != torch.int8 or not jumps.is_contiguous():
        raise ValueError("align_backtrack: jumps must be a contiguous int8 [Tp, B, A] tensor")
    if jumps.data_ptr() % 16:
        jumps = jumps.clone()   # the kernel copies whole 16-byte chunks of the rows
    Tp, B, A = jumps.shape
    if not 0 <= T <= Tp:
        raise ValueError(f"align_backtrack: T={T} outside [0, {Tp}]")
    if final_hi.dtype != torch.float32 or tuple(final_hi.shape) != (B, A) \
            or final_hi.device != device or not final_hi.is_contiguous():
        raise ValueError(f"align_backtrack: final_hi must be a contiguous float32 "
                         f"{(B, A)} tensor on {device}")
    ints = {}
    for name, t, shape in (("aut_len", aut_len, (B,)), ("feat_len", feat_len, (B,)),
                           ("states_tbl", states_tbl, (B, A))):
        if t.device != device or tuple(t.shape) != shape:
            raise ValueError(f"align_backtrack: {name} must be a {shape} tensor on {device}")
        ints[name] = t.to(torch.int32).contiguous()
    states = torch.empty((B, T), dtype=torch.int32, device=device)
    final_pos = torch.empty((B,), dtype=torch.int32, device=device)
    err = _native.load().sr_align_backtrack(
        final_hi.data_ptr(), ints["aut_len"].data_ptr(), jumps.data_ptr(),
        ints["feat_len"].data_ptr(), ints["states_tbl"].data_ptr(), states.data_ptr(),
        final_pos.data_ptr(), B, A, Tp, int(T), int(bool(tie_pruned)), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "align_backtrack")
    align_backtrack.LAUNCHES += 1
    return states, final_pos


align_backtrack.LAUNCHES = 0


# -- batch aligners ------------------------------------------------------------------


def align_batch_chunked(pack, feats, feat_len, tables: AlignerTables,
                        pruning_threshold: Optional[float] = 50.0,
                        tie_pruned: bool = True, dtype=torch.float32,
                        chunk: int = ALIGN_CHUNK, return_device: bool = False,
                        ) -> Tuple[object, Optional[np.ndarray]]:
    """Align a padded batch chunk by chunk on the pack's device.

    pack: gmm.ScorePack (float32/float64 ``dtype``) or gmm.ScorePackDF with
    ``dtype="df32"``; feats float32 [B, T, dim] (numpy, or a tensor on the
    pack's device), zero-padded; feat_len int [B]; pruning_threshold None →
    full DP (no pruning, forced final position). Per chunk: acoustic scores
    (``am_scores``, or kernel C on the df32 path), the gather of each
    position's state, the forward chunk (kernel E or F); then kernel G.

    Returns (states int32 [B, T] numpy, costs [B] numpy — float64 on the
    df32 path) or, with ``return_device=True``, (states int32 [B, T] on the
    device, None) without synchronising."""
    device = pack.device
    feats = torch.as_tensor(feats, dtype=torch.float32, device=device)
    B, T, dim = feats.shape
    n_chunks = -(-T // chunk)
    Tp = n_chunks * chunk
    if T < Tp:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, Tp - T))
    states_tbl = torch.as_tensor(tables.states, dtype=torch.int32, device=device)
    aut_len = torch.as_tensor(tables.lengths, dtype=torch.int32, device=device)
    A = states_tbl.shape[1]
    pos_valid = torch.arange(A, device=device)[None, :] < aut_len[:, None]
    use_pruning = pruning_threshold is not None
    thr64 = np.float64(pruning_threshold if use_pruning else 0.0)
    lens = torch.as_tensor(np.asarray(feat_len), dtype=torch.int32, device=device)
    idx = states_tbl.long()[:, None, :].expand(B, chunk, A)
    S = pack.num_mixtures
    is_df = dtype == "df32"
    if is_df:
        thr = dfm.from_f64(thr64, device)
        tdp = dfm.from_f64(tables.tdp, device)
        prev = dfm.DF(torch.full((B, A), float(np.float32(BIG)), device=device),
                      torch.zeros((B, A), device=device))
    else:
        tdp = torch.as_tensor(tables.tdp, dtype=dtype, device=device)
        prev = torch.full((B, A), float(BIG), dtype=dtype, device=device)

    jumps = []
    for ci in range(n_chunks):
        fl = feats[:, ci * chunk:(ci + 1) * chunk].reshape(B * chunk, dim)
        if is_df:
            am = gmm_mod.am_scores_df(pack, fl)
            ams = dfm.DF(am.hi.reshape(B, chunk, S).gather(2, idx),
                         am.lo.reshape(B, chunk, S).gather(2, idx))
            prev, j = align_fwd_chunk_df(prev, ams, tdp, pos_valid, lens, thr, ci * chunk,
                                         tie_pruned=tie_pruned, use_pruning=use_pruning)
        else:
            am = gmm_mod.am_scores(pack, fl).reshape(B, chunk, S).to(dtype)
            prev, j = align_fwd_chunk(prev, am.gather(2, idx), tdp, pos_valid, lens,
                                      float(thr64), ci * chunk, tie_pruned=tie_pruned,
                                      use_pruning=use_pruning)
        jumps.append(j)
    final = prev.hi if is_df else prev
    states, final_pos = align_backtrack(
        final.to(torch.float32).contiguous(), aut_len,
        jumps[0] if n_chunks == 1 else torch.cat(jumps), lens, states_tbl, T,
        tie_pruned=tie_pruned)
    if return_device:
        return states, None
    fp = final_pos.cpu().numpy().astype(np.int64)[:, None]
    if is_df:
        costs = (np.take_along_axis(prev.hi.cpu().numpy(), fp, axis=1)[:, 0].astype(np.float64)
                 + np.take_along_axis(prev.lo.cpu().numpy(), fp, axis=1)[:, 0]
                 .astype(np.float64))
    else:
        costs = np.take_along_axis(prev.cpu().numpy(), fp, axis=1)[:, 0]
    return states.cpu().numpy(), costs


def align_batch(pack, feats, feat_len, tables: AlignerTables,
                pruning_threshold: Optional[float] = 50.0, tie_pruned: bool = True,
                dtype=torch.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Align a padded batch. Returns (states int32 [B, T], costs [B]).

    The reference package's unchunked scan and its chunked one give
    identical results; the port runs every length through the chunked
    path (``align_batch_chunked``)."""
    return align_batch_chunked(pack, feats, feat_len, tables, pruning_threshold,
                               tie_pruned=tie_pruned, dtype=dtype)


def realign_batch(pack, flat: torch.Tensor, idx: np.ndarray, lens: np.ndarray,
                  tables: AlignerTables, pruning_threshold: Optional[float] = 50.0,
                  tie_pruned: bool = True, dtype=torch.float32) -> torch.Tensor:
    """One realignment batch from a device-resident corpus: the [B, T] frame
    index ``idx`` gathers the features from ``flat`` [N, dim] on the device
    (frames at t >= lens are zeroed), then ``align_batch_chunked`` scores,
    aligns and backtracks there. Returns the int32 [B, T] states on the
    device, without synchronising (the reference's ``_realign_batch_dev``)."""
    device = flat.device
    T = idx.shape[1]
    feats = flat[torch.as_tensor(idx, dtype=torch.long, device=device)]
    live = (torch.arange(T, device=device)[None, :]
            < torch.as_tensor(lens, device=device)[:, None])
    feats = torch.where(live[:, :, None], feats, torch.zeros((), device=device))
    states, _ = align_batch_chunked(pack, feats, lens, tables, pruning_threshold,
                                    tie_pruned=tie_pruned, dtype=dtype, return_device=True)
    return states
