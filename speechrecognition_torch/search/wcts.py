"""Word-conditioned tree search with bigram LM contexts and LM lookahead —
counterpart of speechrecognition_tpu/search/wcts.py.

The reference's production decoder (rwth-asr-0.5/src/Search/
WordConditionedTreeSearch.cc + StateTree.cc + LanguageModelLookahead.cc, and
the Teaching skeleton Teaching/WordConditionedTreeSearch.cc:262-345,590-810):
one copy of the lexical prefix tree per predecessor-word context, the bigram
LM score applied when a word END is reached, and exact recombination over
predecessors into a per-word book. Hypotheses live in a [B, C, N] tensor
(C = W + 1 contexts: every word plus the virtual sentence start, N tree
nodes). Per frame:

    tree copy c:  0-1-2 recursion through parent/grand gathers; word
                  entries into depth-1/2 nodes from book_prev[b, c], each
                  charged the ENTERED node's own emission
                  (``build_entry_tables``: ``entry_state = tables.state``)
    word ends:    cand[b, c, w] = hyp[b, c, end_node[w]] + lm_ext[c, w]
                  book[b, w]    = min_c cand[b, c, w]      (recombination)

LM lookahead (LanguageModelLookahead.cc) adds, inside the pruning decision
only, la[c, n] = min over the words below n of lm_ext[c, w]; histogram
pruning (search/histogram.py) then ranks hypotheses by that prospect.

``wcts_scan`` is one chunk of that scan: on CUDA tensors it launches the
hand-written kernel K (``csrc/wcts_scan.cu``), on CPU tensors it runs the
plain PyTorch version ``wcts_scan_reference``. Both follow the reference's
``_wcts_scan`` step for step, with every option: beam pruning, lookahead,
histogram pruning, the word-end tables for lattices, the statistics,
transparent silence and the carry between chunks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..models import gmm as gmm_mod
from ..ops import _native
from ..tdp import TdpModel
from .decoder import BIG
from .histogram import DEFAULT_BINS, histogram_prune
from .tree_decoder import TreeTables


def extend_lm(lm: np.ndarray, lm_start: np.ndarray) -> np.ndarray:
    """[W, W] bigram matrix + [W] start row → [W+1, W] context-extended
    matrix (last row = virtual sentence-start context)."""
    return np.concatenate([np.asarray(lm, np.float64),
                           np.asarray(lm_start, np.float64)[None, :]], axis=0)


def build_entry_tables(tables: TreeTables, tdp_model):
    """Word-entry tables: entries reach depth-1 nodes (jump 1) and depth-2
    nodes (jump 2), each charging the ENTERED node's own emission.

    (On the SieTill lexicon this equals the reference's first-state charge
    bit for bit, since repetitions make depth-1/2 nodes share a state; on a
    repetition-1 lexicon the skip entry lands in another state and pays
    that state's emission — Sprint semantics.)

    ``tdp_model`` may also be a Sprint TransitionModel: entries then charge
    the entry-m1 forward/skip TDPs regardless of the target state's type
    (Am/TransitionModel.cc entry handling, Am/TransitionModel.hh:64-76),
    scaled by the model's tdp scale."""
    N = tables.num_nodes
    entry_state = tables.state.copy()
    entry_pen = np.full(N, float(BIG))
    if hasattr(tdp_model, "entry_m1"):  # Sprint TransitionModel
        scale = getattr(tdp_model, "scale", 1.0)

        def clean(v: float) -> float:
            return float(BIG) if not np.isfinite(v) else scale * float(v)

        for n in range(N):
            d = int(tables.depth[n])
            if d == 1:
                entry_pen[n] = clean(tdp_model.entry_m1.forward)
            elif d == 2:
                entry_pen[n] = clean(tdp_model.entry_m1.skip)
        return entry_state.astype(np.int32), entry_pen
    for n in range(N):
        d = int(tables.depth[n])
        if d == 1:
            entry_pen[n] = tdp_model.score(int(tables.state[n]), 1)
        elif d == 2:
            entry_pen[n] = tdp_model.score(int(tables.state[tables.parent[n]]), 2)
    return entry_state.astype(np.int32), entry_pen


@dataclass
class LookaheadTables:
    """Compressed LM-lookahead structure (Search/LanguageModelLookahead.cc:
    buildCompressesLookaheadStructure + computeScores)."""

    node_id: np.ndarray      # int32 [N] tree node → lookahead id
    word_sets: np.ndarray    # bool [U, W] reachable words per lookahead id
    num_tables: int          # U (compressed entries, reference nEntries_)

    @staticmethod
    def build(tables: TreeTables, cutoff_depth: Optional[int] = None) -> "LookaheadTables":
        N, W = tables.num_nodes, tables.num_words
        parent = tables.parent
        reach = np.zeros((N, W), bool)
        for w in range(W):
            n = int(tables.end_node[w])
            while n != 0:
                reach[n, w] = True
                n = int(parent[n])
        reach[0, :] = True   # the root anticipates every word
        if cutoff_depth is not None:
            # nodes deeper than the cutoff share their ancestor's table
            anc = np.arange(N)
            depth = tables.depth.copy()
            while (depth > cutoff_depth).any():
                deep = depth > cutoff_depth
                anc[deep] = parent[anc[deep]]
                depth[deep] -= 1
            reach = reach[anc]
        word_sets, node_id = np.unique(reach, axis=0, return_inverse=True)
        return LookaheadTables(node_id=node_id.reshape(-1).astype(np.int32),
                               word_sets=word_sets, num_tables=word_sets.shape[0])

    def scores(self, lm_ext: np.ndarray) -> np.ndarray:
        """Per-context lookahead scores la[c, n] = min_{w below n} lm_ext[c, w]."""
        masked = np.where(self.word_sets[None, :, :],
                          np.asarray(lm_ext, np.float64)[:, None, :], BIG)
        return masked.min(axis=2)[:, self.node_id]       # [C, N]


class WctsCarry(NamedTuple):
    """The scan's state between chunks."""

    hyp: torch.Tensor    # [B, C, N] scores
    bkp: torch.Tensor    # [B, C, N] int32 entry frames
    book: torch.Tensor   # [B, W] per-word book of the last frame
    silp: torch.Tensor   # [B, C] per-context silence ends (transparent silence)
    silb: torch.Tensor   # [B, C] int32 their entry frames


def init_carry(B: int, C: int, N: int, W: int, dtype: torch.dtype, device) -> WctsCarry:
    big = float(BIG)
    return WctsCarry(torch.full((B, C, N), big, dtype=dtype, device=device),
                     torch.zeros((B, C, N), dtype=torch.int32, device=device),
                     torch.full((B, W), big, dtype=dtype, device=device),
                     torch.full((B, C), big, dtype=dtype, device=device),
                     torch.zeros((B, C), dtype=torch.int32, device=device))


def wcts_scan_reference(am: torch.Tensor, feat_len: torch.Tensor, state: torch.Tensor,
                        parent: torch.Tensor, grand: torch.Tensor, tdp: torch.Tensor,
                        loop_allowed: torch.Tensor, entry_state: torch.Tensor,
                        entry_pen: torch.Tensor, end_node: torch.Tensor,
                        lm_ext: torch.Tensor, la: torch.Tensor, am_threshold,
                        prune: bool = True, use_lookahead: bool = False,
                        state_limit: int = 0, histogram_bins: int = 0,
                        emit_ends: bool = False, emit_stats: bool = False,
                        transparent_silence: int = -1,
                        carry_in: Optional[WctsCarry] = None, t0: int = 0):
    """Plain PyTorch version of ``wcts_scan``, one frame per loop step (any
    float dtype, any device). Same contract."""
    B, T, S = am.shape
    dtype, device = am.dtype, am.device
    C, W = lm_ext.shape
    N = state.shape[0]
    big = torch.tensor(float(BIG), dtype=dtype, device=device)
    half_big = big * 0.5
    zero = torch.zeros((), dtype=dtype, device=device)
    st, par, gr, est, en = (x.to(device=device, dtype=torch.long)
                            for x in (state, parent, grand, entry_state, end_node))
    tdp = tdp.to(device=device, dtype=dtype)
    entry_pen = entry_pen.to(device=device, dtype=dtype)
    lm_ext = lm_ext.to(device=device, dtype=dtype)
    la = la.to(device=device, dtype=dtype)
    lall = loop_allowed.to(device=device, dtype=torch.bool)
    thr = torch.tensor(float(am_threshold), dtype=dtype, device=device)
    lens = feat_len.to(device)
    transparent = transparent_silence >= 0
    sil = transparent_silence

    hyp, bkp, book, silp, silb = (carry_in if carry_in is not None
                                  else init_carry(B, C, N, W, dtype, device))
    outs: List[List[torch.Tensor]] = []
    for i in range(T):
        t = t0 + i + 1
        tm1 = torch.tensor(t - 1, dtype=torch.int32, device=device)
        # entries per context: ended words carry their book; the virtual
        # start context is open only at the first frame
        start_col = (zero if t == 1 else big).expand(B, 1)
        ext = torch.cat([book, start_col], dim=1)          # [B, C]
        if transparent:
            via_sil = silp < ext
            ext = torch.minimum(ext, silp)

        loop = torch.where(lall[None, None, :], hyp + tdp[None, None, :, 0], big)
        fwd = hyp[:, :, par] + tdp[None, None, :, 1]
        skip = hyp[:, :, gr] + tdp[None, None, :, 2]
        within, wbkp = skip, bkp[:, :, gr]
        for c, b in ((fwd, bkp[:, :, par]), (loop, bkp)):
            take = c < within
            within = torch.where(take, c, within)
            wbkp = torch.where(take, b, wbkp)
        am_t = am[:, i]
        within = within + am_t[:, None, st]

        entry = (ext[:, :, None] + entry_pen[None, None, :]) + am_t[:, None, est]
        take_entry = entry <= within
        new = torch.where(take_entry, entry, within)
        nbkp = torch.where(take_entry, tm1, wbkp)
        new[:, :, 0] = big
        new = torch.minimum(new, big)

        best = new.amin(dim=(1, 2), keepdim=True)
        best = torch.where(best >= half_big, torch.zeros_like(best), best)
        new = torch.where(new >= half_big, big, new - best)
        if prune:
            if use_lookahead:
                ant = torch.where(new >= half_big, big, new + la[None, :, :])
                ant_best = ant.amin(dim=(1, 2), keepdim=True)
                ant_best = torch.where(ant_best >= half_big, torch.zeros_like(ant_best),
                                       ant_best)
                ant_rel = torch.where(ant >= half_big, big, ant - ant_best)
                new = torch.where(ant_rel > thr, big, new)
                # histogram pruning ranks by the prospect (score + lookahead)
                prune_scores = torch.where(new >= half_big, big, ant_rel)
            else:
                new = torch.where(new > thr, big, new)
                prune_scores = new
            if state_limit:
                flat = prune_scores.reshape(B, -1)
                keep, _ = histogram_prune(flat, flat < half_big, state_limit, zero, thr,
                                          histogram_bins or DEFAULT_BINS)
                new = torch.where(keep.reshape(new.shape), new, big)

        # word-end recombination over predecessor contexts
        ends = new[:, :, en]                                 # [B, C, W]
        cand = torch.where(ends >= half_big, big, ends + lm_ext[None, :, :])
        ends_bkp = nbkp[:, :, en]
        if transparent:
            # silence ends stay per context and never recombine
            sil_new = cand[:, :, sil]
            silb_new = ends_bkp[:, :, sil]
            cand = cand.clone()
            cand[:, :, sil] = big
        pred_new = cand.argmin(dim=1).to(torch.int32)        # the first context
        book_new = cand.gather(1, pred_new[:, None, :].long())[:, 0]
        book_bkp = ends_bkp.gather(1, pred_new[:, None, :].long())[:, 0]
        book_new = torch.where(book_new >= half_big, big, book_new)

        alive = t <= lens
        hyp = torch.where(alive[:, None, None], new, hyp)
        bkp = torch.where(alive[:, None, None], nbkp, bkp)
        silb_prev = silb
        book = torch.where(alive[:, None], book_new, book)
        if transparent:
            silp = torch.where(alive[:, None], sil_new, silp)
            silb = torch.where(alive[:, None], silb_new, silb)
        o = [book_new, book_bkp, pred_new, best[:, 0, 0]]
        if emit_ends:
            o += [cand, ends_bkp]
        if emit_stats:
            live = (new < half_big) & alive[:, None, None]
            o += [live.sum(dim=(1, 2)).to(torch.int32),
                  live.any(dim=2).sum(dim=1).to(torch.int32),
                  (book_new < half_big).sum(dim=1).to(torch.int32) * alive.to(torch.int32)]
        if transparent:
            o += [via_sil, silb_prev, silp, silb]
        outs.append(o)
    stacked = tuple(torch.stack([o[k] for o in outs]) for k in range(len(outs[0])))
    return WctsCarry(hyp, bkp, book, silp, silb), stacked


def wcts_scan(am: torch.Tensor, feat_len: torch.Tensor, state: torch.Tensor,
              parent: torch.Tensor, grand: torch.Tensor, tdp: torch.Tensor,
              loop_allowed: torch.Tensor, entry_state: torch.Tensor, entry_pen: torch.Tensor,
              end_node: torch.Tensor, lm_ext: torch.Tensor, la: torch.Tensor, am_threshold,
              prune: bool = True, use_lookahead: bool = False, state_limit: int = 0,
              histogram_bins: int = 0, emit_ends: bool = False, emit_stats: bool = False,
              transparent_silence: int = -1, carry_in: Optional[WctsCarry] = None,
              t0: int = 0):
    """One time chunk of the word-conditioned tree search.

    am [B, T, S]; feat_len int32 [B]; the tree tables (``TreeTables``) and
    entry tables (``build_entry_tables``); lm_ext [C, W] (last row: the
    sentence start); la [C, N] lookahead scores (read only with
    ``use_lookahead``). Returns (carry_out, outs) for frames t0+1..t0+T,
    outs = (book [T, B, W], bkp [T, B, W], pred [T, B, W] (C−1: the
    sentence start), offset [T, B]), then with ``emit_ends`` the
    pre-recombination word ends cand [T, B, C, W] and their entry frames
    [T, B, C, W], with ``emit_stats`` active states, active trees and word
    ends [T, B] (int32), with ``transparent_silence`` >= 0 (the silence
    word, whose ends re-open their own context) via_sil [T, B, C] (bool),
    the carried silence entry frames [T, B, C], this frame's silence ends
    [T, B, C] and their entry frames [T, B, C]. ``t == 1`` is the global
    frame t0 + i + 1, so chunked decoding equals one scan.

    CPU tensors take the plain version; CUDA tensors launch kernel K
    (float32 or float64; counted in ``wcts_scan.LAUNCHES``), whose C entry
    chooses its instance from the shape (``sr_wcts_scan_instance``): the
    owner instance, a thread a node with its scores in every context in
    registers, for up to 32 contexts and 256 threads (512 at 8 contexts a
    thread) whose state fits in shared memory; else the block
    instance with every tree copy, double-buffered, in shared memory up to
    its limit and past it in device scratch (counted in
    ``SCRATCH_LAUNCHES``). The
    indices are not range-checked here (``WctsTables.build`` does that once,
    on the host)."""
    if am.device.type == "cpu":
        return wcts_scan_reference(am, feat_len, state, parent, grand, tdp, loop_allowed,
                                   entry_state, entry_pen, end_node, lm_ext, la, am_threshold,
                                   prune=prune, use_lookahead=use_lookahead,
                                   state_limit=state_limit, histogram_bins=histogram_bins,
                                   emit_ends=emit_ends, emit_stats=emit_stats,
                                   transparent_silence=transparent_silence,
                                   carry_in=carry_in, t0=t0)
    out, result, in_scratch = wcts_scan_cuda(
        am, feat_len, state, parent, grand, tdp, loop_allowed, entry_state, entry_pen, end_node,
        lm_ext, la, am_threshold, prune=prune, use_lookahead=use_lookahead,
        state_limit=state_limit, histogram_bins=histogram_bins, emit_ends=emit_ends,
        emit_stats=emit_stats, transparent_silence=transparent_silence, carry_in=carry_in,
        t0=t0)
    wcts_scan.LAUNCHES += 1
    wcts_scan.SCRATCH_LAUNCHES += in_scratch
    return out, result


wcts_scan.LAUNCHES = wcts_scan.SCRATCH_LAUNCHES = 0


def wcts_scan_cuda(am: torch.Tensor, feat_len: torch.Tensor, state: torch.Tensor,
                   parent: torch.Tensor, grand: torch.Tensor, tdp: torch.Tensor,
                   loop_allowed: torch.Tensor, entry_state: torch.Tensor,
                   entry_pen: torch.Tensor, end_node: torch.Tensor, lm_ext: torch.Tensor,
                   la: torch.Tensor, am_threshold, prune: bool = True,
                   use_lookahead: bool = False, state_limit: int = 0, histogram_bins: int = 0,
                   emit_ends: bool = False, emit_stats: bool = False,
                   transparent_silence: int = -1, carry_in: Optional[WctsCarry] = None,
                   t0: int = 0, force: int = 0):
    """Kernel K's launch on CUDA tensors, as ``wcts_scan`` makes it but not
    counted: returns (carry_out, outs, whether the state lived in device
    scratch). ``force`` 0 takes the instance the C entry chooses from the
    shape; 1 the block instance (the first design), 8 or 16 the owner
    instance with that many contexts a thread, so that instances can be
    timed beside one another."""
    if am.device.type != "cuda":
        raise ValueError(f"wcts_scan: unsupported device {am.device}")
    if am.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"wcts_scan: the CUDA kernel runs float32 or float64, got {am.dtype}")
    if am.dim() != 3 or not am.is_contiguous():
        raise ValueError("wcts_scan: am must be a contiguous [B, T, S] tensor")
    B, T, S = am.shape
    C, W = lm_ext.shape
    N = state.shape[0]
    dtype, device = am.dtype, am.device
    bins = (histogram_bins or DEFAULT_BINS) if (prune and state_limit) else 0
    if not -1 <= transparent_silence < W:
        raise ValueError(f"wcts_scan: transparent_silence {transparent_silence} outside "
                         f"[-1, {W})")
    ints = _native.typed_args("wcts_scan", device, torch.int32, feat_len=(feat_len, (B,)),
                              state=(state, (N,)), parent=(parent, (N,)), grand=(grand, (N,)),
                              loop_allowed=(loop_allowed, (N,)),
                              entry_state=(entry_state, (N,)), end_node=(end_node, (W,)))
    fl = _native.typed_args("wcts_scan", device, dtype, tdp=(tdp, (N, 3)),
                            entry_pen=(entry_pen, (N,)), lm_ext=(lm_ext, (C, W)),
                            la=(la, (C, N)))
    carry = carry_in if carry_in is not None else init_carry(B, C, N, W, dtype, device)
    for name, t, shape, dt in (("hyp", carry.hyp, (B, C, N), dtype),
                               ("bkp", carry.bkp, (B, C, N), torch.int32),
                               ("book", carry.book, (B, W), dtype),
                               ("silp", carry.silp, (B, C), dtype),
                               ("silb", carry.silb, (B, C), torch.int32)):
        if t.device != device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"wcts_scan: carry {name} must be a contiguous {dt} {shape} "
                             f"tensor on {device}")
    out = WctsCarry(*(torch.empty_like(x) for x in carry))

    def empty(shape, dt):
        return torch.empty(shape, dtype=dt, device=device)

    outs = [empty((T, B, W), dtype), empty((T, B, W), torch.int32),
            empty((T, B, W), torch.int32), empty((T, B), dtype)]
    ends = ([empty((T, B, C, W), dtype), empty((T, B, C, W), torch.int32)]
            if emit_ends else [None, None])
    stats = [empty((T, B), torch.int32) for _ in range(3)] if emit_stats else [None] * 3
    silo = ([empty((T, B, C), torch.bool), empty((T, B, C), torch.int32),
             empty((T, B, C), dtype), empty((T, B, C), torch.int32)]
            if transparent_silence >= 0 else [None] * 4)
    lib = _native.load()
    f64 = int(dtype == torch.float64)
    scratch = _native.scratch(B, lib.sr_wcts_scan_scratch(C, N, W, S, bins, f64), device)
    err = lib.sr_wcts_scan(
        f64, am.data_ptr(), ints["feat_len"].data_ptr(), ints["state"].data_ptr(),
        ints["parent"].data_ptr(), ints["grand"].data_ptr(), fl["tdp"].data_ptr(),
        ints["loop_allowed"].data_ptr(), ints["entry_state"].data_ptr(),
        fl["entry_pen"].data_ptr(), ints["end_node"].data_ptr(), fl["lm_ext"].data_ptr(),
        fl["la"].data_ptr(), *(x.data_ptr() for x in carry), *(x.data_ptr() for x in out),
        *(x.data_ptr() for x in outs), *map(_native.ptr, ends), *map(_native.ptr, stats),
        *map(_native.ptr, silo), _native.ptr(scratch), B, T, S, C, N, W, int(t0),
        float(am_threshold), int(bool(prune)), int(bool(use_lookahead)), int(state_limit),
        bins, transparent_silence, int(force), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "wcts_scan")
    result = outs
    if emit_ends:
        result += ends
    if emit_stats:
        result += stats
    if transparent_silence >= 0:
        result += silo
    return out, tuple(result), scratch is not None


@dataclass
class WctsTables:
    """Everything ``wcts_scan`` reads besides am and the lengths, built and
    range-checked once on the host, then moved to a device with ``args``."""

    tables: TreeTables
    entry_state: np.ndarray
    entry_pen: np.ndarray
    lm_ext: np.ndarray
    la: np.ndarray
    use_lookahead: bool

    @staticmethod
    def build(tables: TreeTables, tdp_model, lm_matrix, lm_start,
              lookahead: Optional[LookaheadTables] = None) -> "WctsTables":
        lm_ext = extend_lm(lm_matrix, lm_start)
        if lm_ext.shape[1] != tables.num_words:
            raise ValueError(f"the LM has {lm_ext.shape[1]} words, the tree {tables.num_words}")
        entry_state, entry_pen = build_entry_tables(tables, tdp_model)
        la = (lookahead.scores(lm_ext) if lookahead is not None
              else np.zeros((lm_ext.shape[0], tables.num_nodes)))
        end = tables.end_node
        if end.shape != (tables.num_words,) or (end.size and (
                end.min() < 0 or end.max() >= tables.num_nodes)):
            raise ValueError("TreeTables.end_node outside [0, num_nodes)")
        return WctsTables(tables, entry_state, entry_pen, lm_ext, la, lookahead is not None)

    @property
    def num_contexts(self) -> int:
        return self.lm_ext.shape[0]

    def args(self, device, dtype: torch.dtype, num_states: int) -> Tuple[torch.Tensor, ...]:
        """(state, parent, grand, tdp, loop_allowed, entry_state, entry_pen,
        end_node, lm_ext, la) on ``device``, in the kernel's types."""
        tb = self.tables
        tb.check(num_states)
        if self.entry_state.size and (self.entry_state.min() < 0
                                      or self.entry_state.max() >= num_states):
            raise ValueError(f"entry_state outside [0, {num_states})")

        def ints(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)

        def floats(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

        return (ints(tb.state), ints(tb.parent), ints(tb.grand), floats(tb.tdp),
                ints(tb.loop_allowed), ints(self.entry_state), floats(self.entry_pen),
                ints(tb.end_node), floats(self.lm_ext), floats(self.la))


def traceback_wcts(books: np.ndarray, bkps: np.ndarray, preds: np.ndarray,
                   feat_len: np.ndarray, silence_idx: int, num_contexts: int,
                   silence_tables=None) -> List[List[int]]:
    """Host traceback over the per-frame books [T, B, W] → word sequences
    (silence removed). ``silence_tables`` = (via_sil, silb, sil_book,
    sil_bkp) [T, B, C] for transparent silence: the utterance may end in a
    silence, and entry chains skip the silences they passed through."""
    C = num_contexts
    out: List[List[int]] = []
    for b in range(books.shape[1]):
        t = int(feat_len[b])
        if t == 0:
            out.append([])
            continue

        def skip_sil(t: int, c: int) -> int:
            via, silb = silence_tables[0], silence_tables[1]
            while t > 0 and via[t, b, c]:
                t = int(silb[t, b, c])
            return t

        seq: List[int] = []
        best_w = float(books[t - 1, b].min())
        if silence_tables is not None:
            sil_book, sil_bkp = silence_tables[2], silence_tables[3]
            best_s = float(sil_book[t - 1, b].min())
            if min(best_w, best_s) >= BIG * 0.5:
                out.append([])
                continue
            if best_s < best_w:
                c = int(np.argmin(sil_book[t - 1, b]))
                t = skip_sil(int(sil_bkp[t - 1, b, c]), c)
                w = c
            else:
                w = int(np.argmin(books[t - 1, b]))
        else:
            if best_w >= BIG * 0.5:
                out.append([])
                continue
            w = int(np.argmin(books[t - 1, b]))
        while t > 0 and w < C - 1:
            if w != silence_idx:
                seq.append(w)
            t, c = int(bkps[t - 1, b, w]), int(preds[t - 1, b, w])
            if silence_tables is not None:
                t = skip_sil(t, c)
            w = c
        seq.reverse()
        out.append(seq)
    return out


def host_copies(outs) -> List[torch.Tensor]:
    """The scan's outputs on the host. From a card, each is copied into
    page-locked memory (PyTorch's caching host allocator keeps the blocks
    for the next call) and the stream is waited for once: at AN4's shape
    (about 205 MB a call of 130 utterances) pageable copies took about 80
    ms more a call on an H100 machine, and varied by up to 100 ms between
    processes. CPU tensors come back as they are."""
    if not outs or outs[0].device.type != "cuda":
        return [o.cpu() for o in outs]
    host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
    for h, o in zip(host, outs):
        h.copy_(o, non_blocking=True)
    torch.cuda.current_stream(outs[0].device).synchronize()
    return host


@tracing.span("wcts.decode")
def decode_batch_wcts(pack, feats, feat_len: np.ndarray, tables: TreeTables,
                      tdp_model: TdpModel, lm_matrix: np.ndarray, lm_start: np.ndarray,
                      am_threshold: float, silence_idx: int, prune: bool = True,
                      lookahead: Optional[LookaheadTables] = None, state_limit: int = 0,
                      histogram_bins: int = DEFAULT_BINS,
                      dtype: torch.dtype = torch.float32, emit_lattice: bool = False,
                      emit_stats: bool = False, transparent_silence: bool = False,
                      am: Optional[torch.Tensor] = None):
    """Word-conditioned tree decode → word sequences (silence removed).

    Build ``tables`` with word_penalty=0: every word cost lives in
    lm_matrix/lm_start (−log p), as for ``decode_batch_bigram``. One scan
    over the whole T. With ``emit_lattice`` returns (hyps, [ContextLattice
    per utterance]); with ``emit_stats`` (hyps, stats) with the per-frame
    {active_states, active_trees, word_ends} [T, B]; with both (hyps, lats,
    stats). With ``transparent_silence`` the LM history passes through
    silence unchanged (lm_matrix[:, silence] should then hold only the
    silence exit cost). ``am`` may carry precomputed [B, T, S] acoustic
    scores (``pack`` unused). Runs on the pack's device, or with ``am`` on
    its device.

    While tracing (``tracing.py``) the call is the span ``wcts.decode``
    around ``wcts.tables`` (``WctsTables.build``), ``wcts.tables_to_device``
    (their copies and the lengths'; the first blocking copy waits for what
    the stream holds), ``wcts.scan`` (kernel K's launch, and on a card the
    wait for it), ``wcts.to_host`` (every output's copy, ``host_copies``) and
    ``wcts.traceback``; it counts ``wcts.frames_real`` and
    ``wcts.frames_padded`` (B × T), with ``emit_stats``
    ``wcts.active_states`` and ``wcts.word_ends`` (summed over the real
    frames), and ``wcts.words_out``."""
    device = pack.device if am is None else am.device
    B, T, dim = feats.shape
    if tracing.enabled():
        tracing.count("wcts.frames_real", int(np.asarray(feat_len).sum()))
        tracing.count("wcts.frames_padded", B * T)
    with tracing.span("wcts.tables"):
        wt = WctsTables.build(tables, tdp_model, lm_matrix, lm_start, lookahead)
    C = wt.num_contexts
    if am is None:
        flat = torch.as_tensor(feats, dtype=torch.float32, device=device).reshape(B * T, dim)
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
    am = am.to(device=device, dtype=dtype).contiguous()
    with tracing.span("wcts.tables_to_device"):
        args = wt.args(device, dtype, am.shape[2])
        lens = torch.as_tensor(np.asarray(feat_len), dtype=torch.int32, device=device)
    with tracing.span("wcts.scan"):
        _carry, outs = wcts_scan(
            am, lens, *args, am_threshold, prune=prune, use_lookahead=wt.use_lookahead,
            state_limit=state_limit, histogram_bins=histogram_bins, emit_ends=emit_lattice,
            emit_stats=emit_stats, transparent_silence=silence_idx if transparent_silence else -1)
        if tracing.enabled() and device.type == "cuda":
            # the first copy would wait for K: the span holds the wait, so
            # that ``wcts.to_host`` holds the copies alone
            torch.cuda.synchronize(device)
    with tracing.span("wcts.to_host"):
        host = [h.numpy() for h in host_copies(outs)]
    with tracing.span("wcts.traceback"):
        out = traceback_wcts(host[0], host[1], host[2], np.asarray(feat_len), silence_idx, C,
                             tuple(host[-4:]) if transparent_silence else None)
    result = [out]
    if emit_lattice:
        from .context_lattice import ContextLattice
        offsets_np, cands_np, ebkps_np = host[3], host[4], host[5]
        result.append([ContextLattice.from_wcts(
            host[0][:, b], cands_np[:, b], ebkps_np[:, b], offsets_np[:, b],
            int(feat_len[b]), wt.lm_ext, silence_idx) for b in range(B)])
    if emit_stats:
        k = 6 if emit_lattice else 4
        stats = {"active_states": host[k], "active_trees": host[k + 1],
                 "word_ends": host[k + 2]}
        result.append(stats)
    if tracing.enabled():
        if emit_stats:
            # the kernel counts nothing past an utterance's last frame
            tracing.count("wcts.active_states", int(stats["active_states"].sum()))
            tracing.count("wcts.word_ends", int(stats["word_ends"].sum()))
        tracing.count("wcts.words_out", sum(map(len, out)))
    return result[0] if len(result) == 1 else tuple(result)
