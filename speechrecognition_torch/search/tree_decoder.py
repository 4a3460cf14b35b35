"""Lexical prefix-tree time-synchronous decoder (tree search) — counterpart
of speechrecognition_tpu/search/tree_decoder.py.

The lexicon's word automata are merged into a prefix tree over state
sequences, flattened into dense index arrays. Every node has a unique
parent and grandparent, so the 0-1-2 HMM recursion over the tree is

    cost[n] = min(cost[grand(n)] + skip(n), cost[parent(n)] + forward(n),
                  cost[n] + loop(n)) + am[state(n)]

(larger jumps win ties), with word entries flowing from the previous
frame's best word end (the book) through the virtual root. Word identity is
known only at word-end nodes, so the word penalty is charged at the exit.
On the SieTill lexicon (no shared prefixes) the tree is the linear search
space, and the transcripts equal the word-loop decoder's.

``tree_scan`` is one scan over a batch: on CUDA tensors it launches the
hand-written kernel I (``csrc/tree_scan.cu``), on CPU tensors it runs the
plain PyTorch version ``tree_scan_reference``. Both follow the reference's
``_tree_scan`` step for step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..lexicon import Lexicon
from ..models import gmm as gmm_mod
from ..ops import _native
from ..tdp import TdpModel
from .decoder import BIG


@dataclass
class TreeTables:
    """Flattened prefix tree. Node 0 is the virtual root (non-emitting)."""

    state: np.ndarray        # int32 [N] acoustic state per node (0 for root)
    parent: np.ndarray       # int32 [N]
    grand: np.ndarray        # int32 [N]
    depth: np.ndarray        # int32 [N]
    tdp: np.ndarray          # f64 [N, 3] loop/forward/skip into each node
    loop_allowed: np.ndarray  # bool [N] (False at pure word-end leaves)
    end_word: np.ndarray     # int32 [N] word index ending here, −1 otherwise
    exit_penalty: np.ndarray  # f64 [N] word penalty charged at the word end
    num_nodes: int
    num_words: int
    end_node: Optional[np.ndarray] = None  # int32 [W] end node per word
                                           # (homophones share a node)

    @staticmethod
    def build(lexicon: Lexicon, tdp_model: TdpModel, word_penalty) -> "TreeTables":
        W = lexicon.num_words
        if np.isscalar(word_penalty):
            wp_vec = np.where(np.arange(W) == lexicon.silence_idx,
                              0.0, float(word_penalty))
        else:
            wp_vec = np.asarray(word_penalty, np.float64)

        # the trie over state sequences
        children: List[Dict[int, int]] = [{}]
        parent = [0]
        state = [0]
        depth = [0]
        end_word = [-1]
        end_node = np.zeros(W, np.int32)
        for w in range(W):
            node = 0
            for s in lexicon.get_automaton_for_word(w).states:
                nxt = children[node].get(int(s))
                if nxt is None:
                    nxt = len(parent)
                    children[node][int(s)] = nxt
                    children.append({})
                    parent.append(node)
                    state.append(int(s))
                    depth.append(depth[node] + 1)
                    end_word.append(-1)
                node = nxt
            end_node[w] = node
            # homophones keep the smaller word index (word-end ties resolve
            # to the smallest word)
            end_word[node] = w if end_word[node] == -1 else min(end_word[node], w)

        N = len(parent)
        parent_a = np.asarray(parent, np.int32)
        state_a = np.asarray(state, np.int32)
        end_a = np.asarray(end_word, np.int32)
        tdp = tdp_model.table_for_states(state_a)  # [N, 3]
        tdp[0] = BIG                              # nothing enters the root
        has_children = np.zeros(N, bool)
        has_children[[i for i, c in enumerate(children) if c]] = True
        # pure word-end leaves never loop (Recognizer.cpp:131: a hypothesis
        # at its word's last state only crosses word boundaries)
        loop_allowed = has_children | (end_a < 0)
        loop_allowed[0] = False
        exit_pen = np.zeros(N, np.float64)
        mask = end_a >= 0
        exit_pen[mask] = wp_vec[end_a[mask]]
        return TreeTables(state=state_a, parent=parent_a, grand=parent_a[parent_a],
                          depth=np.asarray(depth, np.int32), tdp=tdp,
                          loop_allowed=loop_allowed, end_word=end_a,
                          exit_penalty=exit_pen, num_nodes=N, num_words=W,
                          end_node=end_node)

    def check(self, num_states: int) -> None:
        """Raise unless every index the kernels follow is in range (once, on
        the host, before the tables go to a device)."""
        N = self.num_nodes
        for name, a, hi in (("state", self.state, num_states), ("parent", self.parent, N),
                            ("grand", self.grand, N)):
            if a.shape != (N,) or (N and (a.min() < 0 or a.max() >= hi)):
                raise ValueError(f"TreeTables.{name} outside [0, {hi})")
        if self.end_word.shape != (N,) or (N and self.end_word.max() >= self.num_words):
            raise ValueError("TreeTables.end_word outside [-1, num_words)")

    def device_args(self, device, dtype: torch.dtype, num_states: int) -> Tuple[torch.Tensor, ...]:
        """(state, parent, grand, depth, tdp, loop_allowed, end_word,
        exit_penalty) on ``device``, in the types kernel I reads."""
        self.check(num_states)
        ints = [torch.as_tensor(np.asarray(a, np.int32), device=device)
                for a in (self.state, self.parent, self.grand, self.depth)]
        return (*ints, torch.as_tensor(self.tdp, dtype=dtype, device=device),
                torch.as_tensor(np.asarray(self.loop_allowed, np.int32), device=device),
                torch.as_tensor(np.asarray(self.end_word, np.int32), device=device),
                torch.as_tensor(self.exit_penalty, dtype=dtype, device=device))


def tree_scan_reference(am: torch.Tensor, feat_len: torch.Tensor, state: torch.Tensor,
                        parent: torch.Tensor, grand: torch.Tensor, depth: torch.Tensor,
                        tdp: torch.Tensor, loop_allowed: torch.Tensor,
                        end_word: torch.Tensor, exit_penalty: torch.Tensor,
                        am_threshold, prune: bool = True,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``tree_scan``, one frame per loop step (any
    float dtype, any device). Same contract as ``tree_scan``."""
    B, T, S = am.shape
    dtype, device = am.dtype, am.device
    N = state.shape[0]
    big = torch.tensor(float(BIG), dtype=dtype, device=device)
    half_big = big * 0.5
    st, par, gr = (x.to(device=device, dtype=torch.long) for x in (state, parent, grand))
    dep = depth.to(device)
    tdp = tdp.to(device=device, dtype=dtype)
    xpen = exit_penalty.to(device=device, dtype=dtype)
    ew = end_word.to(device=device, dtype=torch.int32)
    la = loop_allowed.to(device=device, dtype=torch.bool)
    thr = torch.tensor(float(am_threshold), dtype=dtype, device=device)
    lens = feat_len.to(device)

    root = (torch.arange(N, device=device) == 0)[None, :]
    d1, d2 = (dep == 1)[None, :], (dep == 2)[None, :]
    is_end = (ew >= 0)[None, :]
    hyp = big.expand(B, N).clone()
    bkp = torch.zeros((B, N), dtype=torch.int32, device=device)
    book = torch.zeros((B,), dtype=dtype, device=device)

    scores, words, bkps = [], [], []
    for i in range(T):
        t = i + 1
        tm1 = torch.tensor(t - 1, dtype=torch.int32, device=device)
        # predecessor costs through the tree; the root carries the book
        hyp_root = torch.where(root, book[:, None], hyp)
        loop = torch.where(la[None, :], hyp + tdp[None, :, 0], big)
        fwd = hyp_root[:, par] + tdp[None, :, 1]
        fwd = torch.where(d1, book[:, None] + tdp[None, :, 1], fwd)
        skip = hyp_root[:, gr] + tdp[None, :, 2]
        skip = torch.where(d2, book[:, None] + tdp[None, :, 2], skip)
        skip = torch.where(d1, big, skip)
        # larger jumps win ties (the word-loop decoder's rule)
        new, nbkp = skip, torch.where(d2, tm1, bkp[:, gr])
        for c, b in ((fwd, torch.where(d1, tm1, bkp[:, par])), (loop, bkp)):
            take = c < new
            new = torch.where(take, c, new)
            nbkp = torch.where(take, b, nbkp)
        new = new + am[:, i][:, st]
        new = torch.where(root, big, new)
        new = torch.minimum(new, big)

        best = new.amin(dim=1, keepdim=True)
        best = torch.where(best >= half_big, torch.zeros_like(best), best)
        new = torch.where(new >= half_big, big, new - best)
        if prune:
            new = torch.where(new > thr, big, new)

        # word-end recombination: exit penalty charged here; the first node
        # at the minimum wins
        end_scores = torch.where(is_end, new + xpen[None, :], big)
        order = end_scores.argmin(dim=1)
        book_score = end_scores.gather(1, order[:, None])[:, 0]
        book_word = ew[order]
        book_bkp = nbkp.gather(1, order[:, None])[:, 0]
        book_score = torch.where(book_score >= half_big, big, book_score)

        alive = t <= lens
        hyp = torch.where(alive[:, None], new, hyp)
        bkp = torch.where(alive[:, None], nbkp, bkp)
        book = torch.where(alive, book_score, book)
        scores.append(book_score)
        words.append(book_word)
        bkps.append(book_bkp)
    return torch.stack(scores), torch.stack(words), torch.stack(bkps)


def tree_scan(am: torch.Tensor, feat_len: torch.Tensor, state: torch.Tensor,
              parent: torch.Tensor, grand: torch.Tensor, depth: torch.Tensor,
              tdp: torch.Tensor, loop_allowed: torch.Tensor, end_word: torch.Tensor,
              exit_penalty: torch.Tensor, am_threshold, prune: bool = True,
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tree Viterbi over a batch, from frame 1 with book 0.

    am [B, T, S]; feat_len int32 [B]; the tree tables as in TreeTables (as
    tensors; ``TreeTables.device_args`` checks their ranges once and gives
    them in the kernel's types). Returns per-frame (book score [T, B], book
    word [T, B], book backpointer [T, B]).

    CPU tensors take the plain version; CUDA tensors launch kernel I
    (float32 or float64; counted in ``tree_scan.LAUNCHES``), whose C entry
    chooses its instance from the tree's size (``sr_tree_scan_instance``):
    the owner instance up to 1,024 nodes, each node's tables, score and
    backpointer in registers, else the block instance with the tree's
    double-buffered scores in shared memory up to its limit
    (``sr_tree_scan_scratch`` gives 0) and past it in device scratch (also
    counted in ``SCRATCH_LAUNCHES``). The indices are not range-checked
    here: a launch does not synchronise."""
    if am.device.type == "cpu":
        return tree_scan_reference(am, feat_len, state, parent, grand, depth, tdp,
                                   loop_allowed, end_word, exit_penalty, am_threshold,
                                   prune=prune)
    outs, in_scratch = tree_scan_cuda(am, feat_len, state, parent, grand, depth, tdp,
                                      loop_allowed, end_word, exit_penalty, am_threshold,
                                      prune=prune)
    tree_scan.LAUNCHES += 1
    tree_scan.SCRATCH_LAUNCHES += in_scratch
    return outs


tree_scan.LAUNCHES = tree_scan.SCRATCH_LAUNCHES = 0


def tree_scan_cuda(am: torch.Tensor, feat_len: torch.Tensor, state: torch.Tensor,
                   parent: torch.Tensor, grand: torch.Tensor, depth: torch.Tensor,
                   tdp: torch.Tensor, loop_allowed: torch.Tensor, end_word: torch.Tensor,
                   exit_penalty: torch.Tensor, am_threshold, prune: bool = True,
                   first_design: bool = False):
    """Kernel I's launch on CUDA tensors, as ``tree_scan`` makes it but not
    counted: returns (outs, whether the lattice lived in device scratch).
    ``first_design`` launches the block instance whatever the tree's size,
    so that it can be timed beside the owner instance."""
    if am.device.type != "cuda":
        raise ValueError(f"tree_scan: unsupported device {am.device}")
    if am.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tree_scan: the CUDA kernel runs float32 or float64, got {am.dtype}")
    if am.dim() != 3 or not am.is_contiguous():
        raise ValueError("tree_scan: am must be a contiguous [B, T, S] tensor")
    B, T, S = am.shape
    N = state.shape[0]
    dtype, device = am.dtype, am.device
    ints = _native.typed_args("tree_scan", device, torch.int32, feat_len=(feat_len, (B,)),
                              state=(state, (N,)), parent=(parent, (N,)), grand=(grand, (N,)),
                              depth=(depth, (N,)), loop_allowed=(loop_allowed, (N,)),
                              end_word=(end_word, (N,)))
    fl = _native.typed_args("tree_scan", device, dtype, tdp=(tdp, (N, 3)),
                            exit_penalty=(exit_penalty, (N,)))
    score = torch.empty((T, B), dtype=dtype, device=device)
    word = torch.empty((T, B), dtype=torch.int32, device=device)
    wbkp = torch.empty((T, B), dtype=torch.int32, device=device)
    lib = _native.load()
    f64 = int(dtype == torch.float64)
    # 0 for every tree the owner instance takes: only the block instance's
    # lattice ever passes shared memory
    scratch = _native.scratch(B, lib.sr_tree_scan_scratch(N, f64), device)
    err = lib.sr_tree_scan(
        f64, am.data_ptr(), ints["feat_len"].data_ptr(), ints["state"].data_ptr(),
        ints["parent"].data_ptr(), ints["grand"].data_ptr(), ints["depth"].data_ptr(),
        fl["tdp"].data_ptr(), ints["loop_allowed"].data_ptr(), ints["end_word"].data_ptr(),
        fl["exit_penalty"].data_ptr(), score.data_ptr(), word.data_ptr(), wbkp.data_ptr(),
        _native.ptr(scratch), B, T, S, N, float(am_threshold), int(bool(prune)),
        int(bool(first_design)), device.index, torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "tree_scan")
    return (score, word, wbkp), scratch is not None


def decode_batch_tree(pack, feats, feat_len: np.ndarray, tables: TreeTables,
                      am_threshold: float, silence_idx: int, prune: bool = True,
                      dtype: torch.dtype = torch.float32,
                      am: Optional[torch.Tensor] = None) -> List[List[int]]:
    """Tree decode → word sequences (silence removed).

    feats f32 [B, T, dim] (numpy, or a tensor on the pack's device). One scan
    over the whole T from book 0, as the reference decodes. ``am`` may carry
    precomputed [B, T, S] acoustic scores (the NN scorer's; ``pack`` may
    then be None). The traceback walks the best-end tables from each
    utterance's last frame, as the reference does even where the book is
    BIG."""
    device = pack.device if am is None else am.device
    B, T, dim = feats.shape
    if am is None:
        flat = torch.as_tensor(feats, dtype=torch.float32, device=device).reshape(B * T, dim)
        am = gmm_mod.am_scores(pack, flat).reshape(B, T, pack.num_mixtures)
    am = am.to(device=device, dtype=dtype).contiguous()
    lens = torch.as_tensor(np.asarray(feat_len), dtype=torch.int32, device=device)
    _scores, words, bkps = tree_scan(am, lens, *tables.device_args(device, dtype, am.shape[2]),
                                     am_threshold, prune=prune)
    words_np = words.cpu().numpy()
    bkps_np = bkps.cpu().numpy()
    out: List[List[int]] = []
    for b in range(B):
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
