"""Plain reference of the AN4 configuration's production decode: the int8
scores of ``configs/an4-lvcsr/reference.py`` and the word-conditioned tree
search with LM lookahead (rwth-asr-0.5/src/Search/
WordConditionedTreeSearch.cc, StateTree.cc, LanguageModelLookahead.cc) in
float32, dense over every (predecessor word, tree node) slot, with its word
traceback. NumPy for the tables, PyTorch for the scan.

The prefix tree is built from the plain lexicon (harness/traffic.py): node 0
the root, one node a distinct prefix of state sequences, numbered as the
words are inserted in lexicon order. Its transition costs follow Sprint's
transition model (Am/TransitionModel.cc): a node's loop by its own state's
type, forward and skip by the source node's type, the entries into depth-1
and depth-2 nodes by entry-m1's forward and skip; a state's type is silence
on the silence word's path, else the default row (the lexicon draws the
silence's classes apart from the words', so no node lies on both).

Per frame t (1-based) and context c (each word, then the sentence start):

- the context's entry score: the book of its word at t-1 (the sentence
  start: 0 at t = 1, else BIG), or the silence that ended in the context at
  t-1 where that is strictly smaller (transparent silence);
- each node: the best of its grandparent's score plus the skip cost, its
  parent's plus the forward cost (if strictly less) and its own plus the
  loop cost (if strictly less), plus its state's score; a depth-1 or
  depth-2 node's entry (the context's entry score plus the entry cost plus
  the ENTERED node's state's score, as the port's ``build_entry_tables``
  charges it; WordConditionedTreeSearch.cc charges the first state's score
  on entry) wins ties; the root stays BIG;
- renormalisation by the frame's best slot; pruning of every slot whose
  score plus lookahead, less the frame's best such prospect, exceeds the
  threshold (no histogram pruning: the configuration's ``state_limit`` 0);
- word ends: cand[c, w] = the score of w's end node in copy c plus
  lm_ext[c, w] (the bigram boundary cost with the word exit); the silence
  column stays per context, the others recombine into the per-word book at
  the first context with the least candidate (the reference's recombination
  keeps one predecessor a word too).

The lookahead la[c, n] is the least lm_ext[c, w] over the words below node
n (the root: over all words), uncompressed and without a depth cutoff
(LanguageModelLookahead.cc compresses the tables and may cut them at a
depth; the scores it gives are the same). Departures from
WordConditionedTreeSearch.cc besides: every slot is computed, live or not
(the reference keeps active lists), and the LM is the configuration's
bigram.

The traceback starts at the least book or (if strictly less) the least
silence end of the utterance's last frame and follows each word's entry
frame and predecessor context, skipping the silences that the entries
passed through. ``start_scores`` gives that starting score plus the frames'
renormalisation offsets: the best path's whole score.

Imports NumPy, PyTorch and the benchmark's plain readers only.
"""

from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

from benchmark.harness import core, mixfile, traffic
from benchmark.harness import lm as lm_text

BIG = 1e30
BATCH = 130

_LVCSR = core.load_module(Path(__file__).resolve().parent.parent / "an4-lvcsr" / "reference.py",
                          "ref_an4_lvcsr_scores")
#: the int8 scores of the AN4 configuration and their unit
quantized_scores = _LVCSR.quantized_scores
score_unit = _LVCSR.score_unit


@dataclass
class Tables:
    """The prefix tree and everything the scan reads besides the scores."""

    state: np.ndarray       # int [N] the node's state (the root 0)
    parent: np.ndarray      # int [N] (the root its own)
    grand: np.ndarray       # int [N] the parent's parent
    depth: np.ndarray       # int [N]
    end_node: np.ndarray    # int [W] each word's last node
    tdp: np.ndarray         # f64 [N, 3] loop, forward, skip into the node
    entry_pen: np.ndarray   # f64 [N] an entry's cost (BIG past depth 2)
    lm_ext: np.ndarray      # f64 [C, W] boundary costs, the last row the sentence start
    la: np.ndarray          # f64 [C, N] lookahead
    silence: int

    @property
    def num_nodes(self) -> int:
        return len(self.state)


def _row(tdp: dict, key: str) -> List[float]:
    scale = float(tdp["scale"])
    return [BIG if v == "inf" or float(v) == float("inf") else scale * float(v)
            for v in tdp[key]]


def build_tables(lex: traffic.Lexicon, tdp: dict, lm_ext: np.ndarray) -> Tables:
    """The tree of ``lex`` with ``tdp``'s costs (the configuration's "tdp"
    block) and the lookahead of ``lm_ext`` [W + 1, W]."""
    children = [{}]
    state, parent, depth, on_sil = [0], [0], [0], [False]
    end_node = np.zeros(lex.num_words, np.int64)
    below = [set()]
    for w in range(lex.num_words):
        node = 0
        for s in lex.states[w]:
            nxt = children[node].get(int(s))
            if nxt is None:
                nxt = len(state)
                children[node][int(s)] = nxt
                children.append({})
                state.append(int(s))
                parent.append(node)
                depth.append(depth[node] + 1)
                on_sil.append(False)
                below.append(set())
            node = nxt
            below[node].add(w)
            on_sil[node] |= w == lex.silence
        end_node[w] = node
    N = len(state)
    parent = np.asarray(parent)
    depth = np.asarray(depth)
    default, silence, entry = _row(tdp, "default"), _row(tdp, "silence"), _row(tdp, "entry_m1")
    kind = [silence if s else default for s in on_sil]
    costs = np.full((N, 3), BIG)
    entry_pen = np.full(N, BIG)
    for n in range(1, N):
        costs[n, 0] = kind[n][0]
        costs[n, 1] = entry[1] if depth[n] == 1 else kind[parent[n]][1]
        if depth[n] == 2:
            costs[n, 2] = entry[2]
        elif depth[n] > 2:
            costs[n, 2] = kind[parent[parent[n]]][2]
        if depth[n] <= 2:
            entry_pen[n] = entry[depth[n]]
    lm_ext = np.asarray(lm_ext, np.float64)
    la = np.empty((lm_ext.shape[0], N))
    la[:, 0] = lm_ext.min(1)
    for n in range(1, N):
        la[:, n] = lm_ext[:, sorted(below[n])].min(1)
    return Tables(np.asarray(state), parent, parent[parent], depth, end_node, costs, entry_pen,
                  lm_ext, la, lex.silence)


def lm_ext_of(cfg: dict, lex: traffic.Lexicon) -> np.ndarray:
    """The configuration's seeded bigram as boundary costs [W + 1, W] over
    the whole lexicon (silence transparent: its column the silence exit)."""
    lmc = cfg["lm"]
    text = lm_text.arpa_text(lex.orth[1:], lmc["seed"], lmc["bigram_share"])
    lm, start = lm_text.boundary_costs(text, lex.orth, lex.silence, lmc["lm_scale"],
                                       lmc["word_exit"], lmc["sil_exit"])
    return np.concatenate([lm, start[None, :]], 0)


def scan(am: torch.Tensor, lens: torch.Tensor, tb: Tables, thr: float, lookahead: bool = True):
    """The search over am [B, T, S] float32: per frame the book, its entry
    frame and predecessor context [T, B, W], the offset [T, B], the live
    slots [T, B] and, for the traceback through silence, via_sil, the
    carried silence entry frames, the silence ends and their entry frames
    [T, B, C]."""
    B, T, S = am.shape
    dev, dt = am.device, am.dtype
    C, W = tb.lm_ext.shape
    N = tb.num_nodes

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dt)

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)
    big = f(BIG)
    half = big * 0.5
    zero = torch.zeros((), dtype=dt, device=dev)
    tdp, pen, lm, la, thr = f(tb.tdp), f(tb.entry_pen), f(tb.lm_ext), f(tb.la), f(thr)
    st, par, gr, en = ix(tb.state), ix(tb.parent), ix(tb.grand), ix(tb.end_node)
    loop_ok = ix(tb.depth) > 0
    sil = tb.silence
    hyp = big.expand(B, C, N).clone()
    bkp = torch.zeros((B, C, N), dtype=torch.int32, device=dev)
    book = big.expand(B, W).clone()
    silp = big.expand(B, C).clone()
    silb = torch.zeros((B, C), dtype=torch.int32, device=dev)
    outs = {k: [] for k in ("book", "bkp", "pred", "offset", "live", "via", "silb_prev",
                            "silp", "silb")}
    for i in range(T):
        t = i + 1
        a = am[:, i]
        ext = torch.cat([book, (zero if t == 1 else big).expand(B, 1)], 1)
        via = silp < ext
        ext = torch.minimum(ext, silp)
        loop = torch.where(loop_ok, hyp + tdp[:, 0], big)
        fwd = hyp[:, :, par] + tdp[:, 1]
        v, vb = hyp[:, :, gr] + tdp[:, 2], bkp[:, :, gr]
        take = fwd < v
        v, vb = torch.where(take, fwd, v), torch.where(take, bkp[:, :, par], vb)
        take = loop < v
        v, vb = torch.where(take, loop, v), torch.where(take, bkp, vb)
        v = v + a[:, st][:, None, :]
        entry = (ext[:, :, None] + pen) + a[:, st][:, None, :]
        take = entry <= v
        new = torch.where(take, entry, v)
        nb = torch.where(take, torch.tensor(t - 1, dtype=torch.int32, device=dev), vb)
        new[:, :, 0] = big
        new = torch.minimum(new, big)
        best = new.amin(dim=(1, 2))
        best = torch.where(best >= half, zero, best)
        new = torch.where(new >= half, big, new - best[:, None, None])
        if lookahead:
            ant = torch.where(new >= half, big, new + la)
            ant_best = ant.amin(dim=(1, 2))
            ant_best = torch.where(ant_best >= half, zero, ant_best)
            rel = torch.where(ant >= half, big, ant - ant_best[:, None, None])
        else:
            rel = new
        new = torch.where(rel > thr, big, new)
        ends = new[:, :, en]
        cand = torch.where(ends >= half, big, ends + lm)
        cand_b = nb[:, :, en]
        sil_new, silb_new = cand[:, :, sil].clone(), cand_b[:, :, sil]
        cand[:, :, sil] = big
        pred = cand.argmin(1)
        bk = cand.gather(1, pred[:, None, :])[:, 0]
        bk = torch.where(bk >= half, big, bk)
        bb = cand_b.gather(1, pred[:, None, :])[:, 0]
        alive = t <= lens
        outs["via"].append(via)
        outs["silb_prev"].append(silb)
        hyp = torch.where(alive[:, None, None], new, hyp)
        bkp = torch.where(alive[:, None, None], nb, bkp)
        book = torch.where(alive[:, None], bk, book)
        silp = torch.where(alive[:, None], sil_new, silp)
        silb = torch.where(alive[:, None], silb_new, silb)
        live = ((new < half) & alive[:, None, None]).sum(dim=(1, 2))
        for k, x in (("book", bk), ("bkp", bb), ("pred", pred.to(torch.int32)),
                     ("offset", best), ("live", live), ("silp", silp), ("silb", silb)):
            outs[k].append(x)
    return {k: torch.stack(v) for k, v in outs.items()}


def start_scores(book: torch.Tensor, sil_book: torch.Tensor, offset: torch.Tensor,
                 lens) -> torch.Tensor:
    """Each utterance's best path score, float64 [B]: the least of its last
    frame's book [T, B, W] and silence ends [T, B, C] (where the traceback
    starts), plus the renormalisation offsets [T, B] of its frames; +inf
    where nothing survived. ``lens`` [B] is an array or a tensor."""
    T, B, _ = book.shape
    dev = book.device
    lens = torch.as_tensor(lens, dtype=torch.int64, device=dev)
    last = (lens - 1).clamp(0, T - 1)
    bi = torch.arange(B, device=dev)
    rel = torch.minimum(book[last, bi].amin(1), sil_book[last, bi].amin(1))
    real = torch.arange(T, device=dev)[:, None] < lens[None, :]
    total = rel.double() + torch.where(real, offset.double(), 0.0).sum(0)
    return torch.where((rel >= BIG * 0.5) | (lens == 0), float("inf"), total)


def traceback(o: dict, lens: np.ndarray, tb: Tables) -> List[List[int]]:
    """Each utterance's words (lexicon indices, silence left out), from the
    host copies of ``scan``'s outputs."""
    C = tb.lm_ext.shape[0]
    book, bkp, pred = o["book"], o["bkp"], o["pred"]
    via, silb_prev, silp, silb = o["via"], o["silb_prev"], o["silp"], o["silb"]
    out = []
    for b, L in enumerate(np.asarray(lens).tolist()):
        words: List[int] = []

        def through_silence(t, c):
            while t > 0 and via[t, b, c]:
                t = int(silb_prev[t, b, c])
            return t
        bw, bs = book[L - 1, b].min() if L else BIG, silp[L - 1, b].min() if L else BIG
        if min(bw, bs) >= BIG * 0.5:
            out.append(words)
            continue
        if bs < bw:
            w = int(np.argmin(silp[L - 1, b]))
            t = through_silence(int(silb[L - 1, b, w]), w)
        else:
            w, t = int(np.argmin(book[L - 1, b])), L
        while t > 0 and w < C - 1:
            if w != tb.silence:
                words.append(w)
            t, w = int(bkp[t - 1, b, w]), int(pred[t - 1, b, w])
            t = through_silence(t, w)
        out.append(words[::-1])
    return out


def decode(cfg: dict, model_path: str, features: np.ndarray, offsets: np.ndarray, device,
           scores: torch.Tensor = None):
    """(words, best path scores float64 [n], live slots an utterance's
    frame [n] arrays) of each utterance; ``scores`` the features'
    ``quantized_scores`` where they were worked out already."""
    if cfg["state_limit"]:
        raise ValueError("the reference has no histogram pruning (state_limit 0)")
    model = mixfile.read_model(model_path, cfg["dim"], cfg["pooling"])
    lex = traffic.lexicon_from_config(cfg["lexicon"], model)
    tb = build_tables(lex, cfg["tdp"], lm_ext_of(cfg, lex))
    if scores is None:
        scores = quantized_scores(model, features, device)
    lengths = np.diff(offsets)
    words, starts, live = [], [], []
    with torch.no_grad():
        for i in range(0, len(lengths), BATCH):
            ids = np.arange(i, min(i + BATCH, len(lengths)))
            lens = lengths[ids]
            T = int(lens.max())
            idx = offsets[ids][:, None] + np.minimum(np.arange(T)[None, :], lens[:, None] - 1)
            am = scores[torch.as_tensor(idx.reshape(-1), device=device)].reshape(len(ids), T, -1)
            lt = torch.as_tensor(lens, dtype=torch.int32, device=device)
            o = scan(am.contiguous(), lt, tb, float(cfg["acoustic_pruning"]), cfg["lookahead"])
            starts.append(start_scores(o["book"], o["silp"], o["offset"], lens).cpu().numpy())
            host = {k: v.cpu().numpy() for k, v in o.items()}
            del o
            words += traceback(host, lens, tb)
            live += [host["live"][:L, k] for k, L in enumerate(lens.tolist())]
    return words, np.concatenate(starts), live
