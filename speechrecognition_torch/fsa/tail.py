"""Fsa library tail: Levenshtein alignment automata, weight
arithmetic, arc sorting, permutation automata, random paths.

Counterparts of the reference's Fsa/Levenshtein.cc, Fsa/Arithmetic.cc
(collect/extend/multiply/expm/logm/extendFinal), Fsa/Sort.cc (+
hSort.hh SortType choices), Fsa/Permute.cc (window/distortion-limited
permutation automata over linear sequences) and Fsa/Random.cc (random
path sampling). Eager host-side constructions like the rest of
fsa/ops.py — the result arrays are what device code consumes.

Port: a copy of speechrecognition_tpu/fsa/tail.py (host code).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .automaton import Automaton
from .semiring import LogSemiring, TropicalSemiring

EPS = -1


# -- Levenshtein (Fsa/Levenshtein.cc) -----------------------------------------

def levenshtein(ref: Automaton, test: Automaton, del_cost: float = 1.0,
                ins_cost: float = 1.0, sub_cost: float = 1.0,
                cor_cost: float = 0.0) -> Automaton:
    """Levenshtein alignment graph of two acceptors: the product
    automaton over (ref state, test state) whose arcs are
    correct/substitute (consume both), delete (consume ref only,
    output ε) and insert (consume test only, input ε); weights are the
    edit costs over the tropical semiring. best_path() of the result
    is the minimum edit distance; ilabel = ref token, olabel = test
    token (ε on ins/del)."""
    r_out, t_out = ref.out_index(), test.out_index()
    state_id: Dict[Tuple[int, int], int] = {}
    arcs: List[Tuple[int, int, int, int, float]] = []
    final: Dict[int, float] = {}
    stack: List[Tuple[int, int]] = []

    def sid(p: int, q: int) -> int:
        key = (p, q)
        if key not in state_id:
            state_id[key] = len(state_id)
            stack.append(key)
        return state_id[key]

    start = sid(ref.initial, test.initial)
    while stack:
        p, q = stack.pop()
        s = state_id[(p, q)]
        if np.isfinite(ref.final[p]) and np.isfinite(test.final[q]):
            final[s] = float(ref.final[p] + test.final[q])
        for i in r_out[p]:
            rl = int(ref.ilabel[i])
            # deletion: ref advances alone
            arcs.append((s, sid(int(ref.dst[i]), q), rl, EPS, del_cost))
            for j in t_out[q]:
                tl = int(test.ilabel[j])
                cost = cor_cost if rl == tl else sub_cost
                arcs.append((s, sid(int(ref.dst[i]), int(test.dst[j])),
                             rl, tl, cost))
        for j in t_out[q]:
            # insertion: test advances alone
            arcs.append((s, sid(p, int(test.dst[j])), EPS,
                         int(test.ilabel[j]), ins_cost))
    return Automaton.build(len(state_id), arcs, final, start)


def levenshtein_info(align: Automaton) -> Dict[str, int]:
    """del/ins/sub/total statistics of the BEST path through a
    Levenshtein alignment graph (Fsa::levenshteinInfo). Walks the raw
    arcs (ε labels mark ins/del) — fsa.ops.best_path strips ε, so the
    shortest path is re-derived here with labels intact."""
    from .ops import shortest_distance

    bwd = shortest_distance(align, reverse=True,
                            semiring=TropicalSemiring)
    dels = ins = sub = 0
    s = align.initial
    out_idx = align.out_index()
    guard = align.num_arcs + align.num_states + 1
    while guard > 0:
        guard -= 1
        if np.isfinite(align.final[s]) and \
                abs(float(align.final[s]) - bwd[s]) < 1e-9:
            break
        nxt = min(out_idx[s],
                  key=lambda i: float(align.weight[i])
                  + bwd[int(align.dst[i])])
        il, ol = int(align.ilabel[nxt]), int(align.olabel[nxt])
        if il != EPS and ol == EPS:
            dels += 1
        elif il == EPS and ol != EPS:
            ins += 1
        elif il != ol:
            sub += 1
        s = int(align.dst[nxt])
    return {"del": dels, "ins": ins, "sub": sub,
            "total": dels + ins + sub}


# -- arithmetic (Fsa/Arithmetic.cc) -------------------------------------------

def _map_weights(a: Automaton, fn, fn_final=None) -> Automaton:
    fn_final = fn_final or fn
    return Automaton(num_states=a.num_states, src=a.src, dst=a.dst,
                     ilabel=a.ilabel, olabel=a.olabel,
                     weight=fn(a.weight.copy()),
                     final=np.where(np.isfinite(a.final),
                                    fn_final(a.final.copy()), a.final),
                     initial=a.initial, semiring=a.semiring)


def collect(a: Automaton, value: float) -> Automaton:
    """⊕ every arc weight with `value` (Fsa::collect)."""
    sr = a.semiring
    plus = np.vectorize(lambda w: sr.plus(w, value))
    return _map_weights(a, plus)


def extend(a: Automaton, value: float) -> Automaton:
    """⊗ every arc weight with `value` (Fsa::extend) — in −log
    semirings this ADDS the value."""
    sr = a.semiring
    times = np.vectorize(lambda w: sr.times(w, value))
    return _map_weights(a, times)


def multiply(a: Automaton, value: float) -> Automaton:
    """Scalar-multiply every weight (real-valued semirings only,
    Fsa::multiply)."""
    return _map_weights(a, lambda w: w * value)


def expm(a: Automaton) -> Automaton:
    """weight ← exp(weight) (Fsa::expm)."""
    return _map_weights(a, np.exp)


def logm(a: Automaton) -> Automaton:
    """weight ← log(weight) (Fsa::logm)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _map_weights(a, np.log)


def extend_final(a: Automaton, value: float) -> Automaton:
    """⊗ only the FINAL weights with `value` (Fsa::extendFinal)."""
    sr = a.semiring
    fin = np.where(np.isfinite(a.final),
                   np.vectorize(lambda w: sr.times(w, value))(
                       a.final.copy()),
                   a.final)
    return Automaton(num_states=a.num_states, src=a.src, dst=a.dst,
                     ilabel=a.ilabel, olabel=a.olabel, weight=a.weight,
                     final=fin, initial=a.initial, semiring=a.semiring)


# -- sorting (Fsa/Sort.cc, hSort.hh SortType*) --------------------------------

SORT_KEYS = {
    "by-arc": lambda a: (a.src, a.ilabel, a.olabel, a.dst, a.weight),
    "by-input": lambda a: (a.src, a.ilabel),
    "by-input-and-output": lambda a: (a.src, a.ilabel, a.olabel),
    "by-input-and-target": lambda a: (a.src, a.ilabel, a.dst),
    "by-input-and-output-and-target":
        lambda a: (a.src, a.ilabel, a.olabel, a.dst),
    "by-output": lambda a: (a.src, a.olabel),
    "by-weight": lambda a: (a.src, a.weight),
}


def sort_arcs(a: Automaton, sort_type: str = "by-input") -> Automaton:
    """Stable per-state arc sort (Fsa::sort; SortType names from
    hSort.hh:22-28 spelled kebab-case)."""
    keys = SORT_KEYS.get(sort_type)
    if keys is None:
        raise ValueError(f"unknown sort type {sort_type!r} "
                         f"(have {sorted(SORT_KEYS)})")
    cols = keys(a)
    order = np.lexsort(tuple(reversed([np.asarray(c) for c in cols])))
    return Automaton(num_states=a.num_states, src=a.src[order],
                     dst=a.dst[order], ilabel=a.ilabel[order],
                     olabel=a.olabel[order], weight=a.weight[order],
                     final=a.final, initial=a.initial, semiring=a.semiring)


# -- permutation automata (Fsa/Permute.cc) ------------------------------------

def permute(a: Automaton, window_size: Optional[int] = None,
            distortion_limit: Optional[int] = None) -> Automaton:
    """Permutation automaton of a LINEAR automaton: accepts every
    reordering of the input sequence where each token moves at most
    `window_size − 1` positions (IBM-constraint coverage-vector
    construction, Fsa/Permute.cc PermuteAutomaton): states are coverage
    bitvectors over the window; `distortion_limit` additionally bounds
    |emitted position − original position|."""
    from .ops import best_path

    # extract the linear label sequence
    labels: List[int] = []
    weights: List[float] = []
    s = a.initial
    out_idx = a.out_index()
    while not np.isfinite(a.final[s]):
        arcs = out_idx[s]
        if len(arcs) != 1:
            raise ValueError("permute expects a linear automaton")
        i = arcs[0]
        labels.append(int(a.ilabel[i]))
        weights.append(float(a.weight[i]))
        s = int(a.dst[i])
    n = len(labels)
    W = n if window_size is None else min(window_size, n)
    D = n if distortion_limit is None else distortion_limit

    # state = (next unconsumed original position base, coverage bitmask
    # of positions [base, base+W) already emitted); arcs emit any
    # uncovered position within the window
    state_id: Dict[Tuple[int, int], int] = {}
    arcs_out: List[Tuple[int, int, int, float]] = []
    final: Dict[int, float] = {}
    stack: List[Tuple[int, int, int]] = []   # (base, mask, emitted count)

    def sid(base: int, mask: int, emitted: int) -> int:
        # normalize: advance base over covered prefix
        while mask & 1:
            mask >>= 1
            base += 1
        key = (base, mask)
        if key not in state_id:
            state_id[key] = len(state_id)
            stack.append((base, mask, emitted))
        return state_id[key]

    start = sid(0, 0, 0)
    seen = set()
    while stack:
        base, mask, emitted = stack.pop()
        if (base, mask) in seen:
            continue
        seen.add((base, mask))
        s0 = state_id[(base, mask)]
        if base >= n and mask == 0:
            final[s0] = 0.0
            continue
        for k in range(min(W, n - base)):
            if mask & (1 << k):
                continue
            pos = base + k
            if abs(pos - emitted) > D:
                continue
            t = sid(base, mask | (1 << k), emitted + 1)
            arcs_out.append((s0, t, labels[pos], weights[pos]))
    return Automaton.build(len(state_id), arcs_out, final, start)


# -- random path (Fsa/Random.cc) ----------------------------------------------

def random_path(a: Automaton, weight: float = 0.0,
                maximum_size: int = 0,
                seed: Optional[int] = None) -> Automaton:
    """Sample one path (linear automaton). `weight` = 0 samples arcs
    uniformly; otherwise p(arc) ∝ exp(−arc.weight · weight) (log
    semirings, Fsa/Random.hh:21-35). `maximum_size` bounds the result
    length (0 = unbounded)."""
    rng = np.random.RandomState(seed)
    out_idx = a.out_index()
    s = a.initial
    path: List[Tuple[int, int, float]] = []
    while True:
        if maximum_size and len(path) >= maximum_size:
            break
        arcs = out_idx[s]
        stop_ok = np.isfinite(a.final[s])
        if not arcs:
            break
        # a final state may stop; weight the stop option like an arc
        opts = list(arcs) + ([None] if stop_ok else [])
        if weight == 0.0:
            pick = opts[rng.randint(len(opts))]
        else:
            w = np.array([float(a.weight[i]) if i is not None
                          else float(a.final[s]) for i in opts])
            p = np.exp(-w * weight - np.min(-w * weight))
            p = p / p.sum()
            pick = opts[rng.choice(len(opts), p=p)]
        if pick is None:
            break
        path.append((int(a.ilabel[pick]), int(a.olabel[pick]),
                     float(a.weight[pick])))
        s = int(a.dst[pick])
        if not out_idx[s] and np.isfinite(a.final[s]):
            break
    arcs_lin = [(i, i + 1, il, ol, w)
                for i, (il, ol, w) in enumerate(path)]
    return Automaton.build(len(path) + 1, arcs_lin, {len(path): 0.0})
