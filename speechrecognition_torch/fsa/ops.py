"""Automaton algorithms (reference: rwth-asr-0.5/src/Fsa/ per-op files:
Compose.cc, Determinize.cc, Minimize.cc, RemoveEpsilons.cc, Best.cc,
Prune.cc, Project.cc, Rational.cc (union/concat/closure), Draw.cc,
Sssp.cc (shortest distances)).

Port: a copy of speechrecognition_tpu/fsa/ops.py (host code).
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .automaton import EPS, Automaton
from .semiring import LogSemiring, TropicalSemiring

INF = float("inf")


# -- shortest distances (Fsa/Sssp.cc) ----------------------------------------

def shortest_distance(a: Automaton, reverse: bool = False,
                      semiring: Optional[type] = None) -> np.ndarray:
    """d[s] = ⊕ over paths initial→s (or s→final when reverse)."""
    sr = semiring or a.semiring
    if reverse:
        src, dst = a.dst, a.src
        seed = [(int(s), float(a.final[s])) for s in a.final_states()]
    else:
        src, dst = a.src, a.dst
        seed = [(a.initial, 0.0)]

    out: List[List[int]] = [[] for _ in range(a.num_states)]
    for i in range(len(src)):
        out[int(src[i])].append(i)

    d = np.full(a.num_states, INF)
    r = np.full(a.num_states, INF)          # unrelaxed mass (Mohri's algorithm)
    queue: deque = deque()
    queued = np.zeros(a.num_states, bool)
    for s, w in seed:
        d[s] = sr.plus(d[s], w)
        r[s] = sr.plus(r[s], w)
        if not queued[s]:
            queue.append(s); queued[s] = True
    while queue:
        s = queue.popleft()
        queued[s] = False
        rs, r[s] = r[s], INF
        for i in out[s]:
            t = int(dst[i])
            nw = sr.times(rs, float(a.weight[i]))
            merged = sr.plus(d[t], nw)
            if merged < d[t] - 1e-12:
                d[t] = merged
                r[t] = sr.plus(r[t], nw)
                if not queued[t]:
                    queue.append(t); queued[t] = True
    return d


# -- best path / n-best (Fsa/Best.cc) -----------------------------------------

def best_path(a: Automaton) -> Tuple[List[int], List[int], float]:
    """Tropical shortest accepting path → (ilabels, olabels, weight);
    returns ([], [], inf) if no accepting path exists."""
    bwd = shortest_distance(a, reverse=True, semiring=TropicalSemiring)
    if bwd[a.initial] == INF:
        return [], [], INF
    out = a.out_index()
    il: List[int] = []
    ol: List[int] = []
    s = a.initial
    total = 0.0
    # greedy walk along arcs consistent with the backward potential
    steps = 0
    max_steps = a.num_arcs + a.num_states + 1
    while True:
        if np.isfinite(a.final[s]) and abs(float(a.final[s]) - bwd[s]) < 1e-9:
            total += float(a.final[s])
            return ([l for l in il if l != EPS], [l for l in ol if l != EPS],
                    total)
        nxt = None
        for i in out[s]:
            t = int(a.dst[i])
            if bwd[t] < INF and abs(float(a.weight[i]) + bwd[t] - bwd[s]) < 1e-9:
                nxt = i
                break
        if nxt is None or steps > max_steps:   # numerical fallback
            best_i = min(out[s], key=lambda i: float(a.weight[i]) + bwd[int(a.dst[i])])
            nxt = best_i
        il.append(int(a.ilabel[nxt]))
        ol.append(int(a.olabel[nxt]))
        total += float(a.weight[nxt])
        s = int(a.dst[nxt])
        steps += 1
        if steps > 2 * max_steps:
            raise RuntimeError("best_path did not terminate (negative cycle?)")


def n_best(a: Automaton, n: int) -> List[Tuple[List[int], float]]:
    """n best accepting ilabel sequences (A* over the backward potential)."""
    bwd = shortest_distance(a, reverse=True, semiring=TropicalSemiring)
    if bwd[a.initial] == INF:
        return []
    out = a.out_index()
    results: List[Tuple[List[int], float]] = []
    seen: Dict[Tuple[int, ...], float] = {}
    counter = 0
    heap = [(bwd[a.initial], counter, a.initial, 0.0, [])]
    pops = 0
    limit = 200000
    while heap and len(results) < n and pops < limit:
        f, _c, s, g, labs = heapq.heappop(heap)
        pops += 1
        if np.isfinite(a.final[s]):
            key = tuple(labs)
            total = g + float(a.final[s])
            if key not in seen or total < seen[key] - 1e-12:
                seen[key] = total
                results.append((list(labs), total))
                if len(results) >= n:
                    break
        for i in out[s]:
            t = int(a.dst[i])
            if bwd[t] == INF:
                continue
            ng = g + float(a.weight[i])
            lab = int(a.ilabel[i])
            nlabs = labs if lab == EPS else labs + [lab]
            counter += 1
            heapq.heappush(heap, (ng + bwd[t], counter, t, ng, nlabs))
    return results


# -- connect / prune (Fsa/Prune.cc) -------------------------------------------

def _remap(a: Automaton, keep: np.ndarray) -> Automaton:
    new_id = np.full(a.num_states, -1, np.int64)
    new_id[keep] = np.arange(keep.sum())
    arc_keep = (new_id[a.src] >= 0) & (new_id[a.dst] >= 0)
    return Automaton(num_states=int(keep.sum()),
                     src=new_id[a.src[arc_keep]].astype(np.int32),
                     dst=new_id[a.dst[arc_keep]].astype(np.int32),
                     ilabel=a.ilabel[arc_keep].copy(),
                     olabel=a.olabel[arc_keep].copy(),
                     weight=a.weight[arc_keep].copy(),
                     final=a.final[keep].copy(),
                     initial=int(new_id[a.initial]),
                     semiring=a.semiring)


def connect(a: Automaton) -> Automaton:
    """Trim: keep states both accessible and co-accessible."""
    fwd = shortest_distance(a, semiring=TropicalSemiring)
    bwd = shortest_distance(a, reverse=True, semiring=TropicalSemiring)
    keep = np.isfinite(fwd) & np.isfinite(bwd)
    if not keep[a.initial]:
        # empty language: single non-final initial state
        return Automaton(num_states=1,
                         src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
                         ilabel=np.zeros(0, np.int32), olabel=np.zeros(0, np.int32),
                         weight=np.zeros(0), final=np.full(1, INF),
                         initial=0, semiring=a.semiring)
    return _remap(a, keep)


def prune(a: Automaton, threshold: float) -> Automaton:
    """Drop arcs whose best path through them exceeds best + threshold
    (posterior-style pruning in the tropical semiring)."""
    fwd = shortest_distance(a, semiring=TropicalSemiring)
    bwd = shortest_distance(a, reverse=True, semiring=TropicalSemiring)
    best = bwd[a.initial]
    through = fwd[a.src] + a.weight + bwd[a.dst]
    arc_keep = through <= best + threshold
    b = Automaton(num_states=a.num_states, src=a.src[arc_keep],
                  dst=a.dst[arc_keep], ilabel=a.ilabel[arc_keep],
                  olabel=a.olabel[arc_keep], weight=a.weight[arc_keep],
                  final=a.final.copy(), initial=a.initial, semiring=a.semiring)
    return connect(b)


# -- rational ops (Fsa/Rational.cc) -------------------------------------------

def union(a: Automaton, b: Automaton) -> Automaton:
    """New super-initial state with eps arcs to both."""
    off = 1
    boff = off + a.num_states
    n = 1 + a.num_states + b.num_states
    src = np.concatenate([[0, 0], a.src + off, b.src + boff]).astype(np.int32)
    dst = np.concatenate([[a.initial + off, b.initial + boff],
                          a.dst + off, b.dst + boff]).astype(np.int32)
    il = np.concatenate([[EPS, EPS], a.ilabel, b.ilabel]).astype(np.int32)
    ol = np.concatenate([[EPS, EPS], a.olabel, b.olabel]).astype(np.int32)
    wt = np.concatenate([[0.0, 0.0], a.weight, b.weight])
    fin = np.concatenate([[INF], a.final, b.final])
    return Automaton(n, src, dst, il, ol, wt, fin, 0, a.semiring)


def concat(a: Automaton, b: Automaton) -> Automaton:
    boff = a.num_states
    n = a.num_states + b.num_states
    fa = a.final_states()
    src = np.concatenate([a.src, fa, b.src + boff]).astype(np.int32)
    dst = np.concatenate([a.dst, np.full(len(fa), b.initial + boff),
                          b.dst + boff]).astype(np.int32)
    il = np.concatenate([a.ilabel, np.full(len(fa), EPS), b.ilabel]).astype(np.int32)
    ol = np.concatenate([a.olabel, np.full(len(fa), EPS), b.olabel]).astype(np.int32)
    wt = np.concatenate([a.weight, a.final[fa], b.weight])
    fin = np.concatenate([np.full(a.num_states, INF), b.final])
    return Automaton(n, src, dst, il, ol, wt, fin, a.initial, a.semiring)


def closure(a: Automaton) -> Automaton:
    """Kleene star: new initial/final super-state with eps loops."""
    off = 1
    n = a.num_states + 1
    fa = a.final_states()
    src = np.concatenate([[0], a.src + off, fa + off]).astype(np.int32)
    dst = np.concatenate([[a.initial + off], a.dst + off,
                          np.zeros(len(fa))]).astype(np.int32)
    il = np.concatenate([[EPS], a.ilabel, np.full(len(fa), EPS)]).astype(np.int32)
    ol = np.concatenate([[EPS], a.olabel, np.full(len(fa), EPS)]).astype(np.int32)
    wt = np.concatenate([[0.0], a.weight, a.final[fa]])
    fin = np.concatenate([[0.0], np.full(a.num_states, INF)])
    return Automaton(n, src, dst, il, ol, wt, fin, 0, a.semiring)


def project(a: Automaton, side: str = "input") -> Automaton:
    lab = a.ilabel if side == "input" else a.olabel
    return Automaton(a.num_states, a.src.copy(), a.dst.copy(), lab.copy(),
                     lab.copy(), a.weight.copy(), a.final.copy(), a.initial,
                     a.semiring)


def invert(a: Automaton) -> Automaton:
    return Automaton(a.num_states, a.src.copy(), a.dst.copy(),
                     a.olabel.copy(), a.ilabel.copy(), a.weight.copy(),
                     a.final.copy(), a.initial, a.semiring)


def reverse(a: Automaton) -> Automaton:
    """Reverse the language: new super-initial connected to old finals."""
    off = 1
    n = a.num_states + 1
    fa = a.final_states()
    src = np.concatenate([np.zeros(len(fa)), a.dst + off]).astype(np.int32)
    dst = np.concatenate([fa + off, a.src + off]).astype(np.int32)
    il = np.concatenate([np.full(len(fa), EPS), a.ilabel]).astype(np.int32)
    ol = np.concatenate([np.full(len(fa), EPS), a.olabel]).astype(np.int32)
    wt = np.concatenate([a.final[fa], a.weight])
    fin = np.full(n, INF)
    fin[a.initial + off] = 0.0
    return Automaton(n, src, dst, il, ol, wt, fin, 0, a.semiring)


# -- epsilon removal (Fsa/RemoveEpsilons.cc) ----------------------------------

def remove_epsilons(a: Automaton) -> Automaton:
    """Tropical eps-closure per state, then fold closures into non-eps
    arcs and final weights."""
    eps_mask = (a.ilabel == EPS) & (a.olabel == EPS)
    eps_out: List[List[int]] = [[] for _ in range(a.num_states)]
    for i in np.nonzero(eps_mask)[0]:
        eps_out[int(a.src[i])].append(int(i))

    arcs: List[Tuple[int, int, int, int, float]] = []
    fin = a.final.copy()
    non_eps = np.nonzero(~eps_mask)[0]
    out_noneps: List[List[int]] = [[] for _ in range(a.num_states)]
    for i in non_eps:
        out_noneps[int(a.src[i])].append(int(i))

    for s in range(a.num_states):
        # closure distances from s over the eps subgraph (Bellman-Ford queue)
        d = {s: 0.0}
        queue = deque([s])
        while queue:
            q = queue.popleft()
            for i in eps_out[q]:
                t = int(a.dst[i])
                nw = d[q] + float(a.weight[i])
                if nw < d.get(t, INF) - 1e-15:
                    d[t] = nw
                    queue.append(t)
        for q, dq in d.items():
            fin[s] = min(fin[s], dq + a.final[q])
            for i in out_noneps[q]:
                arcs.append((s, int(a.dst[i]), int(a.ilabel[i]),
                             int(a.olabel[i]), dq + float(a.weight[i])))
    b = Automaton.build(a.num_states, arcs, fin, a.initial, a.semiring)
    return connect(b)


# -- composition (Fsa/Compose.cc) ---------------------------------------------

def compose(a: Automaton, b: Automaton) -> Automaton:
    """Transducer composition: a.olabel matches b.ilabel.  Epsilons are
    handled by free single-sided moves — in the tropical semiring the
    duplicate eps-paths this admits are harmless (min-idempotent), which
    is the semiring all toolkit lattices use."""
    state_id: Dict[Tuple[int, int], int] = {}
    arcs: List[Tuple[int, int, int, int, float]] = []
    final: Dict[int, float] = {}

    a_out = a.out_index()
    b_out = b.out_index()

    def sid(p: int, q: int) -> int:
        key = (p, q)
        if key not in state_id:
            state_id[key] = len(state_id)
            stack.append(key)
        return state_id[key]

    stack: List[Tuple[int, int]] = []
    start = sid(a.initial, b.initial)
    while stack:
        p, q = stack.pop()
        s = state_id[(p, q)]
        fw = a.final[p] + b.final[q]
        if np.isfinite(fw):
            final[s] = float(fw)
        for i in a_out[p]:
            if a.olabel[i] == EPS:
                # advance a only
                t = sid(int(a.dst[i]), q)
                arcs.append((s, t, int(a.ilabel[i]), EPS, float(a.weight[i])))
            else:
                for j in b_out[q]:
                    if b.ilabel[j] == a.olabel[i]:
                        t = sid(int(a.dst[i]), int(b.dst[j]))
                        arcs.append((s, t, int(a.ilabel[i]), int(b.olabel[j]),
                                     float(a.weight[i]) + float(b.weight[j])))
        for j in b_out[q]:
            if b.ilabel[j] == EPS:
                t = sid(p, int(b.dst[j]))
                arcs.append((s, t, EPS, int(b.olabel[j]), float(b.weight[j])))

    c = Automaton.build(len(state_id), arcs, final, start, a.semiring)
    return connect(c)


# -- determinization / minimization (Fsa/Determinize.cc, Minimize.cc) ---------

def determinize(a: Automaton, max_states: int = 200_000) -> Automaton:
    """Weighted subset construction over the tropical semiring (acceptors,
    eps-free — call remove_epsilons first).

    Scale contract: this is an EAGER host-side construction whose result
    can be exponential in the input (unlike the reference's on-demand
    ``Fsa::Automaton``, Fsa/Determinize.cc, which materializes states
    lazily). ``max_states`` bounds the blow-up: exceeding it raises
    instead of hanging the pipeline. Suitable for lexicon/grammar-scale
    automata (≤ ~10^5 subset states); LVCSR-scale grammar composition
    should stay in the dense decoder tables, which never determinize."""
    if not a.is_acceptor():
        raise ValueError("determinize: acceptors only")
    if bool(((a.ilabel == EPS)).any()):
        a = remove_epsilons(a)

    out = a.out_index()

    def canon(subset: List[Tuple[int, float]]):
        m = min(r for _s, r in subset)
        return (tuple(sorted((s, round(r - m, 12)) for s, r in subset)), m)

    key0, w0 = canon([(a.initial, 0.0)])
    state_id: Dict[Tuple, int] = {key0: 0}
    subsets: List[Tuple] = [key0]
    arcs: List[Tuple[int, int, int, float]] = []
    final: Dict[int, float] = {}
    stack = [key0]
    while stack:
        key = stack.pop()
        s = state_id[key]
        fw = INF
        by_label: Dict[int, Dict[int, float]] = {}
        for q, r in key:
            if np.isfinite(a.final[q]):
                fw = min(fw, r + float(a.final[q]))
            for i in out[q]:
                lab = int(a.ilabel[i])
                t = int(a.dst[i])
                w = r + float(a.weight[i])
                d = by_label.setdefault(lab, {})
                if w < d.get(t, INF):
                    d[t] = w
        if np.isfinite(fw):
            final[s] = fw
        for lab in sorted(by_label):
            nkey, nw = canon(list(by_label[lab].items()))
            if nkey not in state_id:
                if len(state_id) >= max_states:
                    raise RuntimeError(
                        f"determinize: subset construction exceeded "
                        f"{max_states} states (input {a.num_states} states/"
                        f"{a.num_arcs} arcs) — raise max_states or keep the "
                        f"automaton in lazy/dense form")
                state_id[nkey] = len(state_id)
                subsets.append(nkey)
                stack.append(nkey)
            arcs.append((s, state_id[nkey], lab, nw))

    b = Automaton.build(len(state_id), arcs, final, 0, a.semiring)
    # initial residual w0 folds into arc weights out of the start state and
    # its final weight (w0 == 0 for the singleton start subset)
    if w0 != 0.0:
        mask = b.src == 0
        b.weight[mask] += w0
        if np.isfinite(b.final[0]):
            b.final[0] += w0
    return b


def is_deterministic(a: Automaton) -> bool:
    pairs = set()
    for i in range(a.num_arcs):
        key = (int(a.src[i]), int(a.ilabel[i]))
        if a.ilabel[i] == EPS or key in pairs:
            return False
        pairs.add(key)
    return True


def push(a: Automaton) -> Automaton:
    """Weight pushing toward the initial state (potential reweighting with
    the backward tropical distances)."""
    bwd = shortest_distance(a, reverse=True, semiring=TropicalSemiring)
    pot = np.where(np.isfinite(bwd), bwd, 0.0)
    wt = a.weight + pot[a.dst] - pot[a.src]
    fin = a.final - pot
    b = Automaton(a.num_states, a.src.copy(), a.dst.copy(), a.ilabel.copy(),
                  a.olabel.copy(), wt, fin, a.initial, a.semiring)
    # fold the initial potential back so total path weights are unchanged
    mask = b.src == b.initial
    b.weight[mask] += pot[a.initial]
    if np.isfinite(b.final[b.initial]):
        b.final[b.initial] += pot[a.initial]
    return b


def minimize(a: Automaton) -> Automaton:
    """Weighted acceptor minimization: push, then Moore partition
    refinement on (final weight, arc signatures)."""
    a = connect(a)
    if not is_deterministic(a):
        a = determinize(a)
    a = push(a)
    out = a.out_index()

    def fkey(s):
        f = a.final[s]
        return round(float(f), 9) if np.isfinite(f) else None

    cls = {}
    classes: Dict[Tuple, int] = {}
    for s in range(a.num_states):
        k = (fkey(s),)
        if k not in classes:
            classes[k] = len(classes)
        cls[s] = classes[k]

    while True:
        new_classes: Dict[Tuple, int] = {}
        new_cls = {}
        for s in range(a.num_states):
            sig = tuple(sorted((int(a.ilabel[i]), round(float(a.weight[i]), 9),
                                cls[int(a.dst[i])]) for i in out[s]))
            k = (cls[s], sig)
            if k not in new_classes:
                new_classes[k] = len(new_classes)
            new_cls[s] = new_classes[k]
        if len(new_classes) == len(set(cls.values())):
            break
        cls = new_cls

    n = len(set(cls.values()))
    arcs_set = set()
    arcs = []
    fin = np.full(n, INF)
    for s in range(a.num_states):
        fin[cls[s]] = min(fin[cls[s]], float(a.final[s]))
        for i in out[s]:
            t = (cls[s], cls[int(a.dst[i])], int(a.ilabel[i]),
                 round(float(a.weight[i]), 12))
            if t not in arcs_set:
                arcs_set.add(t)
                arcs.append((t[0], t[1], t[2], float(a.weight[i])))
    return Automaton.build(n, arcs, fin, cls[a.initial], a.semiring)


# -- drawing (Fsa/Draw.cc) -----------------------------------------------------

def draw(a: Automaton, symbols: Optional[Dict[int, str]] = None) -> str:
    """Graphviz dot export."""
    def lab(i):
        il = "eps" if a.ilabel[i] == EPS else (
            symbols.get(int(a.ilabel[i]), str(int(a.ilabel[i])))
            if symbols else str(int(a.ilabel[i])))
        if a.ilabel[i] != a.olabel[i]:
            ol = "eps" if a.olabel[i] == EPS else (
                symbols.get(int(a.olabel[i]), str(int(a.olabel[i])))
                if symbols else str(int(a.olabel[i])))
            il = f"{il}:{ol}"
        return f"{il}/{a.weight[i]:.3f}"

    lines = ["digraph fsa {", "rankdir=LR;",
             f'node [shape=circle]; {a.initial} [style=bold];']
    for s in a.final_states():
        lines.append(f'{s} [shape=doublecircle, label="{s}/{a.final[s]:.3f}"];')
    for i in range(a.num_arcs):
        lines.append(f'{a.src[i]} -> {a.dst[i]} [label="{lab(i)}"];')
    lines.append("}")
    return "\n".join(lines)


def from_word_lattice(lat) -> Automaton:
    """search/lattice.WordLattice → acceptor (states = frames 0..T,
    labels = word ids, final at the last frame)."""
    arcs = [(a.start, a.end, a.word, a.score) for a in lat.arcs]
    return Automaton.build(lat.num_frames + 1, arcs, {lat.num_frames: 0.0})
