"""Flf composition / rational-operation nodes over word lattices.

Counterpart of the reference's Flf/Compose.cc +
Flf/RemoveEpsilons.cc + Flf/Fit.cc node implementations
(rwth-asr-0.5/src/Flf/NodeRegistration.hh entries `compose`,
`compose-matching`, `compose-sequencing`, `intersection`, `difference`,
`compose-with-fsa`, `compose-with-lm`, `remove-epsilons`, `fit`):
the lattice is bridged to the framework's Fsa library (fsa/ops.py —
itself the counterpart of Fsa/Compose.cc), composed eagerly, and the
acyclic product is renumbered topologically back into a WordLattice.

Product-lattice node ids are NOT frames; the returned lattice carries a
``times`` map (node → frame of the lattice-side component) so that
time-dependent consumers (fit, drawer, traceback) stay correct.
Epsilon arcs use label −1 (the Fsa library's EPS), distinct from the
silence word: the reference keeps the same distinction between
non-words (silence etc.) and structural epsilons.

Port: a copy of speechrecognition_tpu/search/flf_compose.py (host code).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fsa.automaton import Automaton
from ..fsa import ops as fsa_ops
from .lattice import Arc, WordLattice

EPS = -1        # structural epsilon label (== fsa.ops.EPS)


# -- fsa bridge ---------------------------------------------------------------

def lattice_to_automaton(lat: WordLattice) -> Automaton:
    """WordLattice → acceptor; states are the lattice's nodes, final at
    the last node (Fsa bridge, same layout as fsa.ops.from_word_lattice)."""
    arcs = [(a.start, a.end, a.word, a.score) for a in lat.arcs]
    return Automaton.build(lat.num_frames + 1, arcs, {lat.num_frames: 0.0})


def automaton_to_lattice(auto: Automaton, silence: int = 0,
                         times: Optional[Dict[int, int]] = None,
                         ) -> WordLattice:
    """Acyclic automaton → WordLattice with topologically renumbered
    nodes. Multiple/weighted final states are normalized through a
    single super-final node reached by ε-arcs carrying the final weight
    (the reference's `fit` normalization, Flf/Fit.cc does the same).

    `times` maps ORIGINAL automaton state → frame; the result carries
    the renumbered map (super-final gets the max time).
    """
    n = auto.num_states
    # Kahn topological order
    indeg = np.zeros(n, dtype=np.int64)
    for d in auto.dst:
        indeg[d] += 1
    order: List[int] = [s for s in range(n) if indeg[s] == 0]
    head = 0
    out_idx = auto.out_index()
    while head < len(order):
        s = order[head]
        head += 1
        for i in out_idx[s]:
            d = int(auto.dst[i])
            indeg[d] -= 1
            if indeg[d] == 0:
                order.append(d)
    if len(order) != n:
        raise ValueError("automaton_to_lattice: input has a cycle")
    rank = {s: r for r, s in enumerate(order)}

    finals = auto.final_states()
    single_last_final = (len(finals) == 1
                         and rank[int(finals[0])] == n - 1
                         and auto.final[int(finals[0])] == 0.0)
    num_nodes = n if single_last_final else n + 1
    final_node = num_nodes - 1

    arcs: List[Arc] = []
    for i in range(auto.num_arcs):
        arcs.append(Arc(start=rank[int(auto.src[i])],
                        end=rank[int(auto.dst[i])],
                        word=int(auto.ilabel[i]),
                        score=float(auto.weight[i])))
    if not single_last_final:
        for s in finals:
            arcs.append(Arc(start=rank[int(s)], end=final_node, word=EPS,
                            score=float(auto.final[int(s)])))

    tmap: Optional[Dict[int, int]] = None
    if times is not None:
        tmap = {rank[s]: times[s] for s in range(n) if s in times}
        tmap[final_node] = max(tmap.values(), default=0)
    return WordLattice(num_frames=final_node, arcs=arcs, silence=silence,
                       times=tmap)


def _compose_automata_with_times(lat: WordLattice, other: Automaton,
                                 ) -> Tuple[Automaton, Dict[int, int]]:
    """Compose lattice (left) with automaton (right), recovering each
    product state's time from the left component. fsa_ops.compose gives
    no state provenance, so the product is rebuilt here with the same
    algorithm but (frame, state) bookkeeping kept."""
    a = lattice_to_automaton(lat)
    state_id: Dict[Tuple[int, int], int] = {}
    arcs: List[Tuple[int, int, int, float]] = []
    final: Dict[int, float] = {}
    a_out, b_out = a.out_index(), other.out_index()
    stack: List[Tuple[int, int]] = []

    def sid(p: int, q: int) -> int:
        key = (p, q)
        if key not in state_id:
            state_id[key] = len(state_id)
            stack.append(key)
        return state_id[key]

    start = sid(a.initial, other.initial)
    while stack:
        p, q = stack.pop()
        s = state_id[(p, q)]
        fw = a.final[p] + other.final[q]
        if np.isfinite(fw):
            final[s] = float(fw)
        for i in a_out[p]:
            lab = int(a.olabel[i])
            if lab == EPS:
                t = sid(int(a.dst[i]), q)
                arcs.append((s, t, EPS, float(a.weight[i])))
            else:
                for j in b_out[q]:
                    if int(other.ilabel[j]) == lab:
                        t = sid(int(a.dst[i]), int(other.dst[j]))
                        arcs.append((s, t, lab,
                                     float(a.weight[i]) +
                                     float(other.weight[j])))
        for j in b_out[q]:
            if int(other.ilabel[j]) == EPS:
                t = sid(p, int(other.dst[j]))
                arcs.append((s, t, EPS, float(other.weight[j])))

    c = Automaton.build(len(state_id), arcs, final, start)
    c = fsa_ops.connect(c)
    # connect() renumbers; recover frame provenance by replaying the
    # same keep/remap it applies (states kept = co-accessible ∩
    # accessible, order preserved) — we instead recompute via matching:
    # connect keeps original order, so map through the kept mask.
    # fsa_ops.connect uses _remap(keep): new id = position among kept.
    # Reproduce the mask:
    keep = _reachable_mask(Automaton.build(len(state_id),
                                           arcs, final, start))
    old_times = {v: k[0] for k, v in state_id.items()}
    new_times: Dict[int, int] = {}
    nid = 0
    for s in range(len(state_id)):
        if keep[s]:
            new_times[nid] = old_times[s]
            nid += 1
    return c, new_times


def _reachable_mask(a: Automaton) -> np.ndarray:
    """Accessible ∧ co-accessible mask, mirroring fsa_ops.connect."""
    n = a.num_states
    fwd = np.zeros(n, dtype=bool)
    fwd[a.initial] = True
    out_idx = a.out_index()
    stack = [a.initial]
    while stack:
        s = stack.pop()
        for i in out_idx[s]:
            d = int(a.dst[i])
            if not fwd[d]:
                fwd[d] = True
                stack.append(d)
    bwd = np.isfinite(a.final)
    in_idx: List[List[int]] = [[] for _ in range(n)]
    for i in range(a.num_arcs):
        in_idx[int(a.dst[i])].append(i)
    stack = list(np.nonzero(bwd)[0])
    while stack:
        s = int(stack.pop())
        for i in in_idx[s]:
            src = int(a.src[i])
            if not bwd[src]:
                bwd[src] = True
                stack.append(src)
    return fwd & bwd


# -- node-level operations ----------------------------------------------------

def compose_lattices(left: WordLattice, right: WordLattice,
                     unweighted_left: bool = False) -> WordLattice:
    """`compose` / `compose-matching` / `compose-sequencing`
    (Flf/Compose.cc): compose two lattices as acceptors. If
    ``unweighted_left`` (compose-matching's rule for an unweighted left
    lattice), left weights are set to semiring one (0 in −log)."""
    if unweighted_left:
        left = WordLattice(num_frames=left.num_frames,
                           arcs=[Arc(a.start, a.end, a.word, 0.0)
                                 for a in left.arcs],
                           silence=left.silence, times=left.times)
    auto, times = _compose_automata_with_times(
        left, lattice_to_automaton(right))
    return automaton_to_lattice(auto, silence=left.silence, times=times)


def intersect_lattices(left: WordLattice, right: WordLattice) -> WordLattice:
    """`intersection`: acceptor intersection == acceptor composition."""
    return compose_lattices(left, right)


def difference_lattices(left: WordLattice, right: WordLattice) -> WordLattice:
    """`difference` (Flf/Difference → Fsa difference): paths of `left`
    whose label strings are NOT accepted by `right`. `right` is treated
    as an unweighted acceptor: it is determinized, completed with a sink
    over `left`'s label alphabet, complemented, and intersected."""
    r = Automaton.build(
        right.num_frames + 1,
        [(a.start, a.end, a.word, 0.0) for a in right.arcs],
        {right.num_frames: 0.0})
    r = fsa_ops.remove_epsilons(r)
    r = fsa_ops.determinize(r)
    labels = sorted({a.word for a in left.arcs if a.word != EPS}
                    | {int(l) for l in r.ilabel if int(l) != EPS})
    # complete: add sink state catching all missing transitions
    n = r.num_states
    sink = n
    arcs = [(int(r.src[i]), int(r.dst[i]), int(r.ilabel[i]),
             float(r.weight[i])) for i in range(r.num_arcs)]
    out_idx = r.out_index()
    for s in range(n):
        have = {int(r.ilabel[i]) for i in out_idx[s]}
        for l in labels:
            if l not in have:
                arcs.append((s, sink, l, 0.0))
    for l in labels:
        arcs.append((sink, sink, l, 0.0))
    # complement finality
    fin = {s: 0.0 for s in range(n + 1)
           if not (s < n and np.isfinite(r.final[s]))}
    comp = Automaton.build(n + 1, arcs, fin, r.initial)
    auto, times = _compose_automata_with_times(left, comp)
    return automaton_to_lattice(auto, silence=left.silence, times=times)


def compose_with_fsa(lat: WordLattice, fsa: Automaton,
                     scale: float = 1.0) -> WordLattice:
    """`compose-with-fsa`: compose the lattice with an automaton and add
    `scale` × fsa weights into the score dimension (the reference
    rescoring a single lattice dimension)."""
    scaled = Automaton(num_states=fsa.num_states, src=fsa.src, dst=fsa.dst,
                       ilabel=fsa.ilabel, olabel=fsa.olabel,
                       weight=fsa.weight * scale, final=fsa.final * scale,
                       initial=fsa.initial, semiring=fsa.semiring)
    auto, times = _compose_automata_with_times(lat, scaled)
    return automaton_to_lattice(auto, silence=lat.silence, times=times)


def compose_with_lm(lat: WordLattice, lm, vocab: Sequence[str],
                    scale: float = 1.0,
                    force_sentence_end: bool = True) -> WordLattice:
    """`compose-with-lm` (Flf/Compose.cc ComposeWithLmNode): expand the
    lattice over ARPA LM histories; every non-silence arc is charged
    `scale` × −log p(word | history), segment end charged the
    sentence-end score when `force_sentence_end`.

    Product states are (node, history); silence arcs are transparent
    (do not extend the history and carry no LM score) — the Sprint
    recognizer's treatment of non-words.
    """
    bos = lm.index("<s>")
    eos = lm.index("</s>")
    order_minus1 = max(1, getattr(lm, "order", 3) - 1)

    lm_ids = [lm.index(w) for w in vocab]

    state_id: Dict[Tuple[int, Tuple[int, ...]], int] = {}
    times: Dict[int, int] = {}
    stack: List[Tuple[int, Tuple[int, ...]]] = []

    def sid(node: int, hist: Tuple[int, ...]) -> int:
        key = (node, hist)
        if key not in state_id:
            state_id[key] = len(state_id)
            times[state_id[key]] = lat.time_of(node)
            stack.append(key)
        return state_id[key]

    by_start = lat.by_start()
    start = sid(0, (bos,))
    arcs: List[Tuple[int, int, int, float]] = []
    final: Dict[int, float] = {}
    while stack:
        node, hist = stack.pop()
        s = state_id[(node, hist)]
        if node == lat.num_frames:
            # lm.score is already −ln p (a positive cost)
            w = scale * lm.score(eos, hist) if force_sentence_end else 0.0
            final[s] = w
        for a in by_start.get(node, []):
            if a.word == lat.silence or a.word == EPS:
                t = sid(a.end, hist)
                arcs.append((s, t, a.word, a.score))
            else:
                lw = scale * lm.score(lm_ids[a.word], hist)
                nh = (hist + (lm_ids[a.word],))[-order_minus1:]
                t = sid(a.end, nh)
                arcs.append((s, t, a.word, a.score + lw))

    auto = Automaton.build(len(state_id), arcs, final, start)
    auto = fsa_ops.connect(auto)
    keep = _reachable_mask(Automaton.build(len(state_id), arcs, final, start))
    new_times: Dict[int, int] = {}
    nid = 0
    for s in range(len(state_id)):
        if keep[s]:
            new_times[nid] = times[s]
            nid += 1
    return automaton_to_lattice(auto, silence=lat.silence, times=new_times)


def remove_epsilon_arcs(lat: WordLattice) -> WordLattice:
    """`remove-epsilons` (Flf → Fsa/RemoveEpsilons): classical ε-removal
    over the tropical semiring. Only label −1 is structural epsilon;
    non-words (silence) are real arcs and survive."""
    T = lat.num_frames
    INF = np.inf
    # ε-closure best costs by DAG DP (nodes are topologically ordered)
    eps_out: Dict[int, List[Arc]] = {}
    for a in lat.arcs:
        if a.word == EPS:
            eps_out.setdefault(a.start, []).append(a)
    # closure[s] = {e: best_cost} (including s itself at 0)
    nodes = sorted({a.start for a in lat.arcs} | {a.end for a in lat.arcs}
                   | {0, T})
    closure: Dict[int, Dict[int, float]] = {}
    for s in reversed(nodes):
        cl = {s: 0.0}
        for a in eps_out.get(s, []):
            for e, c in closure.get(a.end, {a.end: 0.0}).items():
                cost = a.score + c
                if cost < cl.get(e, INF):
                    cl[e] = cost
        closure[s] = cl
    arcs: List[Arc] = []
    seen: Dict[Tuple[int, int, int], float] = {}
    for a in lat.arcs:
        if a.word == EPS:
            continue
        # reattach: any state s with ε-path to a.start emits the arc
        for s in nodes:
            c = closure.get(s, {}).get(a.start)
            if c is None:
                continue
            key = (s, a.end, a.word)
            sc = c + a.score
            if sc < seen.get(key, INF):
                seen[key] = sc
    for (s, e, w), sc in seen.items():
        arcs.append(Arc(start=s, end=e, word=w, score=sc))
    # final ε-closure: paths ending with ε-arcs into T fold into the
    # incoming word arc (arc end moves to T carrying the ε cost)
    folded: Dict[Tuple[int, int, int], float] = {}
    for a in arcs:
        c = closure.get(a.end, {}).get(T)
        if c is not None and a.end != T:
            key = (a.start, T, a.word)
            sc = a.score + c
            if sc < folded.get(key, INF):
                folded[key] = sc
    existing = {(a.start, a.end, a.word): a.score for a in arcs}
    for key, sc in folded.items():
        if sc < existing.get(key, INF):
            existing[key] = sc
    out = [Arc(start=s, end=e, word=w, score=sc)
           for (s, e, w), sc in existing.items()]
    out.sort(key=lambda a: (a.start, a.end, a.word))
    res = WordLattice(num_frames=T, arcs=out, silence=lat.silence,
                      times=lat.times)
    from .flf import trim_lattice
    return trim_lattice(res)


def fit_lattice(lat: WordLattice, end_time: Optional[int] = None,
                ) -> WordLattice:
    """`fit` (Flf/Fit.cc): fit the lattice into segment boundaries —
    single initial node at time 0 and single final node at the segment
    end; dangling sub-paths trimmed; a zero-cost ε-arc bridges the last
    lattice node to the segment end if the segment is longer."""
    from .flf import trim_lattice
    if not lat.arcs:
        return lat
    # forward-reachable arcs only (dangling heads die in the trim)
    fwd_ok = {0}
    arcs = []
    for a in sorted(lat.arcs, key=lambda a: a.end):
        if a.start in fwd_ok:
            fwd_ok.add(a.end)
            arcs.append(a)
    if not arcs:
        return WordLattice(num_frames=lat.num_frames, arcs=[],
                           silence=lat.silence, times=lat.times)
    max_end = max(a.end for a in arcs)
    T = max(lat.num_frames, max_end) if end_time is None else end_time
    times = dict(lat.times) if lat.times is not None else None
    if max_end < T:
        # bridge the last reachable node to the segment end (ε, free)
        arcs.append(Arc(start=max_end, end=T, word=EPS, score=0.0))
        if times is not None:
            times[T] = T
    return trim_lattice(WordLattice(num_frames=T, arcs=arcs,
                                    silence=lat.silence, times=times))
