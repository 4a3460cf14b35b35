"""Flf non-word-closure filter family.

Counterpart of the reference's Flf/NonWordFilter.cc
(NodeRegistration.hh entries `non-word-closure-filter`,
`non-word-closure-weak-determinization-filter`,
`non-word-closure-strong-determinization-filter`,
`non-word-closure-normalization-filter`,
`non-word-closure-removal-filter`).

The reference's definitions (its own help text): Pathes_w(s,e) is the
set of paths from s to e with exactly one arc labeled w and all others
non-word; the filters keep, per (w, s, e), only the best-scoring such
paths at three granularities:

  * filter: one best path per ARC a ∈ Arcs_w(s,e) — every word arc
    survives, but its surrounding non-word chains are pruned to the
    best ones (classical ε-removal over the tropical semiring).
  * weak determinization: one best path per SOURCE STATE of the w-arc.
  * strong determinization: one best path per (w, s, e) overall.

In this framework non-words are the lattice's silence label (plus any
extra labels passed in `nonwords`); lattices are DAGs over integer
nodes, so the non-word closures are computed by a single DAG dynamic
program over the non-word subgraph.

All three subset filters return a SUBGRAPH of the input containing the
Viterbi path (asserted in tests); normalization/removal restructure the
graph per the reference's help-text semantics.

Port: a copy of speechrecognition_tpu/search/flf_closure.py (host code).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from .flf import trim_lattice
from .lattice import Arc, WordLattice

INF = float("inf")


def _nonword_set(lat: WordLattice,
                 nonwords: Optional[Sequence[int]] = None) -> Set[int]:
    s = {lat.silence, -1}
    if nonwords:
        s |= set(nonwords)
    return s


def _closure_tables(lat: WordLattice, nw: Set[int]):
    """Best non-word-chain DP over the non-word subgraph.

    Returns (cost, back) where cost[(s, e)] = best −log score of a
    non-word-only path s→e (s=e cost 0 implicit, not stored) and
    back[(s, e)] = last arc on that best path.
    """
    nw_arcs = [a for a in lat.arcs if a.word in nw]
    cost: Dict[Tuple[int, int], float] = {}
    back: Dict[Tuple[int, int], Arc] = {}
    # process arcs in end order; chains extend earlier chains
    for a in sorted(nw_arcs, key=lambda a: (a.end, a.start)):
        # chain starting exactly at a.start
        if a.score < cost.get((a.start, a.end), INF):
            cost[(a.start, a.end)] = a.score
            back[(a.start, a.end)] = a
        # extend every chain ending at a.start
        for (s, e), c in list(cost.items()):
            if e == a.start:
                nc = c + a.score
                if nc < cost.get((s, a.end), INF):
                    cost[(s, a.end)] = nc
                    back[(s, a.end)] = a
    return cost, back


def _chain_arcs(back: Dict[Tuple[int, int], Arc], s: int, e: int,
                ) -> List[Arc]:
    """Reconstruct the best non-word chain s→e from the back table."""
    arcs: List[Arc] = []
    cur = e
    while cur != s:
        a = back[(s, cur)]
        arcs.append(a)
        cur = a.start
    return arcs


def nonword_closure_filter(lat: WordLattice,
                           nonwords: Optional[Sequence[int]] = None,
                           level: str = "arc") -> WordLattice:
    """The three subset filters (level = 'arc' | 'weak' | 'strong').

    Keeps every word arc that wins its group's best-path competition:
      arc:    groups are single arcs — all word arcs kept; only the
              surrounding non-word chains are reduced to the best ones.
      weak:   group (w, source-state, e): per closure sink e, word arcs
              sharing label and source keep only the best.
      strong: group (w, s, e): of all w-arcs connectable from s to e by
              non-word chains, only the overall best path survives.
    """
    nw = _nonword_set(lat, nonwords)
    cost, back = _closure_tables(lat, nw)
    word_arcs = [a for a in lat.arcs if a.word not in nw]

    def chains_into(node: int) -> List[Tuple[int, float]]:
        """(source s, cost) pairs of best non-word chains ending at node,
        plus the trivial (node, 0)."""
        out = [(node, 0.0)]
        for (s, e), c in cost.items():
            if e == node:
                out.append((s, c))
        return out

    def chains_from(node: int) -> List[Tuple[int, float]]:
        out = [(node, 0.0)]
        for (s, e), c in cost.items():
            if s == node:
                out.append((e, c))
        return out

    kept_arcs: Set[Arc] = set()
    kept_chain_pairs: Set[Tuple[int, int]] = set()

    if level == "arc":
        for a in word_arcs:
            kept_arcs.add(a)
            # best chain into a.start and out of a.end for every (s, e)
            for s, _c in chains_into(a.start):
                if s != a.start:
                    kept_chain_pairs.add((s, a.start))
            for e, _c in chains_from(a.end):
                if e != a.end:
                    kept_chain_pairs.add((a.end, e))
    else:
        # competition[(group key)] -> (best path cost, arc, (s,e) chains)
        best: Dict[Tuple, Tuple[float, Arc, Tuple[int, int]]] = {}
        for a in word_arcs:
            for s, cs in chains_into(a.start):
                for e, ce in chains_from(a.end):
                    total = cs + a.score + ce
                    if level == "weak":
                        # per (w, s, e) AND the w-arc's source state s'
                        key = (a.word, s, a.start, e)
                    else:                       # strong: per (w, s, e)
                        key = (a.word, s, e)
                    cur = best.get(key)
                    if cur is None or total < cur[0]:
                        best[key] = (total, a, (s, e))
        for _total, a, (s, e) in best.values():
            kept_arcs.add(a)
            if s != a.start:
                kept_chain_pairs.add((s, a.start))
            if e != a.end:
                kept_chain_pairs.add((a.end, e))

    # pure non-word full paths (zero word arcs) are not members of any
    # Pathes_w — keep the best one so all-silence readings survive
    full = cost.get((0, lat.num_frames))
    if full is not None:
        kept_chain_pairs.add((0, lat.num_frames))

    for (s, e) in kept_chain_pairs:
        if (s, e) in back:
            kept_arcs.update(_chain_arcs(back, s, e))
    arcs = [a for a in lat.arcs if a in kept_arcs]
    return trim_lattice(WordLattice(num_frames=lat.num_frames, arcs=arcs,
                                    silence=lat.silence, times=lat.times))


def nonword_closure_normalization(lat: WordLattice,
                                  nonwords: Optional[Sequence[int]] = None,
                                  ) -> WordLattice:
    """`non-word-closure-normalization-filter`: states whose EVERY
    outgoing arc is a non-word are discarded; their non-word chains are
    joined into single arcs (best score per (s, e)). Word arcs and their
    times are untouched."""
    nw = _nonword_set(lat, nonwords)
    by_start = lat.by_start()
    by_end = lat.by_end()
    # a state is discarded when it sits INSIDE a non-word closure: it
    # has outgoing arcs, and everything entering/leaving it is non-word
    # (a state fed by a word arc is the closure's attachment point and
    # must survive)
    nw_only = {s for s, arcs in by_start.items()
               if arcs and all(a.word in nw for a in arcs)
               and all(a.word in nw for a in by_end.get(s, []))
               and s != 0 and by_end.get(s)}
    cost, back = _closure_tables(lat, nw)
    arcs: List[Arc] = [a for a in lat.arcs if a.word not in nw]
    # keep non-word arcs whose both endpoints survive; join chains that
    # pass through discarded states
    merged: Dict[Tuple[int, int], float] = {}
    for a in lat.arcs:
        if a.word not in nw:
            continue
        if a.start not in nw_only and a.end not in nw_only:
            key = (a.start, a.end)
            if a.score < merged.get(key, INF):
                merged[key] = a.score
    for (s, e), c in cost.items():
        if s in nw_only or e in nw_only:
            continue
        chain = _chain_arcs(back, s, e)
        if len(chain) > 1 and all(x.start in nw_only or x.start == s
                                  for x in chain):
            if c < merged.get((s, e), INF):
                merged[(s, e)] = c
    sil = lat.silence
    for (s, e), c in merged.items():
        arcs.append(Arc(start=s, end=e, word=sil, score=c))
    arcs.sort(key=lambda a: (a.start, a.end, a.word))
    return trim_lattice(WordLattice(num_frames=lat.num_frames, arcs=arcs,
                                    silence=sil, times=lat.times))


def nonword_closure_removal(lat: WordLattice,
                            nonwords: Optional[Sequence[int]] = None,
                            ) -> WordLattice:
    """`non-word-closure-removal-filter`: every word arc leaving a state
    of the non-word closure of s is re-attached to start at s with the
    closure's best score added and the closure's time absorbed; non-word
    arcs disappear. Tail non-word chains into the final node fold into
    the preceding word arc (the arc's end extends to the final node,
    absorbing the crossing time — the help text's 'add the additional
    time needed for crossing the closure')."""
    nw = _nonword_set(lat, nonwords)
    cost, _back = _closure_tables(lat, nw)
    word_arcs = [a for a in lat.arcs if a.word not in nw]
    T = lat.num_frames

    out: Dict[Tuple[int, int, int], float] = {}

    def add(s: int, e: int, w: int, sc: float) -> None:
        key = (s, e, w)
        if sc < out.get(key, INF):
            out[key] = sc

    for a in word_arcs:
        add(a.start, a.end, a.word, a.score)
        for (s, e), c in cost.items():
            if e == a.start:
                add(s, a.end, a.word, c + a.score)
    # fold tail closures into the final node
    folded: Dict[Tuple[int, int, int], float] = {}
    for (s, e, w), sc in out.items():
        c = cost.get((e, T))
        if c is not None:
            key = (s, T, w)
            if sc + c < folded.get(key, INF):
                folded[key] = sc + c
    for key, sc in folded.items():
        if sc < out.get(key, INF):
            out[key] = sc
    arcs = [Arc(start=s, end=e, word=w, score=sc)
            for (s, e, w), sc in sorted(out.items())]
    return trim_lattice(WordLattice(num_frames=T, arcs=arcs,
                                    silence=lat.silence, times=lat.times))
