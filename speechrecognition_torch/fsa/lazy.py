"""On-demand (lazy) weighted automata — the reference's core Fsa design.

rwth-asr's ``Fsa::Automaton`` (Fsa/Automaton.hh) materializes states only
when visited: ``getState(id)`` builds one state's arcs, and operations
(compose, determinize) are thin state-mapping layers, so LVCSR-scale
grammar composition never instantiates the full product space. The eager
ops in fsa/ops.py are fine at lexicon scale but carry explicit
``max_states`` guards; this module is the scalable counterpart:

  * ``LazyAutomaton`` — states are hashable keys; ``arcs(key)`` yields
    (dst_key, ilabel, olabel, weight); memoized per state;
  * ``LazyStatic`` — wrap an eager Automaton;
  * ``lazy_compose`` — epsilon-free acceptor/transducer product, states
    materialized on demand;
  * ``lazy_determinize`` — subset construction on demand (the classic
    case where lazy evaluation beats eager: only subsets the search
    visits exist);
  * ``best_path_lazy`` — uniform-cost (Dijkstra) search over a lazy
    automaton with non-negative weights: expands only the states the
    best path's frontier needs;
  * ``materialize`` — flatten reachable lazy states into an eager
    Automaton (bounded).

Port: a copy of speechrecognition_tpu/fsa/lazy.py (host code).
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Tuple

import numpy as np

from .automaton import EPS, Automaton
from .semiring import TropicalSemiring

INF = float("inf")
ArcT = Tuple[Hashable, int, int, float]  # (dst_key, ilabel, olabel, weight)


class LazyAutomaton:
    """Base: subclasses define ``initial``, ``expand(key)`` and
    ``final_weight(key)``; arc lists are memoized per state key."""

    semiring = TropicalSemiring

    def __init__(self):
        self._cache: Dict[Hashable, List[ArcT]] = {}

    @property
    def initial(self) -> Hashable:
        raise NotImplementedError

    def expand(self, key: Hashable) -> Iterable[ArcT]:
        raise NotImplementedError

    def final_weight(self, key: Hashable) -> float:
        raise NotImplementedError

    def arcs(self, key: Hashable) -> List[ArcT]:
        got = self._cache.get(key)
        if got is None:
            got = list(self.expand(key))
            self._cache[key] = got
        return got

    @property
    def num_materialized(self) -> int:
        return len(self._cache)


class LazyStatic(LazyAutomaton):
    """Lazy view of an eager Automaton (state keys = state ids)."""

    def __init__(self, a: Automaton):
        super().__init__()
        self.a = a
        self._out = a.out_index()

    @property
    def initial(self):
        return self.a.initial

    def expand(self, key):
        a = self.a
        for i in self._out[int(key)]:
            yield (int(a.dst[i]), int(a.ilabel[i]), int(a.olabel[i]),
                   float(a.weight[i]))

    def final_weight(self, key):
        return float(self.a.final[int(key)])


class lazy_compose(LazyAutomaton):
    """Product automaton a∘b on demand (Fsa/Compose.cc semantics for
    epsilon-free inputs: match a's output labels against b's input
    labels)."""

    def __init__(self, a: LazyAutomaton, b: LazyAutomaton):
        super().__init__()
        self.a, self.b = a, b

    @property
    def initial(self):
        return (self.a.initial, self.b.initial)

    def expand(self, key):
        pa, pb = key
        by_label: Dict[int, List[ArcT]] = {}
        for arc in self.b.arcs(pb):
            by_label.setdefault(arc[1], []).append(arc)
        for (da, il, ol, wa) in self.a.arcs(pa):
            for (db, _il2, ol2, wb) in by_label.get(ol, ()):
                yield ((da, db), il, ol2, wa + wb)

    def final_weight(self, key):
        pa, pb = key
        return self.a.final_weight(pa) + self.b.final_weight(pb)


class lazy_determinize(LazyAutomaton):
    """Weighted subset construction on demand (acceptors, eps-free).
    State keys are canonical (frozen residual subsets, offset)."""

    def __init__(self, a: LazyAutomaton):
        super().__init__()
        self.a = a

    @staticmethod
    def _canon(subset):
        m = min(r for _s, r in subset)
        return tuple(sorted((s, round(r - m, 12)) for s, r in subset))

    @property
    def initial(self):
        return self._canon([(self.a.initial, 0.0)])

    def expand(self, key):
        by_label: Dict[int, Dict[Hashable, float]] = {}
        for q, r in key:
            for (d, il, _ol, w) in self.a.arcs(q):
                dd = by_label.setdefault(il, {})
                cand = r + w
                if cand < dd.get(d, INF):
                    dd[d] = cand
        for il in sorted(by_label):
            items = list(by_label[il].items())
            m = min(r for _s, r in items)
            yield (self._canon(items), il, il, m)

    def final_weight(self, key):
        best = INF
        for q, r in key:
            f = self.a.final_weight(q)
            if np.isfinite(f):
                best = min(best, r + f)
        return best


def best_path_lazy(a: LazyAutomaton, max_expansions: int = 1_000_000,
                   ) -> Tuple[List[int], float]:
    """Uniform-cost search (weights must be ≥ 0, e.g. pushed/−log-prob
    automata): returns (input label sequence sans EPS, best score).
    Expands only the frontier the optimal path needs — the payoff of the
    lazy representation."""
    counter = 0
    start = a.initial
    heap: List[Tuple[float, int, Hashable]] = [(0.0, counter, start)]
    dist: Dict[Hashable, float] = {start: 0.0}
    parent: Dict[Hashable, Tuple[Hashable, int]] = {}
    closed = set()
    best_final: Optional[Hashable] = None
    best_score = INF
    expansions = 0
    while heap:
        d, _c, key = heapq.heappop(heap)
        if key in closed or d > dist.get(key, INF):
            continue
        closed.add(key)
        f = a.final_weight(key)
        if np.isfinite(f) and d + f < best_score:
            best_score = d + f
            best_final = key
        if best_final is not None and d >= best_score:
            break
        expansions += 1
        if expansions > max_expansions:
            raise RuntimeError(
                f"best_path_lazy exceeded {max_expansions} expansions")
        for (dst, il, _ol, w) in a.arcs(key):
            if w < -1e-9:
                raise ValueError("best_path_lazy requires weights >= 0")
            nd = d + w
            if nd < dist.get(dst, INF):
                dist[dst] = nd
                counter += 1
                parent[dst] = (key, il)
                heapq.heappush(heap, (nd, counter, dst))
    if best_final is None:
        return [], INF
    labels: List[int] = []
    key = best_final
    while key in parent:
        key, il = parent[key]
        if il != EPS:
            labels.append(il)
    labels.reverse()
    return labels, best_score


def materialize(a: LazyAutomaton, max_states: int = 100_000) -> Automaton:
    """Flatten every reachable lazy state into an eager Automaton."""
    ids: Dict[Hashable, int] = {a.initial: 0}
    order: List[Hashable] = [a.initial]
    arcs: List[Tuple[int, int, int, int, float]] = []
    final: Dict[int, float] = {}
    stack = [a.initial]
    while stack:
        key = stack.pop()
        s = ids[key]
        f = a.final_weight(key)
        if np.isfinite(f):
            final[s] = f
        for (dst, il, ol, w) in a.arcs(key):
            if dst not in ids:
                if len(ids) >= max_states:
                    raise RuntimeError(
                        f"materialize exceeded {max_states} states")
                ids[dst] = len(ids)
                order.append(dst)
                stack.append(dst)
            arcs.append((s, ids[dst], il, ol, w))
    return Automaton.build(len(ids), arcs, final, 0, a.semiring)
