"""Weighted finite-state automata mini-library.

Counterpart of the reference's Fsa module
(rwth-asr-0.5/src/Fsa/: Automaton.hh, Compose.cc, Determinize.cc,
Minimize.cc, RemoveEpsilons.cc, Best.cc, Prune.cc, Draw.cc, Static.cc,
Semiring.hh).  The reference builds lazy on-demand automata in C++; this
framework keeps automata as dense numpy arc tables — graph construction
and surgery are host-side runtime work (like the reference's), while all
per-frame score math stays in the device decoders/lattice kernels.

Port: a copy of speechrecognition_tpu/fsa/__init__.py (host code).
"""

from .semiring import LogSemiring, Semiring, TropicalSemiring
from .automaton import EPS, Automaton, linear_acceptor, read_fsa, write_fsa
from .ops import (best_path, closure, compose, concat, connect, determinize,
                  draw, invert, is_deterministic, minimize, n_best, project,
                  prune, remove_epsilons, reverse, shortest_distance, union)

__all__ = [
    "EPS", "Automaton", "LogSemiring", "Semiring", "TropicalSemiring",
    "best_path", "closure", "compose", "concat", "connect", "determinize",
    "draw", "invert", "is_deterministic", "linear_acceptor", "minimize",
    "n_best", "project", "prune", "read_fsa", "remove_epsilons", "reverse",
    "shortest_distance", "union", "write_fsa",
]
