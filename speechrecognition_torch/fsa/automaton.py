"""Static automaton storage (reference: Fsa/Static.hh StaticAutomaton,
Fsa/Automaton.hh arc/state model, Fsa/Input.cc/Output.cc binary format).

States are 0..num_states−1; arcs are parallel numpy arrays; label EPS=−1
plays the role of Fsa::Epsilon. Transducers carry input and output
labels (acceptors keep them equal).

Port: a copy of speechrecognition_tpu/fsa/automaton.py (host code).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .semiring import Semiring, TropicalSemiring

EPS = -1


@dataclass
class Automaton:
    num_states: int
    src: np.ndarray        # int32 [A]
    dst: np.ndarray        # int32 [A]
    ilabel: np.ndarray     # int32 [A] (EPS = −1)
    olabel: np.ndarray     # int32 [A]
    weight: np.ndarray     # f64 [A]
    final: np.ndarray      # f64 [num_states] final weight (inf = non-final)
    initial: int = 0
    semiring: type = TropicalSemiring

    @staticmethod
    def build(num_states: int, arcs: Sequence[Tuple], final, initial: int = 0,
              semiring: type = TropicalSemiring) -> "Automaton":
        """arcs: iterable of (src, dst, ilabel[, olabel], weight); final:
        dict {state: weight} or array."""
        src, dst, il, ol, wt = [], [], [], [], []
        for a in arcs:
            if len(a) == 4:
                s, d, l, w = a
                o = l
            else:
                s, d, l, o, w = a
            src.append(s); dst.append(d); il.append(l); ol.append(o); wt.append(w)
        fin = np.full(num_states, np.inf)
        if isinstance(final, dict):
            for s, w in final.items():
                fin[s] = w
        else:
            fin = np.asarray(final, np.float64)
        return Automaton(num_states=num_states,
                         src=np.asarray(src, np.int32),
                         dst=np.asarray(dst, np.int32),
                         ilabel=np.asarray(il, np.int32),
                         olabel=np.asarray(ol, np.int32),
                         weight=np.asarray(wt, np.float64),
                         final=fin, initial=initial, semiring=semiring)

    @property
    def num_arcs(self) -> int:
        return len(self.src)

    def is_acceptor(self) -> bool:
        return bool(np.all(self.ilabel == self.olabel))

    def arcs_from(self, state: int) -> np.ndarray:
        return np.nonzero(self.src == state)[0]

    def out_index(self) -> List[List[int]]:
        idx: List[List[int]] = [[] for _ in range(self.num_states)]
        for i in range(self.num_arcs):
            idx[int(self.src[i])].append(i)
        return idx

    def final_states(self) -> np.ndarray:
        return np.nonzero(np.isfinite(self.final))[0]

    def accepts(self, labels: Sequence[int]) -> float:
        """Weight of the best path accepting `labels` (ilabels, EPS-free
        machines only) — brute-force DP, used in tests."""
        big = np.inf
        d = np.full(self.num_states, big)
        d[self.initial] = 0.0
        for lab in labels:
            nd = np.full(self.num_states, big)
            for i in range(self.num_arcs):
                if self.ilabel[i] == lab:
                    c = d[self.src[i]] + self.weight[i]
                    if c < nd[self.dst[i]]:
                        nd[self.dst[i]] = c
            d = nd
        return float((d + self.final).min())


def linear_acceptor(labels: Sequence[int], weights: Optional[Sequence[float]] = None,
                    final_weight: float = 0.0) -> Automaton:
    n = len(labels)
    w = weights if weights is not None else [0.0] * n
    arcs = [(i, i + 1, int(labels[i]), float(w[i])) for i in range(n)]
    return Automaton.build(n + 1, arcs, {n: final_weight})


_MAGIC = b"TPUFSA1\0"


def write_fsa(path: str, a: Automaton) -> None:
    """Binary automaton archive (counterpart of Fsa/Output.cc storeBinary)."""
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<qqq", a.num_states, a.num_arcs, a.initial))
        for arr, dt in ((a.src, np.int32), (a.dst, np.int32),
                        (a.ilabel, np.int32), (a.olabel, np.int32),
                        (a.weight, np.float64)):
            f.write(np.ascontiguousarray(arr, dt).tobytes())
        f.write(np.ascontiguousarray(a.final, np.float64).tobytes())


def read_fsa(path: str) -> Automaton:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"bad fsa magic in {path}")
        num_states, num_arcs, initial = struct.unpack("<qqq", f.read(24))
        def arr(dt, n):
            return np.frombuffer(f.read(np.dtype(dt).itemsize * n), dt).copy()
        src = arr(np.int32, num_arcs)
        dst = arr(np.int32, num_arcs)
        il = arr(np.int32, num_arcs)
        ol = arr(np.int32, num_arcs)
        wt = arr(np.float64, num_arcs)
        fin = arr(np.float64, num_states)
    return Automaton(num_states=num_states, src=src, dst=dst, ilabel=il,
                     olabel=ol, weight=wt, final=fin, initial=int(initial))
