"""Symbol alphabets and automaton archives (Fsa/Alphabet.hh, Fsa/Archive).

The reference attaches string alphabets to automata and stores automata
in archives addressed by name; here an ``Alphabet`` is a bidirectional
symbol table (with the reference's special-symbol conventions) and
``FsaArchive`` stores automata as AT&T-style text files in a directory
with an index — enough to round-trip grammar/lexicon automata between
tools.

Port: a copy of speechrecognition_tpu/fsa/alphabet.py (host code).
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .automaton import EPS, Automaton
from .semiring import LogSemiring, TropicalSemiring


class Alphabet:
    """Bidirectional symbol ↔ id table; id 0.. densely assigned.
    ``*EPS*`` maps to the EPS label (−1), like Fsa's special symbols."""

    EPS_SYMBOL = "*EPS*"

    def __init__(self, symbols: Optional[Iterable[str]] = None):
        self._sym: List[str] = []
        self._idx: Dict[str, int] = {}
        for s in symbols or ():
            self.add(s)

    def add(self, symbol: str) -> int:
        if symbol == self.EPS_SYMBOL:
            return EPS
        got = self._idx.get(symbol)
        if got is None:
            got = len(self._sym)
            self._sym.append(symbol)
            self._idx[symbol] = got
        return got

    def index(self, symbol: str) -> int:
        if symbol == self.EPS_SYMBOL:
            return EPS
        return self._idx[symbol]

    def symbol(self, idx: int) -> str:
        if idx == EPS:
            return self.EPS_SYMBOL
        return self._sym[idx]

    def __len__(self) -> int:
        return len(self._sym)

    def __contains__(self, symbol: str) -> bool:
        return symbol in self._idx

    def symbols(self) -> List[str]:
        return list(self._sym)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for i, s in enumerate(self._sym):
                f.write(f"{s}\t{i}\n")

    @staticmethod
    def load(path: str) -> "Alphabet":
        a = Alphabet()
        with open(path) as f:
            for line in f:
                parts = line.split()
                if parts:
                    a.add(parts[0])
        return a


def write_fsa_text(path: str, a: Automaton,
                   alphabet: Optional[Alphabet] = None) -> None:
    """AT&T-style text format: arc lines "src dst ilabel olabel weight",
    final lines "state weight"; header line carries metadata."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        sr = "log" if a.semiring is LogSemiring else "tropical"
        f.write(f"# fsa num_states={a.num_states} initial={a.initial} "
                f"semiring={sr}\n")
        for i in range(a.num_arcs):
            il = (alphabet.symbol(int(a.ilabel[i])) if alphabet
                  else int(a.ilabel[i]))
            ol = (alphabet.symbol(int(a.olabel[i])) if alphabet
                  else int(a.olabel[i]))
            f.write(f"{int(a.src[i])} {int(a.dst[i])} {il} {ol} "
                    f"{float(a.weight[i]):.9g}\n")
        for s in a.final_states():
            f.write(f"{int(s)} {float(a.final[s]):.9g}\n")


def read_fsa_text(path: str, alphabet: Optional[Alphabet] = None) -> Automaton:
    opener = gzip.open if path.endswith(".gz") else open
    num_states, initial, semiring = 0, 0, TropicalSemiring
    arcs: List[Tuple[int, int, int, int, float]] = []
    final: Dict[int, float] = {}

    def lab(tok: str) -> int:
        if alphabet is not None and not tok.lstrip("-").isdigit():
            return alphabet.index(tok)
        return int(tok)

    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                for tok in line[1:].split():
                    if tok.startswith("num_states="):
                        num_states = int(tok.split("=")[1])
                    elif tok.startswith("initial="):
                        initial = int(tok.split("=")[1])
                    elif tok == "semiring=log":
                        semiring = LogSemiring
                continue
            parts = line.split()
            if len(parts) == 5:
                arcs.append((int(parts[0]), int(parts[1]), lab(parts[2]),
                             lab(parts[3]), float(parts[4])))
            elif len(parts) == 2:
                final[int(parts[0])] = float(parts[1])
    return Automaton.build(num_states, arcs, final, initial, semiring)


class FsaArchive:
    """Directory archive of text automata with an index
    (Fsa/Archive semantics: automata addressed by name)."""

    INDEX = "fsa.index"

    def __init__(self, path: str, alphabet: Optional[Alphabet] = None):
        self.path = path
        self.alphabet = alphabet
        os.makedirs(path, exist_ok=True)
        if alphabet is not None:
            alphabet.save(os.path.join(path, "alphabet.txt"))

    @staticmethod
    def open(path: str) -> "FsaArchive":
        alpha_path = os.path.join(path, "alphabet.txt")
        alpha = Alphabet.load(alpha_path) if os.path.exists(alpha_path) \
            else None
        return FsaArchive(path, alpha)

    def _file(self, name: str) -> str:
        return os.path.join(self.path, name.replace("/", "_") + ".fsa.gz")

    def write(self, name: str, a: Automaton) -> None:
        write_fsa_text(self._file(name), a, self.alphabet)
        with open(os.path.join(self.path, self.INDEX), "a") as f:
            f.write(name + "\n")

    def read(self, name: str) -> Automaton:
        return read_fsa_text(self._file(name), self.alphabet)

    def list(self) -> List[str]:
        idx = os.path.join(self.path, self.INDEX)
        if not os.path.exists(idx):
            return []
        with open(idx) as f:
            return [l.strip() for l in f if l.strip()]
