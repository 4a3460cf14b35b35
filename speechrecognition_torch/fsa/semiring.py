"""Semirings for weighted automata (reference: Fsa/Semiring.hh,
Fsa/tSemiring.hh — tropical and log semirings are the two the toolkit
instantiates for ASR lattices).

Port: a copy of speechrecognition_tpu/fsa/semiring.py (host code).
"""

from __future__ import annotations

import numpy as np


class Semiring:
    """Abstract (⊕, ⊗, 0̄, 1̄). Weights are plain floats (−log scores)."""

    zero: float
    one: float = 0.0

    @staticmethod
    def plus(a: float, b: float) -> float:
        raise NotImplementedError

    @staticmethod
    def times(a: float, b: float) -> float:
        return a + b

    @classmethod
    def sum(cls, weights) -> float:
        acc = cls.zero
        for w in weights:
            acc = cls.plus(acc, w)
        return acc


class TropicalSemiring(Semiring):
    """min/+ — Viterbi scores (Fsa::TropicalSemiring)."""

    zero = float("inf")

    @staticmethod
    def plus(a: float, b: float) -> float:
        return a if a <= b else b


class LogSemiring(Semiring):
    """−logsumexp/+ — posterior sums (Fsa::LogSemiring)."""

    zero = float("inf")

    @staticmethod
    def plus(a: float, b: float) -> float:
        if a == float("inf"):
            return b
        if b == float("inf"):
            return a
        m = min(a, b)
        return m - np.log1p(np.exp(m - max(a, b)))


class ProbabilitySemiring(Semiring):
    """+/× over real probabilities (Fsa/RealSemiring.hh
    ProbabilitySemiring, Semiring.cc:94-99): ⊕ = sum, ⊗ = product,
    0̄ = 0, 1̄ = 1. Weights here are PROBABILITIES, not −log scores."""

    zero = 0.0
    one = 1.0

    @staticmethod
    def plus(a: float, b: float) -> float:
        return a + b

    @staticmethod
    def times(a: float, b: float) -> float:
        return a * b


class CountSemiring(Semiring):
    """Integer counting semiring (Fsa/Semiring.cc:101-156 CountSemiring_):
    ⊕ = saturating integer add, ⊗ = saturating integer multiply,
    0̄ = 0, 1̄ = 1, ∞ = INT32_MAX. Counts paths/derivations."""

    INF = 2 ** 31 - 1
    zero = 0
    one = 1

    @classmethod
    def plus(cls, a, b):
        a, b = int(a), int(b)
        if a == cls.INF or b == cls.INF or cls.INF - a < b:
            return cls.INF
        return a + b

    @classmethod
    def times(cls, a, b):
        a, b = int(a), int(b)
        if a == cls.INF or b == cls.INF:
            return cls.INF
        if a and b and cls.INF // max(a, b) < min(a, b):
            return cls.INF
        return a * b


class TropicalIntegerSemiring(TropicalSemiring):
    """min/+ over 32-bit integers (Semiring.cc:86-92); weights are
    rounded to int on ⊗ and compared exactly."""

    zero = 2 ** 31 - 1

    @staticmethod
    def times(a, b):
        s = int(a) + int(b)
        hi = 2 ** 31 - 1
        return hi if s >= hi else s


class LogIntegerSemiring(LogSemiring):
    """Log semiring with integer-scaled weights (Semiring.cc:47-84):
    ⊗ adds the integer scores; ⊕ collects via the float log-add on the
    scaled values, rounded back to int."""

    zero = 2 ** 31 - 1

    @staticmethod
    def times(a, b):
        s = int(a) + int(b)
        hi = 2 ** 31 - 1
        return hi if s >= hi else s

    @classmethod
    def plus(cls, a, b):
        if a >= cls.zero:
            return b
        if b >= cls.zero:
            return a
        return int(round(LogSemiring.plus(float(a), float(b))))


SEMIRINGS = {
    "tropical": TropicalSemiring,
    "log": LogSemiring,
    "probability": ProbabilitySemiring,
    "count": CountSemiring,
    "tropical-integer": TropicalIntegerSemiring,
    "log-integer": LogIntegerSemiring,
}


def get_semiring(name: str) -> type:
    """Semiring registry by name (Fsa/Semiring.cc getSemiring +
    SemiringTypeChoice)."""
    try:
        return SEMIRINGS[name]
    except KeyError:
        raise ValueError(f"unknown semiring {name!r} "
                         f"(have {sorted(SEMIRINGS)})")


TROPICAL = TropicalSemiring
LOG = LogSemiring
