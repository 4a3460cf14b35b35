"""Word-level edit distance with S/I/D bookkeeping.

A faithful port of the reference DP (src/sietill/Recognizer.cpp:332-389)
including its candidate preference order (match, substitution, vertical
"insertion", horizontal "deletion") *and* its array-swap initialization
quirk, where the first column of row h inherits row h−2's accumulator
(Recognizer.cpp:346-351) — required for count-level parity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence


@dataclass
class EDAccumulator:
    total_count: int = 0
    substitute_count: int = 0
    insert_count: int = 0
    delete_count: int = 0

    def copy(self) -> "EDAccumulator":
        return EDAccumulator(self.total_count, self.substitute_count,
                             self.insert_count, self.delete_count)

    def substitution_error(self) -> None:
        self.total_count += 1
        self.substitute_count += 1

    def insertion_error(self) -> None:
        self.total_count += 1
        self.insert_count += 1

    def deletion_error(self) -> None:
        self.total_count += 1
        self.delete_count += 1

    def __iadd__(self, other: "EDAccumulator") -> "EDAccumulator":
        self.total_count += other.total_count
        self.substitute_count += other.substitute_count
        self.insert_count += other.insert_count
        self.delete_count += other.delete_count
        return self


def edit_distance(ref: Sequence[int], hyp: Sequence[int]) -> EDAccumulator:
    ref_size, hyp_size = len(ref), len(hyp)

    current: List[EDAccumulator] = [EDAccumulator() for _ in range(ref_size + 1)]
    for i in range(1, ref_size + 1):
        current[i] = current[i - 1].copy()
        current[i].deletion_error()
    previous: List[EDAccumulator] = [EDAccumulator() for _ in range(ref_size + 1)]

    for h in range(1, hyp_size + 1):
        current, previous = previous, current  # the reference's swap
        current[0].insertion_error()
        for r in range(1, ref_size + 1):
            best = 0xFFFF
            if previous[r - 1].total_count < best and ref[r - 1] == hyp[h - 1]:
                current[r] = previous[r - 1].copy()
                best = current[r].total_count
            if previous[r - 1].total_count + 1 < best:
                current[r] = previous[r - 1].copy()
                current[r].substitution_error()
                best = current[r].total_count
            if previous[r].total_count + 1 < best:
                current[r] = previous[r].copy()
                current[r].insertion_error()
                best = current[r].total_count
            if current[r - 1].total_count + 1 < best:
                current[r] = current[r - 1].copy()
                current[r].deletion_error()
                best = current[r].total_count
    return current[ref_size].copy()
