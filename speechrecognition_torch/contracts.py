"""Runtime contract checks — the reference's assertion macro system.

Sprint instruments hot code with `require` / `verify` / `ensure` /
`defect` (Core/Assertions.hh) as its de-facto sanitizer (SURVEY §4.2);
sietill uses `assert` + ad-hoc `test(cond, msg)` aborts (Mixtures.cpp:
97-102). The TPU-native counterparts:

  require(cond, msg)  — precondition on caller-supplied data; ALWAYS
                        checked (bad input must not reach a jitted
                        program as silent corruption).
  verify(cond, msg)   — internal consistency; checked unless
                        SPEECH_TPU_CHECKS=0 (the release-build switch).
  ensure(cond, msg)   — postcondition; same gate as verify.
  defect(msg)         — unreachable code reached.

All raise ContractError (a ValueError: call sites that previously
raised ValueError keep their exception contract). Checks run on the
HOST against static shapes/metadata — nothing here touches device
values, so the compiled programs are unaffected.
"""

from __future__ import annotations

import os


class ContractError(ValueError):
    """A require/verify/ensure contract was violated."""


def _enabled() -> bool:
    return os.environ.get("SPEECH_TPU_CHECKS", "1") != "0"


def require(condition: bool, message: str = "precondition violated") -> None:
    """Precondition (always on, like the reference's `require`)."""
    if not condition:
        raise ContractError(f"require failed: {message}")


def verify(condition: bool, message: str = "invariant violated") -> None:
    """Internal invariant (disable with SPEECH_TPU_CHECKS=0)."""
    if _enabled() and not condition:
        raise ContractError(f"verify failed: {message}")


def ensure(condition: bool, message: str = "postcondition violated") -> None:
    """Postcondition (disable with SPEECH_TPU_CHECKS=0)."""
    if _enabled() and not condition:
        raise ContractError(f"ensure failed: {message}")


def defect(message: str = "unreachable code reached") -> None:
    """The reference's `defect()`: a branch that must never execute."""
    raise ContractError(f"defect: {message}")
