"""Hierarchical Sprint-style configuration with wildcard selectors.

Parses the ini-like format of rwth-asr configs (Core/Configuration):

    [*.acoustic-model.tdp]
    *.loop        = 3.0
    silence.loop  = 0.0001

    include other.config

A parameter lookup ``get("recognizer.acoustic-model.tdp.silence.loop")``
resolves against all declared selectors; ``*`` matches any number of path
components. The most specific match wins (more literal components beat
wildcards, later definitions beat earlier on equal specificity) —
mirroring the resolution rules exercised by Core/check.config:24-33.
Values support ``$(var)`` references into previously defined parameters
and the special DESCRIPTION-style bare assignments at file top level.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple


def _selector_to_regex(selector: str) -> re.Pattern:
    parts = selector.split(".")
    rx: List[str] = []
    for i, p in enumerate(parts):
        if p == "*":
            rx.append(r"(?:[^.]+\.)*" if i < len(parts) - 1 else r"(?:[^.]+)*")
        else:
            rx.append(re.escape(p) + (r"\." if i < len(parts) - 1 else ""))
    pattern = "^" + "".join(rx) + "$"
    # collapse artifacts of wildcard joining: "*."-segments already include
    # their dot; literal segments append theirs above
    return re.compile(pattern)


class SprintConfig:
    def __init__(self):
        # ordered list of (selector, regex, specificity, value) per parameter
        self._rules: List[Tuple[str, re.Pattern, int, str]] = []
        self._plain: Dict[str, str] = {}

    @staticmethod
    def read(path: str, _depth: int = 0) -> "SprintConfig":
        cfg = SprintConfig()
        cfg._read_into(path, _depth)
        return cfg

    def _read_into(self, path: str, depth: int) -> None:
        if depth > 10:
            raise ValueError("config include depth exceeded")
        section = ""
        base = os.path.dirname(path)
        with open(path) as f:
            for raw in f:
                line = raw.split("#", 1)[0].strip()
                if not line:
                    continue
                if line.startswith("[") and line.endswith("]"):
                    section = line[1:-1].strip()
                    continue
                if line.startswith("include "):
                    inc = line[8:].strip()
                    self._read_into(os.path.join(base, inc), depth + 1)
                    continue
                if "=" not in line:
                    continue
                key, value = line.split("=", 1)
                key = key.strip()
                value = value.strip()
                full = f"{section}.{key}" if section else key
                self._add(full, value)

    def _add(self, selector: str, value: str) -> None:
        specificity = sum(1 for p in selector.split(".") if p != "*")
        self._rules.append((selector, _selector_to_regex(selector),
                            specificity, value))
        self._plain[selector] = value

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        best: Optional[Tuple[int, int, str]] = None
        for order, (sel, rx, spec, value) in enumerate(self._rules):
            if rx.match(name):
                cand = (spec, order, value)
                if best is None or cand[:2] >= best[:2]:
                    best = cand
        if best is None:
            return default
        return self._resolve(best[2])

    def _resolve(self, value: str) -> str:
        def sub(m):
            return self.get(m.group(1), m.group(0))
        return re.sub(r"\$\(([^)]+)\)", sub, value)

    def items(self) -> List[Tuple[str, str]]:
        """Every declared (full selector, raw value) in file order —
        used by block-structured consumers (e.g. the Flf network parser)
        that enumerate `[section.<name>] key = value` families."""
        return [(sel, value) for sel, _rx, _spec, value in self._rules]

    # typed helpers -----------------------------------------------------------

    def get_float(self, name: str, default: float = 0.0) -> float:
        v = self.get(name)
        if v is None:
            return default
        if v == "infinity":
            return float("inf")
        return float(v)

    def get_int(self, name: str, default: int = 0) -> int:
        v = self.get(name)
        return default if v is None else int(v)

    def get_bool(self, name: str, default: bool = False) -> bool:
        v = self.get(name)
        if v is None:
            return default
        return v.lower() in ("yes", "true", "1", "on")
