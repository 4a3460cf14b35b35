"""Time-distortion penalties (loop/forward/skip), −log scale.

Reference semantics (src/sietill/TdpModel.cpp:19-29): a transition *into*
the silence state is always charged the forward penalty, regardless of the
jump; other states pay loop/forward/skip by jump distance.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .config import Configuration, ParameterFloat


@dataclass(frozen=True)
class TdpModel:
    silence_state: int
    loop: float = 0.0
    forward: float = 0.0
    skip: float = 0.0

    @staticmethod
    def from_config(config: Configuration, silence_state: int) -> "TdpModel":
        return TdpModel(
            silence_state=silence_state,
            loop=ParameterFloat("tdp-loop", 0.0)(config),
            forward=ParameterFloat("tdp-forward", 0.0)(config),
            skip=ParameterFloat("tdp-skip", 0.0)(config),
        )

    def score(self, to_state: int, jump: int) -> float:
        if to_state == self.silence_state:
            return self.forward
        return (self.loop, self.forward, self.skip)[jump]

    def table_for_states(self, states: np.ndarray) -> np.ndarray:
        """f64 [..., 3]: penalty per jump for transitions into each state."""
        base = np.array([self.loop, self.forward, self.skip])
        out = np.broadcast_to(base, states.shape + (3,)).copy()
        out[states == self.silence_state] = self.forward
        return out
