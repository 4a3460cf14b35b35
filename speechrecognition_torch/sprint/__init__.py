"""The Sprint (rwth-asr-0.5) tier's host modules that the LVCSR 1-best
decode needs: the hierarchical config and the per-state-type transition
model. The Bliss, CART, Flow and archive readers are not ported yet."""

from .am import StateTypeTdp, TransitionModel  # noqa: F401
from .config import SprintConfig  # noqa: F401
