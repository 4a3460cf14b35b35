"""The Sprint (rwth-asr-0.5) tier's host modules that the port's paths
need: the hierarchical config, the per-state-type transition model (the
LVCSR 1-best decode) and the Bliss corpus and lexicon readers (the Flf
network's nodes). The CART, Flow and archive readers are not ported yet."""

from .am import StateTypeTdp, TransitionModel  # noqa: F401
from .bliss import BlissCorpus, BlissLexicon  # noqa: F401
from .config import SprintConfig  # noqa: F401
