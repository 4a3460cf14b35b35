"""The Sprint (rwth-asr-0.5) tier's host modules: the hierarchical config,
Bliss XML corpora and lexica, Sprint file archives and Flow feature caches
and networks, CART state tying and its training, LDA front-end transforms,
the per-state-type transition model and the allophone-state model and
graphs, the Mm mixture-set text format, model combination, the channel
harness and the core utilities. Numpy on the host; the per-frame work of
the paths they feed (alignment, training, search) runs in the port's
device modules."""

from .am import StateTypeTdp, TransitionModel  # noqa: F401
from .config import SprintConfig  # noqa: F401
from .archive import FileArchive  # noqa: F401
from .flow_cache import FeatureCache  # noqa: F401
from .bliss import BlissLexicon, BlissCorpus  # noqa: F401
from .cart import DecisionTree  # noqa: F401
from .lda import read_matrix_xml, SlidingWindowLDA  # noqa: F401
from .mc import ModelCombination, ScaledComponent  # noqa: F401
