"""Language models: the count LM (``ngram``: ``Vocabulary``, ``CountLM``),
the ARPA back-off reader, the zerogram, FSA-grammar and class LMs
(``variants``) — copies of the JAX package's numpy modules — and the
character-level RNN LM (``char_rnn``)."""

from .ngram import Vocabulary, CountLM  # noqa: F401
from .arpa import ArpaLM  # noqa: F401
from .variants import ClassLM, ClassMapping, FsaLM, Zerogram  # noqa: F401
