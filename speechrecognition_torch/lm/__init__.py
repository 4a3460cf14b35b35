"""Language models: the ARPA back-off reader (a copy of the JAX package's
numpy module) and the character-level RNN LM (``char_rnn``)."""

from .arpa import ArpaLM  # noqa: F401
