"""Language models: the ARPA back-off reader (a copy of the JAX package's
numpy module)."""

from .arpa import ArpaLM  # noqa: F401
