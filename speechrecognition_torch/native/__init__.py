"""Native (C++) runtime components, exposed via ctypes.

The shared library is built with g++ at first use into ``build/native/`` at
the repository root. A build or load failure raises; the pure-Python path
is taken only when the caller asks for it.
"""

from .loader import load_corpus_native  # noqa: F401
