"""speechrecognition_torch — the PyTorch / CUDA port of speechrecognition_tpu.

The JAX package beside it is the reference: each module here mirrors its
path and public names. Host-side bookkeeping stays in float64 numpy as in
the reference; device code takes an explicit ``device`` and dtype (there is
no global precision switch). The hot loops of the recognition path are
hand-written CUDA kernels under ``csrc/``, built at first use by
``ops/_native.py``; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"

from . import config as config  # noqa: E402,F401
from . import lexicon as lexicon  # noqa: E402,F401
