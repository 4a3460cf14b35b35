"""ctypes wrapper for the native corpus loader (corpus_loader.cpp).

At first use the source is compiled by ``g++`` into
``build/native/libcorpus_loader_<hash>.so`` at the repository root; the name
carries a hash of the source and flags, so an edited source is rebuilt and a
stale library is never loaded. A missing compiler, a failed build and a file
the loader cannot read all raise RuntimeError: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "corpus_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
#: loaded libraries by path
_libs: dict = {}


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libcorpus_loader_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("native corpus loader: g++ not found") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native corpus loader: g++ failed on {SRC.name} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half a file


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; idempotent."""
    with _lock:
        path = library_path()
        if path not in _libs:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.load_corpus.restype = ctypes.c_int
            lib.load_corpus.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ]
            _libs[path] = lib
        return _libs[path]


def load_corpus_native(paths: List[str], mean: Optional[np.ndarray],
                       stddev: Optional[np.ndarray], n_in: int, n_first: int,
                       n_second: int, deriv_step: int, energy_max_norm: bool,
                       num_threads: int = 0,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel load of .mm2 files → (features [total_frames, n_total] f32,
    offsets int64 [n+1]). Raises RuntimeError if the library cannot be built
    or a file fails."""
    lib = load()
    n_total = n_in + n_first + n_second
    sizes = np.array([os.path.getsize(p) for p in paths], dtype=np.int64)
    frames = sizes // (4 * n_in)
    offsets = np.zeros(len(paths) + 1, dtype=np.int64)
    np.cumsum(frames, out=offsets[1:])
    out = np.empty((int(offsets[-1]), n_total), dtype=np.float32)

    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    apply_norm = mean is not None
    mean_arr = np.ascontiguousarray(mean if apply_norm else np.zeros(n_total),
                                    dtype=np.float64)
    std_arr = np.ascontiguousarray(stddev if apply_norm else np.ones(n_total),
                                   dtype=np.float64)
    if mean_arr.shape != (n_total,) or std_arr.shape != (n_total,):
        raise ValueError(f"normalization has {mean_arr.shape}/{std_arr.shape} "
                         f"values, the features {n_total}")
    rc = lib.load_corpus(
        c_paths, len(paths),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mean_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        std_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(apply_norm), int(energy_max_norm),
        n_in, n_first, n_second, deriv_step,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if rc != 0:
        raise RuntimeError(f"native loader failed on file {paths[rc - 1]}")
    return out, offsets
