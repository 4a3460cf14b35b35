"""Binary IO: audio, feature, normalization, alignment and mixture-set files.

All formats are bit-compatible with the reference so models/alignments can
be exchanged in both directions for cross-validation:

  * ``.sph``/``.wav`` 16-bit PCM audio  (reference: IO.cpp:13-44)
  * ``.mm2`` raw float32 feature files  (reference: IO.cpp:48-68)
  * normalization stats, 2×dim float64  (reference: SignalAnalysis.cpp:364-375)
  * alignment dumps                      (reference: Alignment.cpp:303-317)
  * "MIXSET" v2 mixture sets             (reference: Mixtures.cpp:748-878)
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, List, Tuple

import numpy as np

MIX_MAGIC = b"MIXSET\x00\x00"
MIX_VERSION = 2

# -- audio / features --------------------------------------------------------


def read_audio_file(path: str) -> np.ndarray:
    """16-bit PCM samples. RIFF files skip a 44-byte header, anything else is
    treated as .sph with a 1024-byte header (reference: IO.cpp:13-44)."""
    with open(path, "rb") as f:
        head = f.read(4)
        offset = 44 if head == b"RIFF" else 1024
        f.seek(offset, os.SEEK_SET)
        data = f.read()
    n = len(data) // 2
    return np.frombuffer(data[: 2 * n], dtype="<i2").astype(np.int16)


def read_feature_file(path: str) -> np.ndarray:
    """Raw little-endian float32 stream (.mm2)."""
    return np.fromfile(path, dtype="<f4")


def write_feature_file(path: str, features: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.asarray(features, dtype="<f4").tofile(path)


# -- normalization stats -----------------------------------------------------


def read_normalization(path: str, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, stddev), each float64 [dim]."""
    raw = np.fromfile(path, dtype="<f8")
    if raw.size != 2 * dim:
        raise ValueError(f"normalization file {path}: expected {2*dim} doubles, got {raw.size}")
    return raw[:dim].copy(), raw[dim:].copy()


def write_normalization(path: str, mean: np.ndarray, stddev: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.asarray(mean, dtype="<f8").tofile(f)
        np.asarray(stddev, dtype="<f8").tofile(f)


# -- alignments --------------------------------------------------------------

# AlignmentItem layout: uint16 count, uint16 state, float32 weight → 8 bytes
_ALIGN_DTYPE = np.dtype([("count", "<u2"), ("state", "<u2"), ("weight", "<f4")])


def write_alignment(path: str, states: np.ndarray, weights: np.ndarray | None = None,
                    max_aligns: int = 1) -> None:
    """states int [num_frames] (max_aligns=1 layout, the only one used)."""
    num_frames = states.shape[0]
    items = np.zeros(num_frames * max_aligns, dtype=_ALIGN_DTYPE)
    items["count"][::max_aligns] = 1
    items["state"][::max_aligns] = states.astype(np.uint16)
    items["weight"][::max_aligns] = 1.0 if weights is None else weights
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", max_aligns, num_frames))
        items.tofile(f)


def read_alignment(path: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """Returns (states int32 [frames], weights f32 [frames], max_aligns)."""
    with open(path, "rb") as f:
        max_aligns, num_frames = struct.unpack("<QQ", f.read(16))
        items = np.fromfile(f, dtype=_ALIGN_DTYPE, count=num_frames * max_aligns)
    states = items["state"][::max_aligns].astype(np.int32)
    weights = items["weight"][::max_aligns].astype(np.float32)
    return states, weights, max_aligns


# -- MIXSET mixture sets -----------------------------------------------------


@dataclass
class RawMixtureSet:
    """The exact content of a .mix file: accumulator-level EM state.

    ``mean_acc``/``var_acc`` are the weighted Σx and Σx² accumulators,
    ``mean_weight``/``var_weight`` the corresponding Σγ counts; ``densities``
    maps a flat density id to (mean_idx, var_idx); ``mixtures[m]`` lists the
    flat density ids of mixture m. Model parameters (means/vars/weights) are
    re-derived from these by GMM finalization, exactly as the reference's
    ``read()`` calls ``finalize()`` (Mixtures.cpp:829).
    """

    dim: int
    mean_acc: np.ndarray        # f64 [num_means, dim]
    mean_weight: np.ndarray     # f64 [num_means]
    var_acc: np.ndarray         # f64 [num_vars, dim]
    var_weight: np.ndarray      # f64 [num_vars]
    densities: np.ndarray       # i64 [num_densities, 2] → (mean_idx, var_idx)
    mixtures: List[np.ndarray]  # per mixture: i64 [n_d] flat density ids


def _read_accumulator(f: BinaryIO, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    (size,) = struct.unpack("<I", f.read(4))
    feats = np.empty((size, dim), dtype=np.float64)
    weights = np.empty(size, dtype=np.float64)
    for i in range(size):
        (d,) = struct.unpack("<I", f.read(4))
        if d != dim:
            raise ValueError(f"invalid accumulator dimension {d} != {dim}")
        feats[i] = np.frombuffer(f.read(8 * dim), dtype="<f8")
        (weights[i],) = struct.unpack("<d", f.read(8))
    return feats, weights


def _write_accumulator(f: BinaryIO, feats: np.ndarray, weights: np.ndarray,
                       dim: int) -> None:
    f.write(struct.pack("<I", feats.shape[0]))
    for i in range(feats.shape[0]):
        f.write(struct.pack("<I", dim))
        f.write(np.ascontiguousarray(feats[i], dtype="<f8").tobytes())
        f.write(struct.pack("<d", float(weights[i])))


def read_mixture_set(path: str, dim: int) -> RawMixtureSet:
    with open(path, "rb") as f:
        if f.read(8) != MIX_MAGIC:
            raise ValueError("Invalid magic header")
        (version,) = struct.unpack("<I", f.read(4))
        if version != MIX_VERSION:
            raise ValueError(f"Invalid version {version}")
        (dim_test,) = struct.unpack("<I", f.read(4))
        if dim_test != dim:
            raise ValueError(f"dimension mismatch: {dim_test} != {dim}")

        mean_acc, mean_weight = _read_accumulator(f, dim)
        var_acc, var_weight = _read_accumulator(f, dim)

        (density_count,) = struct.unpack("<I", f.read(4))
        densities = np.frombuffer(f.read(8 * density_count), dtype="<u4")
        densities = densities.reshape(density_count, 2).astype(np.int64)

        (mixture_count,) = struct.unpack("<I", f.read(4))
        mixtures: List[np.ndarray] = []
        for _m in range(mixture_count):
            (nd,) = struct.unpack("<I", f.read(4))
            ids = np.empty(nd, dtype=np.int64)
            for d in range(nd):
                (density_idx,) = struct.unpack("<I", f.read(4))
                (w,) = struct.unpack("<d", f.read(8))
                expected = mean_weight[densities[density_idx, 0]]
                if w != expected:
                    raise ValueError("Inconsistent density weight")
                ids[d] = density_idx
            mixtures.append(ids)
    return RawMixtureSet(dim, mean_acc, mean_weight, var_acc, var_weight,
                         densities, mixtures)


def write_mixture_set(path: str, ms: RawMixtureSet) -> None:
    """Writes the compacted reference format (flat ids renumbered mixture-major,
    matching Mixtures.cpp:834-878)."""
    with open(path, "wb") as f:
        f.write(MIX_MAGIC)
        f.write(struct.pack("<II", MIX_VERSION, ms.dim))
        _write_accumulator(f, ms.mean_acc, ms.mean_weight, ms.dim)
        _write_accumulator(f, ms.var_acc, ms.var_weight, ms.dim)

        density_count = sum(len(m) for m in ms.mixtures)
        f.write(struct.pack("<I", density_count))
        for m in ms.mixtures:
            for d in m:
                f.write(struct.pack("<II", int(ms.densities[d, 0]), int(ms.densities[d, 1])))

        f.write(struct.pack("<I", len(ms.mixtures)))
        running = 0
        for m in ms.mixtures:
            f.write(struct.pack("<I", len(m)))
            for d in m:
                w = float(ms.mean_weight[ms.densities[d, 0]])
                f.write(struct.pack("<I", running))
                f.write(struct.pack("<d", w))
                running += 1
