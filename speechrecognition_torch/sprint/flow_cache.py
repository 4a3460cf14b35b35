"""Flow feature-cache reader: cached vector-f32 streams per segment.

A cache archive stores, per segment "corpus/recording/segment":
  * "<key>.attribs" — XML flow attributes (datatype, sample rate, ...)
  * "<key>"        — BinaryOutputStream: [string datatype][u32 n][n packets]
    where a vector-f32 packet is u32 size + size×f32 + f32 start + f32 end
    (Flow/Vector.hh:76-88, Flow/Datatype.cc:21-45, Flow/Timestamp.cc:53-66).

Port: a copy of speechrecognition_tpu/sprint/flow_cache.py (host code).
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .archive import FileArchive


class FeatureCache:
    def __init__(self, path: str):
        self.archive = FileArchive(path)
        self.segments = [k for k in self.archive.keys()
                         if not k.endswith(".attribs")]

    def attributes(self, key: str) -> Dict[str, str]:
        raw = self.archive.read(key + ".attribs").decode("utf-8", "replace")
        return dict(re.findall(r'name="([^"]+)"\s+value="([^"]+)"', raw))

    def read_features(self, key: str) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (features f32 [T, dim], timestamps f32 [T, 2]).

        An entry may contain several gathered blocks (the CacheWriter
        flushes once per datatype change *and* at destruction,
        Flow/Cache.cc:89-104) — concatenate them all."""
        buf = self.archive.read(key)
        off = 0
        feats: List[np.ndarray] = []
        times: List[Tuple[float, float]] = []
        while off < len(buf):
            (name_len,) = struct.unpack_from("<I", buf, off)
            off += 4
            datatype = buf[off: off + name_len].decode()
            off += name_len
            if datatype != "vector-f32":
                raise ValueError(f"{key}: unsupported datatype {datatype}")
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            for _i in range(n):
                (size,) = struct.unpack_from("<I", buf, off)
                off += 4
                vec = np.frombuffer(buf, dtype="<f4", count=size, offset=off)
                off += 4 * size
                # Flow::Time is f64 (Flow/Types.hh:32)
                start, end = struct.unpack_from("<dd", buf, off)
                off += 16
                feats.append(vec)
                times.append((start, end))
            if len(buf) - off < 8:  # trailing bytes after the last block
                break
        return (np.stack(feats) if feats else np.zeros((0, 0), np.float32),
                np.asarray(times, np.float32))
