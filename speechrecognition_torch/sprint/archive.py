"""Sprint FileArchive reader/writer (Core/FileArchive.cc format).

Layout (documented at rwth-asr-0.5/src/Core/FileArchive.cc:28-81 and
implemented by its scanArchive at :370-415 / read at :487-509):
  8B 'SP_ARC1\\0' header, 1B info-table flag, then file blocks:
    u32 0xaa55aa55 | u32 name_size + name | u32 uncompressed_size |
    u32 compressed_size (0 = raw) | u32 checksum | data | u32 0x55aa55aa
  and an optional trailing info table. All integers little-endian.
  Compressed entries are gzip streams (Core::CompressedStream).

The reference's getChecksum() is a stub that always returns 0
(FileArchive.cc:468-472) and its read() REJECTS any entry whose stored
checksum differs from that 0 — so a compatible writer must store
checksum 0, never a real CRC.

Port: a copy of speechrecognition_tpu/sprint/archive.py (host code).
"""

from __future__ import annotations

import gzip
import io
import struct
import zlib
from typing import Dict, List

MAGIC = b"SP_ARC1\x00"
START_TAG = 0xAA55AA55
END_TAG = 0x55AA55AA


class FileArchive:
    def __init__(self, path: str):
        self.path = path
        self._index: Dict[str, tuple] = {}  # name → (pos, usize, csize)
        self._scan()

    def _scan(self) -> None:
        with open(self.path, "rb") as f:
            if f.read(8) != MAGIC:
                raise ValueError(f"{self.path}: not a Sprint archive")
            f.read(1)  # info-table flag; we scan blocks directly (robust)
            while True:
                head = f.read(4)
                if len(head) < 4:
                    break
                (tag,) = struct.unpack("<I", head)
                if tag != START_TAG:
                    break  # reached the info table / trailer
                (name_size,) = struct.unpack("<I", f.read(4))
                if name_size == 0:  # empty file block
                    (size,) = struct.unpack("<I", f.read(4))
                    f.read(8)  # compressed, checksum (both zero)
                    f.seek(size, io.SEEK_CUR)
                else:
                    name = f.read(name_size).decode("utf-8", "replace")
                    # field order per FileArchive.cc:383-388: uncompressed
                    # size first, then compressed size (0 = raw), checksum
                    usize, csize, _chk = struct.unpack("<III", f.read(12))
                    pos = f.tell()
                    self._index[name] = (pos, usize, csize)
                    f.seek(csize if csize else usize, io.SEEK_CUR)
                (end,) = struct.unpack("<I", f.read(4))
                if end != END_TAG:
                    raise ValueError(f"{self.path}: corrupt block near {name!r}")

    def keys(self) -> List[str]:
        return list(self._index.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def read(self, name: str) -> bytes:
        pos, usize, csize = self._index[name]
        with open(self.path, "rb") as f:
            f.seek(pos)
            data = f.read(csize if csize else usize)
        if csize:  # compressed
            try:
                return gzip.decompress(data)
            except OSError:
                return zlib.decompress(data)
        return data


def write_file_archive(path: str, entries: Dict[str, bytes],
                       compress: bool = False) -> None:
    """Write a Sprint SP_ARC1 archive readable by FileArchive (and the
    reference's Core/FileArchive.cc): the block format documented above,
    no trailing info table (readers scan blocks). Checksum is written as
    0 — the reference's getChecksum() stub returns 0 and its read()
    fails on any other stored value (FileArchive.cc:468-472,503-505)."""
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(b"\x00")             # no info table
        for name, data in entries.items():
            raw = data
            csize = 0
            if compress:
                raw = gzip.compress(data)
                csize = len(raw)
            nb = name.encode("utf-8")
            f.write(struct.pack("<I", START_TAG))
            f.write(struct.pack("<I", len(nb)) + nb)
            f.write(struct.pack("<III", len(data), csize, 0))
            f.write(raw)
            f.write(struct.pack("<I", END_TAG))
