"""Sprint Core/ odds-and-ends: bundle archives, MD5 digests, progress
indication, and resource-usage reporting.

Reference counterparts (rwth-asr-0.5/src/Core/):
  * BundleArchive.cc — a ``.bundle`` file lists member archive paths;
    lookups dispatch to the member holding the entry, with a cached
    ``.idx.gz`` index (count line, archive paths, then "entry archive#"
    pairs — BundleArchive.cc:138-142).
  * MD5.cc          — streaming MD5 digest used for cache validation.
    The reference vendors the RSA reference implementation; here the
    platform's hashlib provides the identical digest.
  * ProgressIndicator.cc — terminal task progress with rate display.
  * ResourceUsageInfo.cc — getrusage user/system time + peak RSS report.

Port: a copy of speechrecognition_tpu/sprint/core_utils.py (host code).
"""

from __future__ import annotations

import gzip
import hashlib
import os
import resource
import sys
import time
from typing import Dict, List, Optional

from .archive import FileArchive


class BundleArchive:
    """Read-only view over a set of Sprint file archives listed in a
    ``.bundle`` file (one member path per line, relative paths resolved
    against the bundle's directory)."""

    SUFFIX = ".bundle"

    def __init__(self, path: str):
        self.path = path
        base = os.path.dirname(os.path.abspath(path))
        with open(path) as f:
            members = [l.strip() for l in f if l.strip()
                       and not l.startswith("#")]
        self.member_paths = [
            m if os.path.isabs(m) else os.path.join(base, m) for m in members]
        self._members: List[Optional[FileArchive]] = [None] * len(members)
        self._map: Dict[str, int] = {}
        idx = self.index_path(path)
        if os.path.exists(idx):
            self._read_index(idx)
        else:
            self._build_index()

    @staticmethod
    def index_path(bundle_path: str) -> str:
        return bundle_path + ".idx.gz"   # BundleArchive.cc:101

    def _member(self, i: int) -> FileArchive:
        if self._members[i] is None:
            self._members[i] = FileArchive(self.member_paths[i])
        return self._members[i]

    def _build_index(self) -> None:
        for i in range(len(self.member_paths)):
            for name in self._member(i).keys():
                self._map.setdefault(name, i)

    def _read_index(self, idx: str) -> None:
        with gzip.open(idx, "rt") as f:
            n_arch = int(f.readline())
            for _ in range(n_arch):
                f.readline()             # archive paths (we use the bundle's)
            n_files = int(f.readline())
            for _ in range(n_files):
                name, arch_i = f.readline().rsplit(" ", 1)
                self._map[name] = int(arch_i)

    def write_index(self, idx: Optional[str] = None) -> None:
        """Persist the entry → member map (BundleArchive.cc:138-142)."""
        with gzip.open(idx or self.index_path(self.path), "wt") as f:
            f.write(f"{len(self.member_paths)}\n")
            for p in self.member_paths:
                f.write(p + "\n")
            f.write(f"{len(self._map)}\n")
            for name, i in self._map.items():
                f.write(f"{name} {i}\n")

    def keys(self) -> List[str]:
        return list(self._map.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def read(self, name: str) -> bytes:
        return self._member(self._map[name]).read(name)


class MD5:
    """Streaming MD5 with the Core::MD5 usage pattern (update with bytes
    or str, hex digest via str())."""

    def __init__(self):
        self._h = hashlib.md5()

    def update(self, data) -> "MD5":
        if isinstance(data, str):
            data = data.encode()
        self._h.update(data)
        return self

    def update_from_file(self, path: str, chunk: int = 1 << 20) -> "MD5":
        with open(path, "rb") as f:
            while True:
                b = f.read(chunk)
                if not b:
                    break
                self._h.update(b)
        return self

    def __str__(self) -> str:
        return self._h.hexdigest()

    def digest(self) -> bytes:
        return self._h.digest()


class ProgressIndicator:
    """Core/ProgressIndicator.hh: start(task, total) → notify(done) →
    finish(); draws at most ~10 updates/s on a tty, silent otherwise."""

    def __init__(self, task: str = "", unit: str = "items", out=sys.stderr,
                 min_interval: float = 0.1):
        self.task = task
        self.unit = unit
        self.out = out
        self.min_interval = min_interval
        self.total = 0
        self.done = 0
        self._t0 = 0.0
        self._last = 0.0
        self._tty = hasattr(out, "isatty") and out.isatty()

    def start(self, total: int = 0) -> "ProgressIndicator":
        self.total = total
        self.done = 0
        self._t0 = time.perf_counter()
        self._last = 0.0
        return self

    def notify(self, done: Optional[int] = None) -> None:
        self.done = self.done + 1 if done is None else done
        now = time.perf_counter()
        if not self._tty or now - self._last < self.min_interval:
            return
        self._last = now
        rate = self.done / max(now - self._t0, 1e-9)
        if self.total:
            pct = 100.0 * self.done / self.total
            self.out.write(f"\r{self.task}: {self.done}/{self.total} "
                           f"({pct:.0f}%) {rate:.0f} {self.unit}/s ")
        else:
            self.out.write(f"\r{self.task}: {self.done} "
                           f"{rate:.0f} {self.unit}/s ")
        self.out.flush()

    def finish(self, clear: bool = False) -> float:
        elapsed = time.perf_counter() - self._t0
        if self._tty:
            self.out.write("\r" + " " * 60 + "\r" if clear
                           else f"\r{self.task}: {self.done} {self.unit} "
                                f"in {elapsed:.1f}s\n")
            self.out.flush()
        return elapsed


def resource_usage_info() -> Dict[str, float]:
    """Core/ResourceUsageInfo.cc: user/system CPU seconds and peak RSS
    (bytes) of this process and its finished children."""
    own = resource.getrusage(resource.RUSAGE_SELF)
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    return {
        "user_s": own.ru_utime + kids.ru_utime,
        "system_s": own.ru_stime + kids.ru_stime,
        "elapsed_s": time.perf_counter(),
        # ru_maxrss is KiB on Linux
        "peak_rss_bytes": (own.ru_maxrss + kids.ru_maxrss) * 1024,
    }


def log_resource_usage(log=print) -> Dict[str, float]:
    info = resource_usage_info()
    log(f"resource usage: user {info['user_s']:.1f}s "
        f"system {info['system_s']:.1f}s "
        f"peak rss {info['peak_rss_bytes'] / (1 << 20):.0f} MiB")
    return info
