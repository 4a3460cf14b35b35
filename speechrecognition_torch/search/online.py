"""Online (streaming) recognition: feed feature chunks, read partial
transcripts, with the beam state carried between feeds — counterpart of
speechrecognition_tpu/search/online.py.

The reference's recognizer is per-frame streaming: its corpus loop feeds
features frame by frame and reads partial results via
getCurrentBestSentence and the final traceback at segment end
(rwth-asr-0.5/src/Speech/Recognizer.hh:37-110, Search/Search.hh:33-72,
Tools/SpeechRecognizer/SpeechRecognizer.cc:30-66).

Here the stream is committed in fixed-length chunks through the same
scoring and scan calls the offline decoders make: the word-loop scan
(kernel B in float32/float64, kernels C + D in df32) for
``OnlineRecognizer``, the word-conditioned tree search (kernel K) for
``OnlineWctsRecognizer``. Each scan carries its lattice between chunks and
counts frames globally (``t0``), so the results equal the offline decode of
the same frames; feeds of any size only change when the work happens.
Each committed chunk's traceback tables come to the host once.
``partial()`` decodes the uncommitted tail from the committed carry
without committing it.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..contracts import require
from ..models import gmm as gmm_mod
from ..ops import doublefloat as dfm
from .decoder import (DECODE_CHUNK, DecoderTables, _init_carry, _init_carry_df,
                      _traceback_host, decode_scan, decode_scan_df)


class _FrameBuffer:
    """Lockstep [B, t, dim] frames fed but not yet committed."""

    def __init__(self, num_streams: int):
        self.num_streams = num_streams
        self.pieces: List[np.ndarray] = []
        self.frames = 0

    def append(self, frames) -> None:
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 2:
            frames = frames[None]
        require(frames.shape[0] == self.num_streams,
                f"feed expects {self.num_streams} streams, got {frames.shape[0]}")
        self.pieces.append(frames)
        self.frames += frames.shape[1]

    def take(self, n: int) -> np.ndarray:
        """Pop exactly n buffered frames as one [B, n, dim] array."""
        out, need = [], n
        while need > 0:
            piece = self.pieces[0]
            if piece.shape[1] <= need:
                out.append(piece)
                need -= piece.shape[1]
                self.pieces.pop(0)
            else:
                out.append(piece[:, :need])
                self.pieces[0] = piece[:, need:]
                need = 0
        self.frames -= n
        return out[0] if len(out) == 1 else np.concatenate(out, axis=1)

    def tail(self, chunk: int) -> np.ndarray:
        """Every buffered frame, zero-padded to one chunk (not consumed)."""
        tail = self.pieces[0] if len(self.pieces) == 1 else np.concatenate(self.pieces, axis=1)
        pad = chunk - tail.shape[1]
        return np.pad(tail, ((0, 0), (0, pad), (0, 0))) if pad else tail


def _lengths(feat_len, total: int, num_streams: int) -> np.ndarray:
    if feat_len is None:
        return np.full(num_streams, total, np.int64)
    return np.minimum(np.asarray(feat_len, np.int64), total)


def _stats(xs) -> dict:
    if not xs:
        return {}
    a = np.asarray(xs)
    return {"mean_s": float(a.mean()), "p50_s": float(np.median(a)),
            "max_s": float(a.max()), "n": len(xs)}


class OnlineRecognizer:
    """Streaming word-loop decoder over ``num_streams`` parallel streams.

    feed(frames)  — append [B, T_any, dim] frames (lockstep across streams;
                    pad short streams and pass their true lengths to
                    finish()/partial()).
    partial()     — current best transcripts over everything fed so far.
    finish()      — final transcripts (equal to the offline decode_batch /
                    decode_batch_df of the same frames).
    restart()     — reset all carried state (SearchAlgorithm::restart).

    ``dtype`` is torch.float32 or torch.float64 with a ScorePack, or "df32"
    with a ScorePackDF; everything runs on the pack's device.
    ``chunk_latencies_s`` holds the wall time of each committed chunk,
    ``partial_latencies_s`` of each partial() call.
    """

    def __init__(self, pack, tables: DecoderTables, am_threshold: float,
                 silence_idx: int, dtype=torch.float32, num_streams: int = 1,
                 chunk: int = DECODE_CHUNK, prune: bool = True):
        self.pack = pack
        self.tables = tables
        self.am_threshold = am_threshold
        self.silence_idx = silence_idx
        self.num_streams = num_streams
        self.chunk = chunk
        self.prune = prune
        self.is_df = dtype == "df32"
        self.dtype = dtype
        self.device = pack.device
        dev = self.device
        self._W, self._P = tables.state_table.shape
        ints = tuple(torch.as_tensor(a, device=dev) for a in (
            tables.state_table, tables.last_pos, tables.word_len, tables.first_state))
        if self.is_df:
            self._args = (*ints, dfm.from_f64(tables.tdp_within, dev),
                          dfm.from_f64(tables.entry_pen, dev))
        else:
            self._args = (*ints, torch.as_tensor(tables.tdp_within, device=dev),
                          torch.as_tensor(tables.entry_pen, device=dev))
        self._exit_pen = (None if tables.exit_pen is None
                          else torch.as_tensor(tables.exit_pen, device=dev))
        self.chunk_latencies_s: List[float] = []
        self.partial_latencies_s: List[float] = []
        self.restart()

    def restart(self) -> None:
        """Reset the carried lattice and the buffers (the reference's
        SearchAlgorithm::restart, called at every segment start)."""
        B, W, P = self.num_streams, self._W, self._P
        self._carry = (_init_carry_df(B, W, P, self.device) if self.is_df
                       else _init_carry(B, W, P, self.dtype, self.device))
        self._buffer = _FrameBuffer(self.num_streams)
        self._t_committed = 0
        self._words: List[np.ndarray] = []     # committed [chunk, B] host tables
        self._bkps: List[np.ndarray] = []

    def feed(self, frames: np.ndarray) -> None:
        """Append [B, T_any, dim] feature frames; commits full chunks."""
        self._buffer.append(frames)
        while self._buffer.frames >= self.chunk:
            t0 = time.perf_counter()
            feats = self._buffer.take(self.chunk)
            # committed frames are all real: mask nothing
            lens = np.full(self.num_streams, self._t_committed + self.chunk, np.int64)
            self._carry, w, b = self._scan_chunk(feats, lens)
            self._words.append(w.cpu().numpy())
            self._bkps.append(b.cpu().numpy())
            self._t_committed += self.chunk
            self.chunk_latencies_s.append(time.perf_counter() - t0)

    def _scan_chunk(self, feats: np.ndarray, feat_len: np.ndarray):
        """One chunk through the scoring and scan calls offline decoding makes."""
        B, chunk = self.num_streams, self.chunk
        dev = self.device
        lens = torch.as_tensor(feat_len, dtype=torch.int32, device=dev)
        fl = torch.as_tensor(feats, device=dev).reshape(B * chunk, -1)
        S = self.pack.num_mixtures
        if self.is_df:
            am = gmm_mod.am_scores_df(self.pack, fl)
            am = dfm.DF(am.hi.reshape(B, chunk, S), am.lo.reshape(B, chunk, S))
            carry, (_s, w, b) = decode_scan_df(am, lens, *self._args, self.am_threshold,
                                               prune=self.prune, carry_in=self._carry,
                                               t0=self._t_committed)
        else:
            am = gmm_mod.am_scores(self.pack, fl).reshape(B, chunk, S).to(self.dtype)
            carry, (_s, w, b) = decode_scan(am, lens, *self._args, self.am_threshold,
                                            prune=self.prune, carry_in=self._carry,
                                            t0=self._t_committed, exit_pen=self._exit_pen)
        return carry, w, b

    def partial(self, feat_len: Optional[Sequence[int]] = None) -> List[List[int]]:
        """Best transcripts over everything fed so far (the reference's
        getCurrentBestSentence): decodes the uncommitted tail from the
        committed carry WITHOUT committing it."""
        t0 = time.perf_counter()
        total = self._t_committed + self._buffer.frames
        if total == 0:      # callable at any point, also before feed()
            self.partial_latencies_s.append(time.perf_counter() - t0)
            return [[] for _ in range(self.num_streams)]
        feat_len = _lengths(feat_len, total, self.num_streams)
        words, bkps = list(self._words), list(self._bkps)
        if self._buffer.frames:
            _carry, w, b = self._scan_chunk(self._buffer.tail(self.chunk), feat_len)
            words.append(w.cpu().numpy())
            bkps.append(b.cpu().numpy())
        out = _traceback_host(np.concatenate(words), np.concatenate(bkps), feat_len,
                              self.silence_idx)
        self.partial_latencies_s.append(time.perf_counter() - t0)
        return out

    def finish(self, feat_len: Optional[Sequence[int]] = None) -> List[List[int]]:
        """Final transcripts; per-stream true lengths may be passed when
        streams were padded to stay lockstep."""
        return self.partial(feat_len)

    @property
    def latency_stats(self) -> dict:
        return {"chunk_frames": self.chunk, "commit": _stats(self.chunk_latencies_s),
                "partial": _stats(self.partial_latencies_s)}


class OnlineWctsRecognizer:
    """Streaming LVCSR recognition over the word-conditioned tree search
    (the reference's online mode runs this decoder, SpeechRecognizer.cc:
    30-66): feed feature chunks, partial()/finish() transcripts, the
    tree-copy lattice carried between chunks (hyp, bkp, book, silp, silb).
    Chunk commits go through ``wcts_scan`` with the carry and the global
    frame count, so the results equal the offline ``decode_batch_wcts`` of
    the same frames. Runs on the pack's device in ``dtype`` (float32 or
    float64)."""

    def __init__(self, pack, tables, tdp_model, lm_matrix, lm_start, am_threshold: float,
                 silence_idx: int, lookahead=None, transparent_silence: bool = False,
                 dtype: torch.dtype = torch.float32, num_streams: int = 1, chunk: int = 64,
                 prune: bool = True):
        from .wcts import WctsTables

        self.pack = pack
        self.tables = tables
        self.am_threshold = am_threshold
        self.silence_idx = silence_idx
        self.num_streams = num_streams
        self.chunk = chunk
        self.prune = prune
        self.dtype = dtype
        self.transparent = transparent_silence
        self.device = pack.device
        self._wt = WctsTables.build(tables, tdp_model, lm_matrix, lm_start, lookahead)
        self.lm_ext = self._wt.lm_ext
        self.C, self.W = self.lm_ext.shape
        self.N = tables.num_nodes
        self._args = self._wt.args(self.device, dtype, pack.num_mixtures)
        self.chunk_latencies_s: List[float] = []
        self.partial_latencies_s: List[float] = []
        self.restart()

    def restart(self) -> None:
        from .wcts import init_carry

        self._carry = init_carry(self.num_streams, self.C, self.N, self.W, self.dtype,
                                 self.device)
        self._buffer = _FrameBuffer(self.num_streams)
        self._t_committed = 0
        #: host copies of the per-frame outputs, one tuple per committed chunk
        self._outs: List[tuple] = []

    def feed(self, frames: np.ndarray) -> None:
        """Append [B, T_any, dim] feature frames; commits full chunks."""
        self._buffer.append(frames)
        while self._buffer.frames >= self.chunk:
            t0 = time.perf_counter()
            feats = self._buffer.take(self.chunk)
            lens = np.full(self.num_streams, self._t_committed + self.chunk, np.int64)
            self._carry, outs = self._scan(feats, lens)
            self._outs.append(tuple(o.cpu().numpy() for o in outs))
            self._t_committed += self.chunk
            self.chunk_latencies_s.append(time.perf_counter() - t0)

    def _scan(self, feats: np.ndarray, feat_len: np.ndarray):
        from .wcts import wcts_scan

        B, chunk = self.num_streams, self.chunk
        dev = self.device
        fl = torch.as_tensor(feats, device=dev).reshape(B * chunk, -1)
        am = gmm_mod.am_scores(self.pack, fl).reshape(
            B, chunk, self.pack.num_mixtures).to(self.dtype).contiguous()
        return wcts_scan(am, torch.as_tensor(feat_len, dtype=torch.int32, device=dev),
                         *self._args, self.am_threshold, prune=self.prune,
                         use_lookahead=self._wt.use_lookahead,
                         transparent_silence=self.silence_idx if self.transparent else -1,
                         carry_in=self._carry, t0=self._t_committed)

    def partial(self, feat_len=None) -> List[List[int]]:
        """Best transcripts over everything fed so far, the uncommitted tail
        decoded from the committed carry without committing it."""
        from .wcts import traceback_wcts

        t0 = time.perf_counter()
        total = self._t_committed + self._buffer.frames
        if total == 0:
            self.partial_latencies_s.append(time.perf_counter() - t0)
            return [[] for _ in range(self.num_streams)]
        feat_len = _lengths(feat_len, total, self.num_streams)
        outs_list = list(self._outs)
        if self._buffer.frames:
            _carry, outs = self._scan(self._buffer.tail(self.chunk), feat_len)
            outs_list.append(tuple(o.cpu().numpy() for o in outs))
        cat = [np.concatenate([o[k] for o in outs_list]) for k in range(len(outs_list[0]))]
        out = traceback_wcts(cat[0], cat[1], cat[2], feat_len, self.silence_idx, self.C,
                             tuple(cat[-4:]) if self.transparent else None)
        self.partial_latencies_s.append(time.perf_counter() - t0)
        return out

    def finish(self, feat_len=None) -> List[List[int]]:
        return self.partial(feat_len)

    @property
    def latency_stats(self) -> dict:
        return {"chunk_frames": self.chunk, "commit": _stats(self.chunk_latencies_s),
                "partial": _stats(self.partial_latencies_s)}
