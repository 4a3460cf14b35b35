"""Corpus description and feature store.

The reference loads every utterance's ``.mm2`` file into one flat float
array with per-segment offsets (src/sietill/Corpus.cpp:89-111). We keep that
flat layout (it is exactly what segment-sum EM accumulation wants) and add
length-bucketed padded batch views for the batched decoder/aligner.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .config import Configuration, ParameterString
from .features.frontend import SignalAnalysisConfig, process_features
from .io import read_feature_file, read_normalization
from .lexicon import Lexicon


@dataclass
class Segment:
    name: str
    speaker: int
    gender: int
    orth: List[int]  # word indices


@dataclass
class CorpusDescription:
    """Parses the segments JSON (reference: Corpus.cpp:28-85)."""

    segments: List[Segment] = field(default_factory=list)

    @staticmethod
    def read(path: str, lexicon: Lexicon) -> "CorpusDescription":
        with open(path, "r") as f:
            data = json.load(f)
        speakers: dict = {}
        genders: dict = {}
        segs: List[Segment] = []
        for s in data.get("segments", []):
            spk = speakers.setdefault(s.get("speaker", ""), len(speakers))
            gen = genders.setdefault(s.get("gender", ""), len(genders))
            orth = [lexicon.word_idx(w) for w in s.get("orth", "").split()]
            segs.append(Segment(name=s.get("name", ""), speaker=spk, gender=gen, orth=orth))
        return CorpusDescription(segments=segs)

    @staticmethod
    def from_config(config: Configuration, lexicon: Lexicon) -> "CorpusDescription":
        path = ParameterString("corpus", "")(config)
        return CorpusDescription.read(path, lexicon)


@dataclass
class Corpus:
    """All features in one flat array + offsets, plus reference word sequences."""

    features: np.ndarray          # f32 [total_frames, dim]
    feature_offsets: np.ndarray   # i64 [num_segments + 1] (frames)
    orths: List[List[int]]
    names: List[str]
    frame_duration: float         # seconds per frame
    dim: int

    @staticmethod
    def read(description: CorpusDescription, feature_path: str,
             cfg: SignalAnalysisConfig,
             normalization_path: Optional[str] = None,
             use_native: bool = True) -> "Corpus":
        """Read every segment's features. ``use_native`` reads through the
        threaded C++ loader (native/loader.py), which raises if it cannot be
        built; ``use_native=False`` takes the pure-Python path. Both give
        the same bits."""
        mean = std = None
        if normalization_path:
            mean, std = read_normalization(normalization_path, cfg.n_features_total)
        names = [seg.name for seg in description.segments]
        paths = [feature_path + n + ".mm2" for n in names]

        if use_native and paths:
            from .native.loader import load_corpus_native
            features, offsets = load_corpus_native(
                paths, mean, std, cfg.n_features_in_file, cfg.n_features_first,
                cfg.n_features_second, cfg.deriv_step, cfg.energy_max_norm)
        else:
            buffers: List[np.ndarray] = []
            off = [0]
            for p in paths:
                f12 = read_feature_file(p)
                feats = process_features(f12, mean, std, cfg)
                buffers.append(feats)
                off.append(off[-1] + feats.shape[0])
            features = (np.concatenate(buffers, axis=0) if buffers
                        else np.zeros((0, cfg.n_features_total), np.float32))
            offsets = np.asarray(off, dtype=np.int64)

        return Corpus(
            features=features,
            feature_offsets=offsets,
            orths=[list(seg.orth) for seg in description.segments],
            names=names,
            frame_duration=cfg.window_shift / cfg.sample_rate,
            dim=cfg.n_features_total,
        )

    # -- basic accessors -----------------------------------------------------

    @property
    def num_segments(self) -> int:
        return len(self.orths)

    @property
    def total_frames(self) -> int:
        return int(self.feature_offsets[-1])

    def seq_length(self, s: int) -> int:
        return int(self.feature_offsets[s + 1] - self.feature_offsets[s])

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.feature_offsets).astype(np.int64)

    @property
    def max_seq_length(self) -> int:
        return int(self.lengths.max()) if self.num_segments else 0

    def feature_sequence(self, s: int) -> np.ndarray:
        return self.features[self.feature_offsets[s]: self.feature_offsets[s + 1]]

    @property
    def total_audio_seconds(self) -> float:
        return self.total_frames * self.frame_duration

    # -- batched padded views ------------------------------------------------

    def padded_batch(self, seg_ids: Sequence[int], pad_to: Optional[int] = None,
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(features f32 [B, T_pad, dim] zero-padded, lengths i32 [B])."""
        seg_ids = list(seg_ids)
        lens = np.array([self.seq_length(s) for s in seg_ids], dtype=np.int32)
        T = int(pad_to or lens.max())
        out = np.zeros((len(seg_ids), T, self.dim), dtype=np.float32)
        for i, s in enumerate(seg_ids):
            out[i, : lens[i]] = self.feature_sequence(s)
        return out, lens

    def length_bucketed_batches(self, batch_size: int, pad_multiple: int = 32,
                                ) -> Iterator[Tuple[List[int], np.ndarray, np.ndarray]]:
        """Yields (segment_ids, features [B,T,dim], lengths [B]) sorted by
        length so each padded batch wastes minimal compute. The last batch of
        a bucket may be smaller; callers relying on fixed shapes should pad."""
        order = np.argsort(self.lengths, kind="stable")
        for i in range(0, len(order), batch_size):
            ids = order[i: i + batch_size].tolist()
            max_len = max(self.seq_length(s) for s in ids)
            T = -(-max_len // pad_multiple) * pad_multiple
            feats, lens = self.padded_batch(ids, pad_to=T)
            yield ids, feats, lens
