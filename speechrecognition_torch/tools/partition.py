"""Corpus partitioning and pruning-sweep tools — counterpart of
speechrecognition_tpu/tools/partition.py, on the port's Corpus and
Recognizer.

Capability parity with the reference's analysis workflows:
  * speaker/gender partitioning of a corpus (the corpus JSON carries
    `speaker` and `gender` per segment — src/sietill/Corpus.cpp:52-85 —
    and the shipped features are laid out by gender/speaker directories
    data/new_features/{m,w}/<speaker>/);
  * the WER-vs-pruning-threshold sweep behind the wer-plotting gnuplot
    data files (src/wer-plotting/gnuplot/test/time.data: lines of
    "<am-threshold> <wer>"; thresholds 25..1e6).

Partitions are index lists into the flat corpus store; ``subset_corpus``
materializes a standalone Corpus (flat feature array + offsets) so every
existing batched/sharded decode runs unchanged on a partition.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..corpus import Corpus, CorpusDescription


def partition_segments(description: CorpusDescription,
                       key: str = "speaker") -> Dict[int, List[int]]:
    """Group segment indices by ``speaker`` or ``gender`` id."""
    if key not in ("speaker", "gender"):
        raise ValueError(f"unknown partition key: {key}")
    groups: Dict[int, List[int]] = {}
    for i, seg in enumerate(description.segments):
        groups.setdefault(getattr(seg, key), []).append(i)
    return groups


def subset_corpus(corpus: Corpus, seg_ids: Sequence[int]) -> Corpus:
    """Standalone Corpus over the chosen segments (features re-packed flat)."""
    off = corpus.feature_offsets
    parts = [corpus.features[off[s]: off[s + 1]] for s in seg_ids]
    new_off = np.zeros(len(seg_ids) + 1, np.int64)
    np.cumsum([p.shape[0] for p in parts], out=new_off[1:])
    return Corpus(
        features=(np.concatenate(parts, axis=0) if parts
                  else corpus.features[:0]),
        feature_offsets=new_off,
        orths=[list(corpus.orths[s]) for s in seg_ids],
        names=[corpus.names[s] for s in seg_ids],
        frame_duration=corpus.frame_duration,
        dim=corpus.dim,
    )


def wer_vs_threshold(make_recognizer: Callable[[float], "object"],
                     corpus: Corpus,
                     thresholds: Sequence[float],
                     batch_size: int = 128,
                     max_segments: Optional[int] = None) -> List[dict]:
    """Decode the corpus at each am-threshold; returns one record per
    threshold with wer/ser/time/rtf — the data behind
    src/wer-plotting/gnuplot/test/gnuplot_wer.txt's WER-vs-time curves."""
    records: List[dict] = []
    for thr in thresholds:
        rec = make_recognizer(float(thr))
        # build the kernels outside the timed region: the reference's
        # time.data x-axis is steady-state decode time
        warmup = getattr(rec, "warmup", None)
        if warmup is not None:
            warmup(corpus, batch_size=batch_size)
        res = rec.recognize_corpus(corpus, batch_size=batch_size,
                                   max_segments=max_segments)
        records.append({
            "threshold": float(thr),
            "wer": res["wer"],
            "ser": res["ser"],
            "time": res["time"],
            "rtf": res["rtf"],
        })
    return records


def write_time_data(records: Sequence[dict], path: str) -> None:
    """gnuplot data file: "<threshold> <wer>" per line
    (format of src/wer-plotting/gnuplot/test/time.data)."""
    with open(path, "w") as f:
        for r in records:
            f.write(f"{r['threshold']:g} {r['wer']:.6f}\n")


def per_group_wer(recognizer, corpus: Corpus,
                  description: CorpusDescription, key: str = "gender",
                  batch_size: int = 128) -> Dict[int, dict]:
    """Decode each speaker/gender partition separately; returns
    group id → recognize_corpus result dict (wer/ser/rtf...)."""
    out: Dict[int, dict] = {}
    for gid, ids in partition_segments(description, key).items():
        sub = subset_corpus(corpus, ids)
        out[gid] = recognizer.recognize_corpus(sub, batch_size=batch_size)
    return out
