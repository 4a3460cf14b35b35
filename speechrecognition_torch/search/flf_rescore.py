"""Flf score-dimension (semiring-key) manipulation.

Counterpart of the reference's Flf/Rescore.cc +
Flf/ChangeSemiring / Flf/Project (NodeRegistration.hh entries `append`,
`add`, `multiply`, `exp`, `log`, `extend-by-penalty`,
`extend-by-pronunciation-score`, `reduce`, `change-semiring`,
`project`, `rescale`).

The reference's lattices carry a VECTOR semiring — one score per named
dimension (am, lm, confidence, …) with per-dimension scales; the
projection Σ_k scale_k · x_k is the scalar used for search. Here the
same model: a `MultiLattice` wraps a WordLattice topology with named
per-arc score arrays + scales; `view()` materializes the projected
WordLattice for any scalar consumer (best, FB, CN, …). A bare
WordLattice promotes to a single-dimension MultiLattice on demand.

Port: a copy of speechrecognition_tpu/search/flf_rescore.py (host code).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .lattice import Arc, WordLattice


@dataclass
class MultiLattice:
    """Lattice topology + named score dimensions with scales
    (FlfCore/Semiring.hh keyed dimensions)."""

    base: WordLattice                       # topology; arc scores ignored
    dims: Dict[str, np.ndarray]             # key → per-arc scores [A]
    scales: Dict[str, float]                # key → scale

    @staticmethod
    def promote(v, key: str = "am") -> "MultiLattice":
        """WordLattice → 1-dimension MultiLattice; MultiLattice → self."""
        if isinstance(v, MultiLattice):
            return v
        lat: WordLattice = v
        return MultiLattice(
            base=lat,
            dims={key: np.array([a.score for a in lat.arcs], np.float64)},
            scales={key: 1.0})

    @property
    def keys(self) -> List[str]:
        return list(self.dims.keys())

    def view(self) -> WordLattice:
        """Projected scalar lattice: score = Σ_k scale_k · dim_k."""
        A = len(self.base.arcs)
        total = np.zeros(A, np.float64)
        for k, x in self.dims.items():
            total += self.scales[k] * x
        arcs = [Arc(start=a.start, end=a.end, word=a.word,
                    score=float(total[i]))
                for i, a in enumerate(self.base.arcs)]
        return WordLattice(num_frames=self.base.num_frames, arcs=arcs,
                           silence=self.base.silence, times=self.base.times)

    def with_dims(self, dims: Dict[str, np.ndarray],
                  scales: Dict[str, float]) -> "MultiLattice":
        return MultiLattice(base=self.base, dims=dims, scales=scales)


def append_lattices(a, b, suffix: str = "-2") -> MultiLattice:
    """`append`: score-wise concatenation of two equal-topology lattices
    — the result's semiring is the concatenation of both semirings
    (Flf/Rescore.cc AppendNode). Topologies must match arc-for-arc."""
    ma, mb = MultiLattice.promote(a), MultiLattice.promote(b, key="am")
    la, lb = ma.base, mb.base
    sig_a = [(x.start, x.end, x.word) for x in la.arcs]
    sig_b = [(x.start, x.end, x.word) for x in lb.arcs]
    if sig_a != sig_b:
        raise ValueError("append: lattices differ in topology "
                         f"({len(sig_a)} vs {len(sig_b)} arcs)")
    dims = dict(ma.dims)
    scales = dict(ma.scales)
    for k, x in mb.dims.items():
        nk = k if k not in dims else k + suffix
        dims[nk] = x
        scales[nk] = mb.scales[k]
    return MultiLattice(base=la, dims=dims, scales=scales)


def _one_key(ml: MultiLattice, key: Optional[str]) -> str:
    if key is None:
        return ml.keys[0]
    if key not in ml.dims:
        raise KeyError(f"no score dimension {key!r} (have {ml.keys})")
    return key


def add_score(v, value: float, key: Optional[str] = None) -> MultiLattice:
    """`add`: f(x_d) = x_d + value on one dimension."""
    ml = MultiLattice.promote(v)
    k = _one_key(ml, key)
    dims = dict(ml.dims)
    dims[k] = dims[k] + value
    return ml.with_dims(dims, dict(ml.scales))


def multiply_score(v, scale: float, key: Optional[str] = None,
                   ) -> MultiLattice:
    """`multiply`: f(x_d) = scale · x_d."""
    ml = MultiLattice.promote(v)
    k = _one_key(ml, key)
    dims = dict(ml.dims)
    dims[k] = dims[k] * scale
    return ml.with_dims(dims, dict(ml.scales))


def exp_score(v, scale: float = 1.0, key: Optional[str] = None,
              ) -> MultiLattice:
    """`exp`: f(x_d) = exp(scale · x_d)."""
    ml = MultiLattice.promote(v)
    k = _one_key(ml, key)
    dims = dict(ml.dims)
    dims[k] = np.exp(scale * dims[k])
    return ml.with_dims(dims, dict(ml.scales))


def log_score(v, scale: float = 1.0, key: Optional[str] = None,
              ) -> MultiLattice:
    """`log`: f(x_d) = scale · log(x_d)."""
    ml = MultiLattice.promote(v)
    k = _one_key(ml, key)
    dims = dict(ml.dims)
    with np.errstate(divide="ignore", invalid="ignore"):
        dims[k] = scale * np.log(dims[k])
    return ml.with_dims(dims, dict(ml.scales))


def extend_by_penalty(v, penalty: float,
                      class_penalties: Optional[Dict[int, float]] = None,
                      key: Optional[str] = None,
                      skip_nonword: bool = True) -> MultiLattice:
    """`extend-by-penalty` (Flf/Rescore.cc PenaltyNode): add a penalty
    to one dimension per arc; per-word-class penalties override the
    default; non-words (silence/ε) stay free when `skip_nonword` — the
    word-penalty convention everywhere else in the toolkit."""
    ml = MultiLattice.promote(v)
    k = _one_key(ml, key)
    dims = dict(ml.dims)
    x = dims[k].copy()
    sil = ml.base.silence
    cp = class_penalties or {}
    for i, a in enumerate(ml.base.arcs):
        if skip_nonword and (a.word == sil or a.word < 0):
            continue
        x[i] += cp.get(a.word, penalty)
    dims[k] = x
    return ml.with_dims(dims, dict(ml.scales))


def extend_by_pronunciation_score(v, pron_scores: Dict[int, float],
                                  scale: float = 1.0,
                                  key: Optional[str] = None) -> MultiLattice:
    """`extend-by-pronunciation-score`: add scale × the lexicon's
    −log pronunciation probability per arc word (Bliss lexicon
    pronunciation variants)."""
    ml = MultiLattice.promote(v)
    k = _one_key(ml, key)
    dims = dict(ml.dims)
    x = dims[k].copy()
    for i, a in enumerate(ml.base.arcs):
        x[i] += scale * pron_scores.get(a.word, 0.0)
    dims[k] = x
    return ml.with_dims(dims, dict(ml.scales))


def reduce_scores(v, keys: Optional[Sequence[str]] = None) -> MultiLattice:
    """`reduce`: fold the weighted scores of the given dimensions into
    the FIRST given key; the folded dimensions become semiring one (0)
    with scale 1. The projected total is unchanged (asserted by the
    reference's own contract)."""
    ml = MultiLattice.promote(v)
    ks = list(keys) if keys else ml.keys
    if not ks:
        return ml
    first = ks[0]
    dims = dict(ml.dims)
    scales = dict(ml.scales)
    acc = np.zeros(len(ml.base.arcs), np.float64)
    for k in ks:
        acc += scales[k] * dims[k]
        dims[k] = np.zeros_like(dims[k])
        scales[k] = 1.0
    dims[first] = acc
    scales[first] = 1.0
    return ml.with_dims(dims, scales)


def change_semiring(v, new_scales: Dict[str, float],
                    rename: Optional[Dict[str, str]] = None) -> MultiLattice:
    """`change-semiring` / `rescale`: replace the semiring — new scales
    and/or renamed dimensions; scores are not modified. Dimensions
    missing from `new_scales` keep their scale; unknown names create
    zero dimensions (the reference pads with semiring one)."""
    ml = MultiLattice.promote(v)
    rename = rename or {}
    dims = {rename.get(k, k): x for k, x in ml.dims.items()}
    scales = {rename.get(k, k): s for k, s in ml.scales.items()}
    for k, s in new_scales.items():
        if k not in dims:
            dims[k] = np.zeros(len(ml.base.arcs), np.float64)
        scales[k] = s
    return ml.with_dims(dims, scales)


def project_semiring(v, keys: Sequence[str]) -> MultiLattice:
    """`project`: keep only the given dimensions."""
    ml = MultiLattice.promote(v)
    dims = {k: ml.dims[k] for k in keys}
    scales = {k: ml.scales[k] for k in keys}
    return ml.with_dims(dims, scales)
