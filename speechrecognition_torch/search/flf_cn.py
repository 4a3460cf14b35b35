"""Flf confusion-network IO, pruning, combination, features and oracle
alignment.

Counterpart of the reference's
Flf/ConfusionNetworkIo.cc + TimeframeConfusionNetworkIo.cc (CN/fCN
archives), Flf/ConfusionNetwork.cc (prune-CN/prune-fCN, oracle
alignment, CN features), Flf/TimeframeConfusionNetworkCombination.cc
(fCN-combination), Flf/TimeframeConfusionNetwork.cc (fCN features,
Frank Wessel confidence, fWER), and
Flf/StateClusterConfusionNetworkBuilder.cc — the NodeRegistration.hh
entries `CN-archive-reader/-writer`, `fCN-archive-reader/-writer`,
`dump-CN`, `dump-fCN`, `prune-CN`, `prune-fCN`, `CN-combination`,
`fCN-combination`, `concatenate-fCNs`, `CN-features`, `fCN-features`,
`fCN-confidence`, `fWER-evaluator`, `oracle-alignment`,
`state-cluster-CN-builder`, `aligner`.

Data model (matching search/flf.py): a CN is a list of CnSlot
(word → posterior, ε implicit); an fCN is a list (frames) of
{word: posterior} dicts.

Port: a copy of speechrecognition_tpu/search/flf_cn.py (host code).
"""

from __future__ import annotations

import gzip
import math
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .flf import CnSlot, cn_decode
from .flf_network import frame_posterior_cn, fwdbwd_posteriors
from .lattice import Arc, WordLattice


# -- archives (ConfusionNetworkIo.cc / TimeframeConfusionNetworkIo.cc) --------

class CnArchive:
    """Directory archive of confusion networks, one gz text file per
    segment + plain index (the same layout as LatticeArchive). Row
    format: `slot <start> <end> <word>:<prob> ...` — the reference's
    textual CN dump made round-trippable."""

    INDEX = "cn.index"
    SUFFIX = ".cn.gz"

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _file(self, seg_id: str) -> str:
        return os.path.join(self.path, seg_id.replace("/", "_") + self.SUFFIX)

    def write(self, seg_id: str, slots: Sequence[CnSlot]) -> None:
        with gzip.open(self._file(seg_id), "wt") as f:
            for s in slots:
                row = " ".join(f"{w}:{p:.12g}"
                               for w, p in sorted(s.probs.items()))
                f.write(f"slot {s.start} {s.end} {row}\n")
        idx = os.path.join(self.path, self.INDEX)
        have = set(self.list())
        if seg_id not in have:
            with open(idx, "a") as f:
                f.write(seg_id + "\n")

    def read(self, seg_id: str) -> List[CnSlot]:
        slots: List[CnSlot] = []
        with gzip.open(self._file(seg_id), "rt") as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0] != "slot":
                    continue
                s = CnSlot(start=int(parts[1]), end=int(parts[2]))
                for tok in parts[3:]:
                    w, p = tok.split(":")
                    s.probs[int(w)] = float(p)
                slots.append(s)
        return slots

    def list(self) -> List[str]:
        idx = os.path.join(self.path, self.INDEX)
        if not os.path.exists(idx):
            return []
        with open(idx) as f:
            return [l.strip() for l in f if l.strip()]


class FcnArchive:
    """Directory archive of frame-wise posterior CNs. Row t:
    `<word>:<prob> ...` (ε mass implicit)."""

    INDEX = "fcn.index"
    SUFFIX = ".fcn.gz"

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _file(self, seg_id: str) -> str:
        return os.path.join(self.path, seg_id.replace("/", "_") + self.SUFFIX)

    def write(self, seg_id: str, pcn: Sequence[Dict[int, float]]) -> None:
        with gzip.open(self._file(seg_id), "wt") as f:
            for row in pcn:
                f.write(" ".join(f"{w}:{p:.12g}"
                                 for w, p in sorted(row.items())) + "\n")
        idx = os.path.join(self.path, self.INDEX)
        if seg_id not in set(self.list()):
            with open(idx, "a") as f:
                f.write(seg_id + "\n")

    def read(self, seg_id: str) -> List[Dict[int, float]]:
        pcn: List[Dict[int, float]] = []
        with gzip.open(self._file(seg_id), "rt") as f:
            for line in f:
                row: Dict[int, float] = {}
                for tok in line.split():
                    w, p = tok.split(":")
                    row[int(w)] = float(p)
                pcn.append(row)
        return pcn

    def list(self) -> List[str]:
        idx = os.path.join(self.path, self.INDEX)
        if not os.path.exists(idx):
            return []
        with open(idx) as f:
            return [l.strip() for l in f if l.strip()]


# -- dumps --------------------------------------------------------------------

def dump_cn(slots: Sequence[CnSlot], vocab: Sequence[str], out,
            seg_id: str = "") -> None:
    """`dump-CN`: textual CN, slot entries sorted by decreasing prob."""
    for i, s in enumerate(slots):
        entries = sorted(s.probs.items(), key=lambda kv: -kv[1])
        eps = s.eps_prob()
        if eps > 0:
            entries = sorted(entries + [(-1, eps)], key=lambda kv: -kv[1])
        row = " ".join(
            f"{vocab[w] if 0 <= w < len(vocab) else '*EPS*'}/{p:.4f}"
            for w, p in entries)
        print(f"{seg_id}\t{i}\t[{s.start},{s.end}]\t{row}", file=out)


def dump_fcn(pcn: Sequence[Dict[int, float]], vocab: Sequence[str], out,
             seg_id: str = "") -> None:
    """`dump-fCN`: per-frame rows sorted by decreasing probability."""
    for t, row in enumerate(pcn):
        entries = sorted(row.items(), key=lambda kv: -kv[1])
        eps = max(0.0, 1.0 - sum(row.values()))
        if eps > 0:
            entries = sorted(entries + [(-1, eps)], key=lambda kv: -kv[1])
        txt = " ".join(
            f"{vocab[w] if 0 <= w < len(vocab) else '*EPS*'}/{p:.4f}"
            for w, p in entries)
        print(f"{seg_id}\t{t}\t{txt}", file=out)


def cn_to_lattice(slots: Sequence[CnSlot], silence: int = 0) -> WordLattice:
    """Sausage lattice representation of a CN (dump-CN port 0): node i
    is slot boundary i; each slot entry becomes an arc with score
    −log p; ε mass becomes a silence arc."""
    arcs: List[Arc] = []
    times: Dict[int, int] = {0: slots[0].start if slots else 0}
    for i, s in enumerate(slots):
        times[i + 1] = s.end
        for w, p in sorted(s.probs.items()):
            arcs.append(Arc(start=i, end=i + 1, word=w,
                            score=-math.log(max(p, 1e-300))))
        eps = s.eps_prob()
        if eps > 0.0:
            arcs.append(Arc(start=i, end=i + 1, word=silence,
                            score=-math.log(max(eps, 1e-300))))
    return WordLattice(num_frames=len(slots), arcs=arcs, silence=silence,
                       times=times)


# -- pruning (ConfusionNetwork.cc prune-CN / prune-fCN) -----------------------

def _prune_dist(probs: Dict[int, float], threshold: Optional[float],
                max_size: Optional[int], normalize: bool,
                ) -> Dict[int, float]:
    entries = sorted(probs.items(), key=lambda kv: -kv[1])
    if threshold is not None:
        kept, mass = [], 0.0
        for w, p in entries:
            kept.append((w, p))
            mass += p
            if mass >= threshold:
                break
        entries = kept
    if max_size is not None:
        entries = entries[:max_size]
    out = dict(entries)
    if normalize and out:
        # ε participates like any entry (PosteriorCn semantics)
        eps = max(0.0, 1.0 - sum(probs.values()))
        z = sum(out.values()) + eps
        if z > 0:
            out = {w: p / z for w, p in out.items()}
    return out


def prune_cn(slots: Sequence[CnSlot], threshold: Optional[float] = None,
             max_slot_size: Optional[int] = None, normalize: bool = False,
             remove_eps_slots: Optional[float] = None) -> List[CnSlot]:
    """`prune-CN`: per-slot probability-mass pruning (keep the first n
    entries summing to `threshold`), max slot size, optional
    re-normalization; slots whose ε mass exceeds `remove_eps_slots`
    are dropped entirely."""
    out: List[CnSlot] = []
    for s in slots:
        if (remove_eps_slots is not None
                and s.eps_prob() >= remove_eps_slots):
            continue
        probs = _prune_dist(s.probs, threshold, max_slot_size, normalize)
        out.append(CnSlot(start=s.start, end=s.end, probs=probs))
    return out


def prune_fcn(pcn: Sequence[Dict[int, float]],
              threshold: Optional[float] = None,
              max_slot_size: Optional[int] = None,
              normalize: bool = False) -> List[Dict[int, float]]:
    """`prune-fCN`: the same slot-wise pruning on frame rows."""
    return [_prune_dist(row, threshold, max_slot_size, normalize)
            for row in pcn]


# -- combination --------------------------------------------------------------

def fcn_combination(fcns: Sequence[Sequence[Dict[int, float]]],
                    weights: Optional[Sequence[float]] = None,
                    max_approx: bool = False) -> List[Dict[int, float]]:
    """`fCN-combination` (TimeframeConfusionNetworkCombination.cc):
    frame- and word-wise joint probability over all systems —
    p(w|t) = Σ_i λ_i p_i(w|t) (weighted mixture; the reference's joint
    probability with normalized weights), or the word-wise maximum
    approximation p(w|t) = max_i p_i(w|t)."""
    if not fcns:
        return []
    n = len(fcns)
    if weights is None:
        weights = [1.0 / n] * n
    else:
        z = sum(weights)
        weights = [w / z for w in weights]
    T = max(len(f) for f in fcns)
    out: List[Dict[int, float]] = []
    for t in range(T):
        row: Dict[int, float] = {}
        for i, f in enumerate(fcns):
            if t >= len(f):
                continue
            for w, p in f[t].items():
                if max_approx:
                    row[w] = max(row.get(w, 0.0), p)
                else:
                    row[w] = row.get(w, 0.0) + weights[i] * p
        out.append(row)
    return out


def concatenate_fcns(fcns: Sequence[Sequence[Dict[int, float]]],
                     ) -> List[Dict[int, float]]:
    """`concatenate-fCNs`: time-concatenate per-segment fCNs of one
    recording."""
    out: List[Dict[int, float]] = []
    for f in fcns:
        out.extend(dict(row) for row in f)
    return out


# -- oracle alignment (ConfusionNetwork.cc oracle-alignment) ------------------

def oracle_align_cn(slots: Sequence[CnSlot], reference: Sequence[int],
                    cost: str = "oracle-error", alpha: float = 1.0,
                    ) -> Tuple[List[Tuple[int, int]], float]:
    """Align a reference word sequence to CN slots.

    Cost functions (the reference's registration help):
      oracle-error:          0 if word in slot else 1
      weighted-oracle-error: rank(word in slot)**alpha, else 100
      oracle-loss:           1 − p(word|slot) if word in slot, else 100

    A slot may consume one reference word or ε (cost = 0 for skipping a
    slot whose best entry is ε-compatible — here: skipping a slot is
    free w.r.t. oracle error, matching 'minimum oracle error as primary
    criterion'); a reference word not aligned to any slot costs 1
    (deletion). Returns ([(slot_index, ref_word)|(-1, ref_word) ...],
    total cost); rows with slot −1 are deletions; skipped slots are not
    listed.
    """
    S, R = len(slots), len(reference)
    BIG = 100.0

    def slot_cost(i: int, w: int) -> float:
        s = slots[i]
        if cost == "oracle-error":
            return 0.0 if w in s.probs else 1.0
        order = sorted(s.probs.items(), key=lambda kv: -kv[1])
        pos = next((k for k, (ww, _p) in enumerate(order) if ww == w), None)
        if cost == "weighted-oracle-error":
            return float(pos) ** alpha if pos is not None else BIG
        if cost == "oracle-loss":
            return 1.0 - s.probs[w] if w in s.probs else BIG
        raise ValueError(f"unknown oracle cost {cost!r}")

    D = np.full((S + 1, R + 1), np.inf)
    D[0, 0] = 0.0
    back = np.zeros((S + 1, R + 1), np.int8)     # 1=diag 2=skip-slot 3=del
    for i in range(S + 1):
        for r in range(R + 1):
            c = D[i, r]
            if not np.isfinite(c):
                continue
            if i < S and r < R:
                nc = c + slot_cost(i, reference[r])
                if nc < D[i + 1, r + 1]:
                    D[i + 1, r + 1] = nc
                    back[i + 1, r + 1] = 1
            if i < S and c < D[i + 1, r]:        # skip slot (ε)
                D[i + 1, r] = c
                back[i + 1, r] = 2
            if r < R and c + 1.0 < D[i, r + 1]:  # reference deletion
                D[i, r + 1] = c + 1.0
                back[i, r + 1] = 3
    rows: List[Tuple[int, int]] = []
    i, r = S, R
    while i > 0 or r > 0:
        mv = back[i, r]
        if mv == 1:
            rows.append((i - 1, reference[r - 1]))
            i, r = i - 1, r - 1
        elif mv == 2:
            i -= 1
        else:
            rows.append((-1, reference[r - 1]))
            r -= 1
    rows.reverse()
    return rows, float(D[S, R])


# -- CN / fCN features (ConfusionNetwork.cc, TimeframeConfusionNetwork.cc) ----

def _arc_slot(slots: Sequence[CnSlot], a: Arc, lat: WordLattice) -> int:
    """Slot index an arc falls into: the slot whose span covers the
    arc's center time (ties → nearest center)."""
    c = 0.5 * (lat.time_of(a.start) + lat.time_of(a.end))
    best, bd = -1, np.inf
    for i, s in enumerate(slots):
        d = abs(s.center - c)
        if s.start <= c < max(s.end, s.start + 1):
            return i
        if d < bd:
            best, bd = i, d
    return best


def cn_features(lat: WordLattice, slots: Sequence[CnSlot],
                feature: str = "confidence",
                oracle: Optional[Sequence[int]] = None,
                eps_threshold: float = 1.0) -> Dict[Arc, float]:
    """`CN-features`: per-arc values derived from a CN.

    confidence:   p(arc word | its slot)
    score:        −log confidence
    entropy:      entropy of the normalized slot distribution
    slot:         index of the slot the arc falls into
    non-eps-slot: like slot, but slots with ε mass ≥ eps_threshold are
                  not counted (arcs over them get −1)
    cost:         0 if the oracle label of the slot equals the arc
                  label, else 1 (requires `oracle` reference)
    """
    out: Dict[Arc, float] = {}
    oracle_rows: Dict[int, int] = {}
    if oracle is not None:
        rows, _c = oracle_align_cn(slots, oracle)
        oracle_rows = {i: w for i, w in rows if i >= 0}
    non_eps_index: Dict[int, int] = {}
    k = 0
    for i, s in enumerate(slots):
        if s.eps_prob() < eps_threshold:
            non_eps_index[i] = k
            k += 1
    for a in lat.arcs:
        i = _arc_slot(slots, a, lat)
        if i < 0:
            out[a] = float("nan")
            continue
        s = slots[i]
        if feature == "confidence":
            out[a] = s.probs.get(a.word, 0.0)
        elif feature == "score":
            out[a] = -math.log(max(s.probs.get(a.word, 0.0), 1e-300))
        elif feature == "entropy":
            z = sum(s.probs.values()) + s.eps_prob()
            ent = 0.0
            for p in list(s.probs.values()) + [s.eps_prob()]:
                if p > 0 and z > 0:
                    q = p / z
                    ent -= q * math.log(q)
            out[a] = ent
        elif feature == "slot":
            out[a] = float(i)
        elif feature == "non-eps-slot":
            out[a] = float(non_eps_index.get(i, -1))
        elif feature == "cost":
            out[a] = 0.0 if oracle_rows.get(i) == a.word else 1.0
        else:
            raise ValueError(f"unknown CN feature {feature!r}")
    return out


def fcn_features(lat: WordLattice, pcn: Sequence[Dict[int, float]],
                 feature: str = "confidence",
                 alpha: float = 0.05) -> Dict[Arc, float]:
    """`fCN-features`: per-arc values from a frame-wise posterior CN.

    confidence: Frank Wessel's confidence — the average frame posterior
                of the arc's label over its span.
    error:      smoothed expected time-frame error
                Σ_t (1 − (1−alpha)·p_t(w) − alpha·[p_t(w) > 0]);
                alpha = 0 gives the unsmoothed expected error.
    """
    out: Dict[Arc, float] = {}
    for a in lat.arcs:
        t0, t1 = lat.time_of(a.start), lat.time_of(a.end)
        span = range(min(t0, len(pcn)), min(t1, len(pcn)))
        n = max(1, len(span))
        if feature == "confidence":
            out[a] = sum(pcn[t].get(a.word, 0.0) for t in span) / n
        elif feature == "error":
            e = 0.0
            for t in span:
                p = pcn[t].get(a.word, 0.0)
                e += 1.0 - (1.0 - alpha) * p - (alpha if p > 0 else 0.0)
            out[a] = e
        else:
            raise ValueError(f"unknown fCN feature {feature!r}")
    return out


# -- fWER (TimeframeError.cc semantics) ---------------------------------------

def _frame_labels(lat: WordLattice, T: Optional[int] = None) -> List[int]:
    """Per-frame labels of a LINEAR lattice (silence → silence label)."""
    T = lat.num_frames if T is None else T
    lab = [lat.silence] * T
    for a in lat.arcs:
        for t in range(lat.time_of(a.start), min(lat.time_of(a.end), T)):
            lab[t] = a.word
    return lab


def fwer(hyp: WordLattice, ref=None,
         ref_fcn: Optional[Sequence[Dict[int, float]]] = None,
         alpha: float = 0.0) -> Tuple[float, int]:
    """`fWER-evaluator`: (expected) time-frame error of a linear
    hypothesis lattice.

    Against a linear reference lattice: # frames whose labels differ.
    Against a reference fCN: expected smoothed error
    Σ_t (1 − (1−alpha)·p_t(hyp_t) − alpha·[p_t(hyp_t) > 0]).
    Returns (error, frame count).
    """
    if ref_fcn is not None:
        T = min(hyp.num_frames, len(ref_fcn))
        lab = _frame_labels(hyp, T)
        err = 0.0
        for t in range(T):
            p = ref_fcn[t].get(lab[t], 0.0)
            err += 1.0 - (1.0 - alpha) * p - (alpha if p > 0 else 0.0)
        return err, T
    T = min(hyp.num_frames, ref.num_frames)
    h, r = _frame_labels(hyp, T), _frame_labels(ref, T)
    return float(sum(1 for t in range(T) if h[t] != r[t])), T


# -- aligner (NodeRegistration `aligner`) -------------------------------------

def align_hypothesis(hyp_words: Sequence[int], ref_lat: WordLattice,
                     ref_fcn: Optional[Sequence[Dict[int, float]]] = None,
                     intersection: bool = True,
                     ) -> List[Tuple[int, int, int]]:
    """Align a linear hypothesis against a reference lattice (by
    intersection) or, if the intersection is empty, against the
    reference fCN (time-alignment DP maximizing frame posterior mass).
    Returns [(word, start_frame, end_frame), ...]."""
    from .flf import compose_linear

    if intersection:
        score, path = compose_linear(
            ref_lat, [w for w in hyp_words if w != ref_lat.silence])
        if path:
            return [(w, s, e) for (s, e, w) in path]
    if ref_fcn is None:
        _post = fwdbwd_posteriors(ref_lat)
        ref_fcn = frame_posterior_cn(ref_lat, _post)
    # DP: assign each hyp word a contiguous span maximizing Σ log p
    T, H = len(ref_fcn), len(hyp_words)
    if H == 0 or T == 0:
        return []
    NEG = -1e30
    gain = np.full((H, T), NEG)
    for i, w in enumerate(hyp_words):
        for t in range(T):
            gain[i, t] = math.log(max(ref_fcn[t].get(w, 0.0), 1e-12))
    D = np.full((H + 1, T + 1), NEG)
    D[0, 0] = 0.0
    back2 = np.zeros((H + 1, T + 1), np.int32)
    for i in range(1, H + 1):
        for t in range(i, T - (H - i) + 1):
            # word i−1 spans (t0, t]
            for t0 in range(i - 1, t):
                v = D[i - 1, t0] + float(gain[i - 1, t0:t].sum())
                if v > D[i, t]:
                    D[i, t] = v
                    back2[i, t] = t0
    rows: List[Tuple[int, int, int]] = []
    t = T
    for i in range(H, 0, -1):
        t0 = int(back2[i, t])
        rows.append((hyp_words[i - 1], t0, t))
        t = t0
    rows.reverse()
    return rows


# -- state-cluster CN builder (StateClusterConfusionNetworkBuilder.cc) --------

def state_cluster_cn(lat: WordLattice,
                     silence_as_eps: bool = True) -> List[CnSlot]:
    """`state-cluster-CN-builder`: build state clusters first, deduce
    arc clusters from them.

    Construction: (1) pinch points — times t no arc crosses — cut the
    lattice into independent intervals (state clusters in time order);
    (2) within an interval, an arc's slot index is its depth = the
    maximum number of word arcs preceding it on any path from the
    interval start (arcs at equal depth form one arc cluster / slot);
    (3) slot distributions are posterior-weighted; paths passing a slot
    with fewer arcs contribute ε mass implicitly (mass deficit).
    """
    _post = fwdbwd_posteriors(lat)
    arcs = [a for a in lat.arcs if np.isfinite(_post[a])]
    if not arcs:
        return []
    prob = {a: math.exp(-_post[a]) for a in arcs}
    T = lat.num_frames
    crossing = np.zeros(T + 1, dtype=np.int64)
    for a in arcs:
        for t in range(a.start + 1, a.end):
            crossing[t] += 1
    pinches = [0] + [t for t in range(1, T) if crossing[t] == 0] + [T]
    pinches = sorted(set(pinches))

    # depth DP per interval: depth(node) = max word-arcs from interval
    # start; arc slot = depth(arc.start) within its interval
    slots_out: List[CnSlot] = []
    by_start = {}
    for a in arcs:
        by_start.setdefault(a.start, []).append(a)
    for lo, hi in zip(pinches[:-1], pinches[1:]):
        depth: Dict[int, int] = {lo: 0}
        for node in range(lo, hi):
            if node not in depth:
                continue
            for a in by_start.get(node, []):
                if a.end > hi:
                    continue
                inc = 0 if (silence_as_eps and a.word == lat.silence) else 1
                d = depth[node] + inc
                if d > depth.get(a.end, -1):
                    depth[a.end] = d
        n_slots = max(depth.values(), default=0)
        if n_slots == 0:
            continue
        islots = [CnSlot(start=lo, end=hi) for _ in range(n_slots)]
        for a in arcs:
            if a.start < lo or a.end > hi:
                continue
            if silence_as_eps and a.word == lat.silence:
                continue
            k = min(depth.get(a.start, 0), n_slots - 1)
            islots[k].probs[a.word] = (islots[k].probs.get(a.word, 0.0)
                                       + prob[a])
            islots[k].start = min(islots[k].start, a.start)
            islots[k].end = max(islots[k].end, a.end)
        slots_out.extend(s for s in islots if s.probs)
    return slots_out
