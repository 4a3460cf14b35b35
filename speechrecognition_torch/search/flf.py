"""Lattice framework tier: HTK SLF IO, lattice archives, confusion
networks, system combination.

Counterpart of the reference's lattice tooling:
  * HTK SLF read/write — Lattice/HtkReader.cc / HtkWriter.cc
  * lattice archives    — Lattice/Archive.cc (ArchiveReader/Writer)
  * confusion networks  — Flf/CenterFrameConfusionNetworkBuilder.cc
  * system combination  — Flf union/CN combination pipeline
                          (Flf/Combination.cc, ROVER-style voting)

Lattice surgery is host-side runtime work here just as it is batch
tooling in the reference (the Flf processor runs offline over archives);
the per-arc posterior math reuses WordLattice.forward_backward.

Port: a copy of speechrecognition_tpu/search/flf.py (host code).
"""

from __future__ import annotations

import gzip
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .lattice import Arc, WordLattice


# -- HTK SLF ------------------------------------------------------------------

def write_slf(path: str, lat: WordLattice, vocab: Sequence[str],
              utterance: str = "", frame_duration: float = 0.01,
              lm_scale: float = 1.0, word_penalty: float = 0.0) -> None:
    """Write a word lattice as HTK Standard Lattice Format (the format
    Lattice/HtkWriter.cc emits).  Nodes are the distinct boundary frames;
    the combined arc score goes to the acoustic field `a=` (scores here
    are −log, HTK stores log-likelihoods, hence the sign flip)."""
    frames = sorted({0, lat.num_frames}
                    | {a.start for a in lat.arcs} | {a.end for a in lat.arcs})
    node_of = {t: i for i, t in enumerate(frames)}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("VERSION=1.0\n")
        if utterance:
            f.write(f"UTTERANCE={utterance}\n")
        f.write(f"lmscale={lm_scale:.2f} wdpenalty={word_penalty:.2f}\n")
        f.write(f"N={len(frames)}\tL={len(lat.arcs)}\n")
        for t in frames:
            f.write(f"I={node_of[t]}\tt={t * frame_duration:.2f}\n")
        for j, a in enumerate(lat.arcs):
            w = vocab[a.word] if 0 <= a.word < len(vocab) else f"w{a.word}"
            f.write(f"J={j}\tS={node_of[a.start]}\tE={node_of[a.end]}\t"
                    f"W={w}\ta={-a.score:.6f}\tl=0.000000\n")


def read_slf(path: str, vocab: Sequence[str],
             frame_duration: float = 0.01, silence: int = 0) -> WordLattice:
    """Read an HTK SLF file back into a WordLattice (HtkReader.cc)."""
    word_idx = {w: i for i, w in enumerate(vocab)}
    node_time: Dict[int, float] = {}
    arcs: List[Arc] = []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = dict(tok.split("=", 1) for tok in line.split()
                          if "=" in tok)
            if "I" in fields:
                node_time[int(fields["I"])] = float(fields.get("t", 0.0))
            elif "J" in fields:
                start = int(round(node_time[int(fields["S"])] / frame_duration))
                end = int(round(node_time[int(fields["E"])] / frame_duration))
                score = -float(fields.get("a", 0.0)) - float(fields.get("l", 0.0))
                w = fields["W"]
                arcs.append(Arc(start=start, end=end,
                                word=word_idx.get(w, -1), score=score))
    num_frames = int(round(max(node_time.values()) / frame_duration)) \
        if node_time else 0
    return WordLattice(num_frames=num_frames, arcs=arcs, silence=silence)


def write_slf_context(path: str, lat, vocab: Sequence[str],
                      utterance: str = "", frame_duration: float = 0.01,
                      lm_scale: float = 1.0) -> None:
    """SLF for a ContextLattice: nodes are (frame, context-word) pairs
    (HTK allows several nodes per time), arcs carry separate acoustic
    ``a=`` and language-model ``l=`` fields so LM rescoring survives the
    round trip (HtkWriter.cc emits the same split)."""
    from .context_lattice import ContextLattice

    assert isinstance(lat, ContextLattice)
    nodes = lat.nodes()
    node_of = {n: i for i, n in enumerate(nodes)}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("VERSION=1.0\n")
        if utterance:
            f.write(f"UTTERANCE={utterance}\n")
        f.write(f"lmscale={lm_scale:.2f} wdpenalty=0.00\n")
        f.write(f"# num_frames={lat.num_frames} num_contexts="
                f"{lat.num_contexts} silence={lat.silence}\n")
        f.write(f"N={len(nodes)}\tL={len(lat.arcs)}\n")
        for (t, c), i in node_of.items():
            f.write(f"I={i}\tt={t * frame_duration:.2f}\tc={c}\n")
        for j, a in enumerate(lat.arcs):
            w = vocab[a.word] if 0 <= a.word < len(vocab) else f"w{a.word}"
            f.write(f"J={j}\tS={node_of[(a.start, a.pred)]}\t"
                    f"E={node_of[(a.end, a.word)]}\tW={w}\t"
                    f"a={-a.am:.6f}\tl={-a.lm:.6f}\n")


def read_slf_context(path: str, vocab: Sequence[str],
                     frame_duration: float = 0.01):
    """Read a context lattice written by write_slf_context."""
    from .context_lattice import CArc, ContextLattice

    word_idx = {w: i for i, w in enumerate(vocab)}
    node: Dict[int, Tuple[int, int]] = {}
    arcs: List[CArc] = []
    meta = {"num_frames": 0, "num_contexts": len(vocab) + 1, "silence": 0}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                for tok in line[1:].split():
                    if "=" in tok:
                        k, v = tok.split("=", 1)
                        if k in meta:
                            meta[k] = int(v)
                continue
            if not line:
                continue
            fields = dict(tok.split("=", 1) for tok in line.split()
                          if "=" in tok)
            if "I" in fields:
                t = int(round(float(fields.get("t", 0.0)) / frame_duration))
                node[int(fields["I"])] = (t, int(fields.get("c", 0)))
            elif "J" in fields:
                s_t, s_c = node[int(fields["S"])]
                e_t, e_c = node[int(fields["E"])]
                arcs.append(CArc(
                    start=s_t, pred=s_c, end=e_t,
                    word=word_idx.get(fields["W"], e_c),
                    am=-float(fields.get("a", 0.0)),
                    lm=-float(fields.get("l", 0.0))))
    return ContextLattice(num_frames=meta["num_frames"],
                          num_contexts=meta["num_contexts"],
                          arcs=arcs, silence=meta["silence"])


# -- Fsa-backed lattice surgery -------------------------------------------------
# The reference keeps lattices as Fsa pairs (Lattice/Lattice.hh) so every
# Fsa op is a lattice op; the same bridge here: WordLattice ↔ fsa.Automaton.


def push_lattice(lat: WordLattice) -> WordLattice:
    """Weight pushing toward the initial node (Fsa push / Flf push op):
    arc scores are re-potentialized with backward distances, path scores
    unchanged. Topology is preserved, so the result maps back 1:1."""
    from ..fsa.ops import from_word_lattice, push

    if not lat.arcs:
        return lat
    a = from_word_lattice(lat)
    b = push(a)
    arcs = [Arc(start=int(b.src[i]), end=int(b.dst[i]),
                word=int(b.ilabel[i]), score=float(b.weight[i]))
            for i in range(b.num_arcs)]
    return WordLattice(num_frames=lat.num_frames, arcs=arcs,
                       silence=lat.silence)


def compose_linear(lat: WordLattice, words: Sequence[int],
                   ) -> Tuple[float, List[Tuple[int, int, int]]]:
    """Intersect the lattice with a linear word-sequence acceptor (the
    Flf compose op against a transcript grammar — the numerator machine
    of lattice-based discriminative training, Lattice/Rescore.cc /
    AccuracyFsaBuilder). Silence arcs pass freely between words.

    Returns (best path score, [(start, end, word)]) or (inf, []) when the
    transcript is not in the lattice."""
    INF = float("inf")
    sil = lat.silence
    n = len(words)
    # DP over (frame-node, transcript position)
    best: Dict[Tuple[int, int], float] = {(0, 0): 0.0}
    back: Dict[Tuple[int, int], Tuple[Tuple[int, int], Arc]] = {}
    for t in range(1, lat.num_frames + 1):
        for a in lat.by_end().get(t, []):
            for (ft, pos), sc in [((a.start, p), best.get((a.start, p), INF))
                                  for p in range(n + 1)]:
                if sc == INF:
                    continue
                if a.word == sil:
                    npos = pos
                elif pos < n and a.word == words[pos]:
                    npos = pos + 1
                else:
                    continue
                cand = sc + a.score
                key = (t, npos)
                if cand < best.get(key, INF):
                    best[key] = cand
                    back[key] = ((a.start, pos), a)
    key = (lat.num_frames, n)
    if key not in best:
        return INF, []
    path: List[Tuple[int, int, int]] = []
    while key in back:
        (pk, a) = back[key]
        path.append((a.start, a.end, a.word))
        key = pk
    path.reverse()
    return best[(lat.num_frames, n)], path


# -- lattice archives ----------------------------------------------------------

class LatticeArchive:
    """Directory archive of SLF lattices with an index file — the role of
    Lattice/Archive.cc's ArchiveReader/ArchiveWriter (one lattice per
    corpus segment, addressed by full segment name)."""

    INDEX = "archive.index"

    def __init__(self, path: str, vocab: Sequence[str],
                 frame_duration: float = 0.01, context: bool = False):
        """``context=True`` stores ContextLattices (predecessor-labelled
        nodes, split am/lm arc fields) instead of plain WordLattices."""
        self.path = path
        self.vocab = list(vocab)
        self.frame_duration = frame_duration
        self.context = context
        os.makedirs(path, exist_ok=True)

    def _file(self, name: str) -> str:
        return os.path.join(self.path, name.replace("/", "_") + ".slf.gz")

    def write(self, name: str, lat) -> None:
        if self.context:
            write_slf_context(self._file(name), lat, self.vocab,
                              utterance=name,
                              frame_duration=self.frame_duration)
        else:
            write_slf(self._file(name), lat, self.vocab, utterance=name,
                      frame_duration=self.frame_duration)
        with open(os.path.join(self.path, self.INDEX), "a") as f:
            f.write(name + "\n")

    def read(self, name: str, silence: int = 0):
        if self.context:
            return read_slf_context(self._file(name), self.vocab,
                                    frame_duration=self.frame_duration)
        return read_slf(self._file(name), self.vocab,
                        frame_duration=self.frame_duration, silence=silence)

    def list(self) -> List[str]:
        idx = os.path.join(self.path, self.INDEX)
        if not os.path.exists(idx):
            return []
        with open(idx) as f:
            return [l.strip() for l in f if l.strip()]


# -- confusion networks ---------------------------------------------------------

@dataclass
class CnSlot:
    start: int
    end: int
    probs: Dict[int, float] = field(default_factory=dict)  # word → posterior

    @property
    def center(self) -> float:
        return 0.5 * (self.start + self.end)

    def eps_prob(self) -> float:
        return max(0.0, 1.0 - sum(self.probs.values()))

    def best(self) -> Tuple[int, float]:
        """(word, prob); word −1 = epsilon (deletion wins)."""
        w, p = max(self.probs.items(), key=lambda kv: kv[1])
        eps = self.eps_prob()
        return (-1, eps) if eps > p else (w, p)


def confusion_network(lat: WordLattice,
                      silence_as_eps: bool = True) -> List[CnSlot]:
    """Center-frame confusion network construction
    (Flf/CenterFrameConfusionNetworkBuilder.cc): repeatedly take the
    unassigned arc with the highest posterior, open a slot at its center
    frame, and assign every unassigned arc overlapping that frame to the
    slot.  Slots are ordered by center time; silence arcs contribute to
    the slot's epsilon mass."""
    _, post = lat.forward_backward()
    arcs = [a for a in lat.arcs if np.isfinite(post[a])]
    prob = {a: math.exp(-post[a]) for a in arcs}
    unassigned = set(range(len(arcs)))
    slots: List[CnSlot] = []
    order = sorted(unassigned, key=lambda i: (-prob[arcs[i]], arcs[i].start))
    for i in order:
        if i not in unassigned:
            continue
        pivot = arcs[i]
        center = 0.5 * (pivot.start + pivot.end)
        slot = CnSlot(start=pivot.start, end=pivot.end)
        for j in sorted(unassigned):
            a = arcs[j]
            if a.start < center < a.end or (a.start == a.end == center):
                word = a.word
                if silence_as_eps and word == lat.silence:
                    continue  # silence mass stays epsilon
                slot.probs[word] = slot.probs.get(word, 0.0) + prob[a]
                unassigned.discard(j)
        unassigned.discard(i)
        if slot.probs:
            slots.append(slot)
    slots.sort(key=lambda s: (s.center, s.start))
    return slots


def cn_decode(slots: Sequence[CnSlot]) -> List[int]:
    """Consensus decoding: per-slot argmax posterior, epsilon slots
    dropped (Flf CN decoder semantics)."""
    out = []
    for s in slots:
        w, _p = s.best()
        if w >= 0:
            out.append(w)
    return out


def combine_confusion_networks(systems: Sequence[Sequence[CnSlot]],
                               weights: Optional[Sequence[float]] = None,
                               ) -> List[CnSlot]:
    """ROVER-style system combination over confusion networks
    (Flf combination pipeline): greedily align slots across systems by
    center-time overlap, then sum system-weighted word posteriors."""
    if weights is None:
        weights = [1.0 / max(1, len(systems))] * len(systems)
    pool: List[Tuple[float, int, CnSlot]] = []
    for sys_i, slots in enumerate(systems):
        for s in slots:
            pool.append((s.center, sys_i, s))
    pool.sort(key=lambda x: (x[0], x[1]))

    combined: List[CnSlot] = []
    used_by: List[set] = []
    for center, sys_i, s in pool:
        target = None
        for k, c in enumerate(combined):
            # one slot per system per combined slot; require overlap
            if sys_i in used_by[k]:
                continue
            if s.start < c.end and c.start < s.end:
                target = k
                break
        if target is None:
            combined.append(CnSlot(start=s.start, end=s.end))
            used_by.append(set())
            target = len(combined) - 1
        c = combined[target]
        c.start = min(c.start, s.start)
        c.end = max(c.end, s.end)
        used_by[target].add(sys_i)
        for w, p in s.probs.items():
            c.probs[w] = c.probs.get(w, 0.0) + weights[sys_i] * p
    combined.sort(key=lambda s: (s.center, s.start))
    return combined


# -- lattice-level structural ops (Flf/FlfCore breadth) -----------------------


def _logadd(a: float, b: float) -> float:
    if math.isinf(a):
        return b
    if math.isinf(b):
        return a
    m = min(a, b)
    return m - math.log1p(math.exp(-abs(a - b)))


def union_lattices(lats: Sequence[WordLattice]) -> WordLattice:
    """Flf union (sum semiring): one lattice containing every input's
    paths over the same audio. Arcs sharing (start, end, word) merge by
    log-add, so each merged arc carries the summed path mass."""
    if not lats:
        raise ValueError("union of zero lattices")
    T = max(l.num_frames for l in lats)
    if any(l.num_frames != T for l in lats):
        raise ValueError("union requires lattices over the same frames "
                         f"({sorted(set(l.num_frames for l in lats))})")
    merged: Dict[Tuple[int, int, int], float] = {}
    for l in lats:
        for a in l.arcs:
            key = (a.start, a.end, a.word)
            merged[key] = _logadd(merged.get(key, math.inf), a.score)
    arcs = [Arc(s, e, w, sc) for (s, e, w), sc in sorted(merged.items())]
    return WordLattice(num_frames=T, arcs=arcs, silence=lats[0].silence)


def trim_lattice(lat: WordLattice) -> WordLattice:
    """Connectivity trim (Flf trim / Fsa::trim): keep only arcs on some
    complete path from frame 0 to the final frame."""
    fwd_ok = {0}
    for a in sorted(lat.arcs, key=lambda a: a.end):
        if a.start in fwd_ok:
            fwd_ok.add(a.end)
    bwd_ok = {lat.num_frames}
    for a in sorted(lat.arcs, key=lambda a: -a.start):
        if a.end in bwd_ok:
            bwd_ok.add(a.start)
    arcs = [a for a in lat.arcs if a.start in fwd_ok and a.end in bwd_ok]
    return WordLattice(num_frames=lat.num_frames, arcs=arcs,
                       silence=lat.silence, times=lat.times)


def mesh_lattice(lat: WordLattice) -> WordLattice:
    """Flf mesh: the time-skeleton lattice — arcs deduplicated by
    (boundary frames, word) with log-added mass, then connectivity
    trimmed. Since WordLattice nodes ARE frames, meshing is exactly this
    projection (every arc becomes connectable at its shared boundary
    times)."""
    return trim_lattice(union_lattices([lat]))


def determinize_lattice(lat: WordLattice):
    """Determinize the lattice's word acceptor (Fsa determinize over the
    tropical semiring; the bridge is fsa.ops.from_word_lattice, mirroring
    the reference's lattices-are-Fsa-pairs design, Lattice/Lattice.hh):
    the result accepts each word sequence once, with its best (min)
    lattice score."""
    from ..fsa.ops import determinize, from_word_lattice

    return determinize(from_word_lattice(trim_lattice(lat)))


def minimize_lattice(lat: WordLattice):
    """Determinize + minimize the lattice's word acceptor."""
    from ..fsa.ops import minimize

    return minimize(determinize_lattice(lat))


def pivot_confusion_network(lat: WordLattice,
                            silence_as_eps: bool = True) -> List[CnSlot]:
    """Pivot-path confusion network (Flf/PivotConfusionNetworkBuilder):
    the 1-best path is the slot skeleton; every remaining arc joins the
    skeleton slot with the largest time overlap (ties → earlier slot).
    Complements `confusion_network` (the center-frame builder)."""
    _, post = lat.forward_backward()
    # recover the best path's arcs (the slot skeleton) by lattice Viterbi
    skeleton: List[CnSlot] = []
    best_cost = {0: 0.0}
    best_arc: Dict[int, Arc] = {}
    for a in sorted(lat.arcs, key=lambda a: a.end):
        if a.start not in best_cost:
            continue
        c = best_cost[a.start] + a.score
        if a.end not in best_cost or c < best_cost[a.end]:
            best_cost[a.end] = c
            best_arc[a.end] = a
    path: List[Arc] = []
    t = lat.num_frames
    while t > 0 and t in best_arc:
        a = best_arc[t]
        path.append(a)
        t = a.start
    path.reverse()
    prob = {a: math.exp(-p) for a, p in post.items() if np.isfinite(p)}
    for a in path:
        slot = CnSlot(start=a.start, end=a.end)
        if not (silence_as_eps and a.word == lat.silence):
            slot.probs[a.word] = prob.get(a, 0.0)
        skeleton.append(slot)
    on_path = set(path)
    for a in sorted(prob, key=lambda a: (a.start, a.end, a.word)):
        if a in on_path:
            continue
        best_k, best_ov = None, -1.0
        for k, s in enumerate(skeleton):
            ov = min(a.end, s.end) - max(a.start, s.start)
            if ov > best_ov:
                best_k, best_ov = k, ov
        if best_k is None or best_ov <= 0:
            continue
        if silence_as_eps and a.word == lat.silence:
            continue
        s = skeleton[best_k]
        s.probs[a.word] = s.probs.get(a.word, 0.0) + prob[a]
    return [s for s in skeleton if s.probs]


def rescore_arpa(clat, lm, vocab: Sequence[str], scale: float = 1.0,
                 silence: Optional[int] = None) -> Tuple[List[int], float]:
    """Exact lattice rescoring with an ARPA back-off n-gram LM
    (Lm/ArpaLm.cc + Flf rescoring networks): Viterbi over the context
    lattice with full n-gram histories as search states (histories are
    expanded on demand — the lattice's bigram contexts impose no limit).
    Arc acoustic scores are reused exactly; LM scores are
    scale · (−ln P(word | history)), silence arcs LM-free (the decoders'
    silence exemption). Returns (best word sequence, total score)."""
    silence = clat.silence if silence is None else silence
    # states: (frame, word-at-node, history tuple of the last order−1
    # words) — histories are truncated to the LM order so the expansion
    # stays polynomial (the standard n-gram lattice expansion)
    keep = max(lm.order - 1, 1)
    start = (0, clat.start_context, ("<s>",))
    best: Dict[Tuple, float] = {start: 0.0}
    back: Dict[Tuple, Tuple[Optional[Tuple], Optional[int]]] = {start: (None, None)}
    arcs_by_src: Dict[Tuple[int, int], List] = {}
    for a in clat.arcs:
        arcs_by_src.setdefault((a.start, a.pred), []).append(a)
    frontier = [start]
    while frontier:
        nxt = []
        for st in frontier:
            t, node_word, hist = st
            base = best[st]
            for a in arcs_by_src.get((t, node_word), []):
                if a.word == silence:
                    lm_cost, h2 = 0.0, hist
                else:
                    lm_cost = scale * lm.score(
                        lm.index(vocab[a.word]),
                        tuple(lm.index(h) if isinstance(h, str) else h
                              for h in hist))
                    h2 = (hist + (vocab[a.word],))[-keep:]
                dst = (a.end, a.word, h2)
                c = base + a.am + lm_cost
                if dst not in best or c < best[dst] - 1e-12:
                    best[dst] = c
                    back[dst] = (st, a.word)
                    nxt.append(dst)
        frontier = nxt
    finals = [(c + scale * lm.score(lm.index("</s>"),
                                    tuple(lm.index(h) if isinstance(h, str)
                                          else h for h in st[2])), st)
              for st, c in best.items() if st[0] == clat.num_frames]
    if not finals:
        return [], math.inf
    total, st = min(finals, key=lambda x: x[0])
    words: List[int] = []
    while st is not None:
        prev, w = back[st]
        if w is not None and w != silence:
            words.append(w)
        st = prev
    words.reverse()
    return words, total
