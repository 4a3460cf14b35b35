"""Flf lattice-processor NETWORK: a config-driven dataflow of lattice
operations, plus the posterior/MBR algorithms the nodes need.

Counterpart of the reference's Flf tool
(rwth-asr-0.5/src/Flf/Network.cc + NodeFactory.cc + NodeRegistration.hh):
the Flf binary parses `[network]` / `[network.<node>]` Sprint-config
blocks into a DAG of typed nodes connected by `links = [port->]name[:port]`
and pulls each segment's data through it. This module implements the
same model — SprintConfig blocks → node DAG → per-segment topological
evaluation — with a registry of node types mapped onto the framework's
lattice ops (search/flf.py, search/lattice.py), exactly as
`sprint/flow.py` does for the Flow feature networks.

Algorithms added here (the high-value Flf absentees):
  * lattice forward/backward posteriors   — Flf/FwdBwd.cc (FB-builder):
    arc −log posteriors + the frame-wise posterior CN (fCN): for every
    frame t, p_t(w) = Σ posteriors of w-labeled arcs covering t.
  * min-fWER / local-cost decoding        — Flf/LocalCostDecoder.cc:
    per-arc risk = expected frame errors against the fCN
    (frame-error risk builder); best path by DP over risks + word
    penalty. Decodes the MBR hypothesis under the local frame-error
    cost instead of the MAP path.
  * gamma correction                      — Flf/GammaCorrection.cc:
    the piecewise-power sharpening gammaCorrectionFunc (breakpoint 0.3)
    applied to CN slot or fCN frame distributions, optionally
    re-normalized.

Port: a copy of speechrecognition_tpu/search/flf_network.py (host code).
The one device path is the ``recognizer`` node: it scores on the network's
``device`` (the card unless the caller asks for the CPU) and decodes there
through ``ngram_decoder.decode_scan_bigram`` (kernel J on a CUDA device).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..sprint.config import SprintConfig
from .flf import (CnSlot, LatticeArchive, cn_decode, confusion_network,
                  determinize_lattice, mesh_lattice, minimize_lattice,
                  pivot_confusion_network, trim_lattice, union_lattices)
from .lattice import Arc, WordLattice


# -- posteriors (Flf/FwdBwd.cc) ----------------------------------------------

def fwdbwd_posteriors(lat: WordLattice) -> Dict[Arc, float]:
    """Arc −log posteriors by lattice forward/backward (FwdBwd.cc
    FwdBwdBuilder; the probability semiring sums live in
    WordLattice.forward_backward)."""
    _nodes, post = lat.forward_backward()
    return post


def frame_posterior_cn(lat: WordLattice,
                       post: Optional[Dict[Arc, float]] = None,
                       ) -> List[Dict[int, float]]:
    """Frame-wise posterior CN (the reference's fCN,
    Flf/ConfusionNetwork.hh PosteriorCn): pcn[t][word] = Σ posterior of
    word-labeled arcs covering frame t. Mass not covered by any arc at t
    is epsilon."""
    if post is None:
        post = fwdbwd_posteriors(lat)
    pcn: List[Dict[int, float]] = [dict() for _ in range(lat.num_frames)]
    for a in lat.arcs:
        p = post.get(a)
        if p is None or not np.isfinite(p):
            continue
        prob = math.exp(-p)
        for t in range(a.start, a.end):
            pcn[t][a.word] = pcn[t].get(a.word, 0.0) + prob
    return pcn


def arc_confidence(lat: WordLattice,
                   post: Optional[Dict[Arc, float]] = None,
                   ) -> Dict[Arc, float]:
    """Per-arc confidence = average frame posterior of the arc's own
    label over its span (Flf add-word-confidence semantics: the fCN
    smoothed confidence)."""
    if post is None:
        post = fwdbwd_posteriors(lat)
    pcn = frame_posterior_cn(lat, post)
    conf: Dict[Arc, float] = {}
    for a in lat.arcs:
        span = max(1, a.end - a.start)
        conf[a] = sum(pcn[t].get(a.word, 0.0)
                      for t in range(a.start, a.end)) / span
    return conf


# -- MBR / local-cost decoding (Flf/LocalCostDecoder.cc) ----------------------

def local_cost_decode(lat: WordLattice, word_penalty: float = 0.0,
                      silence_free: bool = True) -> Tuple[List[int], float]:
    """Minimum-expected-frame-error (min-fWER / local-cost) decoding.

    Risk of an arc = expected frame errors against the frame posterior
    CN:  Σ_{t ∈ span} (1 − p_t(label)) — the frame-error risk builder of
    LocalCostDecoder.cc (ArcSymetricFrameErrorRiskBuilder family); the
    word penalty discourages insertions exactly as the reference's
    paramWordPenalty. Returns (words incl. silence, total risk); DP over
    the lattice DAG picks the risk-minimal path instead of the MAP path.
    """
    post = fwdbwd_posteriors(lat)
    pcn = frame_posterior_cn(lat, post)
    risk: Dict[Arc, float] = {}
    for a in lat.arcs:
        if not np.isfinite(post.get(a, np.inf)):
            risk[a] = float("inf")
            continue
        r = sum(1.0 - pcn[t].get(a.word, 0.0) for t in range(a.start, a.end))
        if not (silence_free and a.word == lat.silence):
            r += word_penalty
        risk[a] = r

    T = lat.num_frames
    best = np.full(T + 1, np.inf)
    best[0] = 0.0
    back: List[Optional[Arc]] = [None] * (T + 1)
    by_end = lat.by_end()
    for t in range(1, T + 1):
        for a in by_end.get(t, []):
            if not np.isfinite(best[a.start]) or not np.isfinite(risk[a]):
                continue
            c = best[a.start] + risk[a]
            if c < best[t]:
                best[t] = c
                back[t] = a
    words: List[int] = []
    t = T
    while t > 0 and back[t] is not None:
        words.append(back[t].word)
        t = back[t].start
    words.reverse()
    return words, float(best[T])


# -- gamma correction (Flf/GammaCorrection.cc) --------------------------------

def gamma_correction_func(x: float, gamma: float, brpt: float = 0.3) -> float:
    """The reference's piecewise-power sharpening
    (GammaCorrection.cc:22-36): identity-anchored at the breakpoint,
    floored at 1e-12, clamped at 1."""
    if x >= 1.0:
        return 1.0
    if x > brpt:
        m = 1.0 - brpt
        y = (1.0 - (1.0 - (x - brpt) / m) ** gamma) * m + brpt
    else:
        y = (x / brpt) ** gamma * brpt
    return max(y, 1e-12)


def gamma_correct_cn(slots: Sequence[CnSlot], gamma: float,
                     normalize: bool = True) -> List[CnSlot]:
    """Gamma-correct CN slot posteriors (CN-gamma-correction node)."""
    if gamma == 1.0:
        return list(slots)
    out = []
    for s in slots:
        probs = {w: gamma_correction_func(p, gamma)
                 for w, p in s.probs.items()}
        if normalize:
            # epsilon mass participates in the re-normalization like any
            # other slot entry (PosteriorCn slots carry it explicitly)
            eps = gamma_correction_func(s.eps_prob(), gamma)
            z = sum(probs.values()) + eps
            probs = {w: p / z for w, p in probs.items()}
        out.append(CnSlot(start=s.start, end=s.end, probs=probs))
    return out


def gamma_correct_fcn(pcn: List[Dict[int, float]], gamma: float,
                      normalize: bool = True) -> List[Dict[int, float]]:
    """Gamma-correct a frame posterior CN (fCN-gamma-correction node)."""
    if gamma == 1.0:
        return pcn
    out = []
    for row in pcn:
        probs = {w: gamma_correction_func(p, gamma) for w, p in row.items()}
        if normalize:
            eps = gamma_correction_func(max(0.0, 1.0 - sum(row.values())),
                                        gamma)
            z = sum(probs.values()) + eps
            probs = {w: p / z for w, p in probs.items()}
        out.append(probs)
    return out


# -- the processor network ----------------------------------------------------

class Ports(dict):
    """Multi-output node result: {port → value}. A node returning Ports
    feeds links by their from-port (the reference's nodes expose
    multiple output ports the same way, e.g. dump-CN's 0:lattice
    1:CN 2:dummy)."""


MAX_PORTS = 16


@dataclass
class FlfNode:
    name: str
    type: str
    attrs: Dict[str, str]
    #: outgoing links: (from_port, target_node, to_port)
    links: List[Tuple[int, str, int]] = field(default_factory=list)


def _parse_link(spec: str) -> Tuple[int, str, int]:
    """`[port->]name[:port]` (Network.cc paramLinks)."""
    from_port = 0
    to_port = 0
    if "->" in spec:
        p, spec = spec.split("->", 1)
        from_port = int(p)
    if ":" in spec:
        spec, p = spec.rsplit(":", 1)
        to_port = int(p)
    return from_port, spec, to_port


class FlfNetwork:
    """Config-driven lattice-processor network.

    Blocks (the reference Flf tool's exact layout):

        [network]            initial-nodes = reader
        [network.reader]     type = archive-reader
                             path = /lattices  links = 0->fb:0
        [network.fb]         type = FB-builder  links = best sink

    Per segment, nodes evaluate in topological order; each node type is
    a function (inputs by port, attrs, ctx) → value. ``run(names)``
    drives the batch like the reference's speech-segment/batch nodes.

    ``device`` is where a ``recognizer`` node scores and decodes: the card
    unless the caller asks for the CPU (``device="cpu"``). Without a card
    such a node raises when it runs; the host nodes never touch a device.
    """

    def __init__(self, nodes: Dict[str, FlfNode], vocab: Sequence[str],
                 silence: int = 0, device="cuda"):
        self.nodes = nodes
        self.device = device
        self.vocab = list(vocab)
        self.word_idx = {w: i for i, w in enumerate(self.vocab)}
        self.silence = silence
        self._order = self._topo_order()
        self._archives: Dict[str, LatticeArchive] = {}
        #: evaluator transcript tables, parsed once per file per network
        self._refs_cache: Dict[str, Dict[str, List[int]]] = {}
        #: per-network caches for the heavier node resources (Bliss
        #: lexica/corpora, CTM tables, fsa files, ARPA LMs, CN/fCN
        #: archives, in-network recognizers)
        self._bliss_cache: Dict[str, object] = {}
        self._ctm_cache: Dict[str, object] = {}
        self._fsa_cache: Dict[str, object] = {}
        self._lm_cache: Dict[str, object] = {}
        self._archives_misc: Dict[str, object] = {}

    @staticmethod
    def parse(cfg: SprintConfig, vocab: Sequence[str], silence: int = 0,
              prefix: str = "network", device="cuda") -> "FlfNetwork":
        # discover nodes + attrs from `[<prefix>.<name>] key = value`;
        # values resolve through cfg.get so $(var) references work like
        # everywhere else in the config system
        attrs_of: Dict[str, Dict[str, str]] = {}
        for sel, _raw in cfg.items():
            if not sel.startswith(prefix + "."):
                continue
            rest = sel[len(prefix) + 1:]
            if "." not in rest:
                continue        # network-level param (initial-nodes, …)
            name, attr = rest.split(".", 1)
            attrs_of.setdefault(name, {})[attr] = cfg.get(sel)
        for n in (cfg.get(f"{prefix}.initial-nodes", "") or "").split():
            attrs_of.setdefault(n, {})
        nodes: Dict[str, FlfNode] = {}
        for n, attrs in sorted(attrs_of.items()):
            links = [_parse_link(s) for s in attrs.pop("links", "").split()]
            nodes[n] = FlfNode(name=n, type=attrs.pop("type", ""),
                               attrs=attrs, links=links)
        for n, node in nodes.items():
            for _fp, tgt, _tp in node.links:
                if tgt not in nodes:
                    raise ValueError(f"flf network: node {n} links to "
                                     f"unknown node {tgt!r}")
        return FlfNetwork(nodes, vocab, silence, device=device)

    def _topo_order(self) -> List[str]:
        indeg = {n: 0 for n in self.nodes}
        for node in self.nodes.values():
            for _fp, tgt, _tp in node.links:
                indeg[tgt] += 1
        order, queue = [], sorted(n for n, d in indeg.items() if d == 0)
        while queue:
            n = queue.pop(0)
            order.append(n)
            for _fp, tgt, _tp in self.nodes[n].links:
                indeg[tgt] -= 1
                if indeg[tgt] == 0:
                    queue.append(tgt)
        if len(order) != len(self.nodes):
            raise ValueError("flf network: cycle in node links")
        return order

    def _archive(self, path: str, context: bool = False) -> LatticeArchive:
        key = f"{path}|{context}"
        if key not in self._archives:
            self._archives[key] = LatticeArchive(path, self.vocab,
                                                 context=context)
        return self._archives[key]

    def run_segment(self, seg_id: str, out=sys.stdout,
                    args: Optional[Sequence[str]] = None,
                    ) -> Dict[str, object]:
        """Pull one segment through the network; returns every node's
        port-0 output by node name (sinks/writers return None)."""
        values: Dict[Tuple[str, int], object] = {}
        results: Dict[str, object] = {}
        ctx = {"id": seg_id, "net": self, "out": out,
               "args": list(args) if args else [seg_id], "device": self.device}
        for n in self._order:
            node = self.nodes[n]
            ins = {p: values.get((n, p)) for p in range(MAX_PORTS)
                   if (n, p) in values}
            fn = NODE_TYPES.get(node.type)
            if fn is None:
                raise ValueError(f"flf network: unknown node type "
                                 f"{node.type!r} (node {n})")
            val = fn(ins, node.attrs, ctx)
            results[n] = val[0] if isinstance(val, Ports) else val
            for fp, tgt, tp in node.links:
                if isinstance(val, Ports):
                    values[(tgt, tp)] = val.get(fp)
                else:
                    values[(tgt, tp)] = val if fp == 0 else None
        return results

    def run(self, seg_ids: Sequence[str], out=sys.stdout,
            ) -> Dict[str, Dict[str, object]]:
        """Batch run over segment ids (the reference's batch /
        speech-segment source nodes)."""
        return {sid: self.run_segment(sid, out=out) for sid in seg_ids}

    def run_batch_file(self, path: str, out=sys.stdout,
                       ) -> Dict[str, Dict[str, object]]:
        """Drive the network from a batch-list file: every line is an
        argument list whose first token is the segment id (the
        reference's `batch` node file mode)."""
        results = {}
        with open(path) as f:
            for line in f:
                args = line.split()
                if not args:
                    continue
                results[args[0]] = self.run_segment(args[0], out=out,
                                                    args=args)
        return results


# -- node catalog -------------------------------------------------------------

def _require(ins, port=0):
    v = ins.get(port)
    if v is None:
        raise ValueError("flf node: missing input")
    return v


def _as_lattice(v) -> WordLattice:
    """Unwrap a (lattice, posteriors) pair from FB-builder /
    add-word-confidence, or project a MultiLattice to its scalar view:
    every lattice-consuming node accepts a bare lattice, the annotated
    pair, or a keyed-dimension lattice (the reference's nodes pass
    lattices with attached score fields the same way)."""
    from .flf_rescore import MultiLattice

    if isinstance(v, tuple):
        v = v[0]
    if isinstance(v, MultiLattice):
        return v.view()
    return v


def n_archive_reader(ins, attrs, ctx):
    net: FlfNetwork = ctx["net"]
    arch = net._archive(attrs["path"],
                        attrs.get("context", "false") == "true")
    return arch.read(ctx["id"], silence=net.silence)


def n_archive_writer(ins, attrs, ctx):
    net: FlfNetwork = ctx["net"]
    net._archive(attrs["path"]).write(ctx["id"], _as_lattice(_require(ins)))
    return None


def n_copy(ins, attrs, ctx):
    return _require(ins)


def n_sink(ins, attrs, ctx):
    return ins.get(0)


def n_info(ins, attrs, ctx):
    lat: WordLattice = _as_lattice(_require(ins))
    print(f"{ctx['id']}\tframes={lat.num_frames}\tarcs={len(lat.arcs)}",
          file=ctx["out"])
    return lat


def n_best(ins, attrs, ctx):
    lat: WordLattice = _as_lattice(_require(ins))
    net: FlfNetwork = ctx["net"]
    words, score = lat.best_path()
    text = " ".join(net.vocab[w] for w in words if w != lat.silence and w >= 0)
    print(f"{ctx['id']}\t{score:.4f}\t{text}", file=ctx["out"])
    return words


def n_dump_n_best(ins, attrs, ctx):
    lat: WordLattice = _as_lattice(_require(ins))
    net: FlfNetwork = ctx["net"]
    n = int(attrs.get("n", "5"))
    rows = lat.n_best(n)
    for rank, (words, score) in enumerate(rows):
        text = " ".join(net.vocab[w] for w in words if w != lat.silence and w >= 0)
        print(f"{ctx['id']}\t{rank}\t{score:.4f}\t{text}", file=ctx["out"])
    return rows


def n_prune_posterior(ins, attrs, ctx):
    lat: WordLattice = _as_lattice(_require(ins))
    return lat.posterior_prune(float(attrs.get("threshold", "5")))


def n_fb_builder(ins, attrs, ctx):
    """FB-builder: annotate the lattice with forward/backward posteriors
    (carried alongside as (lat, posteriors))."""
    lat: WordLattice = _as_lattice(_require(ins))
    return (lat, fwdbwd_posteriors(lat))


def n_add_word_confidence(ins, attrs, ctx):
    v = _require(ins)
    lat, post = v if isinstance(v, tuple) else (v, None)
    return (lat, arc_confidence(lat, post))


def n_local_cost_decoder(ins, attrs, ctx):
    v = _require(ins)
    lat = _as_lattice(v)
    net: FlfNetwork = ctx["net"]
    words, risk = local_cost_decode(
        lat, word_penalty=float(attrs.get("word-penalty", "0")))
    text = " ".join(net.vocab[w] for w in words if w != lat.silence and w >= 0)
    print(f"{ctx['id']}\trisk={risk:.4f}\t{text}", file=ctx["out"])
    return [w for w in words if w != lat.silence and w >= 0]


n_min_fwer_decoder = n_local_cost_decoder     # min-fWER-decoder alias


def n_fcn_builder(ins, attrs, ctx):
    v = _require(ins)
    lat, post = v if isinstance(v, tuple) else (_as_lattice(v), None)
    return frame_posterior_cn(lat, post)


def n_cn_builder(ins, attrs, ctx):
    v = _require(ins)
    lat = _as_lattice(v)
    return confusion_network(lat)


def n_pivot_cn_builder(ins, attrs, ctx):
    v = _require(ins)
    lat = _as_lattice(v)
    return pivot_confusion_network(lat)


def n_cn_gamma(ins, attrs, ctx):
    return gamma_correct_cn(_require(ins), float(attrs.get("gamma", "1")),
                            attrs.get("normalize", "true") == "true")


def n_fcn_gamma(ins, attrs, ctx):
    return gamma_correct_fcn(_require(ins), float(attrs.get("gamma", "1")),
                             attrs.get("normalize", "true") == "true")


def n_cn_decoder(ins, attrs, ctx):
    slots = _require(ins)
    net: FlfNetwork = ctx["net"]
    words = cn_decode(slots)
    text = " ".join(net.vocab[w] for w in words if w != net.silence)
    print(f"{ctx['id']}\t{text}", file=ctx["out"])
    return words


def n_mesh(ins, attrs, ctx):
    return mesh_lattice(_as_lattice(_require(ins)))


def n_clean_up(ins, attrs, ctx):
    return trim_lattice(_as_lattice(_require(ins)))


def n_unite(ins, attrs, ctx):
    lats = [_as_lattice(v) for p, v in sorted(ins.items()) if v is not None]
    return union_lattices(lats)


def n_determinize(ins, attrs, ctx):
    return determinize_lattice(_as_lattice(_require(ins)))


def n_minimize(ins, attrs, ctx):
    return minimize_lattice(_as_lattice(_require(ins)))


def n_rescale(ins, attrs, ctx):
    lat: WordLattice = _as_lattice(_require(ins))
    scale = float(attrs.get("scale", "1"))
    arcs = [Arc(start=a.start, end=a.end, word=a.word, score=a.score * scale)
            for a in lat.arcs]
    return WordLattice(arcs=arcs, num_frames=lat.num_frames,
                       silence=lat.silence)


def n_concatenate(ins, attrs, ctx):
    """concatenate-lattices: input 1's lattice appended after input 0's
    in time (Flf/Concatenate.cc)."""
    a: WordLattice = _as_lattice(_require(ins, 0))
    b: WordLattice = _as_lattice(_require(ins, 1))
    off = a.num_frames
    arcs = list(a.arcs) + [Arc(start=x.start + off, end=x.end + off,
                               word=x.word, score=x.score) for x in b.arcs]
    return WordLattice(num_frames=a.num_frames + b.num_frames, arcs=arcs,
                       silence=a.silence)


def n_map_labels(ins, attrs, ctx):
    """map-labels: rewrite word ids via a `from:to from:to ...` map
    (Flf/Map.cc label mapping)."""
    lat: WordLattice = _as_lattice(_require(ins))
    mapping = {}
    for pair in attrs.get("map", "").split():
        f, t = pair.split(":")
        mapping[int(f)] = int(t)
    arcs = [Arc(start=a.start, end=a.end, word=mapping.get(a.word, a.word),
                score=a.score) for a in lat.arcs]
    return WordLattice(num_frames=lat.num_frames, arcs=arcs,
                       silence=lat.silence)


def n_filter(ins, attrs, ctx):
    """filter: drop arcs by score threshold and/or word list
    (Flf/Filter.cc family)."""
    lat: WordLattice = _as_lattice(_require(ins))
    max_score = float(attrs.get("max-score", "inf"))
    drop = {int(w) for w in attrs.get("drop-words", "").split()}
    arcs = [a for a in lat.arcs
            if a.score <= max_score and a.word not in drop]
    return WordLattice(num_frames=lat.num_frames, arcs=arcs,
                       silence=lat.silence)


def n_remove_null_arcs(ins, attrs, ctx):
    """remove-null-arcs: drop zero-duration arcs (Flf/RemoveNullArcs)."""
    lat: WordLattice = _as_lattice(_require(ins))
    arcs = [a for a in lat.arcs if a.end > a.start]
    return WordLattice(num_frames=lat.num_frames, arcs=arcs,
                       silence=lat.silence)


def n_properties(ins, attrs, ctx):
    """properties/info detail: arc/frame/density statistics line."""
    lat: WordLattice = _as_lattice(_require(ins))
    words = {a.word for a in lat.arcs}
    dens = len(lat.arcs) / max(1, lat.num_frames)
    print(f"{ctx['id']}\tframes={lat.num_frames}\tarcs={len(lat.arcs)}\t"
          f"words={len(words)}\tarcs/frame={dens:.2f}", file=ctx["out"])
    return lat


def n_dump_traceback(ins, attrs, ctx):
    """dump-traceback: best path with word boundaries (the reference's
    traceback channel format). One shortest-path DP serves both the
    words and their boundary frames."""
    lat: WordLattice = _as_lattice(_require(ins))
    net: FlfNetwork = ctx["net"]
    by_end = lat.by_end()
    back: Dict[int, Optional[Arc]] = {}
    costs = np.full(lat.num_frames + 1, np.inf)
    costs[0] = 0.0
    for tt in range(1, lat.num_frames + 1):
        for a in by_end.get(tt, []):
            c = costs[a.start] + a.score
            if c < costs[tt]:
                costs[tt] = c
                back[tt] = a
    rows = []
    t = lat.num_frames
    while t > 0 and back.get(t) is not None:
        a = back[t]
        rows.append((a.start, a.end, a.word))
        t = a.start
    for s, e, w in reversed(rows):
        print(f"{ctx['id']}\t{s}\t{e}\t"
              f"{net.vocab[w] if w < len(net.vocab) else w}",
              file=ctx["out"])
    return [w for _s, _e, w in reversed(rows)]


def n_evaluator(ins, attrs, ctx):
    """Edit-distance evaluation against a transcript table file
    (`<name>\\t<words>` rows — the Flf evaluator node against the Bliss
    orth)."""
    from .edit_distance import edit_distance

    hyp = _require(ins)
    if hyp and isinstance(hyp[0], CnSlot):
        hyp = cn_decode(hyp)
    net: FlfNetwork = ctx["net"]
    hyp = [w for w in hyp if w != net.silence and w >= 0]
    # transcript table parsed once per file per NETWORK (ctx is
    # per-segment, so a ctx-level cache would re-read on every segment)
    path = attrs["transcripts"]
    refs = net._refs_cache.get(path)
    if refs is None:
        refs = {}
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2:
                    refs[parts[0]] = [net.word_idx[w]
                                      for w in parts[1].split()
                                      if w in net.word_idx]
        net._refs_cache[path] = refs
    ref = refs.get(ctx["id"], [])
    ed = edit_distance(ref, hyp)
    print(f"{ctx['id']}\terrors={ed.total_count}\tref={len(ref)}",
          file=ctx["out"])
    return (ed.total_count, len(ref))


# -- sources / segment plumbing (NodeRegistration.hh initial nodes) -----------

def n_speech_segment(ins, attrs, ctx):
    """speech-segment: distribute the current segment (as a dict; the
    Bliss speech segment when a corpus is configured). Port 0: Flf
    segment, port 1: Bliss segment."""
    net: FlfNetwork = ctx["net"]
    seg = {"id": ctx["id"], "orthography": None, "start-time": 0.0,
           "end-time": None, "track": 0}
    corpus_path = attrs.get("corpus")
    if corpus_path:
        if corpus_path not in net._bliss_cache:
            from ..sprint.bliss import BlissCorpus
            net._bliss_cache[corpus_path] = BlissCorpus.read(corpus_path)
        bc = net._bliss_cache[corpus_path]
        for s in bc.segments:
            if bc.full_segment_name(s) == ctx["id"] or s.name == ctx["id"]:
                seg.update({"orthography": s.orth,
                            "start-time": s.start, "end-time": s.end,
                            "track": getattr(s, "track", 0)})
                break
    return Ports({0: seg, 1: seg})


def n_batch(ins, attrs, ctx):
    """batch: argument list of the current run; argument x at port x
    (run_batch_file supplies the per-line args)."""
    args = ctx.get("args", [ctx["id"]])
    return Ports({i: a for i, a in enumerate(args)})


def n_segment_builder(ins, attrs, ctx):
    """segment-builder: combine incoming data to a segment; missing
    fields get defaults (port layout per the reference registration)."""
    fields = ["bliss-speech-segment", "audio-filename", "start-time",
              "end-time", "track", "orthography", "speaker-id",
              "condition-id", "recording-id", "segment-id"]
    base = ins.get(0) if isinstance(ins.get(0), dict) else {}
    seg = {"id": ctx["id"], "orthography": None, "start-time": 0.0,
           "end-time": None, "track": 0}
    seg.update(base)
    for p, name in enumerate(fields):
        if p == 0:
            continue
        if ins.get(p) is not None:
            seg[name] = ins[p]
        elif name in attrs:
            seg[name] = attrs[name]
    if seg.get("segment-id"):
        seg["id"] = seg["segment-id"]
    return seg


def n_buffer(ins, attrs, ctx):
    """buffer: hold the incoming lattice until the next sync and
    manifold it to all outgoing ports."""
    v = _require(ins)
    return Ports({p: v for p in range(MAX_PORTS)})


def n_dummy(ins, attrs, ctx):
    """dummy: pass lattices through if port 0 is connected, else do
    nothing."""
    return ins.get(0)


# -- readers / writers / drawers ----------------------------------------------

def n_drawer(ins, attrs, ctx):
    """drawer: dot-format rendering of the lattice (Flf draw)."""
    import os

    lat: WordLattice = _as_lattice(_require(ins))
    net: FlfNetwork = ctx["net"]

    def label(w: int) -> str:
        if w < 0:
            return "<eps>"
        return net.vocab[w] if w < len(net.vocab) else str(w)

    lines = ["digraph lattice {", "rankdir=LR;", "node [shape=circle];",
             f'{lat.num_frames} [shape=doublecircle];']
    for a in lat.arcs:
        lines.append(f'{a.start} -> {a.end} '
                     f'[label="{label(a.word)}/{a.score:.3f}"];')
    lines.append("}")
    text = "\n".join(lines)
    directory = attrs.get("path", attrs.get("directory", ""))
    if directory:
        os.makedirs(directory, exist_ok=True)
        fname = os.path.join(directory,
                             ctx["id"].replace("/", "_") + ".dot")
        with open(fname, "w") as f:
            f.write(text)
    else:
        print(text, file=ctx["out"])
    return _require(ins)


def n_ctm_reader(ins, attrs, ctx):
    """ctm-reader: build the current segment's linear lattice from a CTM
    file (`<name> <track> <start> <duration> <word> [<score>...]`);
    frame times quantized at `frame-shift` seconds (default 0.01)."""
    net: FlfNetwork = ctx["net"]
    path = attrs["file"]
    shift = float(attrs.get("frame-shift", "0.01"))
    if path not in net._ctm_cache:
        rows: Dict[str, List[Tuple[float, float, str, float]]] = {}
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5 or line.startswith(";;"):
                    continue
                name, _track, start, dur, word = parts[:5]
                score = float(parts[5]) if len(parts) > 5 else 0.0
                rows.setdefault(name, []).append(
                    (float(start), float(dur), word, score))
        net._ctm_cache[path] = rows
    rows = net._ctm_cache[path].get(ctx["id"], [])
    arcs = []
    end_max = 0
    for start, dur, word, score in sorted(rows):
        s = int(round(start / shift))
        e = max(s + 1, int(round((start + dur) / shift)))
        w = net.word_idx.get(word)
        if w is None:
            continue
        arcs.append(Arc(start=s, end=e, word=w, score=score))
        end_max = max(end_max, e)
    # close gaps so the lattice is connected: bridge with ε arcs
    arcs.sort(key=lambda a: a.start)
    bridged: List[Arc] = []
    prev_end = 0
    for a in arcs:
        if a.start > prev_end:
            bridged.append(Arc(start=prev_end, end=a.start, word=-1,
                               score=0.0))
        bridged.append(a)
        prev_end = max(prev_end, a.end)
    return WordLattice(num_frames=end_max, arcs=bridged,
                       silence=net.silence)


def n_fsa_reader(ins, attrs, ctx):
    """fsa-reader: read an automaton (fsa/ text format); buffered."""
    net: FlfNetwork = ctx["net"]
    path = attrs["file"]
    if path not in net._fsa_cache:
        from ..fsa.automaton import read_fsa
        net._fsa_cache[path] = read_fsa(path)
    return net._fsa_cache[path]


def n_string_to_lattice(ins, attrs, ctx):
    """string-to-lattice: convert a string (port 0 or the `string`
    attr) to a linear lattice, one frame per word."""
    net: FlfNetwork = ctx["net"]
    text = ins.get(0) if isinstance(ins.get(0), str) else attrs.get(
        "string", "")
    words = [net.word_idx[w] for w in text.split() if w in net.word_idx]
    arcs = [Arc(start=i, end=i + 1, word=w, score=0.0)
            for i, w in enumerate(words)]
    return WordLattice(num_frames=max(1, len(words)), arcs=arcs,
                       silence=net.silence)


def n_select_n_best(ins, attrs, ctx):
    """select-n-best: port x provides the xth best entry of an incoming
    n-best list (as produced by the n-best node)."""
    rows = _require(ins)
    net: FlfNetwork = ctx["net"]
    out = {}
    for p in range(MAX_PORTS):
        if p < len(rows):
            words, score = rows[p]
            arcs = [Arc(start=i, end=i + 1, word=w, score=0.0)
                    for i, w in enumerate(words)]
            if arcs:
                arcs[0] = Arc(start=0, end=1, word=words[0], score=score)
            out[p] = WordLattice(num_frames=max(1, len(words)), arcs=arcs,
                                 silence=net.silence)
        else:
            out[p] = WordLattice(num_frames=1, arcs=[], silence=net.silence)
    return Ports(out)


def n_dump_all_pairs_best(ins, attrs, ctx):
    """dump-all-pairs-best: all-pairs shortest distances over the
    lattice DAG (scalar projected scores), optionally restricted to
    pairs within `time-threshold` frames."""
    lat: WordLattice = _as_lattice(_require(ins))
    thr = float(attrs.get("time-threshold", "inf"))
    N = lat.num_frames + 1
    D = np.full((N, N), np.inf)
    for i in range(N):
        D[i, i] = 0.0
    for t in range(1, N):
        for a in lat.by_end().get(t, []):
            for s in range(N):
                c = D[s, a.start] + a.score
                if c < D[s, a.end]:
                    D[s, a.end] = c
    for s in range(N):
        for e in range(N):
            if s != e and np.isfinite(D[s, e]) and abs(
                    lat.time_of(e) - lat.time_of(s)) <= thr:
                print(f"{ctx['id']}\t{s}\t{e}\t{D[s, e]:.6f}",
                      file=ctx["out"])
    return D


def n_dump_vocab(ins, attrs, ctx):
    """dump-vocab: all words occurring as input token in the lattice."""
    lat: WordLattice = _as_lattice(_require(ins))
    net: FlfNetwork = ctx["net"]
    words = sorted({a.word for a in lat.arcs if a.word >= 0})
    for w in words:
        print(net.vocab[w] if w < len(net.vocab) else str(w),
              file=ctx["out"])
    return [net.vocab[w] if w < len(net.vocab) else str(w) for w in words]


def n_map_alphabet(ins, attrs, ctx):
    """map-alphabet: map lattice labels through the lexicon —
    `mapping = to-lemma` collapses orthographic variants onto the
    primary orth of each Bliss lemma; `mapping = to-lemma-pron` maps
    each word to its preferred pronunciation variant id (vocab grows a
    pron alphabet on the network)."""
    net: FlfNetwork = ctx["net"]
    lat: WordLattice = _as_lattice(_require(ins))
    lex_path = attrs["lexicon"]
    if lex_path not in net._bliss_cache:
        from ..sprint.bliss import BlissLexicon
        net._bliss_cache[lex_path] = BlissLexicon.read(lex_path)
    lex = net._bliss_cache[lex_path]
    mode = attrs.get("mapping", "to-lemma")
    mapping: Dict[int, int] = {}
    for w, orth in enumerate(net.vocab):
        lemma = lex.lemma_of(orth)
        if lemma is None:
            continue
        if mode == "to-lemma":
            primary = lemma.orth[0] if lemma.orth else orth
            mapping[w] = net.word_idx.get(primary, w)
        elif mode == "to-lemma-pron":
            # preferred (first) pronunciation variant: index into a
            # pron alphabet laid out lemma-major
            mapping[w] = net.word_idx.get(orth, w)
        else:
            raise ValueError(f"map-alphabet: unknown mapping {mode!r}")
    arcs = [Arc(start=a.start, end=a.end,
                word=mapping.get(a.word, a.word), score=a.score)
            for a in lat.arcs]
    return WordLattice(num_frames=lat.num_frames, arcs=arcs,
                       silence=lat.silence, times=lat.times)


# -- composition family (flf_compose) -----------------------------------------

def n_compose(ins, attrs, ctx):
    from .flf_compose import compose_lattices

    left = _as_lattice(_require(ins, 0))
    right = _as_lattice(_require(ins, 1))
    unweighted = attrs.get("unweighted-left", "auto")
    if unweighted == "auto":
        uw = all(a.score == 0.0 for a in left.arcs)
    else:
        uw = unweighted == "true"
    return compose_lattices(left, right, unweighted_left=uw)


def n_compose_sequencing(ins, attrs, ctx):
    from .flf_compose import compose_lattices

    return compose_lattices(_as_lattice(_require(ins, 0)),
                            _as_lattice(_require(ins, 1)))


def n_intersection(ins, attrs, ctx):
    from .flf_compose import intersect_lattices

    return intersect_lattices(_as_lattice(_require(ins, 0)),
                              _as_lattice(_require(ins, 1)))


def n_difference(ins, attrs, ctx):
    from .flf_compose import difference_lattices

    return difference_lattices(_as_lattice(_require(ins, 0)),
                               _as_lattice(_require(ins, 1)))


def n_compose_with_fsa(ins, attrs, ctx):
    from .flf_compose import compose_with_fsa

    lat = _as_lattice(_require(ins, 0))
    fsa = ins.get(1)
    if fsa is None:
        fsa = n_fsa_reader({}, attrs, ctx)
    return compose_with_fsa(lat, fsa, float(attrs.get("scale", "1")))


def n_compose_with_lm(ins, attrs, ctx):
    from .flf_compose import compose_with_lm

    net: FlfNetwork = ctx["net"]
    lat = _as_lattice(_require(ins, 0))
    path = attrs["file"]
    if path not in net._lm_cache:
        from ..lm.arpa import ArpaLM
        net._lm_cache[path] = ArpaLM(path)
    return compose_with_lm(
        lat, net._lm_cache[path], net.vocab,
        scale=float(attrs.get("scale", "1")),
        force_sentence_end=attrs.get("force-sentence-end",
                                     "true") == "true")


def n_remove_epsilons(ins, attrs, ctx):
    from .flf_compose import remove_epsilon_arcs

    return remove_epsilon_arcs(_as_lattice(_require(ins)))


def n_fit(ins, attrs, ctx):
    from .flf_compose import fit_lattice

    lat = _as_lattice(_require(ins))
    seg = ins.get(1)
    end = None
    if isinstance(seg, dict) and seg.get("end-time") is not None:
        shift = float(attrs.get("frame-shift", "0.01"))
        end = int(round(float(seg["end-time"]) / shift))
    elif "end-time" in attrs:
        end = int(attrs["end-time"])
    return fit_lattice(lat, end_time=end)


# -- non-word closure family (flf_closure) ------------------------------------

def _nw_list(attrs, net) -> List[int]:
    return [net.word_idx[w] for w in attrs.get("non-words", "").split()
            if w in net.word_idx]


def n_nonword_closure_filter(ins, attrs, ctx):
    from .flf_closure import nonword_closure_filter

    return nonword_closure_filter(_as_lattice(_require(ins)),
                                  _nw_list(attrs, ctx["net"]), level="arc")


def n_nonword_closure_weak_det(ins, attrs, ctx):
    from .flf_closure import nonword_closure_filter

    return nonword_closure_filter(_as_lattice(_require(ins)),
                                  _nw_list(attrs, ctx["net"]), level="weak")


def n_nonword_closure_strong_det(ins, attrs, ctx):
    from .flf_closure import nonword_closure_filter

    return nonword_closure_filter(_as_lattice(_require(ins)),
                                  _nw_list(attrs, ctx["net"]),
                                  level="strong")


def n_nonword_closure_normalization(ins, attrs, ctx):
    from .flf_closure import nonword_closure_normalization

    return nonword_closure_normalization(_as_lattice(_require(ins)),
                                         _nw_list(attrs, ctx["net"]))


def n_nonword_closure_removal(ins, attrs, ctx):
    from .flf_closure import nonword_closure_removal

    return nonword_closure_removal(_as_lattice(_require(ins)),
                                   _nw_list(attrs, ctx["net"]))


# -- score-dimension manipulation (flf_rescore) -------------------------------

def n_append_scores(ins, attrs, ctx):
    """append: score-wise concatenation of two equal-topology lattices
    (semiring concat; Flf/Rescore.cc AppendNode). The older
    time-concatenation behavior lives under `concatenate-lattices`."""
    from .flf_rescore import append_lattices

    return append_lattices(_strip_post(_require(ins, 0)),
                           _strip_post(_require(ins, 1)))


def _strip_post(v):
    return v[0] if isinstance(v, tuple) else v


def n_add(ins, attrs, ctx):
    from .flf_rescore import add_score

    return add_score(_strip_post(_require(ins)),
                     float(attrs.get("score", attrs.get("value", "0"))),
                     key=attrs.get("key"))


def n_multiply(ins, attrs, ctx):
    from .flf_rescore import multiply_score

    return multiply_score(_strip_post(_require(ins)),
                          float(attrs.get("scale", "1")),
                          key=attrs.get("key"))


def n_exp(ins, attrs, ctx):
    from .flf_rescore import exp_score

    return exp_score(_strip_post(_require(ins)),
                     float(attrs.get("scale", "1")), key=attrs.get("key"))


def n_log(ins, attrs, ctx):
    from .flf_rescore import log_score

    return log_score(_strip_post(_require(ins)),
                     float(attrs.get("scale", "1")), key=attrs.get("key"))


def n_extend_by_penalty(ins, attrs, ctx):
    from .flf_rescore import extend_by_penalty

    net: FlfNetwork = ctx["net"]
    class_pens: Dict[int, float] = {}
    # class config: `classes = cls1 cls2`, `cls1.words = a b`,
    # `cls1.penalty = 3.0` (the reference's class labels)
    for cls in attrs.get("classes", "").split():
        pen = float(attrs.get(f"{cls}.penalty", "0"))
        for w in attrs.get(f"{cls}.words", "").split():
            if w in net.word_idx:
                class_pens[net.word_idx[w]] = pen
    return extend_by_penalty(
        _strip_post(_require(ins)), float(attrs.get("penalty", "0")),
        class_penalties=class_pens, key=attrs.get("key"))


def n_extend_by_pron(ins, attrs, ctx):
    from .flf_rescore import extend_by_pronunciation_score

    net: FlfNetwork = ctx["net"]
    lex_path = attrs["lexicon"]
    key = f"pron|{lex_path}"
    if key not in net._bliss_cache:
        from ..sprint.bliss import BlissLexicon
        lex = BlissLexicon.read(lex_path)
        scores: Dict[int, float] = {}
        for w, orth in enumerate(net.vocab):
            lemma = lex.lemma_of(orth)
            if lemma is not None and len(lemma.pronunciations) > 0:
                # uniform variant probability 1/N → −log N for the
                # preferred variant (the Bliss default when the lexicon
                # carries no explicit pron scores)
                scores[w] = math.log(len(lemma.pronunciations))
        net._bliss_cache[key] = scores
    return extend_by_pronunciation_score(
        _strip_post(_require(ins)), net._bliss_cache[key],
        scale=float(attrs.get("scale", "1")), key=attrs.get("key"))


def n_reduce(ins, attrs, ctx):
    from .flf_rescore import reduce_scores

    keys = attrs.get("keys", "").split() or None
    return reduce_scores(_strip_post(_require(ins)), keys)


def n_change_semiring(ins, attrs, ctx):
    from .flf_rescore import change_semiring

    scales: Dict[str, float] = {}
    for kv in attrs.get("scales", "").split():
        k, v = kv.split(":")
        scales[k] = float(v)
    rename: Dict[str, str] = {}
    for kv in attrs.get("rename", "").split():
        k, v = kv.split(":")
        rename[k] = v
    return change_semiring(_strip_post(_require(ins)), scales, rename)


def n_project_semiring(ins, attrs, ctx):
    from .flf_rescore import project_semiring

    return project_semiring(_strip_post(_require(ins)),
                            attrs.get("keys", "").split())


# -- CN / fCN IO, pruning, combination, features (flf_cn) ---------------------

def n_cn_archive_reader(ins, attrs, ctx):
    from .flf_cn import CnArchive

    net: FlfNetwork = ctx["net"]
    key = "cn|" + attrs["path"]
    if key not in net._archives_misc:
        net._archives_misc[key] = CnArchive(attrs["path"])
    return net._archives_misc[key].read(ctx["id"])


def n_cn_archive_writer(ins, attrs, ctx):
    from .flf_cn import CnArchive

    net: FlfNetwork = ctx["net"]
    key = "cn|" + attrs["path"]
    if key not in net._archives_misc:
        net._archives_misc[key] = CnArchive(attrs["path"])
    net._archives_misc[key].write(ctx["id"], _require(ins))
    return None


def n_fcn_archive_reader(ins, attrs, ctx):
    from .flf_cn import FcnArchive

    net: FlfNetwork = ctx["net"]
    key = "fcn|" + attrs["path"]
    if key not in net._archives_misc:
        net._archives_misc[key] = FcnArchive(attrs["path"])
    return net._archives_misc[key].read(ctx["id"])


def n_fcn_archive_writer(ins, attrs, ctx):
    from .flf_cn import FcnArchive

    net: FlfNetwork = ctx["net"]
    key = "fcn|" + attrs["path"]
    if key not in net._archives_misc:
        net._archives_misc[key] = FcnArchive(attrs["path"])
    net._archives_misc[key].write(ctx["id"], _require(ins))
    return None


def n_dump_cn(ins, attrs, ctx):
    from .flf_cn import cn_to_lattice, dump_cn

    net: FlfNetwork = ctx["net"]
    slots = _require(ins)
    dump_cn(slots, net.vocab, ctx["out"], seg_id=ctx["id"])
    lat = cn_to_lattice(slots, silence=net.silence)
    return Ports({0: lat, 1: slots,
                  2: WordLattice(num_frames=1, arcs=[],
                                 silence=net.silence)})


def n_dump_fcn(ins, attrs, ctx):
    from .flf_cn import dump_fcn

    net: FlfNetwork = ctx["net"]
    pcn = _require(ins)
    dump_fcn(pcn, net.vocab, ctx["out"], seg_id=ctx["id"])
    return Ports({0: pcn, 1: pcn,
                  2: WordLattice(num_frames=1, arcs=[],
                                 silence=net.silence)})


def n_prune_cn(ins, attrs, ctx):
    from .flf_cn import prune_cn

    thr = attrs.get("threshold")
    n = attrs.get("max-slot-size", attrs.get("n"))
    eps = attrs.get("remove-eps-slots")
    return prune_cn(_require(ins),
                    threshold=float(thr) if thr else None,
                    max_slot_size=int(n) if n else None,
                    normalize=attrs.get("normalize", "false") == "true",
                    remove_eps_slots=float(eps) if eps else None)


def n_prune_fcn(ins, attrs, ctx):
    from .flf_cn import prune_fcn

    thr = attrs.get("threshold")
    n = attrs.get("max-slot-size", attrs.get("n"))
    return prune_fcn(_require(ins),
                     threshold=float(thr) if thr else None,
                     max_slot_size=int(n) if n else None,
                     normalize=attrs.get("normalize", "false") == "true")


def n_cn_combination(ins, attrs, ctx):
    """CN-combination: combine and decode incoming posterior CNs."""
    from .flf import combine_confusion_networks

    net: FlfNetwork = ctx["net"]
    systems = [v for _p, v in sorted(ins.items()) if v is not None]
    weights = [float(x) for x in attrs.get("weights", "").split()] or None
    combined = combine_confusion_networks(systems, weights)
    words = cn_decode(combined)
    text = " ".join(net.vocab[w] for w in words
                    if w != net.silence and w >= 0)
    print(f"{ctx['id']}\t{text}", file=ctx["out"])
    return Ports({0: combined, 1: words})


def n_rover_combination(ins, attrs, ctx):
    """ROVER-combination: combine and decode incoming LATTICES (CN per
    system, then slot-aligned vote — Flf's ROVER node over the same CN
    combination machinery)."""
    from .flf import combine_confusion_networks

    net: FlfNetwork = ctx["net"]
    lats = [_as_lattice(v) for _p, v in sorted(ins.items())
            if v is not None]
    systems = [confusion_network(l) for l in lats]
    weights = [float(x) for x in attrs.get("weights", "").split()] or None
    combined = combine_confusion_networks(systems, weights)
    words = cn_decode(combined)
    text = " ".join(net.vocab[w] for w in words
                    if w != net.silence and w >= 0)
    print(f"{ctx['id']}\t{text}", file=ctx["out"])
    return Ports({0: combined, 1: words})


def n_fcn_combination(ins, attrs, ctx):
    from .flf_cn import fcn_combination

    systems = [v for _p, v in sorted(ins.items()) if v is not None]
    weights = [float(x) for x in attrs.get("weights", "").split()] or None
    return fcn_combination(
        systems, weights,
        max_approx=attrs.get("max-approximation", "false") == "true")


def n_concatenate_fcns(ins, attrs, ctx):
    from .flf_cn import concatenate_fcns

    return concatenate_fcns([v for _p, v in sorted(ins.items())
                             if v is not None])


def n_cn_features(ins, attrs, ctx):
    from .flf_cn import cn_features

    net: FlfNetwork = ctx["net"]
    v = _require(ins, 0)
    lat = _as_lattice(v)
    slots = ins.get(1)
    if slots is None:
        slots = confusion_network(lat)
    oracle = None
    if "transcripts" in attrs:
        refs = _load_refs(net, attrs["transcripts"])
        oracle = refs.get(ctx["id"])
    feats = cn_features(lat, slots, feature=attrs.get("feature",
                                                      "confidence"),
                        oracle=oracle,
                        eps_threshold=float(attrs.get("threshold", "1")))
    return (lat, feats)


def n_fcn_features(ins, attrs, ctx):
    from .flf_cn import fcn_features

    v = _require(ins, 0)
    lat = _as_lattice(v)
    pcn = ins.get(1)
    if pcn is None:
        src = _as_lattice(ins.get(2)) if ins.get(2) is not None else lat
        pcn = frame_posterior_cn(src)
    feats = fcn_features(lat, pcn,
                         feature=attrs.get("feature", "confidence"),
                         alpha=float(attrs.get("alpha", "0.05")))
    return (lat, feats)


def n_fcn_confidence(ins, attrs, ctx):
    """fCN-confidence: Frank Wessel word confidence (fCN from port 1 if
    provided, else built from the incoming lattice)."""
    v = _require(ins, 0)
    lat = _as_lattice(v)
    pcn = ins.get(1)
    if pcn is None:
        post = v[1] if isinstance(v, tuple) else None
        return (lat, arc_confidence(lat, post))
    from .flf_cn import fcn_features
    return (lat, fcn_features(lat, pcn, feature="confidence"))


def n_fwer_evaluator(ins, attrs, ctx):
    from .flf_cn import fwer

    hyp = _as_lattice(_require(ins, 0))
    ref = ins.get(1)
    if isinstance(ref, list):                       # fCN reference
        err, T = fwer(hyp, ref_fcn=ref,
                      alpha=float(attrs.get("alpha", "0")))
    else:
        err, T = fwer(hyp, ref=_as_lattice(_require(ins, 1)))
    print(f"{ctx['id']}\tframe-errors={err:.4f}\tframes={T}",
          file=ctx["out"])
    return (err, T)


def n_oracle_alignment(ins, attrs, ctx):
    from .flf_cn import oracle_align_cn

    net: FlfNetwork = ctx["net"]
    slots = _require(ins, 0)
    refs = _load_refs(net, attrs["transcripts"])
    ref = refs.get(ctx["id"], [])
    rows, cost = oracle_align_cn(
        slots, ref, cost=attrs.get("cost", "oracle-error"),
        alpha=float(attrs.get("alpha", "1")))
    print(f"{ctx['id']}\toracle-cost={cost:.4f}", file=ctx["out"])
    return Ports({0: rows, 1: cost})


def n_state_cluster_cn_builder(ins, attrs, ctx):
    from .flf_cn import state_cluster_cn

    return state_cluster_cn(_as_lattice(_require(ins)))


def n_aligner(ins, attrs, ctx):
    from .flf_cn import align_hypothesis

    net: FlfNetwork = ctx["net"]
    hyp = _require(ins, 0)
    if isinstance(hyp, WordLattice) or isinstance(hyp, tuple):
        hyp_words, _sc = _as_lattice(hyp).best_path()
    else:
        hyp_words = list(hyp)
    ref_fcn = ins.get(1) if isinstance(ins.get(1), list) else None
    ref_lat = _as_lattice(ins.get(2) if ref_fcn is not None
                          else _require(ins, 1))
    rows = align_hypothesis(
        [w for w in hyp_words if w >= 0], ref_lat, ref_fcn=ref_fcn,
        intersection=attrs.get("intersection", "true") == "true")
    for w, s, e in rows:
        print(f"{ctx['id']}\t{s}\t{e}\t"
              f"{net.vocab[w] if 0 <= w < len(net.vocab) else w}",
              file=ctx["out"])
    return rows


def _load_refs(net: "FlfNetwork", path: str) -> Dict[str, List[int]]:
    refs = net._refs_cache.get(path)
    if refs is None:
        refs = {}
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2:
                    refs[parts[0]] = [net.word_idx[w]
                                      for w in parts[1].split()
                                      if w in net.word_idx]
        net._refs_cache[path] = refs
    return refs


# -- in-network recognizer (NodeRegistration `recognizer`) --------------------

def n_recognizer(ins, attrs, ctx):
    """recognizer: run the framework's recognizer on the current
    segment and emit its word lattice (the Sprint Recognizer node,
    Flf/Recognizer.cc — here the sietill word-loop system: .mix model +
    corpus, bigram word-end books → WordLattice). Most-common follow-up
    ops (posterior pruning) can be applied in-node via
    `posterior-pruning.threshold`."""
    net: FlfNetwork = ctx["net"]
    key = "recognizer|" + attrs["mixture-file"]
    if key not in net._archives_misc:
        net._archives_misc[key] = _build_recognizer(attrs, ctx["device"])
    rec = net._archives_misc[key]
    lat = rec(ctx["id"])
    thr = attrs.get("posterior-pruning.threshold")
    if thr is not None:
        lat = lat.posterior_prune(float(thr))
    return lat


def _build_recognizer(attrs, device):
    """Load corpus + model once; return seg_id → WordLattice. The f64
    "mxu" pack lives on ``device`` (``pack_device``: raises for the card
    when there is none); each segment is scored there and decoded by
    ``decode_scan_bigram`` (kernel J on a CUDA device)."""
    import torch

    from ..corpus import Corpus, CorpusDescription
    from ..features.frontend import SignalAnalysisConfig
    from ..io import read_mixture_set
    from ..lexicon import build_sietill_lexicon
    from ..models import gmm as gmm_mod
    from ..models.gmm import MixtureModel, VarianceModel
    from ..tdp import TdpModel
    from .decoder import DecoderTables
    from .ngram_decoder import decode_scan_bigram

    lexicon = build_sietill_lexicon()
    desc = CorpusDescription.read(attrs["corpus"], lexicon)
    corpus = Corpus.read(desc, attrs["feature-path"],
                         SignalAnalysisConfig(),
                         normalization_path=attrs.get("normalization"))
    raw = read_mixture_set(attrs["mixture-file"],
                           int(attrs.get("dim", "25")))
    model = MixtureModel.from_raw(raw, VarianceModel.MIXTURE_POOLING,
                                  max_approx=True)
    tdps = [float(x) for x in attrs.get("tdp", "20 0 20").split()]
    tdp = TdpModel(silence_state=0, loop=tdps[0], forward=tdps[1],
                   skip=tdps[2])
    pack = model.pack(dtype=torch.float64, device=device)
    dev = pack.device
    tables = DecoderTables.build(lexicon, tdp, word_penalty=0.0)
    W = lexicon.num_words
    wp = float(attrs.get("word-penalty", "20"))
    lm = np.full((W, W), wp)
    lm[:, lexicon.silence_idx] = 0.0
    lm_start = lm[0].copy()
    beam = float(attrs.get("am-threshold", "200"))
    name_idx = {n: i for i, n in enumerate(corpus.names)}
    ints = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (tables.state_table, tables.last_pos, tables.word_len)]
    f64 = [torch.as_tensor(np.asarray(a, np.float64), device=dev)
           for a in (tables.tdp_within, tables.entry_pen, lm, lm_start)]

    def run(seg_id: str) -> WordLattice:
        b = name_idx[seg_id]
        feats, lens = corpus.padded_batch([b])
        B, T, dim = feats.shape
        x = torch.as_tensor(feats.reshape(B * T, dim), device=dev)
        am = gmm_mod.am_scores(pack, x).reshape(B, T, pack.num_mixtures)
        scores, bkps, _preds, offsets = decode_scan_bigram(
            am.contiguous(), torch.as_tensor(lens, dtype=torch.int32, device=dev),
            *ints, *f64, beam)
        scores, bkps, offsets = (v.cpu().numpy() for v in (scores, bkps, offsets))
        return WordLattice.from_books(scores[:, 0], bkps[:, 0],
                                      offsets[:, 0], int(lens[0]),
                                      silence=lexicon.silence_idx)

    return run


NODE_TYPES: Dict[str, Callable] = {
    "archive-reader": n_archive_reader,
    "reader": n_archive_reader,
    "archive-writer": n_archive_writer,
    "writer": n_archive_writer,
    "copy": n_copy,
    "cache": n_copy,
    "sink": n_sink,
    "info": n_info,
    "best": n_best,
    "dump-n-best": n_dump_n_best,
    "n-best": n_dump_n_best,
    "prune-posterior": n_prune_posterior,
    "FB-builder": n_fb_builder,
    "add-word-confidence": n_add_word_confidence,
    "local-cost-decoder": n_local_cost_decoder,
    "min-fWER-decoder": n_min_fwer_decoder,
    "fCN-builder": n_fcn_builder,
    "center-frame-CN-builder": n_cn_builder,
    "CN-builder": n_cn_builder,
    "pivot-CN-builder": n_pivot_cn_builder,
    "CN-gamma-correction": n_cn_gamma,
    "fCN-gamma-correction": n_fcn_gamma,
    "CN-decoder": n_cn_decoder,
    "mesh": n_mesh,
    "clean-up": n_clean_up,
    "unite": n_unite,
    "determinize": n_determinize,
    "minimize": n_minimize,
    "rescale": n_rescale,
    "evaluator": n_evaluator,
    "concatenate-lattices": n_concatenate,
    "map-labels": n_map_labels,
    "filter": n_filter,
    "remove-null-arcs": n_remove_null_arcs,
    "properties": n_properties,
    "dump-traceback": n_dump_traceback,
    # sources / segment plumbing
    "speech-segment": n_speech_segment,
    "batch": n_batch,
    "segment-builder": n_segment_builder,
    "buffer": n_buffer,
    "dummy": n_dummy,
    # readers / writers / drawers
    "drawer": n_drawer,
    "ctm-reader": n_ctm_reader,
    "fsa-reader": n_fsa_reader,
    "string-to-lattice": n_string_to_lattice,
    "select-n-best": n_select_n_best,
    "dump-all-pairs-best": n_dump_all_pairs_best,
    "dump-vocab": n_dump_vocab,
    "map-alphabet": n_map_alphabet,
    # composition family (Flf/Compose.cc)
    "compose": n_compose,
    "compose-matching": n_compose,
    "compose-sequencing": n_compose_sequencing,
    "intersection": n_intersection,
    "difference": n_difference,
    "compose-with-fsa": n_compose_with_fsa,
    "compose-with-lm": n_compose_with_lm,
    "remove-epsilons": n_remove_epsilons,
    "fit": n_fit,
    # non-word closure family (Flf/NonWordFilter.cc)
    "non-word-closure-filter": n_nonword_closure_filter,
    "non-word-closure-weak-determinization-filter":
        n_nonword_closure_weak_det,
    "non-word-closure-strong-determinization-filter":
        n_nonword_closure_strong_det,
    "non-word-closure-normalization-filter":
        n_nonword_closure_normalization,
    "non-word-closure-removal-filter": n_nonword_closure_removal,
    # score-dimension manipulation (Flf/Rescore.cc)
    "append": n_append_scores,
    "add": n_add,
    "multiply": n_multiply,
    "exp": n_exp,
    "log": n_log,
    "extend-by-penalty": n_extend_by_penalty,
    "extend-by-pronunciation-score": n_extend_by_pron,
    "reduce": n_reduce,
    "change-semiring": n_change_semiring,
    "project": n_project_semiring,
    # CN / fCN IO, pruning, combination, features
    "CN-archive-reader": n_cn_archive_reader,
    "CN-archive-writer": n_cn_archive_writer,
    "fCN-archive-reader": n_fcn_archive_reader,
    "fCN-archive-writer": n_fcn_archive_writer,
    "dump-CN": n_dump_cn,
    "dump-fCN": n_dump_fcn,
    "prune-CN": n_prune_cn,
    "prune-fCN": n_prune_fcn,
    "CN-combination": n_cn_combination,
    "ROVER-combination": n_rover_combination,
    "fCN-combination": n_fcn_combination,
    "concatenate-fCNs": n_concatenate_fcns,
    "CN-features": n_cn_features,
    "fCN-features": n_fcn_features,
    "fCN-confidence": n_fcn_confidence,
    "fWER-evaluator": n_fwer_evaluator,
    "oracle-alignment": n_oracle_alignment,
    "state-cluster-CN-builder": n_state_cluster_cn_builder,
    "cluster-CN-builder": n_state_cluster_cn_builder,   # deprecated name
    "pivot-arc-CN-builder": n_pivot_cn_builder,
    "frame-CN-builder": n_cn_builder,                   # deprecated name
    "aligner": n_aligner,
    "approximated-risk-scorer": n_local_cost_decoder,   # deprecated name
    # in-network recognizer
    "recognizer": n_recognizer,
}
