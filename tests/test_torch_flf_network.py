"""The port's Flf network (search/flf_network.py) against the JAX package's.

* The node census: the port registers exactly the JAX package's node names,
  each to a function of the same name.
* The network configs of tests/test_flf_network.py and
  test_flf_nodes_r5.py, and a sweep that runs every host node on each kind
  of input (lattice, FB-builder pair, CN, fCN), in both packages: results,
  printed text and written files bit-equal (``run_both``,
  tests/torch_flf_tables.py). The port's host networks are built at the
  default device: no host node touches a device.
* The ``recognizer`` node on the first 10 demo segments
  (tests/fixtures/demo_corpus.json, iter-2.mix, the golden config) with
  ``device="cpu"``: best paths equal tests/fixtures/demo_recognition.json's
  hyps; lattices equal the JAX node's, word labels and arcs exactly and arc
  scores within 1e-9 relative (the f64 scores come from a torch product
  here and an XLA dot there); the CN consensus check of
  tests/test_flf.py:107 on the port's lattices. One JAX decode and one
  port decode serve the whole module.
* With CUDA hidden, a network holding a ``recognizer`` node raises when it
  runs, at the default device.
"""

import importlib
import io
import json

import numpy as np
import pytest
import torch

from torch_flf_tables import (FIXTURES, FLF_MODULES, ROOTS, assert_same, demo_segment_names,
                              outcome, package, recognizer_config, run_both)

VOCAB = ["[silence]", "eins", "zwei", "drei", "vier"]
SCORE_RTOL = 1e-9


def toy(P):
    """'eins zwei' (best), 'drei zwei', 'drei [sil]', all-silence."""
    return P.WordLattice(num_frames=6, arcs=[P.Arc(0, 3, 1, 1.0), P.Arc(0, 3, 3, 3.0),
                                             P.Arc(3, 6, 2, 1.0), P.Arc(3, 6, 0, 4.0),
                                             P.Arc(0, 6, 0, 9.0)], silence=0)


def parse(P, cfg_path, vocab=VOCAB, silence=0):
    return P.FlfNetwork.parse(P.SprintConfig.read(str(cfg_path)), vocab, silence=silence)


def network_case(config, segments=("seg-1",), batch_file=None):
    """A case that writes the toy archive, the transcripts and a CTM under
    its root, then runs ``config`` (``{root}`` replaced by it) over
    ``segments`` (or through ``run_batch_file``): (node results by segment,
    printed text)."""
    def case(P, root):
        P.LatticeArchive(str(root / "lats"), VOCAB).write("seg-1", toy(P))
        (root / "refs.txt").write_text("seg-1\teins zwei\n")
        (root / "hyp.ctm").write_text("seg-1 1 0.00 0.03 eins 0.9\nseg-1 1 0.03 0.03 zwei 0.8\n")
        (root / "batch.txt").write_text("seg-1 file-a.wav\nseg-2 file-b.wav\n")
        (root / "net.config").write_text(config.replace("{root}", str(root)))
        net = parse(P, root / "net.config")
        out = io.StringIO()
        res = (net.run_batch_file(str(root / batch_file), out=out) if batch_file
               else net.run(list(segments), out=out))
        return sorted(net.nodes), res, out.getvalue().replace(str(root), "<root>")
    return case


END_TO_END = """
[network]
initial-nodes = reader
[network.reader]
type   = archive-reader
path   = {root}/lats
links  = 0->fb:0
[network.fb]
type   = FB-builder
links  = 0->conf:0 0->decoder:0
[network.conf]
type   = add-word-confidence
links  = 0->cn:0
[network.cn]
type   = center-frame-CN-builder
links  = 0->gamma:0
[network.gamma]
type   = CN-gamma-correction
gamma  = 2.0
links  = 0->cndec:0
[network.cndec]
type   = CN-decoder
links  = 0->eval:0
[network.eval]
type        = evaluator
transcripts = {root}/refs.txt
links       = 0->sink:0
[network.decoder]
type         = local-cost-decoder
word-penalty = 0.5
links        = 0->writerprep:0
[network.writerprep]
type  = copy
links = 0->sink:0
[network.sink]
type = sink
"""

FB_ANY = """
[network.reader]
type = archive-reader
path = {root}/lats
links = fb
[network.fb]
type = FB-builder
links = best info prune
[network.best]
type = best
[network.info]
type = info
[network.prune]
type = prune-posterior
threshold = 50
"""

VARIABLES = """
lattice-dir = {root}/lats
[network.reader]
type = archive-reader
path = $(lattice-dir)
links = best
[network.best]
type = best
"""

NEW_FAMILIES = """
[network.reader]
type = archive-reader
path = {root}/lats
links = grammar:0 closure
[network.str]
type = string-to-lattice
string = eins zwei
links = grammar:1
[network.grammar]
type = compose
links = best
[network.best]
type = best
[network.closure]
type = non-word-closure-filter
links = pen
[network.pen]
type = extend-by-penalty
penalty = 2.5
links = cn
[network.cn]
type = center-frame-CN-builder
links = cnwriter oracle
[network.cnwriter]
type = CN-archive-writer
path = {root}/cns
[network.oracle]
type = oracle-alignment
transcripts = {root}/refs.txt
"""

PORTS = """
[network.reader]
type = archive-reader
path = {root}/lats
links = buffer
[network.buffer]
type = buffer
links = 0->nbest:0 1->cnb:0
[network.nbest]
type = n-best
n = 3
links = select
[network.select]
type = select-n-best
links = 1->secondsink:0
[network.secondsink]
type = sink
[network.cnb]
type = CN-builder
links = dump
[network.dump]
type = dump-CN
links = 1->cnsink:0 0->latsink:0
[network.cnsink]
type = sink
[network.latsink]
type = sink
"""

BATCH = """
[network.batch]
type = batch
links = 0->builder:9 1->builder:1
[network.builder]
type = segment-builder
links = sink
[network.sink]
type = sink
"""

DRAWER = """
[network.reader]
type = archive-reader
path = {root}/lats
links = drawer vocab
[network.drawer]
type = drawer
path = {root}/dots
[network.vocab]
type = dump-vocab
[network.ctm]
type = ctm-reader
file = {root}/hyp.ctm
links = ctmbest
[network.ctmbest]
type = best
"""

NETWORKS = {"end-to-end": (END_TO_END, None), "fb-builder-links": (FB_ANY, None),
            "config-variables": (VARIABLES, None), "new-node-families": (NEW_FAMILIES, None),
            "ports": (PORTS, None), "batch-and-segment-builder": (BATCH, "batch.txt"),
            "drawer-dump-vocab-ctm": (DRAWER, None)}


@pytest.mark.parametrize("name", list(NETWORKS))
def test_network_config_matches_jax(name, tmp_path):
    config, batch_file = NETWORKS[name]
    _nodes, res, text = run_both(network_case(config, batch_file=batch_file), tmp_path,
                                 FLF_MODULES)
    if name == "end-to-end":
        assert res["seg-1"]["cndec"] == [1, 2] and res["seg-1"]["eval"] == (0, 2)
        assert "risk=" in text
    if name == "new-node-families":
        assert res["seg-1"]["oracle"] == [(0, 1), (1, 2)]


@pytest.mark.parametrize("config", ["cycle", "unknown-node"])
def test_network_rejects_bad_links_as_jax(config, tmp_path):
    text = {"cycle": "[network.a]\ntype = copy\nlinks = b\n[network.b]\ntype = copy\nlinks = a\n",
            "unknown-node": "[network.a]\ntype = copy\nlinks = nosuch\n"}[config]

    def case(P, root):
        (root / "bad.config").write_text(text)
        return outcome(parse, P, root / "bad.config")
    err = run_both(case, tmp_path, FLF_MODULES)
    assert isinstance(err, ValueError)


def test_node_functions_called_directly_match_jax(tmp_path):
    """tests/test_flf_network.py::test_extra_node_types: concatenate,
    map-labels, filter, remove-null-arcs, properties, dump-traceback."""
    def case(P, root):
        lat = toy(P)
        net = P.FlfNetwork({}, VOCAB)
        out = io.StringIO()
        ctx = {"id": "seg", "net": net, "out": out}
        withnull = P.WordLattice(num_frames=6, arcs=lat.arcs + [P.Arc(2, 2, 1, 0.5)], silence=0)
        res = [P.n_concatenate({0: lat, 1: lat}, {}, {}),
               P.n_map_labels({0: lat}, {"map": "1:3"}, {}),
               P.n_filter({0: lat}, {"max-score": "3.5", "drop-words": "2"}, {}),
               P.n_remove_null_arcs({0: withnull}, {}, {}),
               P.n_properties({0: lat}, {}, ctx), P.n_dump_traceback({0: lat}, {}, ctx)]
        return res, out.getvalue()
    run_both(case, tmp_path, FLF_MODULES)


# -- every host node on every kind of input ---------------------------------------

BLISS_LEXICON = """<?xml version="1.0" encoding="utf-8"?>
<lexicon>
  <phoneme-inventory><phoneme><symbol>a</symbol></phoneme></phoneme-inventory>
  <lemma special="silence"><orth>[silence]</orth><phon>a</phon></lemma>
  <lemma><orth>eins</orth><orth>vier</orth><phon>a a</phon><phon>a</phon></lemma>
  <lemma><orth>zwei</orth><phon>a a a</phon></lemma>
</lexicon>
"""

BLISS_CORPUS = """<?xml version="1.0" encoding="utf-8"?>
<corpus name="c"><recording name="r"><segment name="seg-1" start="0.5" end="2.0">
<orth>eins zwei</orth></segment></recording></corpus>
"""


TOY_ARPA = """
\\data\\
ngram 1=7
ngram 2=1

\\1-grams:
-0.8\t<s>\t-0.3
-0.9\t</s>
-0.7\teins\t-0.2
-0.8\tzwei\t-0.2
-0.9\tdrei\t-0.1
-1.0\tvier\t-0.1
-2.0\t<unk>

\\2-grams:
-0.3\teins zwei

\\end\\
"""


def scrub(result, root):
    """An exception as (its type name, its message with ``root`` replaced):
    a missing file's message names the run's own root."""
    if isinstance(result, Exception):
        return type(result).__name__, str(result).replace(str(root), "<root>")
    return result


def node_sweep_case(node_types):
    """Each node type of ``node_types`` called on each kind of input on
    ports 0 and 1 (two lattices, two FB-builder pairs, two CNs, two fCNs, a
    lattice with a lattice, a CN, an fCN or an automaton, an n-best list),
    with attributes that name files of the kind it reads; what each call
    returned or raised, and the printed text."""
    def case(P, root):
        lat = toy(P)
        other = P.WordLattice(num_frames=6, arcs=[P.Arc(0, 2, 1, 0.5), P.Arc(2, 6, 2, 1.5),
                                                  P.Arc(0, 6, 4, 3.0)], silence=0)
        P.LatticeArchive(str(root / "lats"), VOCAB).write("seg-1", lat)
        (root / "refs.txt").write_text("seg-1\teins zwei\n")
        (root / "hyp.ctm").write_text("seg-1 1 0.00 0.03 eins 0.9\nseg-1 1 0.03 0.03 zwei 0.8\n")
        (root / "lexicon.xml").write_text(BLISS_LEXICON)
        (root / "corpus.xml").write_text(BLISS_CORPUS)
        (root / "classes").write_text("eins C1 1\nzwei C1 1\n")
        P.write_fsa(str(root / "g.fsa"), P.Automaton.build(
            1, [(0, 0, w, 0.5 * w) for w in range(5)], {0: 0.0}))
        net = P.FlfNetwork({}, VOCAB)
        out = io.StringIO()
        ctx = {"id": "seg-1", "net": net, "out": out, "args": ["seg-1", "a.wav"],
               "device": "cuda"}          # the port's default; no host node reads it
        fb = P.n_fb_builder({0: lat}, {}, ctx)
        cn, fcn = P.confusion_network(lat), P.frame_posterior_cn(lat)
        P.CnArchive(str(root / "out")).write("seg-1", cn)
        P.FcnArchive(str(root / "out")).write("seg-1", fcn)
        (root / "toy.arpa").write_text(TOY_ARPA)
        kinds = {"lattice": (lat, other), "fb": (fb, P.n_fb_builder({0: other}, {}, ctx)),
                 "cn": (cn, P.confusion_network(other)),
                 "fcn": (fcn, P.frame_posterior_cn(other)), "lattice-lattice": (lat, lat),
                 "lattice-cn": (lat, cn), "lattice-fcn": (lat, fcn),
                 "lattice-fsa": (lat, P.Automaton.build(1, [(0, 0, w, 0.25 * w) for w in range(5)],
                                                        {0: 0.0})),
                 "n-best": (P.n_dump_n_best({0: lat}, {"n": "3"}, ctx), None)}
        attrs = {"path": str(root / "out"), "transcripts": str(root / "refs.txt"),
                 "lexicon": str(root / "lexicon.xml"), "corpus": str(root / "corpus.xml"),
                 "threshold": "0.5", "n": "3", "scale": "0.5", "gamma": "2.0",
                 "penalty": "1.5", "value": "0.25", "keys": "am", "scales": "am:0.5",
                 "classes": "C1", "C1.penalty": "0.5", "C1.words": "eins",
                 "end-time": "8", "string": "eins zwei", "map": "1:3", "alpha": "0.1",
                 "max-slot-size": "2", "weights": "2 1", "feature": "entropy",
                 "lm": str(root / "classes")}
        files = {"ctm-reader": str(root / "hyp.ctm"), "fsa-reader": str(root / "g.fsa"),
                 "compose-with-lm": str(root / "toy.arpa")}
        res = {}
        for name in node_types:
            fn = P.NODE_TYPES[name]
            a = dict(attrs, file=files.get(name, str(root / "g.fsa")))
            if name == "fCN-features":
                a["feature"] = "error"
            if name in ("archive-reader", "reader"):
                a["path"] = str(root / "lats")
            res[name] = {k: scrub(outcome(fn, {0: v[0], 1: v[1]}, a, ctx), root)
                         for k, v in kinds.items()}
        return res, out.getvalue().replace(str(root), "<root>")
    return case


HOST_NODES = sorted(set(package("port", ("search.flf_network",)).NODE_TYPES) - {"recognizer"})


@pytest.mark.parametrize("part", range(4))
def test_every_host_node_matches_jax(part, tmp_path):
    nodes = HOST_NODES[part::4]
    res, _text = run_both(node_sweep_case(nodes), tmp_path, FLF_MODULES + ("fsa.automaton",))
    assert sorted(res) == sorted(nodes)


def test_node_census_equals_jax():
    """The port registers the JAX package's node names (the reference's 96
    NodeRegistration.hh names and their aliases), each to a function of the
    same name."""
    jax_types = package("jax", ("search.flf_network",)).NODE_TYPES
    port_types = package("port", ("search.flf_network",)).NODE_TYPES
    assert sorted(port_types) == sorted(jax_types)
    assert {k: f.__name__ for k, f in port_types.items()} == \
        {k: f.__name__ for k, f in jax_types.items()}
    assert len(port_types) >= 96


# -- the recognizer node ----------------------------------------------------------

N_SEGMENTS = 10
CN_LINKS = "best cn"
CN_NODES = "[network.cn]\ntype = CN-builder\nlinks = cndec\n[network.cndec]\ntype = CN-decoder\n"


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURES / "demo_recognition.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def recognized(golden, tmp_path_factory):
    """The network ``rec -> best``, ``rec -> CN-builder -> CN-decoder`` over
    the first demo segments: {"jax": ..., "port": ...} → (node results by
    segment, printed text)."""
    cfg = recognizer_config(tmp_path_factory.mktemp("rec") / "net.config", golden["config"],
                            links=CN_LINKS, extra=CN_NODES)
    names = demo_segment_names(N_SEGMENTS)
    out = {}
    for which in ("jax", "port"):
        P = package(which, FLF_MODULES)
        lexicon = importlib.import_module(f"{ROOTS[which]}.lexicon").build_sietill_lexicon()
        kw = {"device": "cpu"} if which == "port" else {}
        net = P.FlfNetwork.parse(P.SprintConfig.read(str(cfg)), list(lexicon.orth),
                                 silence=lexicon.silence_idx, **kw)
        text = io.StringIO()
        out[which] = (net.run(names, out=text), text.getvalue())
    return out


def test_recognizer_best_paths_equal_golden(recognized, golden):
    res, _text = recognized["port"]
    names = demo_segment_names(N_SEGMENTS)
    hyps = {u["idx"]: u["hyp"] for u in golden["utts"]}
    for i, name in enumerate(names):
        assert [w for w in res[name]["best"] if w != 0] == hyps[i], name


@pytest.mark.parametrize("segment", range(N_SEGMENTS))
def test_recognizer_lattice_equals_jax(recognized, segment):
    """Arcs (start, end, word) and their order exactly, scores within 1e-9
    relative; the best path and the CN decode exactly.

    The CN itself is not held equal: the center-frame builder takes arcs in
    order of posterior, and arcs that lie on every path have posterior 1 up
    to the rounding of the forward-backward sums, so which of them opens a
    slot first follows the scores' last bits. On the 35 demo segments that
    reorders the slots of 6 (ac_zo_fu.08, nu_ac_ne.08, nu_vi_ne.08,
    si_ac_se.08, tel1_num.08, z51_ket.08; posteriors 1 against 1 - 4e-12);
    the decodes stay equal. The builder itself is held bit-equal to JAX's on
    the same lattice (the JAX node's) here and in tests/test_torch_flf.py."""
    from speechrecognition_torch.search.flf import CnSlot, confusion_network
    from speechrecognition_torch.search.lattice import Arc, WordLattice

    name = demo_segment_names(N_SEGMENTS)[segment]
    want, got = recognized["jax"][0][name], recognized["port"][0][name]
    assert [(a.start, a.end, a.word) for a in got["rec"].arcs] == \
        [(a.start, a.end, a.word) for a in want["rec"].arcs]
    assert_same(want["rec"], got["rec"], rtol=SCORE_RTOL)
    assert got["best"] == want["best"] and got["cndec"] == want["cndec"]
    same_input = WordLattice(want["rec"].num_frames,
                             [Arc(a.start, a.end, a.word, a.score) for a in want["rec"].arcs],
                             want["rec"].silence)
    built = confusion_network(same_input)
    assert all(isinstance(s, CnSlot) for s in built)
    assert_same(want["cn"], built)


def test_recognizer_printed_text_equals_jax(recognized):
    assert recognized["port"][1] == recognized["jax"][1]


def test_cn_consensus_on_demo_lattices(recognized):
    """tests/test_flf.py:107 on the port: CN consensus over the recognizer's
    lattices is at least as good as their best paths."""
    from speechrecognition_torch.corpus import CorpusDescription
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.search.edit_distance import edit_distance
    from speechrecognition_torch.search.flf import cn_decode, confusion_network

    desc = CorpusDescription.read(str(FIXTURES / "demo_corpus.json"), build_sietill_lexicon())
    res, _text = recognized["port"]
    err_best = err_cn = total = 0
    for seg in desc.segments[:N_SEGMENTS]:
        lat = res[seg.name]["rec"]
        ref = list(seg.orth)
        err_best += edit_distance(ref, [w for w in lat.best_path()[0] if w != 0]).total_count
        err_cn += edit_distance(ref, [w for w in cn_decode(confusion_network(lat))
                                      if w != 0]).total_count
        total += len(ref)
    assert total > 0
    assert err_cn <= err_best + max(2, int(0.02 * total)), (err_cn, err_best)


def test_recognizer_node_raises_without_cuda(golden, tmp_path, monkeypatch):
    """At the default device and with CUDA hidden, the recognizer node
    raises when it runs (nothing falls back to the CPU); a host network at
    the default device still runs."""
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.search.flf import LatticeArchive
    from speechrecognition_torch.search.flf_network import FlfNetwork
    from speechrecognition_torch.sprint.config import SprintConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lex = build_sietill_lexicon()
    cfg = recognizer_config(tmp_path / "net.config", golden["config"])
    net = FlfNetwork.parse(SprintConfig.read(str(cfg)), list(lex.orth), silence=lex.silence_idx)
    assert net.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.run(demo_segment_names(1), out=io.StringIO())

    P = package("port", FLF_MODULES)
    LatticeArchive(str(tmp_path / "lats"), VOCAB).write("seg-1", toy(P))
    (tmp_path / "host.config").write_text(VARIABLES.replace("{root}", str(tmp_path)))
    host = FlfNetwork.parse(SprintConfig.read(str(tmp_path / "host.config")), VOCAB)
    assert host.run(["seg-1"], out=io.StringIO())["seg-1"]["best"] == [1, 2]


def test_recognizer_f64_scores_come_from_the_device_pack(golden, tmp_path):
    """The recognizer builds an f64 "mxu" pack on the network's device (one
    per mixture file, cached on the network) and decodes each segment there."""
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.search import ngram_decoder
    from speechrecognition_torch.search.flf_network import FlfNetwork
    from speechrecognition_torch.sprint.config import SprintConfig

    lex = build_sietill_lexicon()
    cfg = recognizer_config(tmp_path / "net.config", golden["config"])
    net = FlfNetwork.parse(SprintConfig.read(str(cfg)), list(lex.orth), silence=lex.silence_idx,
                           device="cpu")
    calls = []
    real = ngram_decoder.decode_scan_bigram

    def spy(am, *args, **kwargs):
        calls.append((am.dtype, am.device.type, am.shape[0]))
        return real(am, *args, **kwargs)

    ngram_decoder.decode_scan_bigram = spy
    try:
        net.run(demo_segment_names(2), out=io.StringIO())
    finally:
        ngram_decoder.decode_scan_bigram = real
    assert calls == [(torch.float64, "cpu", 1)] * 2
    assert len(net._archives_misc) == 1
    assert np.isfinite([a.score for a in net.run(demo_segment_names(1), out=io.StringIO())[
        demo_segment_names(1)[0]]["rec"].arcs]).all()
