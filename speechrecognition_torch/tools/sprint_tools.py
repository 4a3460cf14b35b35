"""Sprint-style command-line tools — counterpart of
speechrecognition_tpu/tools/sprint_tools.py on the port's sprint/, fsa/,
lm/ and search/flf* modules.

Counterparts of the reference's Tools/ binaries
(rwth-asr-0.5/src/Tools/):
  * archiver          — Tools/Archiver/Archiver.cc (list/extract/show
                        file archives and feature caches)
  * corpus-statistics — Tools/CorpusStatistics (segments/words/duration)
  * feature-statistics— Tools/FeatureStatistics (per-dim mean/σ, frames)
  * lattice-processor — Tools/LatticeProcessor + Tools/Flf (best, n-best,
                        posterior prune, confusion-network decode over
                        lattice archives)

Usage: python -m speechrecognition_torch.tools.sprint_tools <tool> [args...]
[--device cpu]

``lattice-processor ... network <config>`` runs an Flf network whose
``recognizer`` node decodes on the card (kernel J) unless ``--device``
names another device; every other tool is host work.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np


# -- archiver -----------------------------------------------------------------

def archiver(args: Sequence[str], out=sys.stdout) -> int:
    """archiver <archive> [list | show <key> | extract <key> <file>]"""
    from ..sprint.archive import FileArchive
    if not args:
        print("usage: archiver <archive> [list|show <key>|extract <key> <out>]",
              file=sys.stderr)
        return 1
    arch = FileArchive(args[0])
    mode = args[1] if len(args) > 1 else "list"
    if mode == "list":
        for k in arch.keys():
            print(k, file=out)
        return 0
    if mode == "show":
        data = arch.read(args[2])
        out.write(data.decode("utf-8", "replace"))
        return 0
    if mode == "extract":
        with open(args[3], "wb") as f:
            f.write(arch.read(args[2]))
        return 0
    print(f"archiver: unknown mode {mode}", file=sys.stderr)
    return 1


# -- corpus statistics ----------------------------------------------------------

def corpus_statistics(args: Sequence[str], out=sys.stdout) -> int:
    """corpus-statistics <bliss-corpus.xml[.gz] | sietill-corpus.json>"""
    path = args[0]
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        segs = data if isinstance(data, list) else data.get("segments", data)
        n = len(segs)
        words = sum(len(str(s.get("orth", "")).split()) for s in segs)
        speakers = {s.get("speaker") for s in segs if s.get("speaker")}
        genders: Dict[str, int] = {}
        for s in segs:
            g = s.get("gender")
            if g:
                genders[g] = genders.get(g, 0) + 1
    else:
        from ..sprint.bliss import BlissCorpus
        corpus = BlissCorpus.read(path)
        segs = corpus.segments
        n = len(segs)
        words = sum(len(s.orth) for s in segs)
        # Bliss recordings play the speaker-grouping role in this corpus
        speakers = {s.recording for s in segs}
        genders = {}
        durations = [s.end - s.start for s in segs
                     if np.isfinite(s.end - s.start)]
        stats_extra = {"duration": round(float(sum(durations)), 2)} \
            if durations else {}
        stats = {"segments": n, "words": words, "speakers": len(speakers),
                 "gender": genders, **stats_extra}
        print(json.dumps(stats), file=out)
        return 0
    stats = {"segments": n, "words": words, "speakers": len(speakers),
             "gender": genders}
    print(json.dumps(stats), file=out)
    return 0


# -- feature statistics -----------------------------------------------------------

def feature_statistics(args: Sequence[str], out=sys.stdout) -> int:
    """feature-statistics <cache-file | dir-of-mm2> [dim]"""
    path = args[0]
    total = 0
    mean = None
    sqr = None
    if path.endswith(".cache") or "cache" in path.rsplit("/", 1)[-1]:
        from ..sprint.flow_cache import FeatureCache
        cache = FeatureCache(path)
        for key in cache.segments:
            feats, _t = cache.read_features(key)
            if mean is None:
                mean = np.zeros(feats.shape[1])
                sqr = np.zeros(feats.shape[1])
            mean += feats.sum(axis=0)
            sqr += (feats.astype(np.float64) ** 2).sum(axis=0)
            total += feats.shape[0]
    else:
        import os
        from ..io import read_feature_file
        dim = int(args[1]) if len(args) > 1 else 12
        for root, _d, files in os.walk(path):
            for fn in sorted(files):
                if not fn.endswith(".mm2"):
                    continue
                feats = read_feature_file(os.path.join(root, fn)).reshape(-1, dim)
                if mean is None:
                    mean = np.zeros(dim)
                    sqr = np.zeros(dim)
                mean += feats.sum(axis=0)
                sqr += (feats.astype(np.float64) ** 2).sum(axis=0)
                total += feats.shape[0]
    if total == 0:
        print(json.dumps({"frames": 0}), file=out)
        return 0
    mu = mean / total
    sd = np.sqrt(np.maximum(sqr / total - mu * mu, 0.0))
    print(json.dumps({"frames": total, "dim": len(mu),
                      "mean": [round(float(x), 6) for x in mu],
                      "std": [round(float(x), 6) for x in sd]}), file=out)
    return 0


# -- lattice processor -------------------------------------------------------------

def lattice_processor(args: Sequence[str], out=sys.stdout, device="cuda") -> int:
    """lattice-processor <archive-dir> <vocab-file> <op> [args...]

    ops: best | n-best <n> | prune <-log-posterior> <out-archive> |
         cn-decode | cn-decode-pivot | push <out-archive> |
         compose-linear <transcript-file> | oracle-wer <transcript-file> |
         union <out-archive> <in-archive2> [<in-archive3>...] |
         mesh <out-archive> | determinize | minimize |
         rescore-arpa <arpa-file> [<scale>] |
         mbr-decode [<word-penalty>] | network <config-file>
    Vocab file: one word per line (index = word id). Transcript files:
    "<name>\\t<words...>" per line (words in vocab). ``device``: where a
    network's recognizer node scores and decodes."""
    from ..search.flf import (LatticeArchive, cn_decode, compose_linear,
                              confusion_network, determinize_lattice,
                              mesh_lattice, minimize_lattice,
                              pivot_confusion_network, push_lattice,
                              rescore_arpa, union_lattices)
    arch_path, vocab_path, op = args[0], args[1], args[2]
    with open(vocab_path) as f:
        vocab = [l.strip() for l in f if l.strip()]
    arch = LatticeArchive(arch_path, vocab)
    names = arch.list()
    if op == "best":
        for name in names:
            lat = arch.read(name)
            words, score = lat.best_path()
            text = " ".join(vocab[w] for w in words if w != lat.silence)
            print(f"{name}\t{score:.4f}\t{text}", file=out)
        return 0
    if op == "n-best":
        n = int(args[3])
        for name in names:
            lat = arch.read(name)
            for rank, (words, score) in enumerate(lat.n_best(n)):
                text = " ".join(vocab[w] for w in words if w != lat.silence)
                print(f"{name}\t{rank}\t{score:.4f}\t{text}", file=out)
        return 0
    if op == "prune":
        thr = float(args[3])
        dst = LatticeArchive(args[4], vocab)
        for name in names:
            dst.write(name, arch.read(name).posterior_prune(thr))
        return 0
    if op == "cn-decode":
        for name in names:
            lat = arch.read(name)
            hyp = cn_decode(confusion_network(lat))
            text = " ".join(vocab[w] for w in hyp if w != lat.silence)
            print(f"{name}\t{text}", file=out)
        return 0
    if op == "push":
        dst = LatticeArchive(args[4] if len(args) > 4 else args[3], vocab)
        for name in names:
            dst.write(name, push_lattice(arch.read(name)))
        return 0
    if op == "cn-decode-pivot":
        for name in names:
            lat = arch.read(name)
            hyp = cn_decode(pivot_confusion_network(lat))
            text = " ".join(vocab[w] for w in hyp if w != lat.silence)
            print(f"{name}\t{text}", file=out)
        return 0
    if op == "union":
        dst = LatticeArchive(args[3], vocab)
        others = [LatticeArchive(p, vocab) for p in args[4:]]
        for name in names:
            lats = [arch.read(name)] + [o.read(name) for o in others
                                        if name in o.list()]
            dst.write(name, union_lattices(lats))
        return 0
    if op == "mesh":
        dst = LatticeArchive(args[3], vocab)
        for name in names:
            dst.write(name, mesh_lattice(arch.read(name)))
        return 0
    if op in ("determinize", "minimize"):
        fn = determinize_lattice if op == "determinize" else minimize_lattice
        for name in names:
            lat = arch.read(name)
            a = fn(lat)
            from ..fsa.ops import best_path as fsa_best
            labels, _states, score = fsa_best(a)
            text = " ".join(vocab[w] for w in labels
                            if 0 <= w < len(vocab) and w != lat.silence)
            print(f"{name}\t{a.num_states} states\t{a.num_arcs} arcs\t"
                  f"{score:.4f}\t{text}", file=out)
        return 0
    if op == "rescore-arpa":
        # requires a CONTEXT archive (split am/lm arc fields, written by
        # LatticeArchive(context=True)); detected from the SLF header
        from ..lm.arpa import ArpaLM
        import gzip as _gzip
        lm = ArpaLM(args[3])
        scale = float(args[4]) if len(args) > 4 else 1.0
        if names:
            with _gzip.open(arch._file(names[0]), "rt") as f:
                head = f.read(4096)
            if "num_contexts=" not in head:
                print("rescore-arpa: archive is not a context archive "
                      "(no split am/lm fields)", file=sys.stderr)
                return 1
        carch = LatticeArchive(arch_path, vocab, context=True)
        for name in names:
            lat = carch.read(name)
            words, score = rescore_arpa(lat, lm, vocab, scale=scale)
            text = " ".join(vocab[w] for w in words if w != lat.silence)
            print(f"{name}\t{score:.4f}\t{text}", file=out)
        return 0
    if op in ("compose-linear", "oracle-wer"):
        word_idx = {w: i for i, w in enumerate(vocab)}
        refs = {}
        with open(args[3]) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 2:
                    refs[parts[0]] = [word_idx[w] for w in parts[1].split()
                                      if w in word_idx]
        for name in names:
            lat = arch.read(name)
            ref = refs.get(name, [])
            if op == "compose-linear":
                score, path = compose_linear(lat, ref)
                print(f"{name}\t{score:.4f}\t{len(path)} arcs", file=out)
            else:
                err, R = lat.oracle_wer(ref)
                print(f"{name}\t{err}\t{R}", file=out)
        return 0
    if op == "mbr-decode":
        # minimum-expected-frame-error decoding (Flf/LocalCostDecoder.cc)
        from ..search.flf_network import local_cost_decode
        wp = float(args[3]) if len(args) > 3 else 0.0
        for name in names:
            lat = arch.read(name)
            words, risk = local_cost_decode(lat, word_penalty=wp)
            text = " ".join(vocab[w] for w in words if w != lat.silence)
            print(f"{name}\trisk={risk:.4f}\t{text}", file=out)
        return 0
    if op == "network":
        # config-driven processor network over the archive (Flf tool
        # execution model, search/flf_network.py); the config's
        # archive-reader nodes may reference this archive's path
        from ..search.flf_network import FlfNetwork
        from ..sprint.config import SprintConfig
        net = FlfNetwork.parse(SprintConfig.read(args[3]), vocab, device=device)
        net.run(names, out=out)
        return 0
    print(f"lattice-processor: unknown op {op}", file=sys.stderr)
    return 1


def allophone_tool(args: Sequence[str], out=sys.stdout) -> int:
    """allophone-tool <lexicon.xml[.gz]> <cart.tree[.gz]>
    [dump-allophones | dump-allophone-states | dump-state-tying]

    Counterpart of Tools/AcousticModelTrainer/AllophoneTool.cc: dumps
    the allophone inventory, the allophone states, or the
    allophone-state → mixture (CART class) mapping in the reference's
    `%-32s %9d %9d` dump-state-tying format (AllophoneTool.cc:41-90).
    Allophones are the within-word triphones realized by the lexicon's
    pronunciations ('#' at word boundaries, across-word-model = no)."""
    from ..sprint.am import AllophoneStateModel
    from ..sprint.bliss import BlissLexicon
    from ..sprint.cart import DecisionTree

    if len(args) < 2:
        print("usage: allophone-tool <lexicon> <cart-tree> [mode]",
              file=sys.stderr)
        return 1
    lex = BlissLexicon.read(args[0])
    tree = DecisionTree.read(args[1])
    mode = args[2] if len(args) > 2 else "dump-state-tying"
    asm = AllophoneStateModel(bliss=lex, tree=tree)

    allophones = []
    seen = set()
    for lemma in lex.lemmas:
        for pron in lemma.pronunciations:
            n = len(pron)
            for i, ph in enumerate(pron):
                hist = pron[i - 1] if i > 0 else "#"
                fut = pron[i + 1] if i < n - 1 else "#"
                if n == 1:
                    boundary = "single-phoneme-lemma"
                elif i == 0:
                    boundary = "begin-of-lemma"
                elif i == n - 1:
                    boundary = "end-of-lemma"
                else:
                    boundary = "within-lemma"
                key = (ph, hist, fut, boundary)
                if key not in seen:
                    seen.add(key)
                    allophones.append(key)
    allophones.sort()

    def name(ph, hist, fut, boundary):
        flags = {"single-phoneme-lemma": "@i@f", "begin-of-lemma": "@i",
                 "end-of-lemma": "@f", "within-lemma": ""}[boundary]
        return f"{ph}{{{hist}+{fut}}}{flags}"

    if mode == "dump-allophones":
        for a in allophones:
            print(name(*a), file=out)
        return 0
    if mode == "dump-allophone-states":
        for a in allophones:
            for s in range(asm.states_per_phone):
                print(f"{name(*a)}.{s}", file=out)
        return 0
    if mode == "dump-state-tying":
        print("<allophone-state-mapping>", file=out)
        idx = 0
        for a in allophones:
            ph, hist, fut, boundary = a
            for s in range(asm.states_per_phone):
                cls = tree.classify({
                    "central": ph, "history[0]": hist, "future[0]": fut,
                    "hmm-state": str(s), "boundary": boundary})
                print(f"{name(*a) + '.' + str(s):<32s} {idx:9d} {cls:9d}",
                      file=out)
                idx += 1
        print("</allophone-state-mapping>", file=out)
        return 0
    print(f"allophone-tool: unknown mode {mode}", file=sys.stderr)
    return 1


def cart_viewer(args: Sequence[str], out=sys.stdout) -> int:
    """cart-viewer <cart.tree[.gz]> [text|dot]

    Counterpart of Tools/Cart/CartViewer.cc: renders the decision tree
    — indented text (question key/values per inner node, class id per
    leaf) or graphviz dot."""
    from ..sprint.cart import DecisionTree

    if not args:
        print("usage: cart-viewer <cart-tree> [text|dot]", file=sys.stderr)
        return 1
    tree = DecisionTree.read(args[0])
    mode = args[1] if len(args) > 1 else "text"

    if mode == "text":
        def emit(node, depth):
            pad = "  " * depth
            if node.is_leaf:
                print(f"{pad}class {node.id}", file=out)
                return
            q = tree.questions[node.id]
            vals = " ".join(sorted(q.values))
            print(f"{pad}{q.key} in {{{vals}}} ?", file=out)
            emit(node.left, depth + 1)
            emit(node.right, depth + 1)

        emit(tree.root, 0)
        return 0
    if mode == "dot":
        print('digraph "cart" {\nnode [fontname="Helvetica"]', file=out)

        def emit(node):
            if node.is_leaf:
                print(f'n{id(node)} [shape=box label="class {node.id}"]',
                      file=out)
                return
            q = tree.questions[node.id]
            vals = " ".join(sorted(q.values))
            print(f'n{id(node)} [label="{q.key}\\n{vals}"]', file=out)
            print(f'n{id(node)} -> n{id(node.left)} [label="yes"]',
                  file=out)
            print(f'n{id(node)} -> n{id(node.right)} [label="no"]',
                  file=out)
            emit(node.left)
            emit(node.right)

        emit(tree.root)
        print("}", file=out)
        return 0
    print(f"cart-viewer: unknown mode {mode}", file=sys.stderr)
    return 1


def cart_converter(args: Sequence[str], out=sys.stdout) -> int:
    """cart-converter <old-legacy-tree> <new-cart.xml>
    [--boundary-style STYLE]

    Counterpart of Tools/Cart/CartConverter.py: legacy text tree →
    Sprint CART XML with identical classification (see
    sprint/cart_convert.py for the property mapping)."""
    from ..sprint.cart_convert import convert_legacy_tree
    from ..sprint.cart_train import write_tree_xml
    from ..sprint.legacy_tree import LegacyDecisionTree

    if len(args) < 2:
        print("usage: cart-converter <old-tree> <new-xml> "
              "[--boundary-style STYLE]", file=sys.stderr)
        return 1
    style = "no-pos-dep"
    if "--boundary-style" in args:
        style = args[list(args).index("--boundary-style") + 1]
    legacy = LegacyDecisionTree.read(args[0], boundary_style=style)
    tree = convert_legacy_tree(legacy)
    write_tree_xml(tree, args[1])
    print(f"converted {args[0]} → {args[1]} "
          f"({legacy.num_classes} classes, {len(tree.questions)} "
          f"node questions)", file=out)
    return 0


def flowdraw(args: Sequence[str], out=sys.stdout) -> int:
    """flowdraw <network.flow>

    Counterpart of Tools/Flow/flowdraw.py: Flow network XML → graphviz
    dot (nodes + links + network in/out ports)."""
    import xml.etree.ElementTree as ET

    if not args:
        print("usage: flowdraw <network.flow>", file=sys.stderr)
        return 1
    root = ET.parse(args[0]).getroot()
    netname = root.get("name") or "network"

    def clean(s):
        return s.replace("-", "_").replace(":", "_").replace("$", "")

    print("digraph flow {", file=out)
    for io_el in list(root.findall("in")) + list(root.findall("out")):
        n = io_el.get("name")
        print(f'{clean(n)} [shape=plaintext label="{netname}:{n}"];',
              file=out)
    for node in root.findall("node"):
        name = node.get("name")
        filt = node.get("filter", "")
        print(f'{clean(name)} [shape=record label="{name}\\n{filt}"];',
              file=out)
    for link in root.findall("link"):
        frm = (link.get("from") or "").split(":")[0]
        to = (link.get("to") or "").split(":")[0]
        if frm and to:
            print(f"{clean(frm)} -> {clean(to)};", file=out)
    print("}", file=out)
    return 0


TOOLS = {
    "archiver": archiver,
    "corpus-statistics": corpus_statistics,
    "feature-statistics": feature_statistics,
    "lattice-processor": lattice_processor,
    "allophone-tool": allophone_tool,
    "cart-viewer": cart_viewer,
    "cart-converter": cart_converter,
    "flowdraw": flowdraw,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        k = argv.index("--device")
        device = argv[k + 1]
        del argv[k:k + 2]
    if not argv or argv[0] not in TOOLS:
        print(f"usage: sprint_tools <{'|'.join(TOOLS)}> [args...] [--device cpu]",
              file=sys.stderr)
        return 1
    if argv[0] == "lattice-processor":
        return lattice_processor(argv[1:], device=device)
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
