"""Seeded Sprint setups at the AN4 system's shape: the files that
``tools.an4_system.build_system`` reads (a Bliss lexicon and corpus, a CART
tree, a recognition config and its pruned twin with the AN4 TDP block, an
MFCC feature cache, an LDA matrix, and the three Flow files of
cache.lda.flow), written from a seed.

The published AN4 test setup (bench/an4/RESULTS.md): 130 segments, 35,570
frames, 131 search-lexicon entries, 501 tied classes of which silence has
classes of its own, a 16-dimensional cache, a 9-frame window (right 4) and
an LDA to 45 dimensions. ``write_setup`` writes that shape by default and
smaller ones for the CPU tests. The features are drawn near a mean per
tied class along a path through each segment's chain (silence, each word's
states, a silence after each word), so a trained model aligns them; every
chain fits its segment (at least one frame a position).

Shared by tests/test_torch_sprint*.py, test_torch_state_graph.py and
chip_smoke.py (which loads this file by path). Imports numpy and the
standard library only.
"""

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

#: the AN4 recognition config's [*.acoustic-model.tdp] block
#: (tests/torch_linear_tables.py's AN4_TDP_CONFIG), the LM scale and the
#: pruned config's acoustic pruning
AN4_CONFIG = """\
[*.acoustic-model.tdp]
scale = 1.0
*.loop = 3.0
*.forward = 0.0
*.skip = 3.0
*.exit = 150.0
silence.loop = 0.0001
silence.forward = 3.0
silence.skip = infinity
silence.exit = 15.0
entry-m1.loop = infinity

[*.lm]
scale = 1.0
"""
AN4_PRUNED = AN4_CONFIG + """
[*]
acoustic-pruning = 200
"""

#: AN4's published shape
AN4_SHAPE = dict(segments=130, frames=35570, prons=130, classes=501, phonemes=34,
                 base_dim=16, window=9, right=4, lda_dim=45, words=(5, 21))
#: a CPU test's shape
SMALL_SHAPE = dict(segments=6, frames=900, prons=14, classes=40, phonemes=10,
                   base_dim=16, window=9, right=4, lda_dim=12, words=(2, 5))

SILENCE = "si"
BOUNDARIES = ("single-phoneme-lemma", "begin-of-lemma", "end-of-lemma", "within-lemma")

CACHE_LDA_FLOW = """\
<?xml version="1.0" encoding="ISO-8859-1"?>
<network>
  <out name="features"/>
  <param name="id"/>
  <node name="base-feature-extraction-cache" filter="generic-cache" id="$(id)"/>
  <node name="lda" filter="lda.flow"/>
  <link from="base-feature-extraction-cache" to="lda"/>
  <link from="lda" to="network:features"/>
</network>
"""
LDA_FLOW = """\
<?xml version="1.0" encoding="ISO-8859-1"?>
<network>
  <in name="in"/>
  <out name="out"/>
  <node name="window" filter="window.flow" max-size="{window}" right="{right}"/>
  <link from="network:in" to="window"/>
  <node name="multiplication" filter="signal-matrix-multiplication-f32" file="$(file)"/>
  <link from="window" to="multiplication"/>
  <link from="multiplication" to="network:out"/>
</network>
"""
WINDOW_FLOW = """\
<?xml version="1.0" encoding="ISO-8859-1"?>
<network>
  <in name="in"/>
  <out name="out"/>
  <node name="lda-window" filter="signal-vector-f32-sequence-concatenation"
        max-size="$(max-size)" right="$(right)"/>
  <link from="network:in" to="lda-window"/>
  <link from="lda-window" to="network:out"/>
</network>
"""


@dataclass
class Setup:
    """The written files' paths, and what the writer knows of them: each
    segment's Bliss key, orthography, chain of tied classes and frames."""

    root: str
    paths: Dict[str, str]
    keys: List[str] = field(default_factory=list)
    orths: List[List[str]] = field(default_factory=list)
    chains: List[np.ndarray] = field(default_factory=list)
    frames: List[int] = field(default_factory=list)
    num_classes: int = 0
    base: Dict[str, np.ndarray] = field(default_factory=dict)

    def build_system_args(self) -> Dict[str, str]:
        """The keyword arguments of tools.an4_system.build_system."""
        p = self.paths
        return dict(config=p["config"], pruned_config=p["pruned_config"], lexicon=p["lexicon"],
                    corpus=p["corpus"], cart_tree=p["cart_tree"], flow=p["flow"],
                    cache=p["cache"], lda=p["lda"])

    def flow_config(self) -> Dict[str, str]:
        return {"base-feature-extraction-cache.path": self.paths["cache"],
                "lda.file": self.paths["lda"]}


def _lexicon(rng, n_prons: int, phones: List[str]):
    """Lemma orths and pronunciations: ``n_prons`` pronunciations of 1 to 10
    phones (mean about 3.3), every tenth lemma with a second variant."""
    lemmas: List[Tuple[str, List[List[str]]]] = []
    left = n_prons
    i = 0
    while left > 0:
        n_var = 2 if i % 10 == 9 and left >= 2 else 1
        prons = []
        for _ in range(n_var):
            n = int(np.clip(1 + rng.poisson(2.3), 1, 10))
            prons.append([phones[int(k)] for k in rng.integers(0, len(phones), n)])
        lemmas.append((f"W{i:03d}", prons))
        left -= n_var
        i += 1
    return lemmas


def _contexts(pron: List[str]) -> List[Tuple[str, str, str, str, str]]:
    """(central, history[0], future[0], hmm-state, boundary) of each state of
    a pronunciation, as AllophoneStateModel.tied_states_for_pron asks them."""
    out = []
    n = len(pron)
    for i, ph in enumerate(pron):
        hist = pron[i - 1] if i > 0 else "#"
        fut = pron[i + 1] if i < n - 1 else "#"
        b = BOUNDARIES[0] if n == 1 else BOUNDARIES[1] if i == 0 else \
            BOUNDARIES[2] if i == n - 1 else BOUNDARIES[3]
        for s in range(3):
            out.append((ph, hist, fut, str(s), b))
    return out


KEYS = ("central", "history[0]", "future[0]", "hmm-state", "boundary")


def _tree(rng, contexts, phones: List[str], num_classes: int):
    """A binary CART tree whose leaves split the used contexts into
    ``num_classes`` classes: silence's three states first (classes 0-2), then
    the other leaves, each holding at least one used context. Returns
    (questions [(key, values)], nested nodes, class of each context)."""
    questions: List[Tuple[str, Tuple[str, ...]]] = [("central", (SILENCE,)),
                                                    ("hmm-state", ("0",)),
                                                    ("hmm-state", ("1",))]
    for ph in phones:
        questions.append(("central", (ph,)))
    for b in BOUNDARIES:
        questions.append(("boundary", (b,)))
    ctx_values = ["#"] + phones
    for _ in range(4 * len(phones)):
        key = ("history[0]", "future[0]")[int(rng.integers(0, 2))]
        k = int(rng.integers(1, len(ctx_values)))
        questions.append((key, tuple(sorted(rng.choice(ctx_values, k, replace=False)))))
    qvals = [(KEYS.index(k), set(v)) for k, v in questions]

    # a leaf: ["leaf", contexts]; an inner node: ["node", question, yes, no]
    sil = [c for c in contexts if c[0] == SILENCE]
    rest = [c for c in contexts if c[0] != SILENCE]
    sil_by_state = [[c for c in sil if c[3] == str(s)] for s in range(3)]
    root = ["node", 0,
            ["node", 1, ["leaf", sil_by_state[0]],
             ["node", 2, ["leaf", sil_by_state[1]], ["leaf", sil_by_state[2]]]],
            ["leaf", rest]]
    leaves = [root[3]]
    n_leaves = 3 + 1
    while n_leaves < num_classes:
        splittable = [lf for lf in leaves if len(lf[1]) >= 2 and lf[-1] != "final"]
        if not splittable:
            raise ValueError(f"only {n_leaves} classes can be told apart, not {num_classes}")
        lf = max(splittable, key=lambda x: len(x[1]) + rng.uniform())
        for qi in rng.permutation(len(questions)):
            ki, vals = qvals[qi]
            yes = [c for c in lf[1] if c[ki] in vals]
            if 0 < len(yes) < len(lf[1]):
                no = [c for c in lf[1] if c[ki] not in vals]
                y, n = ["leaf", yes], ["leaf", no]
                lf[:] = ["node", int(qi), y, n]
                leaves.remove(lf)
                leaves.extend([y, n])
                n_leaves += 1
                break
        else:
            lf.append("final")       # no question tells its contexts apart
    # class ids: silence's leaves 0-2, then the others in pre-order
    cls: Dict[tuple, int] = {}
    nxt = [0]

    def number(node):
        if node[0] == "leaf":
            node.insert(1, nxt[0])
            for c in node[2]:
                cls[c] = nxt[0]
            nxt[0] += 1
        else:
            number(node[2])
            number(node[3])

    number(root)
    return questions, root, cls


def _tree_xml(questions, root) -> str:
    lines = ['<?xml version="1.0" encoding="ISO-8859-1"?>', "<decision-tree>",
             "  <properties-definition>", "  </properties-definition>", "  <questions>"]
    for key, vals in questions:
        lines.append("    <question>")
        lines.append(f"      <key>{key}</key>")
        lines.append(f"      <value>{vals[0]}</value>" if len(vals) == 1
                     else f"      <values>{' '.join(vals)}</values>")
        lines.append("    </question>")
    lines += ["  </questions>", "  <binary-tree>"]

    def emit(node, pad):
        if node[0] == "leaf":
            lines.append(f'{pad}<node id="{node[1]}"/>')
        else:
            lines.append(f'{pad}<node id="{node[1]}">')
            emit(node[2], pad + "  ")
            emit(node[3], pad + "  ")
            lines.append(f"{pad}</node>")

    emit(root, "    ")
    lines += ["  </binary-tree>", "</decision-tree>", ""]
    return "\n".join(lines)


def _lexicon_xml(phones: List[str], lemmas) -> str:
    lines = ['<?xml version="1.0" encoding="ISO-8859-1"?>', "<lexicon>", "  <phoneme-inventory>"]
    for ph in [SILENCE] + phones:
        lines.append(f"    <phoneme><symbol>{ph}</symbol></phoneme>")
    lines.append("  </phoneme-inventory>")
    lines.append('  <lemma special="silence"><orth>[SILENCE]</orth><phon>si</phon></lemma>')
    lines.append('  <lemma special="sentence-begin"><orth>&lt;s&gt;</orth></lemma>')
    lines.append('  <lemma special="sentence-end"><orth>&lt;/s&gt;</orth></lemma>')
    for orth, prons in lemmas:
        lines.append(f"  <lemma><orth>{orth}</orth>"
                     + "".join(f"<phon>{' '.join(p)}</phon>" for p in prons) + "</lemma>")
    lines += ["</lexicon>", ""]
    return "\n".join(lines)


def _cache_entry(feats: np.ndarray) -> bytes:
    """One segment's BinaryOutputStream: the datatype, the packet count and
    the vector-f32 packets (size, values, f64 start and end times)."""
    name = b"vector-f32"
    parts = [struct.pack("<I", len(name)), name, struct.pack("<I", feats.shape[0])]
    for t, row in enumerate(feats.astype("<f4")):
        parts += [struct.pack("<I", row.size), row.tobytes(),
                  struct.pack("<dd", 0.01 * t, 0.01 * (t + 1))]
    return b"".join(parts)


def _write_archive(path: str, entries: Dict[str, bytes]) -> None:
    """A Sprint SP_ARC1 archive, raw blocks, checksum 0, no info table."""
    with open(path, "wb") as f:
        f.write(b"SP_ARC1\x00\x00")
        for name, data in entries.items():
            nb = name.encode()
            f.write(struct.pack("<II", 0xAA55AA55, len(nb)) + nb)
            f.write(struct.pack("<III", len(data), 0, 0) + data)
            f.write(struct.pack("<I", 0x55AA55AA))


def write_setup(root: str, seed: int = 0, **shape) -> Setup:
    """Write a seeded setup of ``shape`` (AN4_SHAPE's keys; AN4_SHAPE by
    default) under ``root``."""
    s = {**AN4_SHAPE, **shape}
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    phones = [f"p{i:02d}" for i in range(s["phonemes"])]
    lemmas = _lexicon(rng, s["prons"], phones)
    contexts = sorted({c for _o, prons in lemmas for p in prons for c in _contexts(p)}
                      | set(_contexts([SILENCE])))
    questions, tree, cls = _tree(rng, contexts, phones, s["classes"])

    def chain_of(orth_words):
        first = {o: p[0] for o, p in lemmas}
        sil = [cls[c] for c in _contexts([SILENCE])]
        out = list(sil)
        for w in orth_words:
            out += [cls[c] for c in _contexts(first[w])] + sil
        return np.asarray(out, np.int32)

    B = s["segments"]
    lo, hi = s["words"]
    n_words = np.clip(lo + rng.poisson(0.8, B), lo, hi)
    n_words[0] = hi
    orths = [[lemmas[int(k)][0] for k in rng.integers(0, len(lemmas), int(n))]
             for n in n_words]
    chains = [chain_of(o) for o in orths]
    pos = np.array([len(c) for c in chains], np.float64)
    frames = np.maximum(np.floor(pos * s["frames"] / pos.sum()).astype(np.int64), pos.astype(int))
    frames[np.argmax(frames - pos)] += s["frames"] - frames.sum()
    if (frames < pos).any() or frames.sum() != s["frames"]:
        raise ValueError("the frames do not fit the chains")

    D = s["base_dim"]
    means = rng.normal(0.0, 3.0, (s["classes"], D))
    corpus_name = "AN4"
    keys, entries = [], {}
    base = {}
    for i, (chain, T) in enumerate(zip(chains, frames)):
        # a duration a position: one frame each, the rest spread at random
        dur = 1 + np.bincount(rng.integers(0, len(chain), int(T) - len(chain)),
                              minlength=len(chain))
        states = np.repeat(chain, dur)
        feats = (means[states] + rng.normal(0.0, 1.0, (int(T), D))).astype(np.float32)
        rec = f"rec{i:03d}"
        key = f"{corpus_name}/{rec}/seg{i:03d}"
        keys.append(key)
        base[key] = feats
        entries[key + ".attribs"] = (
            b'<?xml version="1.0" encoding="ISO-8859-1"?>\n<flow-attributes>\n'
            b'  <flow-attribute name="datatype" value="vector-f32"/>\n'
            b'  <flow-attribute name="sample-rate" value="100"/>\n</flow-attributes>\n')
        entries[key] = _cache_entry(feats)

    lda = rng.normal(0.0, 1.0 / np.sqrt(D * s["window"]), (s["lda_dim"], D * s["window"]))
    paths = {k: os.path.join(root, v) for k, v in (
        ("lexicon", "lexicon.xml"), ("corpus", "corpus.xml"), ("cart_tree", "cart.tree"),
        ("config", "recognition.config"), ("pruned_config", "recognition-pruned.config"),
        ("cache", "mfcc.cache"), ("lda", "lda.matrix"), ("flow", "cache.lda.flow"))}
    with open(paths["lexicon"], "w") as f:
        f.write(_lexicon_xml(phones, lemmas))
    with open(paths["cart_tree"], "w") as f:
        f.write(_tree_xml(questions, tree))
    with open(paths["corpus"], "w") as f:
        f.write(f'<?xml version="1.0" encoding="ISO-8859-1"?>\n<corpus name="{corpus_name}">\n')
        for i, o in enumerate(orths):
            f.write(f'  <recording name="rec{i:03d}" audio="rec{i:03d}.wav">\n'
                    f'    <segment name="seg{i:03d}" start="0" end="{frames[i] / 100:.2f}">'
                    f'<orth>{" ".join(o)}</orth></segment>\n  </recording>\n')
        f.write("</corpus>\n")
    with open(paths["config"], "w") as f:
        f.write(AN4_CONFIG)
    with open(paths["pruned_config"], "w") as f:
        f.write(AN4_PRUNED)
    _write_archive(paths["cache"], entries)
    with open(paths["lda"], "w") as f:
        f.write(f'<?xml version="1.0" encoding="ISO-8859-1"?>\n'
                f'<matrix-f32 nRows="{lda.shape[0]}" nColumns="{lda.shape[1]}">\n')
        for row in lda:
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")
        f.write("</matrix-f32>\n")
    with open(paths["flow"], "w") as f:
        f.write(CACHE_LDA_FLOW)
    with open(os.path.join(root, "lda.flow"), "w") as f:
        f.write(LDA_FLOW.format(window=s["window"], right=s["right"]))
    with open(os.path.join(root, "window.flow"), "w") as f:
        f.write(WINDOW_FLOW)
    return Setup(root=root, paths=paths, keys=keys, orths=orths, chains=chains,
                 frames=[int(t) for t in frames], num_classes=s["classes"], base=base)


def write_wav(path: str, samples: np.ndarray) -> None:
    """16-bit mono PCM at 8 kHz behind a 44-byte RIFF header."""
    data = np.asarray(samples, "<i2").tobytes()
    head = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, 8000, 16000, 2, 16)
            + b"data" + struct.pack("<I", len(data)))
    with open(path, "wb") as f:
        f.write(head + data)
