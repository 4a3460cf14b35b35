"""Shared pieces of the lattice tier's CPU tests (fsa/, lm/ngram.py,
lm/variants.py, sprint/bliss.py and search/flf*.py, port against the JAX
package): each package's public names in one namespace, so that one case
runs through both; automata and word-end books drawn from a seed; and a
structural comparison of what the two runs return.

A case is a function ``case(P, root)`` that calls only ``P.<name>`` and
writes only under ``root``; ``run_both`` runs it with the JAX package's
names and with the port's and holds the results equal: ints, strings and
array bytes exactly, floats bit for bit unless a relative tolerance is
given, objects field by field (their class names too), and an exception
by its type name and message.
"""

import dataclasses
import gzip
import importlib
import math
import os
import struct
import types
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).parent / "fixtures"
ROOTS = {"jax": "speechrecognition_tpu", "port": "speechrecognition_torch"}

FSA_MODULES = ("fsa.semiring", "fsa.automaton", "fsa.ops", "fsa.alphabet", "fsa.lazy",
               "fsa.tail")
LM_MODULES = ("fsa.automaton", "lm.ngram", "lm.variants")
FLF_MODULES = ("search.lattice", "search.context_lattice", "search.flf", "search.flf_rescore",
               "search.flf_closure", "search.flf_compose", "search.flf_cn",
               "search.flf_network", "sprint.config", "sprint.bliss", "lm.arpa")


def package(which: str, modules) -> types.SimpleNamespace:
    """The public names of ``modules`` of one package ("jax" or "port") in
    one namespace; a name two modules bind to different objects is left
    out, so that a case cannot take the wrong one."""
    names, ambiguous = {}, set()
    for m in modules:
        mod = importlib.import_module(f"{ROOTS[which]}.{m}")
        for k, v in vars(mod).items():
            if k.startswith("_") or isinstance(v, types.ModuleType):
                continue
            if k in names and names[k] is not v:
                ambiguous.add(k)
            names[k] = v
    return types.SimpleNamespace(**{k: v for k, v in names.items() if k not in ambiguous})


def _float_bits(x: float) -> bytes:
    return struct.pack("<d", float(x))


def assert_same(a, b, rtol: float = 0.0, path: str = "out") -> None:
    """Hold what two runs returned equal (see the module docstring)."""
    ta, tb = type(a).__name__, type(b).__name__
    assert ta == tb, f"{path}: {ta} != {tb}"
    if isinstance(a, BaseException):
        assert str(a) == str(b), f"{path}: {a!r} != {b!r}"
    elif isinstance(a, (float, np.floating)):
        if rtol and math.isfinite(a) and math.isfinite(b):
            assert abs(a - b) <= rtol * max(abs(a), abs(b)), f"{path}: {a!r} != {b!r}"
        else:
            assert _float_bits(a) == _float_bits(b), f"{path}: {a!r} != {b!r}"
    elif isinstance(a, (bool, int, str, bytes, np.integer, np.bool_)) or a is None:
        assert a == b, f"{path}: {a!r} != {b!r}"
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, \
            f"{path}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"
        if rtol and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=path)
        else:
            assert a.tobytes() == b.tobytes(), f"{path}: {a} != {b}"
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: {len(a)} != {len(b)} items"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, rtol, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert len(a) == len(b), f"{path}: {len(a)} != {len(b)} keys"
        for i, ((ka, va), (kb, vb)) in enumerate(zip(a.items(), b.items())):
            assert_same(ka, kb, rtol, f"{path}.key{i}")
            assert_same(va, vb, rtol, f"{path}[{ka!r}]")
    elif isinstance(a, (set, frozenset)):
        assert_same(sorted(a, key=repr), sorted(b, key=repr), rtol, path)
    elif isinstance(a, type) or callable(a) and not hasattr(a, "__dict__"):
        assert a.__qualname__ == b.__qualname__, f"{path}: {a} != {b}"
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            if not f.name.startswith("_"):
                assert_same(getattr(a, f.name), getattr(b, f.name), rtol, f"{path}.{f.name}")
    elif isinstance(a, types.FunctionType):
        assert a.__qualname__ == b.__qualname__, f"{path}: {a} != {b}"
    elif hasattr(a, "__dict__"):
        da = {k: v for k, v in vars(a).items() if not k.startswith("_")}
        db = {k: v for k, v in vars(b).items() if not k.startswith("_")}
        assert_same(da, db, rtol, path)
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def outcome(fn, *args, **kwargs):
    """fn's result, or the exception it raised (compared by type and text)."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:      # noqa: BLE001 - the exception is the outcome
        return e


def read_tree(root: Path) -> dict:
    """Every file under ``root`` (relative path → bytes; a gzip file's
    content, as its header records the time it was written), for comparing
    what two runs wrote."""
    out = {}
    for d, _dirs, files in sorted(os.walk(root)):
        for f in sorted(files):
            p = Path(d) / f
            data = p.read_bytes()
            out[str(p.relative_to(root))] = gzip.decompress(data) if f.endswith(".gz") else data
    return out


def run_both(case, tmp_path: Path, modules, rtol: float = 0.0):
    """Run ``case(P, root)`` with each package's names and its own ``root``
    under ``tmp_path``; hold the results and the files each run wrote (the
    roots' paths replaced by one name) equal. Returns the port's result."""
    out = {}
    for which in ("jax", "port"):
        root = tmp_path / which
        root.mkdir()
        res = case(package(which, modules), root)
        written = {k: v.replace(str(root).encode(), b"<root>")
                   for k, v in read_tree(root).items()}
        out[which] = (res, written)
    assert_same(out["jax"], out["port"], rtol)
    return out["port"][0]


# -- seeded inputs ---------------------------------------------------------------

def random_arcs(rng, num_states=5, num_arcs=10, num_labels=3, eps=False, transducer=False):
    """Acyclic arc tuples (src, dst, ilabel[, olabel], weight) drawn from
    ``rng``: arcs run forward, labels from 1 (EPS = -1 with probability 0.2
    when ``eps``), weights with 3 decimals."""
    arcs = []
    for _ in range(num_arcs):
        s, d = int(rng.integers(num_states)), int(rng.integers(num_states))
        s, d = min(s, d), max(s, d) + (s == d)
        if d >= num_states:
            continue
        lab = -1 if eps and rng.random() < 0.2 else int(rng.integers(num_labels)) + 1
        w = float(np.round(rng.random() * 4, 3))
        if transducer:
            arcs.append((s, d, lab, int(rng.integers(num_labels)) + 1, w))
        else:
            arcs.append((s, d, lab, w))
    return arcs


def random_automaton(P, seed: int, **kw):
    """``P.Automaton`` over ``random_arcs`` (final state the last one, with a
    weight from the seed too)."""
    rng = np.random.default_rng(seed)
    n = kw.pop("num_states", 5)
    arcs = random_arcs(rng, num_states=n, **kw)
    return P.Automaton.build(n, arcs, {n - 1: float(np.round(rng.random(), 3))})


def random_books(seed: int, T: int = 24, W: int = 6):
    """Word-end books of one utterance, as the bigram decoder leaves them:
    scores [T, W] (1e30 where no word ends, about 35 % finite),
    backpointers [T, W] (< t), offsets [T]; word 0 is silence."""
    rng = np.random.default_rng(seed)
    scores = np.where(rng.random((T, W)) < 0.35, np.round(rng.random((T, W)) * 8, 3), 1e30)
    scores[-1, rng.integers(W)] = 0.5            # the utterance ends somewhere
    bkps = np.zeros((T, W), np.int32)
    for t in range(1, T + 1):
        bkps[t - 1] = rng.integers(max(0, t - 6), t, size=W)
    offsets = np.round(rng.random(T) * 2, 3)
    return scores, bkps, offsets


def books_lattice(P, seed: int):
    """``P.WordLattice.from_books`` on ``random_books(seed)``."""
    scores, bkps, offsets = random_books(seed)
    return P.WordLattice.from_books(scores, bkps, offsets, scores.shape[0], silence=0)


def demo_segment_names(n=None):
    """The demo corpus's segment names (tests/fixtures/demo_corpus.json)."""
    import json
    with open(FIXTURES / "demo_corpus.json") as f:
        names = [s["name"] for s in json.load(f)["segments"]]
    return names if n is None else names[:n]


def recognizer_config(path: Path, golden_config: dict, links: str = "best",
                      extra: str = "", am_threshold: float = 200.0) -> Path:
    """An Flf network config over the demo system, written to ``path``: a
    ``recognizer`` node ``rec`` (iter-2.mix, the golden TDPs and word
    penalty) linked to ``links``, a ``best`` node, and the node blocks of
    ``extra``."""
    c = golden_config
    path.write_text(f"""
[network.rec]
type = recognizer
mixture-file = {FIXTURES / 'iter-2.mix'}
corpus = {FIXTURES / 'demo_corpus.json'}
feature-path = {FIXTURES / 'demo_features'}/
normalization = {FIXTURES / 'normalization-demo.bin'}
word-penalty = {c['word_penalty']}
tdp = {c['tdp'][0]} {c['tdp'][1]} {c['tdp'][2]}
am-threshold = {am_threshold}
links = {links}
[network.best]
type = best
{extra}
""")
    return path
