"""The Sprint tier's host modules in the port (archives, Flow caches and
networks, LDA, CART reading, training and conversion, the legacy tree, the
channel harness, the core utilities, BIC clustering, the Mm text format and
model combination) against their speechrecognition_tpu originals.

Each test mirrors a test of the JAX package (tests/test_sprint.py,
test_cart_lda_training.py, test_channel.py, test_flow.py,
test_legacy_tree.py, test_segment_clustering.py, test_tools_tail.py,
test_lvcsr.py), runs the same inputs through both packages, holds the
port to that test's assertions and its results to the JAX package's bit
for bit (the copies are numpy: no torch op in them). The tests that read
the AN4 setup there read tests/torch_sprint_tables.py's seeded files of
the same shape here.
"""

import hashlib
import importlib
import io
import itertools
import math
import os
import re

import numpy as np
import pytest

from torch_sprint_tables import SMALL_SHAPE, write_setup, write_wav

PKGS = ("speechrecognition_tpu", "speechrecognition_torch")


def both(name):
    """(the JAX package's module, the port's module) of sprint/<name>."""
    return tuple(importlib.import_module(f"{p}.sprint.{name}") for p in PKGS)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return write_setup(str(tmp_path_factory.mktemp("sprint_setup")), seed=3, **SMALL_SHAPE)


# -- archives, bundles, MD5, progress (tests/test_sprint.py) ------------------------


def test_file_archive_write_read_roundtrip(tmp_path):
    entries = {"a.feat": b"hello world", "dir/b.bin": bytes(range(256))}
    written = []
    for pkg, mod in zip(PKGS, both("archive")):
        for compress in (False, True):
            p = str(tmp_path / f"{pkg}-{compress}.archive")
            mod.write_file_archive(p, entries, compress=compress)
            written.append((compress, p))
    for mod in both("archive"):
        for _compress, p in written:
            arch = mod.FileArchive(p)
            assert set(arch.keys()) == set(entries)
            for k, v in entries.items():
                assert arch.read(k) == v
    raw = [open(p, "rb").read() for c, p in written if not c]
    assert raw[0] == raw[1]     # the raw archives are the same bytes


def test_bundle_archive(tmp_path):
    jarch, tarch = both("archive")
    tarch.write_file_archive(str(tmp_path / "m1.archive"), {"x": b"one"})
    jarch.write_file_archive(str(tmp_path / "m2.archive"), {"y": b"two", "x": b"shadowed"})
    bundle = tmp_path / "all.bundle"
    for mod in both("core_utils"):
        bundle.write_text("m1.archive\nm2.archive\n")
        b = mod.BundleArchive(str(bundle))
        assert set(b.keys()) == {"x", "y"}
        assert b.read("x") == b"one"          # first member wins (bundle order)
        assert b.read("y") == b"two"
        b.write_index()
        index = bundle.read_text()
        b2 = mod.BundleArchive(str(bundle))
        assert b2.read("y") == b"two"
        if mod.__name__.startswith("speechrecognition_tpu"):
            jindex = index
    assert index == jindex


def test_md5_and_rusage(tmp_path):
    f = tmp_path / "blob"
    f.write_bytes(b"x" * 100000)
    digests = []
    for mod in both("core_utils"):
        m = mod.MD5().update("abc").update(b"def")
        assert str(m) == hashlib.md5(b"abcdef").hexdigest()
        digests.append(str(mod.MD5().update_from_file(str(f))))
        info = mod.resource_usage_info()
        assert info["user_s"] >= 0 and info["peak_rss_bytes"] > 0
    assert digests[0] == digests[1] == hashlib.md5(b"x" * 100000).hexdigest()


def test_progress_indicator():
    class Tty(io.StringIO):
        def isatty(self):
            return True

    for mod in both("core_utils"):
        out = Tty()
        p = mod.ProgressIndicator("scan", out=out, min_interval=0.0)
        p.start(10)
        for _ in range(10):
            p.notify()
        assert p.finish() >= 0
        assert "scan" in out.getvalue() and "10" in out.getvalue()


# -- the AN4 setup's readers, on the seeded files (tests/test_sprint.py) ------------


def test_file_archive_and_cache(setup):
    got = []
    for mod in both("flow_cache"):
        cache = mod.FeatureCache(setup.paths["cache"])
        assert cache.segments == setup.keys
        key = cache.segments[0]
        assert cache.attributes(key).get("datatype") == "vector-f32"
        feats, times = cache.read_features(key)
        assert feats.shape == (setup.frames[0], 16) and feats.dtype == np.float32
        assert times[1, 0] > times[0, 0]
        got.append([cache.read_features(k) for k in cache.segments])
    for (fa, ta), (fb, tb), k in zip(got[0], got[1], setup.keys):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(fa, setup.base[k])
        np.testing.assert_array_equal(ta, tb)


def test_bliss_corpus_and_lexicon(setup):
    out = []
    for mod in both("bliss"):
        corpus = mod.BlissCorpus.read(setup.paths["corpus"])
        assert corpus.name == "AN4" and len(corpus.segments) == SMALL_SHAPE["segments"]
        assert [corpus.full_segment_name(s) for s in corpus.segments] == setup.keys
        assert [s.orth for s in corpus.segments] == setup.orths
        lex = mod.BlissLexicon.read(setup.paths["lexicon"])
        assert lex.silence_lemma.orth[0] == "[SILENCE]"
        assert lex.silence_lemma.pronunciations == [["si"]]
        for lm in lex.lemmas:
            for pron in lm.pronunciations:
                assert all(ph in lex.phoneme_index for ph in pron)
        out.append((lex.phonemes, [(lm.orth, lm.pronunciations, lm.special)
                                   for lm in lex.lemmas]))
    assert out[0] == out[1]


def test_cart_tree(setup):
    ids = []
    for bliss, cart in zip(both("bliss"), both("cart")):
        tree = cart.DecisionTree.read(setup.paths["cart_tree"])
        assert tree.num_leaves() == setup.num_classes
        assert tree.max_leaf_id() == setup.num_classes - 1
        lex = bliss.BlissLexicon.read(setup.paths["lexicon"])
        row = []
        for ph, s, b in itertools.product(lex.phonemes, range(3),
                                          ("single-phoneme-lemma", "within-lemma")):
            cls = tree.classify({"central": ph, "history[0]": "#", "future[0]": "#",
                                 "hmm-state": str(s), "boundary": b})
            assert 0 <= cls <= tree.max_leaf_id()
            row.append(cls)
        # silence's three states are classes of their own, 0-2
        assert row[:6:2] == [0, 1, 2]
        ids.append(row)
        ids.append(tree.tying_table(lex.phonemes[:4]))
    assert ids[0] == ids[2]
    np.testing.assert_array_equal(ids[1], ids[3])


def test_lda_matrix_and_window(setup):
    outs = []
    feats = np.random.default_rng(0).normal(0, 1, (50, 16)).astype(np.float32)
    for mod in both("lda"):
        mat = mod.read_matrix_xml(setup.paths["lda"])
        assert mat.shape == (SMALL_SHAPE["lda_dim"], 9 * 16)
        lda = mod.SlidingWindowLDA(mat, max_size=9, right=4)
        assert lda.input_dim == 16
        out = lda(feats)
        assert out.shape == (50, SMALL_SHAPE["lda_dim"]) and np.isfinite(out).all()
        outs += [mat, out, lda(setup.base[setup.keys[0]])]
    for a, b in zip(outs[:3], outs[3:]):
        np.testing.assert_array_equal(a, b)


def test_sprint_config(setup):
    from speechrecognition_torch.sprint import SprintConfig
    cfg = SprintConfig.read(setup.paths["config"])
    assert cfg.get_float("x.acoustic-model.tdp.loop") == 3.0
    assert cfg.get_float("x.acoustic-model.tdp.silence.loop") == 0.0001
    assert cfg.get_float("x.acoustic-model.tdp.silence.skip") == float("inf")
    assert cfg.get_float("x.acoustic-model.tdp.entry-m1.loop") == float("inf")
    pruned = SprintConfig.read(setup.paths["pruned_config"])
    assert pruned.get_float("x.acoustic-pruning") == 200.0


# -- Flow networks (tests/test_flow.py) ---------------------------------------------


def test_parse_cache_lda_flow(setup):
    parsed = []
    for mod in both("flow"):
        net = mod.FlowNetwork.parse(setup.paths["flow"], config=setup.flow_config())
        assert net.outputs == ["features"] and "id" in net.params
        assert set(net.nodes) == {"base-feature-extraction-cache",
                                  "lda/window/lda-window", "lda/multiplication"}
        assert net.nodes["lda/window/lda-window"].attrs["max-size"] == "9"
        assert net.nodes["lda/window/lda-window"].attrs["right"] == "4"
        assert net.nodes["lda/multiplication"].attrs["file"] == setup.paths["lda"]
        parsed.append(({n: (v.filter, v.attrs) for n, v in net.nodes.items()}, net.links))
    assert parsed[0] == parsed[1]


def test_flow_matches_direct_lda_pipeline(setup):
    jflow, tflow = both("flow")
    from speechrecognition_torch.sprint import (BlissCorpus, FeatureCache, SlidingWindowLDA,
                                                read_matrix_xml)
    corpus = BlissCorpus.read(setup.paths["corpus"])
    cache = FeatureCache(setup.paths["cache"])
    lda = SlidingWindowLDA(read_matrix_xml(setup.paths["lda"]), max_size=9, right=4)
    nets = [m.FlowNetwork.parse(setup.paths["flow"], config=setup.flow_config())
            for m in (jflow, tflow)]
    ctxs = [{}, {}]
    for seg in corpus.segments:
        key = corpus.full_segment_name(seg)
        outs = [n.run(params={"id": key}, context=c)["features"] for n, c in zip(nets, ctxs)]
        expect = lda(cache.read_features(key)[0])
        np.testing.assert_array_equal(outs[1], expect)
        np.testing.assert_array_equal(outs[0], outs[1])


def test_flow_simple_filters(tmp_path):
    p = tmp_path / "simple.flow"
    p.write_text("""<?xml version="1.0"?>
<network>
  <in name="in"/>
  <out name="out"/>
  <node name="pre" filter="signal-preemphasis" alpha="1.0"/>
  <link from="network:in" to="pre"/>
  <node name="norm" filter="signal-normalization" type="mean"/>
  <link from="pre" to="norm"/>
  <link from="norm" to="network:out"/>
</network>""")
    x = np.arange(12, dtype=np.float64).reshape(6, 2)
    pre = x.copy()
    pre[1:] -= x[:-1]
    pre[0] *= 0.0
    expect = pre - pre.mean(axis=0, keepdims=True)
    outs = [m.FlowNetwork.parse(str(p)).run(inputs={"in": x})["out"] for m in both("flow")]
    np.testing.assert_allclose(outs[1], expect)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_regression_node_first_and_second_order():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 6))
    attrs = {"max-size": "5", "right": "2"}
    for order in (1, 2):
        got = [m.f_regression({"in": x}, {**attrs, "order": str(order)}, {})
               for m in both("flow")]
        np.testing.assert_array_equal(got[0], got[1])
        n = 5
        dt = np.arange(n) - (n - 1) / 2.0
        tm = (dt * dt).sum()
        for t in range(2, 38):
            win = x[t - 2: t + 3]
            if order == 1:
                want = (dt[:, None] * win).sum(axis=0) / tm
            else:
                ns = tm * tm - n * (dt ** 4).sum()
                want = (win * tm - win * (dt * dt)[:, None] * n).sum(axis=0) * 2.0 / ns
            np.testing.assert_allclose(got[1][t], want, rtol=1e-12)


@pytest.mark.parametrize("seconds", [0.3, 1.7])
def test_sietill_mfcc_flow_on_a_wav(tmp_path, seconds):
    """The packaged audio → MFCC network (sprint/flows/sietill-mfcc.flow) on a
    seeded 8 kHz WAV equals the port's extract_features and the JAX
    package's network, bit for bit."""
    from speechrecognition_torch.features.frontend import extract_features
    from speechrecognition_torch.io import read_audio_file

    rng = np.random.default_rng(int(seconds * 10))
    t = np.arange(int(8000 * seconds)) / 8000.0
    samples = (3000 * np.sin(2 * np.pi * 440 * t) + rng.normal(0, 300, t.size)).astype(np.int16)
    wav = str(tmp_path / "utt.wav")
    write_wav(wav, samples)
    np.testing.assert_array_equal(read_audio_file(wav), samples)
    outs = []
    for mod in both("flow"):
        flow = os.path.join(os.path.dirname(mod.__file__), "flows", "sietill-mfcc.flow")
        net = mod.FlowNetwork.parse(flow)
        assert net.outputs == ["features"]
        outs.append(net.run(params={"input-file": wav, "id": "utt"})["features"])
    got = outs[1].astype(np.float32)
    np.testing.assert_array_equal(got, extract_features(samples))
    np.testing.assert_array_equal(outs[0], outs[1])


# -- CART training and LDA estimation (tests/test_cart_lda_training.py) ------------


def _examples(mod, rng, centers, props, n_per=200, dim=3, spread=0.05):
    feats, labels = [], []
    for i, c in enumerate(centers):
        feats.append(rng.normal(c, spread, (n_per, dim)))
        labels.append(np.full(n_per, i))
    return mod.ExampleSet.accumulate(np.concatenate(feats), np.concatenate(labels), props)


def _train(case, mod, cart):
    """One of test_cart_lda_training.py's trainings with package ``mod``
    (cart_train) and ``cart``; returns (tree, leaves, trainer)."""
    Q, Step, Plan = cart.Question, mod.Step, mod.TrainingPlan
    if case == "planted":
        rng = np.random.default_rng(1)
        props = [{"central": p, "hmm-state": "0"} for p in "a e i o".split()]
        ex = _examples(mod, rng, [(0, 0, 0), (0, 0, 0), (5, 5, 5), (5, 5, 5)], props)
        qs = [Q("central", frozenset(s.split())) for s in ("a", "e", "a e", "a i", "a o")]
        plan = Plan([Step("s", "split", qs, min_obs=1)], max_leaves=2)
    elif case.startswith("limits"):
        rng = np.random.default_rng(2)
        props = [{"central": p} for p in "a b c d".split()]
        ex = _examples(mod, rng, [(0, 0, 0), (2, 2, 2), (4, 4, 4), (6, 6, 6)], props)
        qs = [Q("central", frozenset([p])) for p in "a b c d".split()]
        plan = {"limits-leaves": Plan([Step("s", "split", qs, min_obs=1)], max_leaves=3),
                "limits-obs": Plan([Step("s", "split", qs, min_obs=10_000)]),
                "limits-gain": Plan([Step("s", "split", qs, min_gain=1e12)])}[case]
    elif case == "silence":
        rng = np.random.default_rng(3)
        props = [{"central": "si"}, {"central": "a"}, {"central": "b"}]
        ex = _examples(mod, rng, [(9, 9, 9), (0, 0, 0), (1, 1, 1)], props)
        plan = Plan([Step("sil", "cluster", [Q("central", frozenset(["si"]))], min_obs=1),
                     Step("main", "split", [Q("central", frozenset([p])) for p in "ab"],
                          min_obs=1)])
    elif case == "round-trip":
        rng = np.random.default_rng(4)
        phones = "a b c d e f".split()
        props = [{"central": p, "hmm-state": str(s)} for p in phones for s in range(2)]
        centers = rng.normal(0, 3, (len(props), 3))
        ex = _examples(mod, rng, centers, props, n_per=50)
        qs = ([Q("central", frozenset([p])) for p in phones]
              + [Q("central", frozenset(["a", "b", "c"])), Q("hmm-state", frozenset(["0"]))])
        plan = Plan([Step("s", "split", qs, min_obs=1)], max_leaves=7)
    else:    # "once": a committed question leaves the children's candidates
        rng = np.random.default_rng(5)
        props = [{"central": p} for p in "a b c".split()]
        ex = _examples(mod, rng, [(0, 0, 0), (4, 4, 4), (8, 8, 8)], props)
        plan = Plan([Step("s", "split", [Q("central", frozenset(["a"]))], min_obs=1)])
    trainer = mod.CartTrainer(plan, ex)
    tree, leaves = trainer.train()
    return tree, leaves, trainer, props


CART_CASES = {"planted": 2, "limits-leaves": 3, "limits-obs": 1, "limits-gain": 1,
              "silence": 3, "round-trip": 7, "once": 2}


@pytest.mark.parametrize("case", list(CART_CASES))
def test_cart_training(case, tmp_path):
    runs = [_train(case, m, c) for m, c in zip(both("cart_train"), both("cart"))]
    texts = []
    for mod, cart, (tree, leaves, trainer, props) in zip(both("cart_train"), both("cart"), runs):
        assert len(leaves) == CART_CASES[case]
        ids = [tree.classify(p) for p in props]
        if case == "planted":
            assert trainer.splits[0].question.values == frozenset({"a", "e"})
            assert ids[0] == ids[1] and ids[2] == ids[3] and ids[0] != ids[2]
        if case == "silence":
            assert ids[0] == 0 and ids[1] != ids[2]
        path = str(tmp_path / f"{mod.__name__}.tree")
        mod.write_tree_xml(tree, path)
        back = cart.DecisionTree.read(path)
        assert [back.classify(p) for p in props] == ids
        texts.append(open(path).read())
    assert texts[0] == texts[1]
    assert [s.gain for s in runs[0][2].splits] == [s.gain for s in runs[1][2].splits]


def test_pooled_neg_ll_closed_form():
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 1.5, (1000, 4))
    n = np.asarray(float(len(x)))
    lls = [float(m._pooled_neg_ll(n, x.sum(0), (x * x).sum(0), 1e-10))
           for m in both("cart_train")]
    expect = 0.5 * len(x) * (4 + 4 * math.log(2 * math.pi) + np.log(x.var(axis=0)).sum())
    assert abs(lls[1] - expect) < 1e-6 * abs(expect) and lls[0] == lls[1]


def test_plan_xml_parse(tmp_path):
    p = tmp_path / "plan.xml"
    p.write_text("""<decision-tree-training>
      <max-leaves>100</max-leaves>
      <step name="silence" action="cluster">
        <min-obs>500</min-obs><min-gain>0</min-gain>
        <questions><question><key>central</key><value>si</value></question></questions>
      </step>
      <step name="main" action="split">
        <min-obs>1000</min-obs><min-gain>50</min-gain>
        <questions>
          <question description="vowel"><key>central</key><values>a e i</values></question>
        </questions>
      </step>
    </decision-tree-training>""")
    plans = [m.TrainingPlan.read_xml(str(p)) for m in both("cart_train")]
    for plan in plans:
        assert plan.max_leaves == 100
        assert [s.action for s in plan.steps] == ["cluster", "split"]
        assert plan.steps[1].min_obs == 1000 and plan.steps[1].min_gain == 50
        assert plan.steps[1].questions[0].values == frozenset("a e i".split())
    assert [(s.name, s.action, s.min_obs, s.min_gain, [(q.key, q.values) for q in s.questions])
            for s in plans[0].steps] == \
        [(s.name, s.action, s.min_obs, s.min_gain, [(q.key, q.values) for q in s.questions])
         for s in plans[1].steps]


def test_scatter_identity_and_merge():
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (500, 4)) + rng.integers(0, 3, 500)[:, None]
    c = rng.integers(0, 3, 500)
    results = []
    for mod in both("lda"):
        est = mod.ScatterMatricesEstimator(3, 4)
        est.accumulate(x, c)
        b, w, t = est.finalize()
        np.testing.assert_allclose(b + w, t, rtol=1e-12, atol=1e-12)
        e1, e2 = mod.ScatterMatricesEstimator(3, 4), mod.ScatterMatricesEstimator(3, 4)
        e1.accumulate(x[:250], c[:250])
        e2.accumulate(x[250:], c[250:])
        e1.merge(e2)
        merged = e1.finalize()
        for u, v in zip(merged, (b, w, t)):
            np.testing.assert_allclose(u, v, rtol=1e-10, atol=1e-12)
        results.append((b, w, t) + tuple(merged))
    for u, v in zip(*results):
        np.testing.assert_array_equal(u, v)


def test_generalized_eigen_two_class_direction():
    rng = np.random.default_rng(7)
    cov = np.array([[2.0, 0.7, 0.1], [0.7, 1.0, 0.2], [0.1, 0.2, 0.5]])
    L = np.linalg.cholesky(cov)
    mu = [np.zeros(3), np.array([1.0, -2.0, 0.5])]
    xs = np.concatenate([rng.normal(0, 1, (20000, 3)) @ L.T + mu[k] for k in range(2)])
    cs = np.repeat(np.arange(2), 20000)
    results = []
    for mod in both("lda"):
        est = mod.ScatterMatricesEstimator(2, 3)
        est.accumulate(xs, cs)
        between, within, _ = est.finalize()
        vals, vecs = mod.solve_generalized_eigen(between, within)
        assert vals[0] > 1.0 and abs(vals[1]) < 0.05 and abs(vals[2]) < 0.05
        fisher = np.linalg.solve(within, mu[1] - mu[0])
        cos = abs(fisher @ vecs[:, 0]) / (np.linalg.norm(fisher) * np.linalg.norm(vecs[:, 0]))
        assert cos > 0.99
        np.testing.assert_allclose(vecs.T @ within @ vecs, np.eye(3), atol=1e-8)
        results.append((vals, vecs))
    for u, v in zip(*results):
        np.testing.assert_array_equal(u, v)


def test_estimate_lda_reduction():
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.normal(k, 0.3, (2000, 5)) for k in range(4)])
    c = np.repeat(np.arange(4), 2000)
    results = []
    for mod in both("lda"):
        est = mod.ScatterMatricesEstimator(4, 5)
        est.accumulate(x, c)
        b, w, _ = est.finalize()
        vals, transform = mod.estimate_lda(b, w, reduced_dim=2)
        assert transform.shape == (2, 5) and vals[0] >= vals[1] >= vals[2]
        vals2, tr2 = mod.estimate_lda(b, w, eigenvalue_threshold=float(vals[1]) / 2)
        assert tr2.shape[0] >= 1
        results.append((vals, transform, vals2, tr2))
    for u, v in zip(*results):
        np.testing.assert_array_equal(u, v)


def test_sliding_window_lda_end_to_end():
    rng = np.random.default_rng(9)
    segs, labs = [], []
    for _ in range(30):
        cls = (np.arange(50) // 25).astype(np.int64)
        segs.append(np.where(cls[:, None] == 0, -1.0, 1.0) + rng.normal(0, 0.4, (50, 4)))
        labs.append(cls)
    projs = []
    for mod in both("lda"):
        lda = mod.estimate_sliding_window_lda(segs, labs, num_classes=2, max_size=3, right=1,
                                              reduced_dim=2, regularize=1e-8)
        proj = lda(segs[0].astype(np.float32))
        assert proj.shape == (50, 2)
        s = max(proj[:25, 0].std(), proj[25:, 0].std())
        assert abs(proj[:25, 0].mean() - proj[25:, 0].mean()) > 3.0 * s
        projs.append(proj)
    np.testing.assert_array_equal(projs[0], projs[1])


# -- the channel harness (tests/test_channel.py) --------------------------------------


def _config(mod_config, tmp_path, text):
    p = tmp_path / "test.config"
    p.write_text(text)
    return mod_config.SprintConfig.read(str(p))


def _channels():
    return zip(both("channel"), both("config"), PKGS)


def test_channel_resolution_and_file_target(tmp_path):
    texts = []
    for ch, cf, pkg in _channels():
        out = tmp_path / f"{pkg}.log"
        mgr = ch.ChannelManager(_config(cf, tmp_path, f"[*]\nresults.channel = {out}\n"))
        channel = ch.Component(mgr, "check.test-1").channel("results")
        assert channel.is_open()
        ch.XmlWriter(channel).full("score", 1.5)
        mgr.close()
        text = out.read_text()
        assert text.startswith('<?xml version="1.0"')
        assert "<score>1.5</score>" in text and "</sprint>" in text
        texts.append(text)
    assert texts[0] == texts[1]


def test_unconfigured_channel_is_closed(tmp_path):
    for ch, cf, _pkg in _channels():
        comp = ch.Component(ch.ChannelManager(_config(cf, tmp_path, "[*]\n")), "check.foo")
        assert not comp.channel("statistics").is_open()


def test_component_messages_and_counts(tmp_path, capsys):
    captured = []
    for ch, cf, _pkg in _channels():
        comp = ch.Component(ch.ChannelManager(_config(cf, tmp_path, "[*]\n")),
                            "recognizer.search")
        comp.log("starting <search>")
        comp.warning("beam & small")
        comp.error("bad model")
        c = capsys.readouterr()
        assert '<log component="recognizer.search">starting &lt;search&gt;</log>' in c.out
        assert "<warning" in c.err and "beam &amp; small" in c.err
        assert comp.n_errors == 1 and comp.n_warnings == 1
        with pytest.raises(RuntimeError):
            comp.critical_error("fatal")
        assert comp.n_errors == 2
        captured.append((c.out, capsys.readouterr().err))
    assert captured[0] == captured[1]


def test_xml_writer_nesting_and_escaping(tmp_path):
    texts = []
    for ch, cf, pkg in _channels():
        out = tmp_path / f"{pkg}-trace.log"
        mgr = ch.ChannelManager(_config(cf, tmp_path, f"[*]\ntrace.channel = {out}\n"))
        with ch.Component(mgr, "app").xml_channel("trace") as xml:
            xml.open("traceback", segment="utt<1>")
            xml.full("word", "zwei", start=0, end=42)
            xml.empty("silence", frames=10)
            xml.close("traceback")
        mgr.close()
        text = out.read_text()
        assert '<traceback segment="utt&lt;1&gt;">' in text
        assert '<word start="0" end="42">zwei</word>' in text
        assert '<silence frames="10"/>' in text
        assert text.index("<traceback") < text.index("<word")
        texts.append(text)
    assert texts[0] == texts[1]


def test_wildcard_channel_selection(tmp_path):
    for ch, cf, pkg in _channels():
        a = tmp_path / f"{pkg}-a.log"
        mgr = ch.ChannelManager(_config(cf, tmp_path, f"[*.test-1]\nresults.channel = {a}\n"))
        assert ch.Component(mgr, "check.test-1").channel("results").is_open()
        assert not ch.Component(mgr, "check.test-2").channel("results").is_open()
        mgr.close()


def test_application_run_and_overrides(tmp_path):
    base = tmp_path / "app.config"
    base.write_text("[*]\nalpha = 1\n")
    for ch, _cf, pkg in _channels():
        sysinfo = tmp_path / f"{pkg}-sys.log"
        app = ch.Application("tool", argv=[f"--config={base}", "--tool.alpha=2", "corpus.json",
                                           f"--tool.system-info.channel={sysinfo}"])
        assert app.args == ["corpus.json"]
        assert app.config.get("tool.alpha") == "2"
        seen = {}

        def main(a):
            seen["alpha"] = a.config.get_int("tool.alpha")
            a.log("running")
            return 0

        assert app.run(main) == 0
        assert seen["alpha"] == 2
        assert "<elapsed-time" in sysinfo.read_text()


def test_application_error_status(tmp_path):
    base = tmp_path / "app.config"
    base.write_text("[*]\n")
    for ch, _cf, _pkg in _channels():
        app = ch.Application("tool", argv=[f"--config={base}"])

        def main(a):
            a.error("broken")
            return 0

        assert app.run(main) == 1


# -- the legacy tree and its conversion (tests/test_legacy_tree.py, test_tools_tail.py)

LEGACY_FILE = """a
b
si
#

phone part line 1
phone part line 2


VOWEL a

node(0,l,1)
node(1,c,2)
leaf(1)
leaf(2)
leaf(3,0)
"""


@pytest.fixture()
def legacy_trees(tmp_path):
    p = tmp_path / "legacy.tree"
    p.write_text(LEGACY_FILE)
    return str(p), [m.LegacyDecisionTree.read(str(p)) for m in both("legacy_tree")]


def test_legacy_sections_parsed(legacy_trees):
    _p, trees = legacy_trees
    for tree in trees:
        assert tree.phonemes == ["a", "b", "si", "#"]
        assert tree.silence_idx == 2 and tree.boundary_idx == 3
        assert [q.name for q in tree.questions] == ["VOWEL", "STATE-0", "STATE-1", "STATE-2",
                                                    "a", "b"]
        assert tree.n_clusters == 3 and tree.num_classes == 4


def test_legacy_classify_walk(legacy_trees):
    _p, trees = legacy_trees
    for tree in trees:
        assert tree.classify("b", 0, left="a") == 0
        assert tree.classify("b", 2, left="a") == 1
        assert tree.classify("b", 0, left="b") == 2
        assert tree.classify("a", 0) == 2
        assert tree.classify("si", 1, left="a") == 3
    ctx = ["a", "b", "si", None]
    walks = [[t.classify(c, s, left=l, right=r, boundary_flag=f)
              for c, s, l, r, f in itertools.product(["a", "b", "si"], range(3), ctx, ctx,
                                                     range(4))] for t in trees]
    assert walks[0] == walks[1]


def test_legacy_boundary_styles(legacy_trees):
    p, _trees = legacy_trees
    for mod in both("legacy_tree"):
        t1 = mod.LegacyDecisionTree.read(p, boundary_style="pos-dep")
        assert [q.name for q in t1.questions][4] == "POSITION-WORD-BOUNDARY"
        assert t1.translate_boundary(0) == 0 and t1.translate_boundary(2) == 1
        t2 = mod.LegacyDecisionTree.read(p, boundary_style="super-pos-dep")
        assert [q.name for q in t2.questions][4:7] == [
            "ONE-PHONEME-WORD", "POSITION-WORD-BEGINNING", "POSITION-WORD-END"]
        assert [t2.translate_boundary(f) for f in (0, 1, 2, 3)] == [0, 2, 3, 1]


def test_legacy_position_question_classify(tmp_path):
    content = LEGACY_FILE.replace(
        "node(0,l,1)\nnode(1,c,2)\nleaf(1)\nleaf(2)\nleaf(3,0)\n", "node(5,c,1)\nleaf(1)\nleaf(2)\n")
    p = tmp_path / "legacy2.tree"
    p.write_text(content)
    for mod in both("legacy_tree"):
        t = mod.LegacyDecisionTree.read(str(p), boundary_style="super-pos-dep")
        assert t.classify("a", 0, boundary_flag=1) == 0
        assert t.classify("a", 0, boundary_flag=0) == 1


def test_legacy_missing_specials_rejected(tmp_path):
    p = tmp_path / "bad.tree"
    p.write_text("a\nb\n\nphone\n\n\nQ a\n\nleaf(1)\n")
    for mod in both("legacy_tree"):
        with pytest.raises(ValueError, match="boundary not defined"):
            mod.LegacyDecisionTree.read(str(p))


def test_legacy_draw_dot(legacy_trees):
    _p, trees = legacy_trees
    dots = []
    for tree in trees:
        out = io.StringIO()
        tree.draw(out)
        s = out.getvalue()
        assert s.startswith("digraph") and "VOWEL" in s and "class: 2" in s
        assert s.count("[label=\"yes\"]") == 2
        # node names are the nodes' id()s: number them in order of appearance
        names = {}
        dots.append(re.sub(r"\d{6,}", lambda m: str(names.setdefault(m.group(), len(names))), s))
    assert dots[0] == dots[1]


def test_cart_converter_equivalence(legacy_trees, tmp_path):
    """convert_legacy_tree, written by write_tree_xml and read back, classifies
    every allophone state as the legacy loader does (the cart-converter
    tool's steps); both packages write the same XML."""
    p, _trees = legacy_trees
    texts = []
    for lt, cc, ct, cart, pkg in zip(both("legacy_tree"), both("cart_convert"),
                                     both("cart_train"), both("cart"), PKGS):
        legacy = lt.LegacyDecisionTree.read(p)
        new = str(tmp_path / f"{pkg}.xml")
        ct.write_tree_xml(cc.convert_legacy_tree(legacy), new)
        converted = cart.DecisionTree.read(new)
        assert converted.max_leaf_id() == 3 and len(converted.questions) >= 3
        contexts = ["a", "b", "si", None]
        for center, state, left, right, flag in itertools.product(
                ["a", "b", "si"], range(3), contexts, contexts, range(4)):
            assert converted.classify(cc.legacy_props(center, state, left, right, flag,
                                                      legacy)) == \
                legacy.classify(center, state, left, right, flag)
        texts.append(open(new).read())
    assert texts[0] == texts[1]


# -- BIC segment clustering (tests/test_segment_clustering.py) ------------------------


def _segments(rng, mean, n_seg, frames=120, dim=6):
    return [rng.randn(frames, dim) + mean for _ in range(n_seg)]


def test_merge_equals_joint_stats():
    rng = np.random.RandomState(0)
    a, b = rng.randn(50, 4), rng.randn(70, 4)
    res = []
    for mod in both("segment_clustering"):
        m = mod.GaussianStats.from_features(a).merge(mod.GaussianStats.from_features(b))
        joint = mod.GaussianStats.from_features(np.vstack([a, b]))
        assert m.n == joint.n
        np.testing.assert_allclose(m.scatter, joint.scatter, atol=1e-8)
        np.testing.assert_allclose(m.covariance(), joint.covariance(), atol=1e-10)
        res.append((m.sum, m.scatter, m.covariance()))
    for u, v in zip(*res):
        np.testing.assert_array_equal(u, v)


def test_glr_properties():
    glrs = []
    for mod in both("segment_clustering"):
        rng = np.random.RandomState(1)
        same = [mod.GaussianStats.from_features(rng.randn(200, 3)) for _ in range(2)]
        far = mod.GaussianStats.from_features(rng.randn(200, 3) + 8.0)
        glr = mod._pairwise_glr(same + [far])
        assert glr[0, 1] < glr[0, 2] and glr[0, 1] < glr[1, 2] and glr[0, 1] < 50.0
        glrs.append(glr)
    np.testing.assert_array_equal(glrs[0], glrs[1])


@pytest.mark.parametrize("case", ["two-speakers", "forced-one", "bounded"])
def test_cluster_segments(case):
    results = []
    for mod in both("segment_clustering"):
        if case == "two-speakers":
            rng = np.random.RandomState(2)
            res = mod.cluster_segments(_segments(rng, 0.0, 4) + _segments(rng, 6.0, 4),
                                       lambda_=1.0)
            assert isinstance(res, mod.ClusterResult) and res.num_clusters == 2
            first, second = set(res.assignment[:4].tolist()), set(res.assignment[4:].tolist())
            assert len(first) == 1 and len(second) == 1 and first != second
        else:
            rng = np.random.RandomState(3)
            segs = _segments(rng, 0.0, 3) + _segments(rng, 5.0, 3) + _segments(rng, -5.0, 3)
            if case == "forced-one":
                res = mod.cluster_segments(segs, lambda_=1.0, min_clusters=1, max_clusters=1)
                assert res.num_clusters == 1
            else:
                res = mod.cluster_segments(segs, lambda_=1.0, threshold=1e12, min_clusters=4)
                assert res.num_clusters == 4
        results.append(res)
    np.testing.assert_array_equal(results[0].assignment, results[1].assignment)
    assert results[0].num_clusters == results[1].num_clusters


def test_bic_penalty_formula():
    d, n = 5, 1000.0
    p = 0.5 * (d + 0.5 * d * (d + 1))
    for mod in both("segment_clustering"):
        assert mod.bic_penalty(d, n, 2.0) == 2.0 * p * np.log(n)


# -- model combination (tests/test_lvcsr.py::test_mc_scaled_model_combination) -------


def test_mc_scaled_model_combination(tmp_path):
    path = tmp_path / "mc.config"
    path.write_text("[x]\nscale = 1.0\npronunciation-scale = 2.0\n[x.acoustic-model]\n"
                    "scale = 4.0\n[x.lm]\nscale = 11.0\n")
    mats = []
    for mc, cf in zip(both("mc"), both("config")):
        root = mc.ScaledComponent(2.0)
        am = root.add_child("acoustic-model", mc.ScaledComponent(3.0))
        tdp = am.add_child("tdp", mc.ScaledComponent(0.5))
        assert am.scale == 6.0 and tdp.scale == 3.0
        root.set_own_scale(1.0)
        assert am.scale == 3.0 and tdp.scale == 1.5
        root.distribute_scale_update({"acoustic-model.tdp": 2.0})
        assert tdp.own_scale == 2.0 and tdp.scale == 6.0
        comb = mc.ModelCombination.from_config(cf.SprintConfig.read(str(path)))
        assert (comb.am_scale, comb.lm_scale, comb.pronunciation_scale, comb.tdp_scale) == \
            (4.0, 11.0, 2.0, 4.0)
        mats.append(comb.lm_matrix(np.ones((3, 3))))
    np.testing.assert_array_equal(mats[0], mats[1])
    assert np.allclose(mats[1], 11.0)
