"""The port's tools (speechrecognition_torch/tools/{sprint_tools,partition,
plots}.py and the counterparts of the root tools full_parity, wer_sweep
and mpe_run) against the JAX package's on the same inputs.

Every sprint_tools action's output text (and written files) equals JAX's:
the lattice-processor ops of tests/test_sprint_tools.py on a small
archive, and the archive, statistics, allophone, CART and Flow tools of
tests/test_tools_tail.py on the seeded Sprint setup of
tests/torch_sprint_tables.py (the AN4 files are absent); ``network`` runs
the Flf recognizer node on the CPU. ``partition``'s groups, subsets and
threshold sweep and ``plots``' readers equal JAX's; the plot writers run
where matplotlib is installed. The root tools' counterparts run at their
smallest arguments on the demo corpus.
"""

import io
import json
import re

import numpy as np
import pytest
import torch

import speechrecognition_tpu.tools.partition as jpart
import speechrecognition_tpu.tools.plots as jplots
import speechrecognition_tpu.tools.sprint_tools as jst
from speechrecognition_tpu.search import flf as jflf
from speechrecognition_tpu.search.lattice import Arc as JArc, WordLattice as JLattice

import speechrecognition_torch.tools.partition as part
import speechrecognition_torch.tools.plots as plots
import speechrecognition_torch.tools.sprint_tools as st
import torch_flf_tables as ft
import torch_sprint_tables as sprint_tables
from speechrecognition_torch.tools import full_parity, mpe_run, wer_sweep
from torch_search_tables import DEMO_SETTINGS, FIXTURES, demo_setup

torch.set_num_threads(1)
VOCAB = ["[sil]", "eins", "zwei", "drei"]
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


def run_both(name, args, **kw):
    """(rc, text) of the port's and of JAX's tool on the same arguments."""
    out = []
    for mod in (st, jst):
        buf = io.StringIO()
        fn = getattr(mod, name)
        rc = fn(list(args), out=buf, **(kw if mod is st else {}))
        out.append((rc, buf.getvalue()))
    return out


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A lattice archive of two utterances and its vocabulary file."""
    root = tmp_path_factory.mktemp("lat")
    arch_dir = root / "arch"
    vocab_file = root / "vocab.txt"
    vocab_file.write_text("\n".join(VOCAB) + "\n")
    arch = jflf.LatticeArchive(str(arch_dir), VOCAB)
    arch.write("utt1", JLattice(num_frames=10, arcs=[
        JArc(0, 4, 1, 1.0), JArc(4, 8, 2, 0.5), JArc(4, 8, 3, 4.0), JArc(8, 10, 0, 0.1)],
        silence=0))
    arch.write("utt2", JLattice(num_frames=12, arcs=[
        JArc(0, 3, 2, 2.0), JArc(0, 5, 1, 3.0), JArc(3, 7, 3, 1.5), JArc(5, 7, 3, 0.25),
        JArc(7, 12, 1, 2.5), JArc(7, 12, 2, 2.5)], silence=0))
    refs = root / "refs.txt"
    refs.write_text("utt1\teins zwei\nutt2\tzwei drei eins\n")
    second = root / "arch2"
    jflf.LatticeArchive(str(second), VOCAB).write("utt1", JLattice(
        num_frames=10, arcs=[JArc(0, 4, 1, 0.5), JArc(4, 10, 3, 0.5)], silence=0))
    return root, str(arch_dir), str(vocab_file), str(refs), str(second)


def _files(d):
    import os
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("op", ["best", "n-best 2", "n-best 5", "cn-decode", "cn-decode-pivot",
                                "determinize", "minimize", "compose-linear REFS",
                                "oracle-wer REFS", "mbr-decode", "mbr-decode 1.5", "bogus"])
def test_lattice_processor_text_equals_jax(archive, op):
    _root, arch, vocab, refs, _second = archive
    args = [arch, vocab] + op.replace("REFS", refs).split()
    (rc, text), (jrc, jtext) = run_both("lattice_processor", args)
    assert rc == jrc and text == jtext
    if op != "bogus":
        assert rc == 0 and text


@pytest.mark.parametrize("op", ["prune", "push", "mesh", "union"])
def test_lattice_processor_written_archives_equal_jax(archive, op):
    root, arch, vocab, _refs, second = archive
    outs = [str(root / f"{op}-port"), str(root / f"{op}-jax")]
    for mod, dst in zip((st, jst), outs):
        extra = {"prune": ["1.0", dst], "push": [dst], "mesh": [dst], "union": [dst, second]}
        assert mod.lattice_processor([arch, vocab, op] + extra[op], out=io.StringIO()) == 0
    assert _files(outs[0]) == _files(outs[1]) and _files(outs[0])


def test_lattice_processor_network_recognizer_equals_jax(tmp_path):
    """``network``: the Flf recognizer node decodes four demo segments on
    the CPU; its best paths print as JAX's."""
    from torch_search_tables import FIXTURES as fx
    with open(fx / "demo_recognition.json") as f:
        golden = json.load(f)
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    lex = build_sietill_lexicon()
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(lex.orth) + "\n")
    names = ft.demo_segment_names(4)
    arch = jflf.LatticeArchive(str(tmp_path / "segs"), list(lex.orth))
    for n in names:
        arch.write(n, JLattice(num_frames=1, arcs=[JArc(0, 1, 0, 0.0)], silence=0))
    cfg = ft.recognizer_config(tmp_path / "net.config", golden["config"])
    (rc, text), (jrc, jtext) = run_both(
        "lattice_processor", [str(tmp_path / "segs"), str(vocab), "network", str(cfg)],
        device="cpu")
    assert rc == jrc == 0
    lines, jlines = text.splitlines(), jtext.splitlines()
    assert len(lines) == len(jlines) == len(names)
    for a, b in zip(lines, jlines):
        n, score, words = a.split("\t")
        jn, jscore, jwords = b.split("\t")
        assert (n, words) == (jn, jwords)
        assert abs(float(score) - float(jscore)) <= 1e-3
    hyps = [u["hyp"] for u in golden["utts"][:4]]
    assert [[lex.orth.index(w) for w in ln.split("\t")[2].split()] for ln in lines] == hyps


@pytest.fixture(scope="module")
def sprint_setup(tmp_path_factory):
    return sprint_tables.write_setup(str(tmp_path_factory.mktemp("sprint")), 0,
                                     **sprint_tables.SMALL_SHAPE)


def _stable_ids(text):
    """Replace object ids in a dot graph by their order of appearance."""
    seen = {}
    return re.sub(r"n(\d{6,})", lambda m: "n%d" % seen.setdefault(m.group(1), len(seen)), text)


@pytest.mark.parametrize("mode", ["dump-state-tying", "dump-allophones",
                                  "dump-allophone-states", "bogus"])
def test_allophone_tool_equals_jax(sprint_setup, mode):
    p = sprint_setup.paths
    (rc, text), (jrc, jtext) = run_both("allophone_tool", [p["lexicon"], p["cart_tree"], mode])
    assert rc == jrc and text == jtext


@pytest.mark.parametrize("mode", ["text", "dot"])
def test_cart_viewer_equals_jax(sprint_setup, mode):
    (rc, text), (jrc, jtext) = run_both("cart_viewer", [sprint_setup.paths["cart_tree"], mode])
    assert rc == jrc == 0 and _stable_ids(text) == _stable_ids(jtext) and text


def test_cart_converter_equals_jax(tmp_path):
    old = tmp_path / "legacy.tree"
    old.write_text(LEGACY_FILE)
    outs = []
    for mod, name in ((st, "port.xml"), (jst, "jax.xml")):
        buf = io.StringIO()
        assert mod.cart_converter([str(old), str(tmp_path / name)], out=buf) == 0
        outs.append((buf.getvalue().replace(name, "X"), (tmp_path / name).read_bytes()))
    assert outs[0] == outs[1]


def test_flowdraw_and_archiver_equal_jax(sprint_setup, tmp_path):
    p = sprint_setup.paths
    (rc, text), (jrc, jtext) = run_both("flowdraw", [p["flow"]])
    assert rc == jrc == 0 and text == jtext and "->" in text
    (rc, keys), (jrc, jkeys) = run_both("archiver", [p["cache"], "list"])
    assert rc == jrc == 0 and keys == jkeys
    key = keys.splitlines()[0]
    for mode in (["show", key], ["bogus"]):
        (rc, text), (jrc, jtext) = run_both("archiver", [p["cache"]] + mode)
        assert rc == jrc and text == jtext
    for mod, name in ((st, "a.bin"), (jst, "b.bin")):
        assert mod.archiver([p["cache"], "extract", key, str(tmp_path / name)]) == 0
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()


def test_statistics_equal_jax(sprint_setup, tmp_path):
    p = sprint_setup.paths
    for name, args in (("feature_statistics", [p["cache"]]),
                       ("corpus_statistics", [p["corpus"]]),
                       ("corpus_statistics", [str(FIXTURES / "demo_corpus.json")])):
        (rc, text), (jrc, jtext) = run_both(name, args)
        assert rc == jrc == 0 and text == jtext and json.loads(text)


def test_feature_statistics_of_a_feature_directory():
    """The reference's .mm2 branch passes a dim that its reader does not
    take and raises; the port reads each file as [frames, dim] (ROADMAP
    Queue 3)."""
    import os
    from speechrecognition_torch.io import read_feature_file
    d = str(FIXTURES / "demo_features")
    with pytest.raises(TypeError):
        jst.feature_statistics([d, "12"], out=io.StringIO())
    buf = io.StringIO()
    assert st.feature_statistics([d, "12"], out=buf) == 0
    feats = np.concatenate([read_feature_file(os.path.join(r, f)).reshape(-1, 12)
                            for r, _d, fs in os.walk(d) for f in sorted(fs)
                            if f.endswith(".mm2")]).astype(np.float64)
    got = json.loads(buf.getvalue())
    assert got["frames"] == feats.shape[0] and got["dim"] == 12
    # the tool sums each file in float32 and prints 6 decimals
    np.testing.assert_allclose(got["mean"], feats.mean(axis=0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["std"], feats.std(axis=0), rtol=1e-6, atol=1e-5)


def test_main_dispatch():
    assert st.main([]) == 1 and st.main(["no-such-tool"]) == 1
    assert st.main(["no-such-tool", "--device", "cpu"]) == 1


# -- partition --------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo():
    from speechrecognition_torch.corpus import CorpusDescription
    from speechrecognition_tpu.corpus import Corpus as JCorpus
    from speechrecognition_tpu.corpus import CorpusDescription as JDesc
    from speechrecognition_tpu.lexicon import build_sietill_lexicon as jlexicon
    lex, corpus, tdp, model = demo_setup()
    desc = CorpusDescription.read(str(FIXTURES / "demo_corpus.json"), lex)
    jdesc = JDesc.read(str(FIXTURES / "demo_corpus.json"), jlexicon())
    jcorpus = JCorpus(features=corpus.features, feature_offsets=corpus.feature_offsets,
                      orths=corpus.orths, names=corpus.names,
                      frame_duration=corpus.frame_duration, dim=corpus.dim)
    return lex, corpus, tdp, model, desc, jdesc, jcorpus


@pytest.mark.parametrize("key", ["speaker", "gender"])
def test_partition_and_subset_equal_jax(demo, key):
    lex, corpus, tdp, model, desc, jdesc, jcorpus = demo
    groups = part.partition_segments(desc, key)
    assert groups == jpart.partition_segments(jdesc, key)
    assert sum(len(v) for v in groups.values()) == corpus.num_segments
    for ids in groups.values():
        sub, jsub = part.subset_corpus(corpus, ids), jpart.subset_corpus(jcorpus, ids)
        for a in ("features", "feature_offsets"):
            x, y = getattr(sub, a), getattr(jsub, a)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert (sub.orths, sub.names) == (jsub.orths, jsub.names)
    with pytest.raises(ValueError):
        part.partition_segments(desc, "age")


def test_wer_vs_threshold_and_groups_equal_jax(demo, tmp_path):
    import jax.numpy as jnp
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.search.decoder import Recognizer
    from speechrecognition_tpu.config import Configuration as JConfiguration
    from speechrecognition_tpu.io import read_mixture_set
    from speechrecognition_tpu.lexicon import build_sietill_lexicon as jlexicon
    from speechrecognition_tpu.models.gmm import MixtureModel as JModel, VarianceModel as JVar
    from speechrecognition_tpu.search.decoder import Recognizer as JRecognizer
    from speechrecognition_tpu.tdp import TdpModel as JTdp
    lex, corpus, tdp, model, desc, jdesc, jcorpus = demo
    pack = model.pack(dtype=torch.float64, device="cpu")
    jlex = jlexicon()
    jpack = JModel.from_raw(read_mixture_set(str(FIXTURES / "iter-2.mix"), 25),
                            JVar.MIXTURE_POOLING, max_approx=True).pack(dtype=jnp.float64)
    jtdp = JTdp(silence_state=jlex.silence_state, loop=3.0, forward=0.0, skip=30.0)

    def settings(thr):
        return dict(DEMO_SETTINGS, **{"am-threshold": thr})

    recs = part.wer_vs_threshold(
        lambda thr: Recognizer(Configuration(settings(thr)), lex, tdp, pack,
                               dtype=torch.float64), corpus, [25.0, 200.0], batch_size=35)
    jrecs = jpart.wer_vs_threshold(
        lambda thr: JRecognizer(JConfiguration(settings(thr)), jlex, jtdp, jpack,
                                dtype=jnp.float64), jcorpus, [25.0, 200.0], batch_size=35)
    for r, j in zip(recs, jrecs):
        assert (r["threshold"], r["wer"], r["ser"]) == (j["threshold"], j["wer"], j["ser"])
    assert recs[1]["wer"] == pytest.approx(19.587629, abs=1e-6)
    for mod, rows, name in ((part, recs, "port.data"), (jpart, jrecs, "jax.data")):
        mod.write_time_data(rows, str(tmp_path / name))
    assert (tmp_path / "port.data").read_text() == (tmp_path / "jax.data").read_text()
    rec = Recognizer(Configuration(DEMO_SETTINGS), lex, tdp, pack, dtype=torch.float64)
    jrec = JRecognizer(JConfiguration(DEMO_SETTINGS), jlex, jtdp, jpack, dtype=jnp.float64)
    got = part.per_group_wer(rec, corpus, desc, "gender", batch_size=35)
    want = jpart.per_group_wer(jrec, jcorpus, jdesc, "gender", batch_size=35)
    assert sorted(got) == sorted(want)
    for g in got:
        assert got[g]["hyps"] == want[g]["hyps"] and got[g]["wer"] == want[g]["wer"]


# -- plots ------------------------------------------------------------------------


def test_plot_readers_equal_jax(tmp_path):
    rows = plots.read_am_scores(str(FIXTURES / "am_scores.data"))
    assert rows == jplots.read_am_scores(str(FIXTURES / "am_scores.data"))
    assert rows[0] == (-1, 0, 0, 32.9885) and len(rows) == 10
    path = tmp_path / "nn.data"
    path.write_text("Train frame error rate # Cv frame error rate # Time (s)\n"
                    "0.5 # 0.6 # 12.0\n0.4 # 0.55 # 11.0\n1e-3 # 2.5E-2 # 7\n")
    for a, b in zip(plots.read_nn_stats(str(path)), jplots.read_nn_stats(str(path))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    spec = np.random.default_rng(0).random((100, 257)) + 1e-6
    plots.dump_log_spectrum_pgm(spec, str(tmp_path / "a.pgm"))
    jplots.dump_log_spectrum_pgm(spec, str(tmp_path / "b.pgm"))
    assert (tmp_path / "a.pgm").read_bytes() == (tmp_path / "b.pgm").read_bytes()


def test_plot_writers(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    plots.plot_energy_segmentation(rng.normal(-2, 1, 300), 40, 260, str(tmp_path / "e.png"))
    plots.plot_am_scores(str(FIXTURES / "am_scores.data"), str(tmp_path / "am.png"))
    p = rng.random(106)
    plots.plot_state_priors({"a": p / p.sum()}, str(tmp_path / "p.png"))
    stats = tmp_path / "nn.data"
    stats.write_text("0.5 # 0.6 # 12.0\n0.4 # 0.55 # 11.0\n")
    plots.plot_nn_training(str(stats), str(tmp_path / "nn.png"))
    plots.plot_wer_vs_threshold([(25, 91.7, 0.01), (200, 19.6, 0.02)], str(tmp_path / "w.png"))
    plots.plot_mixture_scores({"max": [3.0, 2.0, 1.5]}, str(tmp_path / "m.png"))
    for name in ("e", "am", "p", "nn", "w", "m"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000


# -- the root tools' counterparts -------------------------------------------------

DEMO_ARGS = ["--corpus", str(FIXTURES / "demo_corpus.json"),
             "--features", str(FIXTURES / "demo_features") + "/",
             "--normalization", str(FIXTURES / "normalization-demo.bin"),
             "--model", str(FIXTURES / "iter-2.mix"), "--pooling", "mixture",
             "--device", "cpu"]


def test_full_parity_on_the_demo_corpus(capsys):
    rc = full_parity.main(DEMO_ARGS + ["--golden", str(FIXTURES / "demo_recognition.json"),
                                       "--dtype", "f64", "--batch-size", "35"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "transcript mismatches: 0/35" in out
    assert "WER 19.587629%" in out and "S/I/D 4/14/1" in out


@pytest.mark.parametrize("mode", ["threshold", "tuning"])
def test_wer_sweep_on_the_demo_corpus(tmp_path, mode):
    out = tmp_path / "sweep.data"
    rc = wer_sweep.main(DEMO_ARGS + ["--mode", mode, "--thresholds", "25,200" if mode ==
                                     "threshold" else "200", "--word-penalties", "80",
                                     "--tdps", "3-0-30", "--batch-size", "35", "--dtype", "f64",
                                     "--out", str(out)])
    assert rc == 0
    lines = out.read_text().splitlines()
    if mode == "threshold":
        assert lines == ["25 91.752577", "200 19.587629"]
    else:
        assert lines == ["TDP # WP # WER # SER", "3-0-30 80 19.59 20.00"]


def test_mpe_run_on_the_demo_corpus(tmp_path):
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({"pooling": "mixture", "tdp": [3.0, 0.0, 30.0],
                                "word_penalty": 80.0, "am_threshold": 200.0}))
    out = tmp_path / "run"
    args = ["--train-corpus", str(FIXTURES / "demo_corpus.json"),
            "--features", str(FIXTURES / "demo_features") + "/",
            "--normalization", str(FIXTURES / "normalization-demo.bin"),
            "--model", str(FIXTURES / "iter-2.mix"), "--meta", str(meta), "--iters", "1",
            "--max-segments", "6", "--holdout", "2", "--batch", "4", "--decode-batch", "2",
            "--out", str(out), "--device", "cpu"]
    assert mpe_run.main(args) == 0
    res = json.loads((out / "results.json").read_text())
    assert res["segments"] == 4 and len(res["iterations"]) == 1
    row = res["iterations"][0]
    assert np.isfinite(row["expected_accuracy_before"]) and row["holdout"]["wer"] >= 0
    assert (out / "mpe-1.mix").stat().st_size > 0
    assert list(out.glob("ml_alignment_*.npy"))
