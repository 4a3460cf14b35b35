"""The AN4 system's assembly, features and CART-tied training through the
port's tools/an4_system.py (build_system, load_corpus, train_model) and the
Mm text format (sprint/mm_io.py), against the JAX package on
tests/torch_sprint_tables.py's seeded setup at a small size.

The repository's tools/an4_system.py reads the reference's fixed paths in
``build_system``, so the JAX side runs its steps here (BlissLexicon.read,
DecisionTree.read, AllophoneStateModel, FlowNetwork.parse) and calls its
``load_corpus`` and ``train_model``, which take objects. One short EM run
(1 split) of each: the AM-score and density-count lines equal, the
written model's parameters within tests/test_torch_train.py's rtol 1e-9 /
atol 1e-7.
"""

import importlib.util
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from speechrecognition_torch.tools import an4_system as tan4
from torch_sprint_tables import SMALL_SHAPE, write_setup

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def root_tool():
    """The repository's tools/an4_system.py (the JAX package's AN4 tool)."""
    spec = importlib.util.spec_from_file_location("root_an4_system",
                                                  REPO / "tools" / "an4_system.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_build_system(setup):
    """The root tool's build_system steps on the seeded files."""
    from speechrecognition_tpu.sprint import (BlissCorpus, BlissLexicon, DecisionTree,
                                              SprintConfig)
    from speechrecognition_tpu.sprint.am import AllophoneStateModel, TransitionModel
    from speechrecognition_tpu.sprint.flow import FlowNetwork
    cfg = SprintConfig.read(setup.paths["config"])
    cfg_pruned = SprintConfig.read(setup.paths["pruned_config"])
    asm = AllophoneStateModel(bliss=BlissLexicon.read(setup.paths["lexicon"]),
                              tree=DecisionTree.read(setup.paths["cart_tree"]))
    lex, _orths, _tied = asm.build_search_lexicon()
    net = FlowNetwork.parse(setup.paths["flow"], config=setup.flow_config())
    return (cfg, BlissCorpus.read(setup.paths["corpus"]), asm, lex,
            TransitionModel.from_config(cfg), net,
            float(cfg_pruned.get("x.acoustic-pruning", "200")), float(cfg.get("x.lm.scale", "1")))


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    setup = write_setup(str(tmp_path_factory.mktemp("sprint_train")), seed=2, **SMALL_SHAPE)
    return setup, jax_build_system(setup), tan4.build_system(**setup.build_system_args())


def test_build_system_equal(systems):
    setup, jsys, tsys = systems
    assert tsys[6:] == jsys[6:] == (200.0, 1.0)
    (jl, tl), (jtm, ttm) = (jsys[3], tsys[3]), (jsys[4], tsys[4])
    assert tl.orth == jl.orth and tl.silence == jl.silence == 0
    for x, y in zip(jl.automata, tl.automata):
        np.testing.assert_array_equal(x.states, y.states)
    for field in ("default", "silence", "entry_m1", "entry_m2", "phone1", "scale"):
        assert str(getattr(ttm, field)) == str(getattr(jtm, field))
    assert ttm.silence.skip == float("inf")
    assert tsys[2].num_classes == jsys[2].num_classes == setup.num_classes
    assert set(tsys[5].nodes) == set(jsys[5].nodes)


def test_load_corpus_equal(systems):
    setup, jsys, tsys = systems
    tcorpus, tws = tan4.load_corpus(tsys[1], tsys[3], tsys[5])
    jcorpus, jws = root_tool().load_corpus(jsys[1], jsys[3], jsys[5])
    assert tws == jws and tcorpus.orths == jcorpus.orths and tcorpus.names == jcorpus.names
    np.testing.assert_array_equal(tcorpus.features, jcorpus.features)
    np.testing.assert_array_equal(tcorpus.feature_offsets, jcorpus.feature_offsets)
    assert tcorpus.features.shape == (SMALL_SHAPE["frames"], SMALL_SHAPE["lda_dim"])
    assert tcorpus.features.dtype == np.float32
    assert list(np.diff(tcorpus.feature_offsets)) == setup.frames


@pytest.fixture(scope="module")
def trained(systems, tmp_path_factory):
    """One split of the root tool's recipe with each package, float64 (the
    port on the CPU)."""
    _setup, jsys, tsys = systems
    tout, jout = tmp_path_factory.mktemp("torch_am"), tmp_path_factory.mktemp("jax_am")
    tcorpus, _ = tan4.load_corpus(tsys[1], tsys[3], tsys[5])
    tlog, jlog = [], []
    with mock.patch.object(tan4, "log", lambda *a: tlog.append(" ".join(map(str, a)))):
        tmodel, _ts = tan4.train_model(tcorpus, tsys[3], tsys[2], str(tout), 1, "f64",
                                       device="cpu")
    root = root_tool()
    root.log = lambda *a: jlog.append(" ".join(map(str, a)))
    jcorpus, _ = root.load_corpus(jsys[1], jsys[3], jsys[5])
    jmodel, _js = root.train_model(jcorpus, jsys[3], jsys[2], str(jout), 1, "f64")
    return tmodel, jmodel, tout, jout, tlog, jlog, tcorpus


def test_train_model_equals_jax(trained):
    from speechrecognition_torch.io import read_mixture_set
    tmodel, jmodel, tout, jout, tlog, jlog, _corpus = trained
    scores = [[ln for ln in log if ln.startswith(("AM score", "Num densities"))]
              for log in (tlog, jlog)]
    assert scores[0] == scores[1] and len(scores[0]) > 4
    assert tmodel.num_densities() == jmodel.num_densities() > SMALL_SHAPE["classes"]
    assert tmodel.mixtures == jmodel.mixtures
    for field in ("means", "vars", "mean_weights_log"):
        np.testing.assert_allclose(getattr(tmodel, field), getattr(jmodel, field),
                                   rtol=1e-9, atol=1e-7)
    a = read_mixture_set(str(tout / "am.mix"), SMALL_SHAPE["lda_dim"])
    b = read_mixture_set(str(jout / "am.mix"), SMALL_SHAPE["lda_dim"])
    np.testing.assert_array_equal(a.mean_weight, b.mean_weight)
    np.testing.assert_allclose(a.mean_acc, b.mean_acc, rtol=1e-9, atol=1e-7)
    np.testing.assert_allclose(a.var_acc, b.var_acc, rtol=1e-9, atol=1e-7)


def test_train_model_rejects_other_dtypes(trained):
    _tm, _jm, tout, _jo, _tl, _jl, corpus = trained
    with pytest.raises(ValueError, match="train_dtype"):
        tan4.train_model(corpus, None, None, str(tout), 1, "f32", device="cpu")


def test_mm_io_round_trip(trained, tmp_path):
    """write_sprint_mixture_set of the trained model: both packages write
    the same text, and read_sprint_mixture_set gives back its densities."""
    import speechrecognition_torch.sprint.mm_io as tmm
    import speechrecognition_tpu.sprint.mm_io as jmm
    tmodel, jmodel, *_ = trained
    tpath, jpath = tmp_path / "torch.pms", tmp_path / "jax.pms"
    tmm.write_sprint_mixture_set(str(tpath), tmodel)
    jmm.write_sprint_mixture_set(str(jpath), tmodel)
    assert tpath.read_text() == jpath.read_text()
    dim, mixtures, densities, means, covs = tmm.read_sprint_mixture_set(str(tpath))
    assert (dim, len(mixtures), len(covs)) == (tmodel.dim, tmodel.num_mixtures, 1)
    # densities of classes that saw no frame (non-finite means) are dropped
    kept = [[(mi, vi) for mi, vi in tmodel.mixtures[s]
             if np.isfinite(tmodel.means[mi]).all() and np.isfinite(tmodel.mean_weights_log[mi])]
            for s in range(tmodel.num_mixtures)]
    assert 0 < sum(map(len, kept)) <= tmodel.num_densities()
    assert [len(m) for m in mixtures] == [len(k) for k in kept]
    assert sum(len(m) for m in mixtures) == len(densities)
    np.testing.assert_array_equal(covs[0], tmodel.vars[0])
    for row, kept_row in zip(mixtures, kept):
        for (d, lw), (mi, _vi) in zip(row, kept_row):
            np.testing.assert_array_equal(means[densities[d][0]], tmodel.means[mi])
            assert lw == tmodel.mean_weights_log[mi]
    back = jmm.read_sprint_mixture_set(str(tpath))
    assert back[0] == dim and back[1] == mixtures and back[2] == densities
