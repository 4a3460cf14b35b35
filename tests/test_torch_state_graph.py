"""Allophone-state graphs (sprint/state_graph.py, sprint/am.py's
AllophoneStateModel) and the Sprint-mode alignments over them, the port
against the JAX package on tests/torch_sprint_tables.py's seeded setup of
the AN4 system's shape (a small size): the tied-state chains, their FSAs and
AlignerTables bit-equal; Viterbi alignments in f32 "pallas", f64 "mxu" and
df32 with tests/test_torch_align.py's COST_RTOL and equal states;
Baum-Welch posteriors within 1e-12 (f64) and 1e-5 (f32) of JAX's f64
(tests/test_torch_baumwelch.py's TOL).

The AN4 TDPs forbid the silence skip (infinity). test_df32_infinite_silence_skip
pins what both packages do with it on the df32 path (ROADMAP Queue 3 #21).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.align.baumwelch as jbw
import speechrecognition_tpu.align.viterbi as jvit
import speechrecognition_tpu.models.gmm as jgmm
from speechrecognition_tpu.ops import doublefloat as jdf

import speechrecognition_torch.align.baumwelch as tbw
import speechrecognition_torch.align.viterbi as tvit
import speechrecognition_torch.models.gmm as tgmm
from speechrecognition_torch.ops import doublefloat as tdf
from torch_sprint_tables import SMALL_SHAPE, write_setup

torch.set_num_threads(1)

PKGS = ("speechrecognition_tpu", "speechrecognition_torch")
#: tests/test_torch_align.py's cost tolerances, and the Baum-Welch ones of
#: tests/test_torch_baumwelch.py
COST_RTOL = {"f32": 1e-4, "f64": 0.0, "df32": 1e-12}
BW_TOL = {"f64": 1e-12, "f32": 1e-5}
BIG = 1e30


def sprint(pkg, name):
    return importlib.import_module(f"{pkg}.sprint.{name}")


def build(pkg, setup):
    """The root tool's build_system steps with package ``pkg``: the Bliss
    lexicon, the CART tree, the AllophoneStateModel, the config's
    TransitionModel and the graph builder."""
    bliss = sprint(pkg, "bliss").BlissLexicon.read(setup.paths["lexicon"])
    tree = sprint(pkg, "cart").DecisionTree.read(setup.paths["cart_tree"])
    am = sprint(pkg, "am")
    asm = am.AllophoneStateModel(bliss=bliss, tree=tree)
    tm = am.TransitionModel.from_config(
        sprint(pkg, "config").SprintConfig.read(setup.paths["config"]))
    return sprint(pkg, "state_graph").AllophoneStateGraphBuilder(model=asm, transition=tm)


@pytest.fixture(scope="module")
def sg(tmp_path_factory):
    """The seeded setup, both packages' builders, the port's corpus through
    the Flow network, the aligner tables and a 1-density tied GMM estimated
    from a linear mapping of frames onto chain positions (as
    tests/test_state_graph.py's Baum-Welch test), in both packages."""
    from speechrecognition_torch.tools.an4_system import build_system, load_corpus
    setup = write_setup(str(tmp_path_factory.mktemp("state_graph")), seed=1, **SMALL_SHAPE)
    builders = [build(p, setup) for p in PKGS]
    _cfg, corpus_xml, asm, lex, _tm, net, _ap, _lms = build_system(**setup.build_system_args())
    corpus, _ws = load_corpus(corpus_xml, lex, net)
    tables = sprint(PKGS[1], "state_graph").aligner_tables_for_orths(builders[1], setup.orths)
    model = tgmm.MixtureModel(dim=corpus.dim, num_mixtures=asm.num_classes,
                              var_model=tgmm.VarianceModel.GLOBAL_POOLING, max_approx=True)
    model.mean_weight_acc[:] = 1e-3
    model.var_weight_acc[:] = 1e-3
    model.var_acc[:] = 1e-3
    for s in range(corpus.num_segments):
        f = corpus.feature_sequence(s)
        n, T = tables.lengths[s], f.shape[0]
        st = tables.states[s][np.minimum((np.arange(T) * n) // T, n - 1)]
        for c in np.unique(st):
            m = st == c
            model.mean_weight_acc[c] += m.sum()
            model.mean_acc[c] += f[m].sum(axis=0)
            model.var_weight_acc[0] += m.sum()
            model.var_acc[0] += (f[m] ** 2).sum(axis=0)
    model.finalize()
    raw = model.to_raw()
    models = (jgmm.MixtureModel.from_raw(raw, jgmm.VarianceModel.GLOBAL_POOLING, max_approx=True),
              tgmm.MixtureModel.from_raw(raw, tgmm.VarianceModel.GLOBAL_POOLING, max_approx=True))
    feats, lens = corpus.padded_batch(list(range(corpus.num_segments)))
    return setup, builders, tables, models, feats, lens


def test_chain_structure(sg):
    setup, builders, _tables, _models, _feats, _lens = sg
    out = []
    for b in builders:
        sil = b._silence_states()
        assert sil == [0, 1, 2]            # 1 silence phone x 3 HMM states, own classes
        words = setup.orths[0]
        chain = b.chain_for_orth(words)
        np.testing.assert_array_equal(chain.states, setup.chains[0])
        w_len = len(b._pron_states(words[0]))
        assert b.chain_for_orth(words[:1]).num_states == 3 + w_len + 3
        assert b.chain_for_orth(words[:1], silence_between=False).num_states == w_len
        flags = b._state_types(words, True)
        assert len(flags) == chain.num_states and flags[:3] == [True] * 3
        out.append([b.chain_for_orth(o).states.tolist() for o in setup.orths])
    assert out[0] == out[1]


def test_search_lexicon_equal(sg):
    _setup, builders, _tables, _models, _feats, _lens = sg
    built = [b.model.build_search_lexicon() for b in builders]
    (jl, jo, jt), (tl, to, tt) = built
    assert jo == to and jl.orth == tl.orth and jl.silence == tl.silence == 0
    assert len(to) == SMALL_SHAPE["prons"] + 1
    for x, y in zip(jl.automata, tl.automata):
        np.testing.assert_array_equal(x.states, y.states)
    np.testing.assert_array_equal(jt, tt)
    assert builders[0].model.num_classes == builders[1].model.num_classes == SMALL_SHAPE["classes"]


def test_fsa_weights_and_topology(sg):
    setup, builders, _tables, _models, _feats, _lens = sg
    words = setup.orths[0][:1]
    fsas = [b.build_fsa(words) for b in builders]
    for b, fsa in zip(builders, fsas):
        n = fsa.num_states
        assert n == b.chain_for_orth(words).num_states
        assert (fsa.src == fsa.dst).sum() == n           # a loop arc on every state
        loop = lambda i: fsa.weight[(fsa.src == i) & (fsa.dst == i)][0]  # noqa: E731
        assert loop(0) == pytest.approx(0.0001)           # silence loop
        assert loop(3) == pytest.approx(3.0)              # the word's default loop
        assert fsa.final[n - 1] == pytest.approx(15.0)    # the silence exit
        # the skip into a silence position is the config's infinity
        skip_into_sil = fsa.weight[(fsa.dst == n - 1) & (fsa.src == n - 3)]
        assert np.isinf(skip_into_sil).all() and skip_into_sil.size == 1
        assert np.isfinite(fsa.accepts([int(s) for s in b.chain_for_orth(words).states]))
    for field in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(fsas[0], field), getattr(fsas[1], field))
    np.testing.assert_array_equal(fsas[0].final, fsas[1].final)


def test_alignment_fsas(sg):
    _setup, builders, _tables, _models, _feats, _lens = sg
    gamma = np.array([[0.7, 0.3, 0.0], [0.0, 1.0, 0.0]])
    out = []
    for b in builders:
        lin = type(b).alignment_fsa(np.array([5, 5, 7, 9], np.int32), scores=[1, 2, 3, 4])
        assert lin.num_states == 5 and lin.num_arcs == 4
        assert lin.accepts([5, 5, 7, 9]) == pytest.approx(10.0)
        saus = type(b).alignment_posterior_fsa(gamma, np.array([11, 12, 13]))
        assert saus.num_states == 3
        for t in range(2):
            assert np.exp(-saus.weight[saus.src == t]).sum() == pytest.approx(1.0)
        out.append((lin.weight, saus.src, saus.dst, saus.weight))
    for x, y in zip(*out):
        np.testing.assert_array_equal(x, y)


def test_aligner_tables_equal(sg):
    setup, builders, tables, _models, _feats, _lens = sg
    jtab = sprint(PKGS[0], "state_graph").aligner_tables_for_orths(builders[0], setup.orths)
    for f in ("states", "lengths", "tdp"):
        assert getattr(jtab, f).dtype == getattr(tables, f).dtype
        np.testing.assert_array_equal(getattr(jtab, f), getattr(tables, f))
    for s, chain in enumerate(setup.chains):
        np.testing.assert_array_equal(tables.states[s, :len(chain)], chain)
    # the silence rows carry the forbidden skip, the word rows the default
    assert np.isinf(tables.tdp[0, 0, 2]) and tables.tdp[0, 3, 2] == 3.0
    assert (tables.lengths <= np.asarray(setup.frames)).all()   # every chain fits


def packs(models, kind):
    jm, tm = models
    if kind == "df32":
        return tm.pack_df(device="cpu"), jm.pack_df(), "df32", "df32"
    method = "pallas" if kind == "f32" else "mxu"
    dt, jdt = ((torch.float32, jnp.float32) if kind == "f32" else (torch.float64, jnp.float64))
    return (tm.pack(dtype=dt, device="cpu", method=method), jm.pack(dtype=jdt, method=method),
            dt, jdt)


def jax_tables(tables):
    return jvit.AlignerTables(states=tables.states, lengths=tables.lengths, tdp=tables.tdp)


@pytest.mark.parametrize("kind,thr", [("f32", 300.0), ("f64", 300.0), ("f32", None),
                                      ("f64", None), ("df32", None)])
def test_align_equals_jax(sg, kind, thr):
    """The Sprint-mode alignment (aligner_tables_for_orths) of the port on the
    CPU against JAX's align_batch: equal states, costs within COST_RTOL."""
    _setup, _builders, tables, models, feats, lens = sg
    pack, jpack, dt, jdt = packs(models, kind)
    states, costs = tvit.align_batch_chunked(pack, feats, lens, tables, thr,
                                             tie_pruned=thr is not None, dtype=dt)
    jstates, jcosts = jvit.align_batch(jpack, feats, lens, jax_tables(tables), thr,
                                       tie_pruned=thr is not None, dtype=jdt)
    np.testing.assert_array_equal(states, np.asarray(jstates))
    np.testing.assert_allclose(costs, np.asarray(jcosts), rtol=COST_RTOL[kind], atol=0)
    assert np.all(costs < BIG / 2)         # every utterance reaches a final position


def test_df32_infinite_silence_skip(sg):
    """What both packages do with the AN4 TDPs' infinite silence skip on the
    df32 path, pruned (tie_pruned, threshold 300):

    * doublefloat.from_f64 splits inf into (inf, NaN) in both;
    * the skip into a silence position is the first candidate, and no other
      candidate is strictly less than a NaN, so every silence position past
      the first two costs NaN every frame; pruning turns it into BIG, so no
      path crosses a silence between two words, and the row minimum
      (pairwise halving) is NaN wherever a NaN meets it in the second half
      of a pair. Both packages give the same costs and, where an utterance
      reaches a final position, the same states; they differ from the f64
      alignment's;
    * an utterance whose row dies (cost BIG) walks back through positions
      past the row: JAX's align_batch fills those (int32 minimum), its
      align_batch_chunked raises IndexError, and the port wraps and clamps
      them (ROADMAP Queue 3 #7).

    Without pruning (a forced final position) the skip is the last
    candidate, never taken, and df32 equals f64 (test_align_equals_jax)."""
    _setup, _builders, tables, models, feats, lens = sg
    for dfm in (jdf, tdf):
        d = dfm.from_f64(np.array([np.inf, 3.0]))
        hi, lo = np.asarray(d.hi), np.asarray(d.lo)
        assert hi[0] == np.inf and np.isnan(lo[0]) and hi[1] == 3.0 and lo[1] == 0.0
    pack, jpack, _dt, _jdt = packs(models, "df32")
    states, costs = tvit.align_batch_chunked(pack, feats, lens, tables, 300.0, dtype="df32")
    jstates, jcosts = jvit.align_batch(jpack, feats, lens, jax_tables(tables), 300.0,
                                       dtype="df32")
    jstates, jcosts = np.asarray(jstates), np.asarray(jcosts)
    np.testing.assert_allclose(costs, jcosts, rtol=COST_RTOL["df32"], atol=0)
    dead = costs >= BIG / 2
    assert dead.any() and not dead.all()
    np.testing.assert_array_equal(states[~dead], jstates[~dead])
    for s in np.nonzero(dead)[0]:
        assert (jstates[s, :lens[s]] == np.iinfo(np.int32).min).any()
        assert ((states[s] >= 0) & (states[s] < SMALL_SHAPE["classes"])).all()
    with pytest.raises(IndexError):
        jvit.align_batch_chunked(jpack, feats, lens, jax_tables(tables), 300.0, dtype="df32")
    f64_states, f64_costs = tvit.align_batch_chunked(
        packs(models, "f64")[0], feats, lens, tables, 300.0, dtype=torch.float64)
    assert np.all(f64_costs < BIG / 2)
    assert all(not np.array_equal(states[s], f64_states[s]) for s in range(len(lens)))
    # no surviving path enters the first inner silence: positions past the
    # first word's end are never reached
    for s in np.nonzero(~dead)[0]:
        first_word = len(_builders[1]._pron_states(_setup.orths[s][0]))
        assert set(states[s, :lens[s]]) <= set(tables.states[s, :3 + first_word])


@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_baum_welch_equals_jax(sg, kind):
    """baum_welch_posteriors over the Sprint tables (f64 "mxu", f32 "pallas")
    against JAX's f64 run (its float32 forward-backward raises: ROADMAP
    Queue 3 #13): gamma and log_z within BW_TOL."""
    _setup, _builders, tables, models, feats, lens = sg
    jm, _tm = models
    jg, jz = jbw.baum_welch_posteriors(jm.pack(dtype=jnp.float64), feats, lens,
                                       jax_tables(tables), dtype=jnp.float64)
    pack, _jpack, dt, _jdt = packs(models, kind)
    g, z = tbw.baum_welch_posteriors(pack, feats, lens, tables, dtype=dt)
    assert g.dtype == dt and torch.isfinite(g).all() and torch.isfinite(z).all()
    g, z = g.numpy().astype(np.float64), z.numpy().astype(np.float64)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=0, atol=BW_TOL[kind])
    np.testing.assert_allclose(z, np.asarray(jz), rtol=BW_TOL[kind], atol=0)


def test_baum_welch_alignment(sg):
    """tests/test_state_graph.py::test_baum_welch_alignment_over_an4 on the
    seeded setup, through the port: posteriors sum to 1 a frame, log_z is
    finite, the argmax path is monotone over the chain positions, and the
    posterior best path is a [B, T] state path."""
    _setup, _builders, tables, models, feats, lens = sg
    _jm, tm = models
    gamma, log_z = tbw.baum_welch_posteriors(tm.pack(dtype=torch.float64, device="cpu"), feats,
                                             lens, tables, dtype=torch.float64)
    g = gamma.numpy()
    for b in range(len(lens)):
        np.testing.assert_allclose(g[b, :lens[b]].sum(axis=1), 1.0, atol=1e-9)
        steps = np.diff(g[b, :lens[b]].argmax(axis=1))
        assert (steps >= 0).all() and (steps <= 2).all()
    assert torch.isfinite(log_z).all()
    best = tbw.best_path_from_posteriors(gamma, tables)
    assert best.shape == feats.shape[:2] and best.dtype == np.int32
