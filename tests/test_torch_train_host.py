"""The trainer's host layer: EM bookkeeping of MixtureModel, the linear
segmentations, the aligner tables and the sorted-block index of the port
give the same results as the JAX package's, bit for bit."""

from pathlib import Path

import numpy as np
import pytest

import speechrecognition_tpu.align.linear_seg as jseg
import speechrecognition_tpu.align.viterbi as jvit
import speechrecognition_tpu.io as jio
import speechrecognition_tpu.lexicon as jlex
import speechrecognition_tpu.models.gmm as jgmm
import speechrecognition_tpu.tdp as jtdp

import speechrecognition_torch.align.linear_seg as tseg
import speechrecognition_torch.align.viterbi as tvit
import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.gmm as tgmm
import speechrecognition_torch.tdp as ttdp

FIX = Path(__file__).resolve().parent / "fixtures"
ARRAYS = ("means", "mean_acc", "mean_weights", "mean_weights_log", "mean_weight_acc",
          "mean_refs", "vars", "vars_inv", "var_acc", "var_weight_acc", "var_refs", "norm")


def random_raw(pkg_io, pooling: str, seed: int, S: int = 7, dim: int = 5):
    """A random accumulator set: 1-3 densities per mixture, some with a
    count below 1 (eliminated) and one with count 0 (nan parameters)."""
    rng = np.random.default_rng(seed)
    per_mix = rng.integers(1, 4, size=S)
    n_means = int(per_mix.sum())
    n_vars = {"none": n_means, "mixture": S, "global": 1}[pooling]
    counts = rng.integers(0, 40, size=n_means).astype(np.float64)
    counts[rng.integers(0, n_means)] = 0.0
    counts[counts == 1] = 0.5
    means = rng.normal(size=(n_means, dim))
    mean_acc = means * counts[:, None]
    densities, mixtures, d = [], [], 0
    for s in range(S):
        ids = []
        for _ in range(per_mix[s]):
            vi = {"none": d, "mixture": s, "global": 0}[pooling]
            densities.append((d, vi))
            ids.append(len(densities) - 1)
            d += 1
        mixtures.append(np.asarray(ids, np.int64))
    var_weight = rng.integers(5, 80, size=n_vars).astype(np.float64)
    var_acc = (rng.uniform(0.5, 2.0, size=(n_vars, dim)) + 1.0) * var_weight[:, None]
    return pkg_io.RawMixtureSet(dim=dim, mean_acc=mean_acc, mean_weight=counts,
                                var_acc=var_acc, var_weight=var_weight,
                                densities=np.asarray(densities, np.int64), mixtures=mixtures)


def assert_models_equal(a, b):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert [list(map(tuple, m)) for m in a.mixtures] == \
        [[(int(x), int(y)) for x, y in m] for m in b.mixtures]


def assert_raw_equal(a, b):
    for name in ("mean_acc", "mean_weight", "var_acc", "var_weight", "densities"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert len(a.mixtures) == len(b.mixtures)
    for x, y in zip(a.mixtures, b.mixtures):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("pooling", ["NO_POOLING", "MIXTURE_POOLING", "GLOBAL_POOLING"])
def test_bookkeeping_sequence_equals_jax(pooling, tmp_path):
    """from_raw → statistics → finalize → split → statistics → finalize →
    eliminate → statistics → finalize → sync_accumulators_to_parameters →
    to_raw, on one random accumulator set, through both packages."""
    key = tgmm.VarianceModel[pooling].value
    jm = jgmm.MixtureModel.from_raw(random_raw(jio, key, 3), jgmm.VarianceModel[pooling],
                                    max_approx=True)
    tm = tgmm.MixtureModel.from_raw(random_raw(tio, key, 3), tgmm.VarianceModel[pooling],
                                    max_approx=True)
    assert_models_equal(tm, jm)
    rng = np.random.default_rng(7)

    def stats():
        S, D, dim = tm.num_mixtures, tm.max_densities_per_mixture, tm.dim
        w = rng.integers(0, 30, size=(S, D)).astype(np.float64)
        return (w, rng.normal(size=(S, D, dim)) * w[:, :, None] + w[:, :, None],
                rng.uniform(1.0, 3.0, size=(S, D, dim)) * w[:, :, None])

    for step in ("split", "eliminate", None):
        if step == "split":
            jm.split(2.0)
            tm.split(2.0)
        elif step == "eliminate":
            jm.eliminate(1.0)
            tm.eliminate(1.0)
        w, xs, x2s = stats()
        jm.apply_statistics(w, xs, x2s)
        tm.apply_statistics(w, xs, x2s)
        jm.finalize()
        tm.finalize()
        assert_models_equal(tm, jm)
        assert tm.num_densities() == jm.num_densities()
    jm.sync_accumulators_to_parameters()
    tm.sync_accumulators_to_parameters()
    assert_models_equal(tm, jm)
    raw = tm.to_raw()
    assert_raw_equal(raw, jm.to_raw())
    tio.write_mixture_set(str(tmp_path / "m.mix"), raw)
    back = tio.read_mixture_set(str(tmp_path / "m.mix"), tm.dim)
    assert_raw_equal(back, raw)
    assert_models_equal(tgmm.MixtureModel.from_raw(back, tm.var_model, True),
                        jgmm.MixtureModel.from_raw(jm.to_raw(), jm.var_model, True))


def test_reset_accumulators():
    tm = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(FIX / "iter-1.mix"), 25),
                                    tgmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    tm.reset_accumulators()
    assert not tm.mean_acc.any() and not tm.mean_weight_acc.any()
    assert not tm.var_weight_acc.any() and (tm.var_acc == tgmm.MIN_VARIANCE).all()


@pytest.fixture(scope="module")
def energies():
    lex = tlex.build_sietill_lexicon()
    desc = tcorpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = tcorpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                 tfront.SignalAnalysisConfig(),
                                 normalization_path=str(FIX / "normalization-demo.bin"))
    return corpus, [corpus.feature_sequence(s)[:, 0] for s in range(corpus.num_segments)]


@pytest.mark.parametrize("variant", ["approximation", "running_sums", "full_dp"])
def test_linear_segmentation_equals_jax(energies, variant):
    corpus, es = energies
    assert len(es) == 35
    lex = tlex.build_sietill_lexicon()
    for s, e in enumerate(es):
        fn = f"linear_segmentation_{variant}"
        b = getattr(tseg, fn)(e)
        assert b == getattr(jseg, fn)(e), (s, variant)
        states = tlex.build_segment_automaton(lex, corpus.orths[s]).states
        np.testing.assert_array_equal(tseg.linear_alignment_mapping(states, e.shape[0], *b),
                                      jseg.linear_alignment_mapping(states, e.shape[0], *b))


def test_aligner_tables_equal(energies):
    corpus, _ = energies
    jl, tl = jlex.build_sietill_lexicon(), tlex.build_sietill_lexicon()
    jt = jvit.AlignerTables.build([jlex.build_segment_automaton(jl, o) for o in corpus.orths],
                                  jtdp.TdpModel(silence_state=0, loop=20.0, forward=0.0,
                                                skip=20.0))
    tt = tvit.AlignerTables.build([tlex.build_segment_automaton(tl, o) for o in corpus.orths],
                                  ttdp.TdpModel(silence_state=0, loop=20.0, forward=0.0,
                                                skip=20.0))
    for name in ("states", "lengths", "tdp"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
        assert getattr(tt, name).dtype == getattr(jt, name).dtype
    ids = np.array([4, 0, 33])
    sub = tt.rows(ids)
    np.testing.assert_array_equal(sub.states, tt.states[ids])
    np.testing.assert_array_equal(sub.tdp, tt.tdp[ids])


@pytest.mark.parametrize("block", [4096, 256])
def test_sorted_blocks_equal(block):
    align, _w, _m = tio.read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    got = tgmm.sorted_blocks(align, 106, block=block)
    ref = jgmm.sorted_blocks(align, 106, block=block)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    frame_idx, block_state, nb = got
    live = frame_idx[frame_idx >= 0]
    assert sorted(live.tolist()) == list(range(align.shape[0]))
    assert (align[np.maximum(frame_idx, 0)][frame_idx >= 0]
            == np.repeat(block_state, block).reshape(frame_idx.shape)[frame_idx >= 0]).all()
    assert nb <= frame_idx.shape[0]

