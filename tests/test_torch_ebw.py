"""The port's MMI / EBW trainer against the JAX package's, on the CPU.

iter-2.mix on the first eight demo utterances (tests/fixtures, both
packages reading them), alignment-2-0.dump as the numerator alignment, TDP
3-0-30, float64, ``EbwConfig()`` defaults: the denominator lattices have
the same arcs (start, end, word) with scores within 1e-9; the numerator and
denominator statistics, the updated means, variances and weights and the
MMI criterion are within 1e-9 relative. One ``iterate`` with
tests/test_ebw.py's settings (E 2, τ 10) lowers the criterion in both and
gives the same diagnostics.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.corpus as jcorpus
import speechrecognition_tpu.io as jio
import speechrecognition_tpu.lexicon as jlex
import speechrecognition_tpu.models.gmm as jgmm
import speechrecognition_tpu.tdp as jtdp
import speechrecognition_tpu.train.ebw as jebw

import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.gmm as tgmm
import speechrecognition_torch.tdp as ttdp
import speechrecognition_torch.train.ebw as tebw

torch.set_num_threads(1)

FIX = Path(__file__).resolve().parent / "fixtures"
SEGMENTS = list(range(8))
RTOL = 1e-9


def subset(corpus, ids, cls):
    """The utterances ``ids`` of ``corpus`` as a corpus of class ``cls``."""
    lengths = [corpus.seq_length(s) for s in ids]
    return cls(features=np.concatenate([corpus.feature_sequence(s) for s in ids]),
               feature_offsets=np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64),
               orths=[list(corpus.orths[s]) for s in ids], names=[corpus.names[s] for s in ids],
               frame_duration=corpus.frame_duration, dim=corpus.dim)


def demo_setup(ids=SEGMENTS):
    """(port corpus, JAX corpus, alignment, port lexicon, JAX lexicon, port
    TDPs, JAX TDPs) for the demo utterances ``ids``."""
    lex, jl = tlex.build_sietill_lexicon(), jlex.build_sietill_lexicon()
    desc = tcorpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    full = tcorpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                               tfront.SignalAnalysisConfig(),
                               normalization_path=str(FIX / "normalization-demo.bin"))
    align, _w, _m = tio.read_alignment(str(FIX / "demo_alignments" / "alignment-2-0.dump"))
    ali = np.concatenate([align[full.feature_offsets[s]:full.feature_offsets[s + 1]]
                          for s in ids]).astype(np.int64)
    tdp = dict(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    return (subset(full, ids, tcorpus.Corpus), subset(full, ids, jcorpus.Corpus), ali, lex, jl,
            ttdp.TdpModel(**tdp), jtdp.TdpModel(**tdp))


def iter2():
    jm = jgmm.MixtureModel.from_raw(jio.read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                    jgmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    tm = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                    tgmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    return jm, tm


def close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=rtol)


@pytest.fixture(scope="module")
def run():
    """One pass of every step in both packages with EbwConfig() defaults."""
    corpus, jcorp, ali, lex, jl, tdp, jt = demo_setup()
    jm, tm = iter2()
    tr = tebw.EbwTrainer(tebw.EbwConfig(), lex, tm, tdp, dtype=torch.float64, device="cpu")
    jtr = jebw.EbwTrainer(jebw.EbwConfig(), jl, jm, jt, dtype=jnp.float64)
    out = {}
    for name, trainer, c in (("port", tr, corpus), ("jax", jtr, jcorp)):
        lats = trainer.decode_lattices(c)
        crit = trainer.mmi_criterion(c, ali, lats)
        num = trainer.numerator_statistics(c, ali)
        den = trainer.denominator_statistics(c, lats)
        trainer.ebw_update(num, den)
        out[name] = dict(lats=lats, crit=crit, num=num, den=den, model=trainer.model)
    return out, corpus


def test_lattices_equal_jax(run):
    out, corpus = run
    assert len(out["port"]["lats"]) == corpus.num_segments
    for lat, jl in zip(out["port"]["lats"], out["jax"]["lats"]):
        assert lat.num_frames == jl.num_frames
        assert [(a.start, a.end, a.word) for a in lat.arcs] == \
            [(a.start, a.end, a.word) for a in jl.arcs]
        close([a.score for a in lat.arcs], [a.score for a in jl.arcs])


@pytest.mark.parametrize("side", ["num", "den"])
def test_statistics_equal_jax(run, side):
    out, corpus = run
    for got, want in zip(out["port"][side], out["jax"][side]):
        assert got.shape == np.asarray(want).shape
        close(got, want)
    if side == "num":   # every frame once
        assert out["port"]["num"][0].sum() == corpus.total_frames


def test_mmi_criterion_equals_jax(run):
    out, _ = run
    close(out["port"]["crit"], out["jax"]["crit"])


def test_ebw_update_equals_jax(run):
    out, _ = run
    tm, jm = out["port"]["model"], out["jax"]["model"]
    for name in ("means", "vars", "vars_inv", "norm", "mean_weights", "mean_weights_log",
                 "mean_acc", "var_acc", "mean_weight_acc", "var_weight_acc"):
        close(getattr(tm, name), getattr(jm, name))
    _jm0, tm0 = iter2()
    assert not np.array_equal(tm.means, tm0.means)


def test_iterate_lowers_the_criterion_as_jax():
    """tests/test_ebw.py's settings: E 2, τ 10, word penalty 80, threshold
    200, one batch."""
    corpus, jcorp, ali, lex, jl, tdp, jt = demo_setup()
    jm, tm = iter2()
    kw = dict(e_constant=2.0, i_smoothing_tau=10.0, word_penalty=80.0, am_threshold=200.0,
              batch_size=len(SEGMENTS))
    got = tebw.EbwTrainer(tebw.EbwConfig(**kw), lex, tm, tdp, dtype=torch.float64,
                          device="cpu").iterate(corpus, ali)
    want = jebw.EbwTrainer(jebw.EbwConfig(**kw), jl, jm, jt, dtype=jnp.float64).iterate(jcorp, ali)
    assert got["criterion_after"] < got["criterion_before"], got
    n = corpus.total_frames
    assert got["num_frames_mass"] == n
    assert 0.5 * n < got["den_frames_mass"] < 1.2 * n
    for key in got:
        close(got[key], want[key])


def test_trainer_on_a_missing_card_raises(monkeypatch):
    """The default device is the card; without one the trainer raises and
    does not fall back to the CPU."""
    _corpus, _jc, _ali, lex, _jl, tdp, _jt = demo_setup([0])
    _jm, tm = iter2()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tebw.EbwTrainer(tebw.EbwConfig(), lex, tm, tdp)
