"""The port's EM trainer end to end on the CPU (plain versions), against the
C++ trainer's outputs and the JAX package's Trainer.

The oracle recipe is tests/test_em_demo.py's: MIXTURE_POOLING, tdp 20/0/20,
pruning 120, 2 splits, 1 alignment, 3 estimates, on the 35 demo utterances.
The constants are copied, not imported (the card's machine has no jax). In
f64: the ten AM-score lines within 1e-4 (the oracle prints 6 digits); the
alignment dumps bit-equal to tests/fixtures/demo_alignments/; iter-lin.mix
exact in counts, iter-2.mix within rtol 1e-9 / atol 1e-7; the JAX trainer's
stats lines as strings and its alignment. Sum mode (max-approx=false)
against tests/fixtures/sum_mode/, and a resumed run. The df32 trainer is
tests/test_torch_train_df32.py, which shares these helpers."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from speechrecognition_torch.train.em import Trainer, TrainerConfig

# One intra-op thread per test process (see tests/test_torch_align.py).
torch.set_num_threads(1)

FIX =Path(__file__).resolve().parent / "fixtures"
TDP = dict(loop=20.0, forward=0.0, skip=20.0)
RECIPE = dict(min_obs=1, num_splits=2, num_aligns=1, num_estimates=3, pruning_threshold=120.0)
# the C++ trainer's AM-score trajectories (%g, 6 significant digits)
ORACLE_AM_SCORES = {
    (-1, 0, 0): 32.9885,
    (0, 0, 0): 32.5804,
    (1, -1, 0): 32.1673,
    (1, 0, 0): 31.9418, (1, 0, 1): 31.9074, (1, 0, 2): 31.8869,
    (2, -1, 0): 31.4152,
    (2, 0, 0): 31.3187, (2, 0, 1): 31.2697, (2, 0, 2): 31.2383,
}
ORACLE_SUM_AM_SCORES = {
    (-1, 0, 0): 32.9885,
    (0, 0, 0): 32.5804,
    (1, -1, 0): 32.0199,
    (1, 0, 0): 31.8052, (1, 0, 1): 31.7698, (1, 0, 2): 31.7469,
    (2, -1, 0): 31.212,
    (2, 0, 0): 31.105, (2, 0, 1): 31.0495, (2, 0, 2): 31.0119,
}


def read_corpus(pkg_corpus, pkg_front, lexicon, **kw):
    desc = pkg_corpus.CorpusDescription.read(str(FIX / "demo_corpus.json"), lexicon)
    return pkg_corpus.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                  pkg_front.SignalAnalysisConfig(),
                                  normalization_path=str(FIX / "normalization-demo.bin"), **kw)


def train(pkg, out: Path, dtype, max_approx=True, **cfg_kw):
    """Run package ``pkg``'s trainer ("torch" on the CPU, or "jax") with the
    oracle recipe; returns (trainer, alignment)."""
    if pkg == "torch":
        import speechrecognition_torch.corpus as corpus_mod
        import speechrecognition_torch.features.frontend as front
        import speechrecognition_torch.lexicon as lex_mod
        import speechrecognition_torch.models.gmm as gmm
        import speechrecognition_torch.tdp as tdp_mod
        from speechrecognition_torch.train.em import Trainer, TrainerConfig
        kw = dict(device="cpu")
    else:
        import speechrecognition_tpu.corpus as corpus_mod
        import speechrecognition_tpu.features.frontend as front
        import speechrecognition_tpu.lexicon as lex_mod
        import speechrecognition_tpu.models.gmm as gmm
        import speechrecognition_tpu.tdp as tdp_mod
        from speechrecognition_tpu.train.em import Trainer, TrainerConfig
        kw = {}
    lex = lex_mod.build_sietill_lexicon()
    corpus = read_corpus(corpus_mod, front, lex, **({} if pkg == "torch" else
                                                    {"use_native": False}))
    model = gmm.MixtureModel(dim=25, num_mixtures=lex.num_states,
                             var_model=gmm.VarianceModel.MIXTURE_POOLING, max_approx=max_approx)
    cfg = TrainerConfig(**{**RECIPE, **cfg_kw}, mixture_path=str(out) + "/iter-",
                        alignment_path=str(out) + "/alignment-")
    trainer = Trainer(cfg, lex, model, tdp_mod.TdpModel(silence_state=lex.silence_state, **TDP),
                      max_approx=max_approx, dtype=dtype, log=lambda *a: None, **kw)
    return trainer, trainer.train(corpus)


def trajectory(stats_lines):
    got = {}
    for line in stats_lines:
        i, j, k, s = line.split()
        got[(int(i), int(j), int(k))] = float(s)
    return got


def assert_trajectory(stats_lines, oracle, tol=1e-4):
    got = trajectory(stats_lines)
    assert set(got) == set(oracle)
    for key, ref in oracle.items():
        # the oracle prints %g (6 significant digits)
        assert abs(got[key] - ref) < tol, (key, got[key], ref)


def assert_alignments(out: Path, ref_dir: Path, names):
    from speechrecognition_torch.io import read_alignment
    for name in names:
        ref, _, _ = read_alignment(str(ref_dir / name))
        mine, _, _ = read_alignment(str(out / name))
        assert mine.shape == ref.shape
        np.testing.assert_array_equal(mine, ref)


def assert_mix(out: Path, ref_path: Path, name, exact_counts, rtol, atol):
    from speechrecognition_torch.io import read_mixture_set
    ref = read_mixture_set(str(ref_path), 25)
    mine = read_mixture_set(str(out / name), 25)
    assert [len(m) for m in mine.mixtures] == [len(m) for m in ref.mixtures]
    if exact_counts:
        np.testing.assert_array_equal(mine.mean_weight, ref.mean_weight)
    else:
        np.testing.assert_allclose(mine.mean_weight, ref.mean_weight, rtol=rtol, atol=atol)
    np.testing.assert_allclose(mine.mean_acc, ref.mean_acc, rtol=rtol, atol=atol)


# -- f64: the oracle, the JAX trainer, sum mode, resume --------------------------


@pytest.fixture(scope="module")
def f64_runs(tmp_path_factory):
    """The port's and the JAX package's f64 trainers on the demo corpus."""
    out, jout = tmp_path_factory.mktemp("torch_f64"), tmp_path_factory.mktemp("jax_f64")
    import jax.numpy as jnp
    trainer, alignment = train("torch", out, torch.float64)
    jtrainer, jalignment = train("jax", jout, jnp.float64)
    return trainer, alignment, out, jtrainer, jalignment


def test_f64_trajectory_matches_oracle(f64_runs):
    assert_trajectory(f64_runs[0].stats_lines, ORACLE_AM_SCORES)


def test_f64_alignments_match_oracle(f64_runs):
    assert_alignments(f64_runs[2], FIX / "demo_alignments",
                      [f"alignment-{i}-0.dump" for i in range(3)])


def test_f64_mixtures_match_oracle(f64_runs):
    out = f64_runs[2]
    assert_mix(out, FIX / "iter-lin.mix", "iter-lin.mix", True, rtol=1e-12, atol=1e-9)
    assert_mix(out, FIX / "iter-2.mix", "iter-2.mix", True, rtol=1e-9, atol=1e-7)


def test_f64_equals_jax_trainer(f64_runs):
    trainer, alignment, _out, jtrainer, jalignment = f64_runs
    assert trainer.stats_lines == jtrainer.stats_lines
    np.testing.assert_array_equal(alignment, jalignment)
    assert alignment.dtype == np.int32
    assert set(trainer.phase_seconds) == {"estimate", "align", "score"}


def test_f64_sum_mode_matches_oracle(tmp_path):
    trainer, _alignment = train("torch", tmp_path, torch.float64, max_approx=False)
    assert_trajectory(trainer.stats_lines, ORACLE_SUM_AM_SCORES)
    assert_alignments(tmp_path, FIX / "sum_mode", ["alignment-2-0.dump"])
    for name in ("iter-lin.mix", "iter-2.mix"):
        assert_mix(tmp_path, FIX / "sum_mode" / name, name, False, rtol=1e-6, atol=1e-5)


def test_df32_sum_mode_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="max-approx"):
        train("torch", tmp_path, "df32", max_approx=False)


def test_resume_from_split_1(f64_runs, tmp_path):
    """start_split=2 from the run's own iter-1.mix and alignment dump writes
    the same iter-2.mix and alignment as the uninterrupted run."""
    out = f64_runs[2]
    for name in ("iter-1.mix", "alignment-1-0.dump"):
        shutil.copy(out / name, tmp_path / name)
    trainer, _ = train("torch", tmp_path, torch.float64, start_split=2)
    assert trainer.stats_lines == f64_runs[0].stats_lines[-4:]
    assert (tmp_path / "iter-2.mix").read_bytes() == (out / "iter-2.mix").read_bytes()
    assert_alignments(tmp_path, out, ["alignment-2-0.dump"])


def test_trainer_config_from_config():
    from speechrecognition_torch.config import Configuration
    cfg = TrainerConfig.from_config(Configuration({
        "min-obs": 2, "num-splits": 4, "num-estimates": 10, "pruning-threshold": 200.0,
        "alignment-pruning": False, "approx-linear-segmentation": False,
        "train-batch-size": 64, "start-split": 1, "linear-segmentation-variant": "full-dp"}))
    assert (cfg.min_obs, cfg.num_splits, cfg.num_aligns, cfg.num_estimates) == (2, 4, 1, 10)
    assert cfg.pruning_threshold == 200.0 and not cfg.alignment_pruning
    assert not cfg.approx_linear_segmentation and cfg.batch_size == 64
    assert cfg.start_split == 1 and cfg.segmentation_variant == "full-dp"


def test_trainer_refuses_unknown_dtype():
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.models.gmm import MixtureModel
    from speechrecognition_torch.tdp import TdpModel
    lex = build_sietill_lexicon()
    with pytest.raises(ValueError, match="dtype"):
        Trainer(TrainerConfig(), lex, MixtureModel(25, lex.num_states), TdpModel(0),
                dtype=torch.float16, device="cpu")
