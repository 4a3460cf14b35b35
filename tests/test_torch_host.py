"""Port host layer: the host-only modules of speechrecognition_torch give the
same results as their speechrecognition_tpu originals, bit for bit."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import speechrecognition_tpu.corpus as jcorpus
import speechrecognition_tpu.features.frontend as jfront
import speechrecognition_tpu.io as jio
import speechrecognition_tpu.lexicon as jlex
import speechrecognition_tpu.models.gmm as jgmm
import speechrecognition_tpu.search.decoder as jdec
from speechrecognition_tpu.search.edit_distance import EDAccumulator as JAcc
from speechrecognition_tpu.search.edit_distance import edit_distance as j_edit_distance
import speechrecognition_tpu.tdp as jtdp

import speechrecognition_torch.corpus as tcorpus
import speechrecognition_torch.features.frontend as tfront
import speechrecognition_torch.io as tio
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.models.gmm as tgmm
import speechrecognition_torch.search.decoder as tdec
from speechrecognition_torch.search.edit_distance import EDAccumulator as TAcc
from speechrecognition_torch.search.edit_distance import edit_distance as t_edit_distance
import speechrecognition_torch.tdp as ttdp

REPO = Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
MODELS = [("iter-2.mix", "MIXTURE_POOLING"), ("../../bench/model.mix", "NO_POOLING")]


def test_lexicon_tables_equal():
    a, b = jlex.build_sietill_lexicon(), tlex.build_sietill_lexicon()
    assert (a.num_words, a.max_positions, a.num_states) == (12, 24, 106)
    assert (b.num_words, b.max_positions, b.num_states) == (12, 24, 106)
    assert a.orth == b.orth and a.silence_idx == b.silence_idx
    assert a.silence_state == b.silence_state
    np.testing.assert_array_equal(a.state_table(), b.state_table())
    np.testing.assert_array_equal(a.word_lengths(), b.word_lengths())
    assert b.state_table().dtype == np.int32


def test_tdp_tables_equal():
    lex = tlex.build_sietill_lexicon()
    a = jtdp.TdpModel(silence_state=0, loop=3.0, forward=0.0, skip=30.0)
    b = ttdp.TdpModel(silence_state=0, loop=3.0, forward=0.0, skip=30.0)
    np.testing.assert_array_equal(a.table_for_states(lex.state_table()),
                                  b.table_for_states(lex.state_table()))
    assert [a.score(s, j) for s in range(3) for j in range(3)] == \
        [b.score(s, j) for s in range(3) for j in range(3)]


@pytest.mark.parametrize("path", [m for m, _ in MODELS])
def test_read_mixture_set_equal(path):
    a = jio.read_mixture_set(str(FIX / path), 25)
    b = tio.read_mixture_set(str(FIX / path), 25)
    for field in ("mean_acc", "mean_weight", "var_acc", "var_weight", "densities"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert len(a.mixtures) == len(b.mixtures) == 106
    for ma, mb in zip(a.mixtures, b.mixtures):
        np.testing.assert_array_equal(ma, mb)


@pytest.mark.parametrize("path,pooling", MODELS)
def test_mixture_model_from_raw_equal(path, pooling):
    a = jgmm.MixtureModel.from_raw(jio.read_mixture_set(str(FIX / path), 25),
                                   jgmm.VarianceModel[pooling], max_approx=True)
    b = tgmm.MixtureModel.from_raw(tio.read_mixture_set(str(FIX / path), 25),
                                   tgmm.VarianceModel[pooling], max_approx=True)
    for field in ("means", "mean_weights", "mean_weights_log", "vars",
                  "vars_inv", "norm", "mean_refs", "var_refs"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.mixtures == b.mixtures
    assert a.max_densities_per_mixture == b.max_densities_per_mixture


@pytest.fixture(scope="module")
def corpora():
    jl, tl = jlex.build_sietill_lexicon(), tlex.build_sietill_lexicon()
    desc_path = str(FIX / "demo_corpus.json")
    feat_path = str(FIX / "demo_features") + "/"
    norm = str(FIX / "normalization-demo.bin")
    a = jcorpus.Corpus.read(jcorpus.CorpusDescription.read(desc_path, jl), feat_path,
                            jfront.SignalAnalysisConfig(), normalization_path=norm,
                            use_native=False)
    b = tcorpus.Corpus.read(tcorpus.CorpusDescription.read(desc_path, tl), feat_path,
                            tfront.SignalAnalysisConfig(), normalization_path=norm)
    return a, b


def test_corpus_read_equal(corpora):
    a, b = corpora
    assert b.num_segments == 35 and b.features.dtype == np.float32
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.feature_offsets, b.feature_offsets)
    assert a.orths == b.orths and a.names == b.names
    assert a.frame_duration == b.frame_duration and a.dim == b.dim == 25


def test_demo_corpus_description_matches_golden(corpora):
    """demo_corpus.json lists the feature files in the golden file's order."""
    _, b = corpora
    with open(FIX / "demo_recognition.json") as f:
        golden = json.load(f)
    assert sorted(p.name[:-4] for p in (FIX / "demo_features").glob("*.mm2")) == b.names
    for u in golden["utts"]:
        assert b.orths[u["idx"]] == u["ref"]


def test_padded_batch_equal(corpora):
    a, b = corpora
    ids = [3, 0, 34, 17]
    fa, la = a.padded_batch(ids, pad_to=704)
    fb, lb = b.padded_batch(ids, pad_to=704)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(la, lb)


def test_frontend_numpy_path_equal():
    rng = np.random.default_rng(0)
    samples = rng.integers(-3000, 3000, size=4000).astype(np.int16)
    cfg_a, cfg_b = jfront.SignalAnalysisConfig(), tfront.SignalAnalysisConfig()
    fa = jfront.extract_features(samples, cfg_a)
    fb = tfront.extract_features(samples, cfg_b)
    np.testing.assert_array_equal(fa, fb)
    mean, std = tfront.compute_normalization_stats(tfront.add_deltas(fb, cfg_b))
    for x, y in zip(jfront.compute_normalization_stats(jfront.add_deltas(fa, cfg_a)),
                    (mean, std)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jfront.process_features(fa, mean, std, cfg_a),
                                  tfront.process_features(fb, mean, std, cfg_b))


def test_edit_distance_on_golden_pairs():
    with open(FIX / "demo_recognition.json") as f:
        golden = json.load(f)
    acc_a, acc_b = JAcc(), TAcc()
    for u in golden["utts"]:
        ea, eb = j_edit_distance(u["ref"], u["hyp"]), t_edit_distance(u["ref"], u["hyp"])
        assert [eb.substitute_count, eb.insert_count, eb.delete_count] == u["sid"]
        assert [ea.substitute_count, ea.insert_count, ea.delete_count] == u["sid"]
        acc_a += ea
        acc_b += eb
    for acc in (acc_a, acc_b):
        assert [acc.substitute_count, acc.insert_count, acc.delete_count] == \
            golden["corpus"]["sid"]


@pytest.mark.parametrize("exclude_last_pred", [True, False])
@pytest.mark.parametrize("word_penalty", [80.0, "per-word"])
def test_decoder_tables_equal(exclude_last_pred, word_penalty):
    if word_penalty == "per-word":
        word_penalty = np.linspace(0.0, 55.0, 12)
    a = jdec.DecoderTables.build(jlex.build_sietill_lexicon(),
                                 jtdp.TdpModel(0, 3.0, 0.0, 30.0), word_penalty,
                                 exclude_last_pred=exclude_last_pred)
    b = tdec.DecoderTables.build(tlex.build_sietill_lexicon(),
                                 ttdp.TdpModel(0, 3.0, 0.0, 30.0), word_penalty,
                                 exclude_last_pred=exclude_last_pred)
    for field in ("state_table", "word_len", "last_pos", "first_state",
                  "tdp_within", "entry_pen"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (a.num_words, a.max_pos, a.exit_pen) == (b.num_words, b.max_pos, b.exit_pen)


def test_port_imports_no_jax():
    """The port and every module of its slice import without jax."""
    code = (
        "import sys\n"
        "import speechrecognition_torch\n"
        "import speechrecognition_torch.config, speechrecognition_torch.contracts\n"
        "import speechrecognition_torch.lexicon, speechrecognition_torch.tdp\n"
        "import speechrecognition_torch.io, speechrecognition_torch.corpus\n"
        "import speechrecognition_torch.features.frontend\n"
        "import speechrecognition_torch.search.edit_distance\n"
        "import speechrecognition_torch.ops._native\n"
        "import speechrecognition_torch.ops.mahalanobis\n"
        "import speechrecognition_torch.models.gmm\n"
        "import speechrecognition_torch.search.decoder\n"
        "import speechrecognition_torch.convert\n"
        "import speechrecognition_torch.cli\n"
        "import speechrecognition_torch.train.em\n"
        "import speechrecognition_torch.align.viterbi\n"
        "import speechrecognition_torch.models.nn\n"
        "import speechrecognition_torch.train.nn_training\n"
        "import speechrecognition_torch.tools.tsne, speechrecognition_torch.tools.time_align_df\n"
        "import speechrecognition_torch.native.loader\n"
        "import speechrecognition_torch.sprint.config, speechrecognition_torch.sprint.am\n"
        "import speechrecognition_torch.lm.arpa, speechrecognition_torch.tools.an4_system\n"
        "import speechrecognition_torch.lm.char_rnn\n"
        "import speechrecognition_torch.models.quantized\n"
        "import speechrecognition_torch.search.linear_lvcsr\n"
        "import speechrecognition_torch.fsa, speechrecognition_torch.fsa.lazy\n"
        "import speechrecognition_torch.fsa.alphabet, speechrecognition_torch.fsa.tail\n"
        "import speechrecognition_torch.lm.ngram, speechrecognition_torch.lm.variants\n"
        "import speechrecognition_torch.sprint.bliss, speechrecognition_torch.search.flf\n"
        "import speechrecognition_torch.search.flf_rescore\n"
        "import speechrecognition_torch.search.flf_closure\n"
        "import speechrecognition_torch.search.flf_compose\n"
        "import speechrecognition_torch.search.flf_network\n"
        "import speechrecognition_torch.search.flf_cn\n"
        "import speechrecognition_torch.sprint.archive, speechrecognition_torch.sprint.flow_cache\n"
        "import speechrecognition_torch.sprint.lda, speechrecognition_torch.sprint.flow\n"
        "import speechrecognition_torch.sprint.cart, speechrecognition_torch.sprint.state_graph\n"
        "import speechrecognition_torch.sprint.mm_io, speechrecognition_torch.sprint.mc\n"
        "import speechrecognition_torch.sprint.legacy_tree\n"
        "import speechrecognition_torch.sprint.cart_convert\n"
        "import speechrecognition_torch.sprint.cart_train\n"
        "import speechrecognition_torch.sprint.segment_clustering\n"
        "import speechrecognition_torch.sprint.core_utils\n"
        "import speechrecognition_torch.sprint.channel\n"
        "from speechrecognition_torch.sprint.am import AllophoneStateModel\n"
        "from speechrecognition_torch.tools.an4_system import (build_system, load_corpus,\n"
        "                                                     train_model)\n"
        "import speechrecognition_torch.parallel, speechrecognition_torch.parallel.mesh\n"
        "import speechrecognition_torch.parallel.multihost\n"
        "import speechrecognition_torch.parallel.wcts_step\n"
        "import speechrecognition_torch.tools.partition, speechrecognition_torch.tools.plots\n"
        "import speechrecognition_torch.tools.sprint_tools\n"
        "import speechrecognition_torch.tools.full_parity\n"
        "import speechrecognition_torch.tools.wer_sweep, speechrecognition_torch.tools.mpe_run\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('speechrecognition_tpu') or m.startswith('matplotlib'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("pooling", ["GLOBAL_POOLING", "MIXTURE_POOLING", "NO_POOLING"])
def test_mixture_model_init_equal(pooling):
    a = jgmm.MixtureModel(25, 106, jgmm.VarianceModel[pooling])
    b = tgmm.MixtureModel(25, 106, tgmm.VarianceModel[pooling])
    for field in ("means", "mean_acc", "mean_refs", "vars", "var_acc", "var_refs", "norm"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.mixtures == b.mixtures
    assert tgmm.VarianceModel.from_string("none") is tgmm.VarianceModel.NO_POOLING
