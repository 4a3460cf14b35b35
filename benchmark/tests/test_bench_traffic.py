"""The traffic generator: deterministic for a seed, different across seeds,
the same set of lengths for every seed."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import mixfile, traffic  # noqa: E402

CASES = {"sietill-gmm": "sietill-train-corpus", "an4-lvcsr": "an4-decode-jobs"}


def _setup(config):
    cdir = ROOT / "benchmark" / "configs" / config
    cfg = json.loads((cdir / "config.json").read_text())
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{CASES[config]}.json").read_text())
    mix.update(utterances=12, length_max=240, length_mean=150)
    model = mixfile.read_model(str(cdir / cfg["model_file"]), cfg["dim"], cfg["pooling"])
    return cfg, mix, traffic.lexicon_from_config(cfg["lexicon"], model), model


@pytest.mark.parametrize("config", sorted(CASES))
def test_corpus_is_a_function_of_the_seed(config):
    cfg, mix, lex, model = _setup(config)
    a = traffic.draw_corpus(2 ** 31 + 11, mix, lex, model, "cpu")
    b = traffic.draw_corpus(2 ** 31 + 11, mix, lex, model, "cpu")
    c = traffic.draw_corpus(2 ** 31 + 12, mix, lex, model, "cpu")
    assert np.array_equal(a.features, b.features) and a.words == b.words
    assert np.array_equal(a.offsets, b.offsets)
    assert not np.array_equal(a.features[:100], c.features[:100]) and a.words != c.words
    # the same lengths in another order
    assert sorted(a.lengths) == sorted(c.lengths)
    assert a.features.shape == (a.offsets[-1], cfg["dim"]) and a.features.dtype == np.float32
    assert all(1 <= len(w) <= mix["words_max"] for w in a.words)
    assert all(lex.silence not in w for w in a.words)


@pytest.mark.parametrize("config", sorted(CASES))
def test_fixed_lengths_follow_the_mix(config):
    _cfg, mix, _lex, _model = _setup(config)
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{CASES[config]}.json").read_text())
    L = traffic.fixed_lengths(mix)
    assert len(L) == mix["utterances"]
    assert L.min() >= mix["length_min"] and L.max() <= mix["length_max"]
    assert abs(L.mean() - mix["length_mean"]) < 0.02 * mix["length_mean"]
    assert np.array_equal(L, traffic.fixed_lengths(mix))


def test_sietill_lexicon_numbers_states_word_by_word():
    cfg, _mix, lex, _model = _setup("sietill-gmm")
    assert lex.num_words == 12 and lex.silence == 0
    assert [len(s) for s in lex.states][:3] == [1, 18, 18]
    assert int(lex.states[-1][-1]) == cfg["mixtures"] - 1


def test_an4_lexicon_shape():
    cfg, _mix, lex, _model = _setup("an4-lvcsr")
    assert int(_model.active.any(1).sum()) == 407
    assert lex.num_words == cfg["lexicon"]["num_words"] + 1
    sil = set(lex.states[0].tolist())
    assert len(lex.states[0]) == 3
    assert all(len(s) % 3 == 0 and 3 <= len(s) <= 30 for s in lex.states[1:])
    assert not any(sil & set(s.tolist()) for s in lex.states[1:])
    # every state a trained class
    assert all(_model.active[s].any(1).all() for s in lex.states)
