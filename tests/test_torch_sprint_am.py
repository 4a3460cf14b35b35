"""The port's Sprint host modules (speechrecognition_torch/sprint/{config,am}.py,
lm/arpa.py, tools/an4_system.build_lm_matrices) against the JAX package's
and the repository's tools/an4_system.py on the same inputs.

``TransitionModel.decoder_tables`` and ``tree_tables`` give JAX's arrays at
state repetitions 1 and 2 on small tied lexica (a TDP row of every state
type distinct, an infinite TDP, a scale); ``from_config`` reads the AN4
config block written here as JAX reads it; ``ArpaLM`` scores a seeded ARPA
file written here as JAX's does; ``build_lm_matrices`` gives the root tool's
matrices (its data directory pointed at the test's directory).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from speechrecognition_tpu.lexicon import Lexicon as JLexicon
from speechrecognition_tpu.lexicon import MarkovAutomaton as JAutomaton
from speechrecognition_tpu.lm.arpa import ArpaLM as JArpa
from speechrecognition_tpu.sprint.am import StateTypeTdp as JRow
from speechrecognition_tpu.sprint.am import TransitionModel as JTm
from speechrecognition_tpu.sprint.config import SprintConfig as JConfig

from speechrecognition_torch.lm.arpa import ArpaLM
from speechrecognition_torch.sprint import SprintConfig, StateTypeTdp, TransitionModel
from speechrecognition_torch.tools import an4_system
from torch_linear_tables import AN4_TDP, AN4_TDP_CONFIG, INF, an4_lexicon, arpa_text, \
    tied_lexicon

REPO = Path(__file__).resolve().parent.parent
ROWS = {"default": (3.0, 0.5, 4.0, 20.0), "silence": (0.25, 2.0, INF, 7.0),
        "entry_m1": (INF, 1.0, 5.0, 0.0), "entry_m2": (9.0, 9.0, 9.0, 9.0),
        "phone1": (1.5, 0.75, 2.5, 11.0)}


def models(scale=1.5, phone1=True):
    port = TransitionModel(**{k: StateTypeTdp(*v) for k, v in ROWS.items()
                              if phone1 or k != "phone1"}, scale=scale)
    jax = JTm(**{k: JRow(*v) for k, v in ROWS.items() if phone1 or k != "phone1"},
              scale=scale)
    return port, jax


def jax_lexicon(lex):
    return JLexicon(orth=list(lex.orth),
                    automata=[JAutomaton(states=a.states.copy()) for a in lex.automata],
                    silence=lex.silence)


def small_lexicon(seed):
    rng = np.random.default_rng(seed)
    return tied_lexicon([1, 2, 3, 6, 4, 2], 3, 12, rng)


def assert_fields_equal(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape and x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("phone1", [True, False])
def test_decoder_tables_equal_jax(reps, seed, phone1):
    lex = small_lexicon(seed)
    port, jax = models(phone1=phone1)
    a = port.decoder_tables(lex, state_repetitions=reps)
    b = jax.decoder_tables(jax_lexicon(lex), state_repetitions=reps)
    assert_fields_equal(a, b, ("state_table", "word_len", "last_pos", "first_state",
                               "tdp_within", "entry_pen", "exit_pen", "num_words", "max_pos"))


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_tree_tables_equal_jax(reps, seed):
    lex = small_lexicon(seed)
    # shared prefixes: a word that starts like another
    lex.automata[3].states[:2] = lex.automata[2].states[:2]
    port, jax = models()
    a = port.tree_tables(lex, state_repetitions=reps)
    b = jax.tree_tables(jax_lexicon(lex), state_repetitions=reps)
    assert_fields_equal(a, b, ("state", "parent", "grand", "depth", "tdp", "loop_allowed",
                               "end_word", "exit_penalty", "num_nodes", "num_words",
                               "end_node"))


def test_an4_tables_equal_jax():
    """The AN4-shaped lexicon (130 words, 3 to 30 positions) with the AN4
    config's TDPs: what chip_smoke.py decodes."""
    lex = an4_lexicon(0)
    jax = JTm(**{k: JRow(*(getattr(getattr(AN4_TDP, k), f) for f in
                           ("loop", "forward", "skip", "exit")))
                 for k in ("default", "silence", "entry_m1", "entry_m2", "phone1")},
              scale=AN4_TDP.scale)
    a, b = AN4_TDP.decoder_tables(lex), jax.decoder_tables(jax_lexicon(lex))
    assert_fields_equal(a, b, ("state_table", "word_len", "last_pos", "tdp_within",
                               "entry_pen", "exit_pen"))
    assert a.max_pos == 30 and a.num_words == 131
    assert 9.0 <= a.word_len[1:].mean() <= 11.0


def test_from_config_equals_jax(tmp_path):
    path = tmp_path / "an4.config"
    path.write_text(AN4_TDP_CONFIG)
    port = TransitionModel.from_config(SprintConfig.read(str(path)))
    jax = JTm.from_config(JConfig.read(str(path)))
    assert port == AN4_TDP
    for k in ("default", "silence", "entry_m1", "entry_m2", "phone1"):
        assert getattr(port, k).__dict__ == getattr(jax, k).__dict__, k
    assert port.scale == jax.scale == 1.0


def test_sprint_config_resolution_equals_jax(tmp_path):
    (tmp_path / "inc.config").write_text("[*]\nbase = 7\n")
    (tmp_path / "main.config").write_text(
        "include inc.config\n[*.acoustic-model.tdp]\n*.loop = $(base)\n"
        "recognizer.acoustic-model.tdp.silence.loop = 0.5\n[x.y]\nflag = yes\n")
    port, jax = (C.read(str(tmp_path / "main.config")) for C in (SprintConfig, JConfig))
    for name in ("recognizer.acoustic-model.tdp.silence.loop",
                 "other.acoustic-model.tdp.silence.loop", "a.acoustic-model.tdp.state-0.loop",
                 "x.y.flag", "missing.key"):
        assert port.get(name) == jax.get(name), name
    assert port.get_bool("x.y.flag") and port.get_float("a.acoustic-model.tdp.x.loop") == 7.0
    assert port.items() == jax.items()


@pytest.mark.parametrize("seed", [0, 1])
def test_arpa_scores_equal_jax(tmp_path, seed):
    words = [f"W{i:03d}" for i in range(12)]
    path = tmp_path / "lm.arpa"
    path.write_text(arpa_text(words, seed))
    port, jax = ArpaLM(str(path)), JArpa(str(path))
    assert port.order == jax.order == 2
    vocab = ["<s>"] + words + ["</s>", "<unk>", "NOT-IN-LM"]
    for w in vocab[1:]:
        for h in vocab[:-1]:
            assert port.score_str(w, [h]) == jax.score_str(w, [h]), (w, h)
    assert port.sentence_score(words[:5]) == jax.sentence_score(words[:5])
    np.testing.assert_array_equal(port.score_table([[1], [2]], [3, 4, 5]),
                                  jax.score_table([[1], [2]], [3, 4, 5]))


@pytest.mark.parametrize("tuned", [False, True])
def test_build_lm_matrices_equal_the_root_tool(tmp_path, monkeypatch, tuned):
    sys.path.insert(0, str(REPO / "tools"))
    import an4_system as root_tool
    lex = an4_lexicon(1)
    words = lex.orth[1:]
    (tmp_path / "an4.2.20081121.lm").write_text(arpa_text(words[:-3], 3))  # 3 words <unk>
    monkeypatch.setattr(root_tool, "DATA", str(tmp_path))
    jax = JTm(**{k: JRow(*(getattr(getattr(AN4_TDP, k), f) for f in
                           ("loop", "forward", "skip", "exit")))
                 for k in ("default", "silence", "entry_m1", "entry_m2", "phone1")},
              scale=AN4_TDP.scale)
    args = (6.0, 30.0, 10.0) if tuned else (1.0,)
    want = root_tool.build_lm_matrices(jax_lexicon(lex), jax, *args)
    got = an4_system.build_lm_matrices(lex, AN4_TDP, *args,
                                       arpa_path=str(tmp_path / "an4.2.20081121.lm"))
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)
    lm, lm_start = got
    assert (lm[:, lex.silence_idx] == (10.0 if tuned else 15.0)).all()
