"""The port's spans and counters (speechrecognition_torch/tracing.py) on the
CPU: off unless a ``torch.profiler`` records, then named ranges in the
exported chrome trace, nested as the LVCSR decode, the WCTS decode, the EM
trainer and the corpus decode call their steps, and counters of real and
padded frames."""

import gc
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from speechrecognition_torch import tracing
from speechrecognition_torch.models.quantized import am_scores_q_chunked, build_quant_pack
from speechrecognition_torch.search import linear_lvcsr as tl
from speechrecognition_torch.search import wcts as tw

from torch_linear_tables import (AN4_TDP, linear_case, pooled_model, pooled_raw, random_lm,
                                 tied_lexicon)

torch.set_num_threads(1)

LVCSR_NESTING = {
    "lvcsr.tables": "lvcsr.decode", "lvcsr.tables_to_device": "lvcsr.decode",
    "lvcsr.scan": "lvcsr.decode",
    "lvcsr.traceback": "lvcsr.decode", "lvcsr.words_to_host": "lvcsr.decode",
    "lvcsr.results": "lvcsr.decode",
}
WCTS_NESTING = {
    "wcts.tables": "wcts.decode", "wcts.tables_to_device": "wcts.decode",
    "wcts.scan": "wcts.decode", "wcts.to_host": "wcts.decode", "wcts.traceback": "wcts.decode",
}
EM_NESTING = {
    "em.realign": "em.round", "em.estimate": "em.round", "em.score": "em.round",
    "em.realign.index": "em.realign", "em.realign.batch": "em.realign",
    "em.realign.states_to_host": "em.realign", "em.realign.scatter": "em.realign",
    "em.sorted_blocks": "em.estimate", "em.gather": "em.estimate",
    "em.mstep": "em.estimate", "em.pack": ("em.realign", "em.estimate", "em.score"),
    "em.estep": ("em.estimate", "em.score"), "em.stats_to_host": ("em.estimate", "em.score"),
}
DECODE_NESTING = {
    "decode.gather": "decode.corpus", "decode.batch": "decode.corpus",
    "decode.wer": "decode.corpus", "decode.scores": "decode.batch",
    "decode.scan": "decode.batch", "decode.to_host": "decode.batch",
    "decode.traceback": "decode.batch",
}


def lvcsr_decode(scores="q8"):
    """A tiny int8-scored linear decode as the AN4 job runs it: scores in
    chunks (one ``torch.cat``), then the scan, traceback and word lists.
    With ``scores="case"`` the case's own scores, which decode to words."""
    lex, tm, lm, lm_start, am, lens, thr = linear_case("silence-1")
    B, T, S = am.shape
    rng = np.random.default_rng(3)
    qp = build_quant_pack(pooled_model(pooled_raw(rng, S, 3, 4)), device="cpu")
    feats = rng.normal(0.0, 2.0, (B, T, 4)).astype(np.float32)
    if scores == "q8":
        am = am_scores_q_chunked(qp, torch.as_tensor(feats.reshape(B * T, 4)), chunk=16)
    words = tl.decode_batch_linear_lvcsr(None, feats, lens, tm.decoder_tables(lex), lm,
                                         lm_start, thr, 0, am=torch.as_tensor(am).reshape(B, T, S))
    return words, int(lens.sum()), B * T


def wcts_decode(stats=True):
    """A tiny WCTS decode as the AN4 cell runs it (lookahead, transparent
    silence, the statistics when ``stats``): (words, stats or None, lengths,
    B × T)."""
    rng = np.random.default_rng(5)
    lex = tied_lexicon([3, 6, 9, 3, 6], 3, 12, rng, own_silence=True)
    lm, lm_start = random_lm(rng, lex.num_words, 0, 2.0)
    tables = AN4_TDP.tree_tables(lex)
    lens = np.array([30, 22, 27], np.int32)
    B, T = len(lens), int(lens.max())
    am = torch.as_tensor(rng.uniform(0.0, 10.0, (B, T, 12)).astype(np.float32))
    out = tw.decode_batch_wcts(None, np.zeros((B, T, 1), np.float32), lens, tables, AN4_TDP, lm,
                               lm_start, 200.0, 0, lookahead=tw.LookaheadTables.build(tables),
                               emit_stats=stats, transparent_silence=True, am=am)
    words, st = out if stats else (out, None)
    return words, st, lens, B * T


FIX = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="module")
def demo():
    """The SieTill lexicon, the demo corpus and the TDPs of the demo recipe."""
    from speechrecognition_torch import corpus as corpus_mod
    from speechrecognition_torch.features import frontend
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.tdp import TdpModel
    lex = build_sietill_lexicon()
    desc = corpus_mod.CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = corpus_mod.Corpus.read(desc, str(FIX / "demo_features") + "/",
                                    frontend.SignalAnalysisConfig(),
                                    normalization_path=str(FIX / "normalization-demo.bin"))
    return lex, corpus, TdpModel(silence_state=lex.silence_state, loop=20.0, forward=0.0,
                                 skip=20.0)


@pytest.fixture(scope="module")
def demo_trainer(demo):
    """The float64 trainer after one realign-and-estimate round on the demo
    corpus: (trainer, corpus, aligner tables, alignment)."""
    from speechrecognition_torch.align.viterbi import AlignerTables
    from speechrecognition_torch.lexicon import build_segment_automaton
    from speechrecognition_torch.models.gmm import MixtureModel, VarianceModel
    from speechrecognition_torch.train.em import Trainer, TrainerConfig
    lex, corpus, tdp = demo
    model = MixtureModel(dim=25, num_mixtures=lex.num_states,
                         var_model=VarianceModel.MIXTURE_POOLING)
    cfg = TrainerConfig(min_obs=1, num_splits=0, num_aligns=1, num_estimates=1,
                        pruning_threshold=120.0, batch_size=16)
    trainer = Trainer(cfg, lex, model, tdp, dtype=torch.float64, log=lambda *a: None, device="cpu")
    alignment = trainer.train(corpus)
    tables = AlignerTables.build([build_segment_automaton(lex, o) for o in corpus.orths], tdp)
    return trainer, corpus, tables, alignment


def traced(fn, tmp_path):
    """fn()'s result, and the user annotations of its chrome trace by name,
    with the counters it counted."""
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault(e["name"], []).append((float(e["ts"]), float(e["ts"]) + e["dur"]))
    counts = tracing.counters()
    tracing.reset()
    return out, spans, counts


def assert_nested(spans, nesting):
    """Each span of a child name lies inside a span of one of its parents."""
    for child, parents in nesting.items():
        parents = parents if isinstance(parents, tuple) else (parents,)
        assert child in spans and all(p in spans for p in parents), (child, sorted(spans))
        for a, b in spans[child]:
            assert any(pa <= a and b <= pb for p in parents for pa, pb in spans[p]), child


@pytest.fixture
def counted_record_function(monkeypatch):
    """How many times ``torch.profiler.record_function`` was entered."""
    entered = []
    real = torch.profiler.record_function

    class Counted(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()
    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    return entered


def test_off_enters_no_record_function(counted_record_function):
    tracing.reset()
    assert not tracing.enabled()
    with tracing.span("x"):
        tracing.count("x.frames", 5)
    gc.collect()
    assert counted_record_function == []
    assert tracing.counters() == {}


def test_off_the_lvcsr_decode_and_a_round_enter_no_record_function(counted_record_function,
                                                                   demo_trainer):
    tracing.reset()
    lvcsr_decode()
    wcts_decode()
    trainer, corpus, tables, alignment = demo_trainer
    trainer._split_round(corpus, tables, alignment.copy(), 0)
    assert counted_record_function == []
    assert tracing.counters() == {}


def test_span_feeds_its_dict_whether_on_or_off(tmp_path):
    seconds = {"phase": 0.0}
    with tracing.span("x", seconds, "phase"):
        sum(range(1000))
    off = seconds["phase"]
    assert off > 0.0

    def on():
        with tracing.span("x", seconds, "phase"):
            sum(range(1000))
    _, spans, _ = traced(on, tmp_path)
    assert "x" in spans and seconds["phase"] > off


def test_span_as_a_decorator_spans_each_call(counted_record_function, tmp_path):
    @tracing.span("y")
    def twice(a, b=1):
        """Twice the sum."""
        return 2 * (a + b)

    assert twice.__name__ == "twice" and twice.__doc__ == "Twice the sum."
    assert twice(3, b=2) == 10 and counted_record_function == []

    def on():
        return twice(1), twice(2)
    out, spans, _ = traced(on, tmp_path)
    assert out == (4, 6) and len(spans["y"]) == 2 and counted_record_function.count("y") == 2


def test_lvcsr_spans_nest_and_count_frames(tmp_path):
    (words, real, padded), spans, counts = traced(lvcsr_decode, tmp_path)
    assert_nested(spans, LVCSR_NESTING)
    assert len(spans["lvcsr.decode"]) == 1 and len(spans["quantized.scores"]) == 1
    assert counts["lvcsr.frames_real"] == real <= counts["lvcsr.frames_padded"] == padded
    assert words == lvcsr_decode()[0]


def test_em_round_spans_nest_count_frames_and_feed_phase_seconds(demo_trainer, tmp_path):
    trainer, corpus, tables, alignment = demo_trainer
    assert set(trainer.phase_seconds) == {"estimate", "align", "score"}
    before = dict(trainer.phase_seconds)
    _, spans, counts = traced(
        lambda: trainer._split_round(corpus, tables, alignment.copy(), 0), tmp_path)
    assert_nested(spans, EM_NESTING)
    assert len(spans["em.round"]) == 1 and len(spans["em.sorted_blocks"]) == 1
    assert len(spans["em.realign.batch"]) == -(-corpus.num_segments // 16)
    assert counts["align.frames_real"] == corpus.total_frames
    assert counts["align.frames_real"] <= counts["align.frames_padded"]
    for key in before:
        assert trainer.phase_seconds[key] > before[key], key
    took = {k: trainer.phase_seconds[k] - before[k] for k in before}
    for key, name in (("align", "em.realign"), ("score", "em.score")):
        (a, b), = spans[name]
        assert took[key] == pytest.approx((b - a) * 1e-6, rel=0.2, abs=2e-3), key


def test_corpus_decode_spans_nest_and_count_frames(demo, tmp_path):
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.io import read_mixture_set
    from speechrecognition_torch.models.gmm import MixtureModel, VarianceModel
    from speechrecognition_torch.search.decoder import Recognizer
    lex, corpus, tdp = demo
    model = MixtureModel.from_raw(read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                  VarianceModel.MIXTURE_POOLING, max_approx=True)
    rec = Recognizer(Configuration({"am-threshold": 200.0, "word-penalty": 80.0}), lex, tdp,
                     model.pack_df(device="cpu"), dtype="df32")
    res, spans, counts = traced(
        lambda: rec.recognize_corpus(corpus, batch_size=4, max_segments=3), tmp_path)
    assert_nested(spans, DECODE_NESTING)
    assert "rtf_steady" not in res and res["num_decoded"] == 3 and res["time"] > 0
    assert counts["decode.frames_real"] == int(corpus.lengths[:3].sum())
    assert counts["decode.frames_real"] <= counts["decode.frames_padded"]


def test_a_collection_inside_a_profile_is_a_span(tmp_path):
    _, spans, counts = traced(gc.collect, tmp_path)
    assert len(spans["host.gc"]) >= 1 and counts["host.gc_collections"] >= 1


@pytest.mark.parametrize("scores", ["q8", "case"])
def test_lvcsr_decode_counts_the_words_it_hands_back(scores, tmp_path):
    (words, _, _), _, counts = traced(lambda: lvcsr_decode(scores), tmp_path)
    assert counts["lvcsr.words_out"] == sum(map(len, words))
    if scores == "case":
        assert counts["lvcsr.words_out"] > 0
    tracing.reset()
    assert lvcsr_decode(scores)[0] == words and "lvcsr.words_out" not in tracing.counters()


@pytest.mark.parametrize("stats", [True, False])
def test_wcts_spans_nest_and_count(stats, tmp_path):
    (words, st, lens, padded), spans, counts = traced(lambda: wcts_decode(stats), tmp_path)
    assert_nested(spans, WCTS_NESTING)
    assert all(len(spans[n]) == 1 for n in WCTS_NESTING) and len(spans["wcts.decode"]) == 1
    assert counts["wcts.frames_real"] == int(lens.sum()) < counts["wcts.frames_padded"] == padded
    assert counts["wcts.words_out"] == sum(map(len, words)) > 0
    if stats:
        assert counts["wcts.active_states"] == int(st["active_states"].sum()) > 0
        assert counts["wcts.word_ends"] == int(st["word_ends"].sum()) > 0
    else:
        assert "wcts.active_states" not in counts and "wcts.word_ends" not in counts
    tracing.reset()
    assert wcts_decode(stats)[0] == words and tracing.counters() == {}
