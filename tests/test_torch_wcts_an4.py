"""The port's word-conditioned tree search at the AN4 setup's shape against
the benchmark's plain reference (benchmark/configs/an4-wcts/reference.py) on
the CPU, where ``wcts_scan`` takes its plain version.

On seeded tied lexica of 20 words over 60 classes (the cell's lexicon kind,
TDPs, LM kind and scales), 6 utterances of 40-90 frames, lookahead and
transparent silence on: ``decode_batch_wcts`` gives the reference's words,
best path scores (where the traceback starts plus the frames' offsets) and
live hypotheses a frame. On the cell's own lexicon the reference's tree and
its tables equal ``TransitionModel.tree_tables``'s (1,416 nodes). Without
the lookahead in the pruning (the cell's ``no_lookahead`` fault) the words
of at least one utterance change on a seed where they are known to.
"""

import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.drivers import lvcsr_jobs  # noqa: E402
from benchmark.harness import core, mixfile, traffic  # noqa: E402
from benchmark.harness import lm as lm_text  # noqa: E402
from speechrecognition_torch.lexicon import Lexicon, MarkovAutomaton  # noqa: E402
from speechrecognition_torch.search import wcts  # noqa: E402
from speechrecognition_torch.tools.an4_system import build_lm_matrices  # noqa: E402

torch.set_num_threads(1)

CDIR = ROOT / "benchmark" / "configs" / "an4-wcts"
REF = core.load_module(CDIR / "reference.py", "ref_an4_wcts_tests")
CFG = json.loads((CDIR / "config.json").read_text())
CLASSES, WORDS, UTTERANCES = 60, 20, 6
#: both sides add, subtract, compare and select the same float32 values in
#: the same order (and sum the offsets with the same function): equal
SCORE_ULPS = 0.0


def port_lexicon(plex):
    lex = Lexicon()
    lex.orth = list(plex.orth)
    lex.automata = [MarkovAutomaton(states=s.copy()) for s in plex.states]
    lex.silence = plex.silence
    return lex


def port_lm(plex, lex, tm, tmp_path):
    lmc = CFG["lm"]
    path = tmp_path / "lm.arpa"
    path.write_text(lm_text.arpa_text(plex.orth[1:], lmc["seed"], lmc["bigram_share"]))
    return build_lm_matrices(lex, tm, lmc["lm_scale"], lmc["word_exit"], lmc["sil_exit"],
                             arpa_path=str(path))


def small_case(seed):
    """A tied lexicon of WORDS words over CLASSES classes, and UTTERANCES
    utterances' scores [B, T, S] float32 along seeded word strings: the
    spoken state's score low, the others higher."""
    spec = dict(CFG["lexicon"], seed=seed, num_words=WORDS, num_classes=CLASSES)
    plex = traffic.lexicon_from_config(spec, SimpleNamespace(active=np.ones((CLASSES, 1), bool)))
    rng = np.random.default_rng(seed)
    lens = rng.integers(40, 91, UTTERANCES).astype(np.int32)
    T = int(lens.max())
    am = rng.uniform(6.0, 14.0, (UTTERANCES, T, CLASSES)).astype(np.float32)
    sil = plex.states[plex.silence]
    for b, L in enumerate(lens):
        path = list(sil)
        while len(path) < L:
            path += list(plex.states[int(rng.integers(1, plex.num_words))])
            if rng.uniform() < 0.3:
                path += list(sil)
        states = np.repeat(path, rng.integers(1, 4, len(path)))[:L]
        am[b, np.arange(len(states)), states] = rng.uniform(0.0, 2.0, len(states))
    return plex, torch.as_tensor(am), lens


def port_decode(monkeypatch, tmp_path, plex, am, lens, thr, lookahead=True):
    """(words, best path scores, live hypotheses [T, B]) of the port's
    ``decode_batch_wcts``; the scores read from kernel K's outputs as the
    cell's driver reads them."""
    lex = port_lexicon(plex)
    tm = lvcsr_jobs.transition_model(CFG)
    lm, lm_start = port_lm(plex, lex, tm, tmp_path)
    tables = tm.tree_tables(lex)
    starts = []
    scan = wcts.wcts_scan

    def keep(am_, feat_len, *a, **k):
        carry, outs = scan(am_, feat_len, *a, **k)
        starts.append(REF.start_scores(outs[0], outs[-2], outs[3], feat_len))
        return carry, outs
    monkeypatch.setattr(wcts, "wcts_scan", keep)
    B, T, _ = am.shape
    hyps, stats = wcts.decode_batch_wcts(
        None, np.zeros((B, T, 1), np.float32), lens, tables, tm, lm, lm_start, thr,
        lex.silence_idx, prune=True,
        lookahead=wcts.LookaheadTables.build(tables) if lookahead else None,
        emit_stats=True, transparent_silence=True, am=am)
    return hyps, starts[0].numpy(), stats["active_states"]


def reference_decode(plex, am, lens, thr):
    tb = REF.build_tables(plex, CFG["tdp"], REF.lm_ext_of(CFG, plex))
    o = REF.scan(am, torch.as_tensor(lens), tb, thr)
    starts = REF.start_scores(o["book"], o["silp"], o["offset"], lens).numpy()
    host = {k: v.numpy() for k, v in o.items()}
    return REF.traceback(host, lens, tb), starts, host["live"]


@pytest.mark.parametrize("seed", [3, 11, 2 ** 31 + 7])
@pytest.mark.parametrize("thr", [200.0, 60.0])
def test_port_equals_the_reference(monkeypatch, tmp_path, seed, thr):
    plex, am, lens = small_case(seed)
    words, starts, live = port_decode(monkeypatch, tmp_path, plex, am, lens, thr)
    ref_words, ref_starts, ref_live = reference_decode(plex, am, lens, thr)
    assert words == ref_words
    assert sum(map(len, words)) >= UTTERANCES
    assert np.isfinite(ref_starts).all()
    unit = np.spacing(np.maximum(np.abs(ref_starts), 1.0).astype(np.float32))
    assert (np.abs(starts - ref_starts) / unit).max() <= SCORE_ULPS
    for b, L in enumerate(lens):
        assert np.array_equal(live[:L, b], ref_live[:L, b])


def test_reference_tree_is_the_cells_tree():
    """On the cell's own lexicon: the reference's tree has tree_tables's
    1,416 nodes, in the same order, with the same costs, entries and
    lookahead."""
    model = mixfile.read_model(str(CDIR / CFG["model_file"]), CFG["dim"], CFG["pooling"])
    plex = traffic.lexicon_from_config(CFG["lexicon"], model)
    lex = port_lexicon(plex)
    tm = lvcsr_jobs.transition_model(CFG)
    tables = tm.tree_tables(lex)
    lm_ext = REF.lm_ext_of(CFG, plex)
    tb = REF.build_tables(plex, CFG["tdp"], lm_ext)
    assert tb.num_nodes == tables.num_nodes == CFG["tree_nodes"] == 1416
    assert lm_ext.shape[0] == CFG["contexts"] == 132
    for mine, port in ((tb.state, tables.state), (tb.parent, tables.parent),
                       (tb.grand, tables.grand), (tb.depth, tables.depth),
                       (tb.end_node, tables.end_node)):
        assert np.array_equal(mine, port)
    entry_state, entry_pen = wcts.build_entry_tables(tables, tm)
    assert np.array_equal(entry_state, tables.state)
    la = wcts.LookaheadTables.build(tables).scores(lm_ext)
    for mine, port in ((tb.tdp, tables.tdp), (tb.entry_pen, entry_pen), (tb.la, la)):
        assert np.array_equal(mine.astype(np.float32), port.astype(np.float32))


def test_no_lookahead_changes_words(monkeypatch, tmp_path):
    """The cell's ``no_lookahead`` fault: pruned without the lookahead, the
    port's words differ from the reference's on at least one utterance of
    this seed at a beam of 40 (and the live hypotheses on most frames)."""
    plex, am, lens = small_case(5)
    ref_words, _r, ref_live = reference_decode(plex, am, lens, 40.0)
    assert port_decode(monkeypatch, tmp_path, plex, am, lens, 40.0)[0] == ref_words
    words, _s, live = port_decode(monkeypatch, tmp_path, plex, am, lens, 40.0, lookahead=False)
    assert sum(w != r for w, r in zip(words, ref_words)) >= 1
    differ = sum(int((live[:L, b] != ref_live[:L, b]).sum()) for b, L in enumerate(lens))
    assert differ > lens.sum() / 2


def test_host_copies_of_cpu_tensors_are_the_tensors():
    outs = [torch.arange(6.0).reshape(2, 3), torch.tensor([True, False])]
    assert all(h is o for h, o in zip(wcts.host_copies(outs), outs))


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, {root!r});"
            "from benchmark.harness import core;"
            "core.load_module(core.BENCH / 'configs' / 'an4-wcts' / 'reference.py');"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(root=str(ROOT))
    import subprocess
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not mods & {"jax", "jaxlib", "flax", "speechrecognition_tpu",
                       "speechrecognition_torch"}
