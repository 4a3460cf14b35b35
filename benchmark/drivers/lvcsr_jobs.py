"""Driver of LVCSR decode jobs: the steps ``tools/an4_system.decode`` runs
for ``linear-q8`` after its set-up, a job at a time.

Set-up builds the configuration's model, its int8 quantized scoring pack
(``build_quant_pack``), the float pack ``decode`` builds beside it, the
transition model's tables and the LM's boundary matrices (from a seeded ARPA
file written under the temporary directory), draws the seeded pool of jobs
(features padded on the host as ``Corpus.padded_batch`` pads them, held in
page-locked host memory on a card) and runs every job once (the warm-up). A
step of the window is one job: the host features to the card,
``am_scores_q_chunked`` (kernel O), then ``decode_batch_linear_lvcsr``
(kernels M and N) and the word ids back on the host. The window cycles
through the pool. The check compares, for the jobs drawn from the seed, the
scores of their last run with the plain reference's int8 scores, and the
words of every utterance at each time the window ran them with the plain
reference's words.

``variant="control"`` puts the plain reference's int4 scores where the
program's int8 scores go (``benchmark/controls.py``).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from benchmark.harness import lm as lm_text
from benchmark.harness import core, mixfile, traffic


def draw_pool(cell, seed, device):
    """(plain lexicon, plain model, the pool's corpora)."""
    cfg, mix = cell.config, cell.mix
    model = mixfile.read_model(str(cell.config_dir / cfg["model_file"]), cfg["dim"], cfg["pooling"])
    lex = traffic.lexicon_from_config(cfg["lexicon"], model)
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 62, mix["jobs"])
    return lex, model, [traffic.draw_corpus(int(s), mix, lex, model, device) for s in seeds]


def _padded(corpus, dim):
    """Features padded to the job's longest utterance, and the lengths."""
    lens = corpus.lengths.astype(np.int32)
    T = int(lens.max())
    out = np.zeros((len(lens), T, dim), np.float32)
    for i, L in enumerate(lens):
        out[i, :L] = corpus.features[corpus.offsets[i]:corpus.offsets[i + 1]]
    return out, lens


def transition_model(cfg):
    from speechrecognition_torch.sprint.am import StateTypeTdp, TransitionModel
    t = cfg["tdp"]

    def row(k):
        return StateTypeTdp(*(float(v) for v in t[k]))
    return TransitionModel(default=row("default"), silence=row("silence"),
                           entry_m1=row("entry_m1"), entry_m2=row("entry_m2"),
                           scale=float(t["scale"]), phone1=row("phone1"))


def setup(cell, seed, device, clock, variant="program"):
    cfg, mix = cell.config, cell.mix
    with clock.part("import"):
        from speechrecognition_torch.io import read_mixture_set
        from speechrecognition_torch.lexicon import Lexicon, MarkovAutomaton
        from speechrecognition_torch.models import gmm
        from speechrecognition_torch.models.quantized import build_quant_pack
        from speechrecognition_torch.ops import _native
        from speechrecognition_torch.tools.an4_system import build_lm_matrices
    if device.type == "cuda":
        with clock.part("kernels"):
            _native.load()
    with clock.part("model"):
        raw = read_mixture_set(str(cell.config_dir / cfg["model_file"]), cfg["dim"])
        model = gmm.MixtureModel.from_raw(raw, gmm.VarianceModel.GLOBAL_POOLING,
                                          max_approx=cfg["max_approximation"])
        pmodel = mixfile.read_model(str(cell.config_dir / cfg["model_file"]), cfg["dim"],
                                    cfg["pooling"])
        plex = traffic.lexicon_from_config(cfg["lexicon"], pmodel)
        lex = Lexicon()
        lex.orth = list(plex.orth)
        lex.automata = [MarkovAutomaton(states=s.copy()) for s in plex.states]
        lex.silence = plex.silence
        tm = transition_model(cfg)
        lmc = cfg["lm"]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "lm.arpa")
            with open(path, "w") as f:
                f.write(lm_text.arpa_text(plex.orth[1:], lmc["seed"], lmc["bigram_share"]))
            lm, lm_start = build_lm_matrices(lex, tm, lmc["lm_scale"], lmc["word_exit"],
                                             lmc["sil_exit"], arpa_path=path)
        pack = model.pack(dtype=torch.float32, device=device)
        qp = build_quant_pack(model, preselection=False, device=device)
        tables = tm.decoder_tables(lex)
    with clock.part("traffic"):
        _l, _m, pool = draw_pool(cell, seed, device)
        jobs = [_padded(c, cfg["dim"]) for c in pool]
        host = [torch.from_numpy(f.reshape(-1, cfg["dim"])) for f, _ in jobs]
        if device.type == "cuda":
            host = [h.pin_memory() for h in host]
    scores = None
    if variant == "control":
        ref = cell.reference()

        def scores(_qp, flat):
            return ref.quantized_scores(pmodel, flat, device, bits=4)
    state = {"cell": cell, "seed": seed, "device": device, "pack": pack, "qp": qp,
             "tables": tables, "lm": lm, "lm_start": lm_start, "silence": lex.silence_idx,
             "pool": pool, "jobs": jobs, "host": host, "next": 0, "words": [], "am": {},
             "scores": scores,
             "checked": sorted(np.random.default_rng(seed + 1).choice(
                 len(jobs), mix["checked_jobs"], replace=False).tolist())}
    with clock.part("warm-up"):
        for _ in jobs:
            step(state)
        state["words"] = []
        state["next"] = 0
    return state


def step(state):
    from speechrecognition_torch.models.quantized import am_scores_q_chunked
    from speechrecognition_torch.search.linear_lvcsr import decode_batch_linear_lvcsr
    j = state["next"]
    state["next"] = (j + 1) % len(state["jobs"])
    feats, lens = state["jobs"][j]
    B, T, dim = feats.shape
    qp, cfg = state["qp"], state["cell"].config
    with torch.profiler.record_function("bench.features_to_device"):
        flat = state["host"][j].to(state["pack"].device)
    with torch.profiler.record_function("bench.am_scores_q"):
        am = (state["scores"] or am_scores_q_chunked)(qp, flat).reshape(B, T, qp.num_mixtures)
    if j in state["checked"]:
        state["am"][j] = am
    with torch.profiler.record_function("bench.decode_linear"):
        hyps = decode_batch_linear_lvcsr(state["pack"], feats, lens, state["tables"], state["lm"],
                                         state["lm_start"], cfg["acoustic_pruning"],
                                         state["silence"], prune=True, am=am)
    state["words"].append((j, hyps))
    return {"audio_s": float(lens.sum()) * cfg["frame_seconds"], "utterances": B}


def work(state, records):
    cfg = state["cell"].config
    frames = sum(int(state["jobs"][j][1].sum()) for j, _h in state["words"])
    tables = state["tables"]
    sil = state["silence"]
    wl = [int(n) for w, n in enumerate(tables.word_len) if w != sil]
    return {"frames": frames, "dim": cfg["dim"], "mixtures": cfg["mixtures"],
            "densities": int(state["qp"].active.sum()), "word_len": wl,
            "silence_positions": int(tables.word_len[sil])}


def _score_gap(am, scores, lens, unit) -> float:
    """The widest gap between the program's scores of a job's real frames
    and the reference's, in units of the int8 distance (``unit``)."""
    B, T, S = am.shape
    rows = torch.as_tensor(np.concatenate([b * T + np.arange(L) for b, L in enumerate(lens)]),
                           device=am.device)
    flat = am.reshape(B * T, S)
    gap = torch.zeros((), dtype=torch.float64, device=am.device)
    for i in range(0, len(rows), 1 << 15):
        d = (flat[rows[i:i + (1 << 15)]].double() - scores[i:i + (1 << 15)].double()).abs()
        gap = torch.maximum(gap, d.max())
    return float(gap) / unit


def check(state, records):
    cell = state["cell"]
    ref = cell.reference()
    checked = state["checked"]
    state["pack"] = state["qp"] = state["host"] = None
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()
    path = str(cell.config_dir / cell.config["model_file"])
    model = mixfile.read_model(path, cell.config["dim"], cell.config["pooling"])
    unit = ref.score_unit(model)
    expect, gaps = {}, []
    for j in checked:
        c = state["pool"][j]
        scores = ref.quantized_scores(model, c.features, state["device"])
        gaps.append(_score_gap(state["am"].pop(j), scores, state["jobs"][j][1], unit))
        expect[j] = ref.decode(cell.config, path, c.features, c.offsets, state["device"],
                               scores=scores)
        del scores
    exact = [w == d for j in checked for w, d in zip(expect[j], state["pool"][j].words)]
    core.log(f"lvcsr_jobs: the reference decodes {100 * sum(exact) / len(exact):.2f} % of "
             f"checked utterances as spoken")
    attempted = failed = 0
    for j, hyps in state["words"]:
        if j in expect:
            attempted += len(hyps)
            failed += sum(h != e for h, e in zip(hyps, expect[j]))
    share = failed / attempted if attempted else float("nan")
    return {"word_mismatch_share": share, "score_gap_units": max(gaps)}, attempted, failed
