"""Driver of EM training: ``Trainer`` iterations over a seeded corpus, each
as the trainer's split round runs a realign-and-estimate step without a
split: the realignment (kernels C, F, G), the E-step (kernel H), the M-step
on the host and the AM score (kernel H).

Set-up builds the configuration's model (the trained model file), the
trainer, the corpus's segment automata and one iteration (the warm-up: the
first realignment, every alignment bucket's shape). A step of the window is
one iteration (``Trainer._split_round`` at round 0 with one alignment and one
estimate). The check reads the first ``checked_iterations`` iterations of
the window, the ones the plain reference follows from the model file: their
alignments, the first one's statistics, the change of the model over them,
and their AM scores.

``variant="control"`` trains with the program's float32 path; ``fault``
plants a fault under the timed path (``controls.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import core, mixfile, traffic


def _params(model, S, D, dim):
    """The model's (means, variances, log-weights) in [S, D] slots (NaN where
    a mixture has fewer densities)."""
    means = np.full((S, D, dim), np.nan)
    var = np.full((S, D, dim), np.nan)
    logw = np.full((S, D), np.nan)
    for s, dens in enumerate(model.mixtures):
        for d, (mi, vi) in enumerate(dens):
            means[s, d], var[s, d], logw[s, d] = model.means[mi], model.vars[vi], \
                model.mean_weights_log[mi]
    return means, var, logw


def setup(cell, seed, device, clock, variant="program", fault=None):
    cfg, mix = cell.config, cell.mix
    with clock.part("import"):
        from speechrecognition_torch.align.viterbi import AlignerTables
        from speechrecognition_torch.corpus import Corpus
        from speechrecognition_torch.io import read_mixture_set
        from speechrecognition_torch.lexicon import Lexicon, build_segment_automaton
        from speechrecognition_torch.models import gmm
        from speechrecognition_torch.ops import _native
        from speechrecognition_torch.tdp import TdpModel
        from speechrecognition_torch.train.em import Trainer, TrainerConfig
    if device.type == "cuda":
        with clock.part("kernels"):
            _native.load()
    with clock.part("model"):
        raw = read_mixture_set(str(cell.config_dir / cfg["model_file"]), cfg["dim"])
        model = gmm.MixtureModel.from_raw(raw, gmm.VarianceModel.NO_POOLING,
                                          max_approx=cfg["max_approximation"])
        lex = Lexicon()
        spec = cfg["lexicon"]
        for i, (orth, n, reps) in enumerate(spec["words"]):
            lex.add_word(orth, n, reps, silence=(i == spec["silence"]))
        tdp = TdpModel(silence_state=lex.silence_state, **cfg["tdp"])
        tcfg = TrainerConfig(min_obs=1, num_splits=0, num_aligns=1, num_estimates=1,
                             pruning_threshold=cfg["train_pruning_threshold"],
                             batch_size=mix["align_batch"])
        dtype = torch.float32 if variant == "control" else cfg["precision"]
        trainer = Trainer(tcfg, lex, model, tdp, dtype=dtype, log=lambda *a: None,
                          device=device)
    with clock.part("traffic"):
        pmodel = mixfile.read_model(str(cell.config_dir / cfg["model_file"]), cfg["dim"],
                                    cfg["pooling"])
        plex = traffic.lexicon_from_config(cfg["lexicon"], pmodel)
        drawn = traffic.draw_corpus(seed, mix, plex, pmodel, device)
        n = mix["utterances"]
        corpus = Corpus(features=drawn.features, feature_offsets=drawn.offsets,
                        orths=drawn.words, names=[f"utt-{i:05d}" for i in range(n)],
                        frame_duration=cfg["frame_seconds"], dim=cfg["dim"])
        automata = [build_segment_automaton(lex, orth) for orth in corpus.orths]
        tables = AlignerTables.build(automata, tdp)
    state = {"cell": cell, "device": device, "trainer": trainer, "corpus": corpus,
             "drawn": drawn, "tables": tables,
             "alignment": np.zeros(corpus.total_frames, np.int32),
             "record": None, "checked": [], "phases": [],
             "S": cfg["mixtures"], "D": model.max_densities_per_mixture}
    # what the check reads: each checked iteration's statistics, AM score
    # and alignment, and the model after it
    orig_apply = model.apply_statistics
    orig_score = trainer.calc_am_score

    def apply(w, xs, x2s):
        if state["record"] is not None and "stats" not in state["record"]:
            state["record"]["stats"] = (w.copy(), xs.copy(), x2s.copy())
        return orig_apply(w, xs, x2s)

    def score(corpus_, alignment):
        s = orig_score(corpus_, alignment)
        if state["record"] is not None:
            state["record"]["score"] = s
        return s
    model.apply_statistics = apply
    trainer.calc_am_score = score
    if fault is not None:
        fault(state)
    with clock.part("warm-up"):
        step(state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        state["phases"] = []
    state["start"] = _params(trainer.model, state["S"], state["D"], cfg["dim"])
    return state


def step(state):
    tr, corpus = state["trainer"], state["corpus"]
    cell = state["cell"]
    record = len(state["checked"]) < cell.mix["checked_iterations"] and "start" in state
    state["record"] = {} if record else None
    before = dict(tr.phase_seconds)
    tr._split_round(corpus, state["tables"], state["alignment"], 0)
    state["phases"].append({k: tr.phase_seconds[k] - before[k] for k in before})
    if record:
        rec = state["record"]
        rec["alignment"] = state["alignment"].copy()
        rec["params"] = _params(tr.model, state["S"], state["D"], cell.config["dim"])
        state["checked"].append(rec)
    state["record"] = None
    return {"audio_s": corpus.total_audio_seconds, "utterances": corpus.num_segments}


def work(state, records):
    """Real frames and automaton cells of the window's iterations."""
    corpus, tables = state["corpus"], state["tables"]
    it = len(records)
    lens = corpus.lengths
    return {"frames": corpus.total_frames * it, "dim": state["cell"].config["dim"],
            "mixtures": state["S"], "densities": int(state["trainer"].model.num_densities()),
            "align_cells": int((lens * tables.lengths).sum()) * it,
            "estep_rows": 2 * corpus.total_frames * it, "estep_densities": state["D"],
            "phase_seconds": state["phases"]}


def _leaf_gap(prog, ref, floor_share=None):
    """The worst leaf's gap of norms, |‖p‖ − ‖r‖|, against the larger of the
    reference leaf's norm and the median leaf's; leaves are the rows of the
    arrays' first axis (a mixture). With ``floor_share``, leaves whose
    reference norm is under that share of the median are left out."""
    worst = 0.0
    for p, r in zip(prog, ref):
        p = np.nan_to_num(p.reshape(p.shape[0], -1), nan=0.0, posinf=0.0, neginf=0.0)
        r = np.nan_to_num(r.reshape(r.shape[0], -1), nan=0.0, posinf=0.0, neginf=0.0)
        np_, nr = np.linalg.norm(p, axis=1), np.linalg.norm(r, axis=1)
        med = float(np.median(nr))
        den = np.maximum(nr, med)
        keep = (nr >= (floor_share * med if floor_share else 0.0)) & (den > 0)
        if keep.any():
            worst = max(worst, float((np.abs(np_ - nr)[keep] / den[keep]).max()))
    return worst


def check(state, records):
    cell, drawn = state["cell"], state["drawn"]
    checked = state["checked"]
    k = cell.mix["checked_iterations"]
    state["trainer"] = None
    if "restore" in state:
        setattr(*state.pop("restore"))
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.reference()
    steps = ref.train(cell.config, str(cell.config_dir / cell.config["model_file"]),
                      drawn.features, drawn.offsets, drawn.words, state["device"], 1 + k)
    nan = float("nan")
    if len(checked) < k or any(len(c) != 4 for c in checked):
        return {"am_score_gap": nan, "alignment_mismatch_share": nan, "stats_gap": nan,
                "change_gap": nan}, 0, 0
    start, window = steps[0], steps[1:]
    score_gap = max(abs(c["score"] - r["score"]) / abs(r["score"])
                    for c, r in zip(checked, window))
    mismatch = [int((c["alignment"] != r["alignment"]).sum()) for c, r in zip(checked, window)]
    stats_gap = _leaf_gap(checked[0]["stats"], window[0]["stats"])
    with np.errstate(invalid="ignore"):
        delta_p = [a - b for a, b in zip(checked[-1]["params"], state["start"])]
        delta_r = [a - b for a, b in zip(window[-1]["params"], start["params"])]
    change_gap = _leaf_gap(delta_p, delta_r, floor_share=1e-3)
    core.log(f"em_train: AM scores {[c['score'] for c in checked]} against "
             f"{[r['score'] for r in window]}; frames aligned differently {mismatch}")
    frames = len(drawn.features)
    return ({"am_score_gap": score_gap, "alignment_mismatch_share": max(mismatch) / frames,
             "stats_gap": stats_gap, "change_gap": change_gap},
            k * frames, sum(mismatch))


def fault_half_batch(state):
    """The E-step leaves out every second frame of its blocks and takes its
    sums over the rest."""
    from speechrecognition_torch.train import em
    orig = em.em_pass_sorted

    def em_pass(pack, frames, mask, block_state, first_pass=False):
        half = mask.clone()
        half[:, 1::2] = 0
        return orig(pack, frames, half, block_state, first_pass=first_pass)
    state["restore"] = (em, "em_pass_sorted", orig)
    em.em_pass_sorted = em_pass


def fault_altered_state(state):
    """One frame's aligned state is altered where the realignment produces
    it (the first frame of the first utterance of every batch)."""
    from speechrecognition_torch.train import em
    orig = em.realign_batch

    def realign(*a, **k):
        states = orig(*a, **k)
        states[0, 0] = (states[0, 0] + 1) % state["S"]
        return states
    state["restore"] = (em, "realign_batch", orig)
    em.realign_batch = realign


FAULTS = {"half_batch": fault_half_batch, "altered_state": fault_altered_state}
