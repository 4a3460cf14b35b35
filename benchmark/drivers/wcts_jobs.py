"""Driver of the AN4 setup's production decode jobs: the steps
``tools/an4_system.decode(..., dtype_name="q8", prune=True,
lookahead_on=True)`` runs after its set-up, a job at a time.

Set-up builds what ``lvcsr_jobs`` builds (the model, its int8 pack, the
float pack ``decode`` builds beside it, the LM's boundary matrices from the
seeded ARPA file, the seeded pool of jobs in page-locked host memory), with
the transition model's prefix-tree tables (``tree_tables``) and their LM
lookahead (``LookaheadTables.build``) in place of the linear tables, and
runs every job once (the warm-up). A step of the window is one job: the host
features to the card, ``am_scores_q_chunked`` (kernel O), then
``decode_batch_wcts`` with the lookahead, the statistics and transparent
silence (kernel K, the copies to the host and the host traceback). The
window cycles through the pool.

The check compares, for the jobs drawn from the seed, the scores of their
last run with the plain reference's int8 scores, and at each time the
window ran them: every utterance's words, its best path's score (where the
traceback starts, plus the frames' renormalisation offsets; read from kernel
K's outputs by wrapping ``search.wcts.wcts_scan`` while the checked jobs
run) and the live hypotheses of each of its frames (the statistics), each
against the plain reference's.

``variant="control"`` rounds the int8 scores through bfloat16 before the
scan; ``FAULTS["no_lookahead"]`` leaves the lookahead out of the pruning
(``benchmark/controls.py``).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from benchmark.drivers import lvcsr_jobs
from benchmark.harness import core, mixfile, traffic
from benchmark.harness import lm as lm_text


class KeepStarts:
    """``search.wcts.wcts_scan`` as the timed path calls it, keeping each
    utterance's best path score of the checked jobs' runs (on the card,
    with ``start_scores``); the program's own attributes (its launch
    counts) pass through to the function it wraps."""

    def __init__(self, scan, state, start_scores):
        self.__dict__.update(scan=scan, state=state, start_scores=start_scores)

    def __getattr__(self, name):
        return getattr(self.scan, name)

    def __setattr__(self, name, value):
        setattr(self.scan, name, value)

    def __call__(self, am, feat_len, *a, **k):
        carry, outs = self.scan(am, feat_len, *a, **k)
        keep = self.state["keep"]
        if keep is not None:
            # book [T, B, W], offset [T, B], the silence ends [T, B, C]
            keep.append(self.start_scores(outs[0], outs[-2], outs[3], feat_len))
        return carry, outs


def _wrap(state, ref):
    from speechrecognition_torch.search import wcts
    scan = wcts.wcts_scan
    scan = scan.scan if isinstance(scan, KeepStarts) else scan
    wcts.wcts_scan = KeepStarts(scan, state, ref.start_scores)
    return scan


def _unwrap(scan):
    from speechrecognition_torch.search import wcts
    wcts.wcts_scan = scan


def fault_no_lookahead(state):
    """The lookahead left out of the pruning."""
    state["lookahead"] = None


FAULTS = {"no_lookahead": fault_no_lookahead}


def setup(cell, seed, device, clock, variant="program", fault=None):
    cfg, mix = cell.config, cell.mix
    with clock.part("import"):
        from speechrecognition_torch.io import read_mixture_set
        from speechrecognition_torch.lexicon import Lexicon, MarkovAutomaton
        from speechrecognition_torch.models import gmm
        from speechrecognition_torch.models.quantized import build_quant_pack
        from speechrecognition_torch.ops import _native
        from speechrecognition_torch.search.wcts import LookaheadTables
        from speechrecognition_torch.tools.an4_system import build_lm_matrices
    if device.type == "cuda":
        with clock.part("kernels"):
            _native.load()
    with clock.part("model"):
        path = str(cell.config_dir / cfg["model_file"])
        raw = read_mixture_set(path, cfg["dim"])
        model = gmm.MixtureModel.from_raw(raw, gmm.VarianceModel.GLOBAL_POOLING,
                                          max_approx=cfg["max_approximation"])
        pmodel = mixfile.read_model(path, cfg["dim"], cfg["pooling"])
        plex = traffic.lexicon_from_config(cfg["lexicon"], pmodel)
        lex = Lexicon()
        lex.orth = list(plex.orth)
        lex.automata = [MarkovAutomaton(states=s.copy()) for s in plex.states]
        lex.silence = plex.silence
        tm = lvcsr_jobs.transition_model(cfg)
        lmc = cfg["lm"]
        with tempfile.TemporaryDirectory() as tmp:
            arpa = os.path.join(tmp, "lm.arpa")
            with open(arpa, "w") as f:
                f.write(lm_text.arpa_text(plex.orth[1:], lmc["seed"], lmc["bigram_share"]))
            lm, lm_start = build_lm_matrices(lex, tm, lmc["lm_scale"], lmc["word_exit"],
                                             lmc["sil_exit"], arpa_path=arpa)
        pack = model.pack(dtype=torch.float32, device=device)
        qp = build_quant_pack(model, preselection=False, device=device)
        tables = tm.tree_tables(lex)
        lookahead = LookaheadTables.build(tables) if cfg["lookahead"] else None
    with clock.part("traffic"):
        _l, _m, pool = lvcsr_jobs.draw_pool(cell, seed, device)
        jobs = [lvcsr_jobs._padded(c, cfg["dim"]) for c in pool]
        host = [torch.from_numpy(f.reshape(-1, cfg["dim"])) for f, _ in jobs]
        if device.type == "cuda":
            host = [h.pin_memory() for h in host]
    state = {"cell": cell, "seed": seed, "device": device, "pack": pack, "qp": qp,
             "tables": tables, "tm": tm, "lm": lm, "lm_start": lm_start,
             "silence": lex.silence_idx, "lookahead": lookahead,
             "control": variant == "control", "pool": pool, "jobs": jobs, "host": host,
             "next": 0, "runs": [], "am": {}, "keep": None, "frames": 0, "live": 0, "ends": 0,
             "checked": sorted(np.random.default_rng(seed + 1).choice(
                 len(jobs), mix["checked_jobs"], replace=False).tolist())}
    if fault is not None:
        fault(state)
    state["scan"] = _wrap(state, cell.reference())
    with clock.part("warm-up"):
        for _ in jobs:
            step(state)
        state.update(runs=[], next=0, frames=0, live=0, ends=0)
    return state


def step(state):
    from speechrecognition_torch.models.quantized import am_scores_q_chunked
    from speechrecognition_torch.search.wcts import decode_batch_wcts
    j = state["next"]
    state["next"] = (j + 1) % len(state["jobs"])
    feats, lens = state["jobs"][j]
    B, T, dim = feats.shape
    qp, cfg = state["qp"], state["cell"].config
    with torch.profiler.record_function("bench.features_to_device"):
        flat = state["host"][j].to(state["pack"].device)
    with torch.profiler.record_function("bench.am_scores_q"):
        am = am_scores_q_chunked(qp, flat).reshape(B, T, qp.num_mixtures)
        if state["control"]:
            am = am.to(torch.bfloat16).to(torch.float32)
    checked = j in state["checked"]
    if checked:
        state["am"][j] = am
        state["keep"] = []
    with torch.profiler.record_function("bench.decode_wcts"):
        hyps, stats = decode_batch_wcts(
            state["pack"], feats, lens, state["tables"], state["tm"], state["lm"],
            state["lm_start"], cfg["acoustic_pruning"], state["silence"], prune=True,
            lookahead=state["lookahead"], state_limit=cfg["state_limit"], emit_stats=True,
            transparent_silence=cfg["transparent_silence"], am=am)
    state["frames"] += int(lens.sum())
    state["live"] += int(stats["active_states"].sum())
    state["ends"] += int(stats["word_ends"].sum())
    if checked:
        # a copy, so that the program's page-locked block goes back to its cache
        state["runs"].append((j, hyps, state["keep"][0], stats["active_states"].copy()))
        state["keep"] = None
    return {"audio_s": float(lens.sum()) * cfg["frame_seconds"], "utterances": B}


def work(state, records):
    """The window's real frames (kernel O's count) and, summed over them,
    the live hypotheses and live word ends of kernel K's statistics."""
    cfg = state["cell"].config
    return {"frames": state["frames"], "dim": cfg["dim"], "mixtures": cfg["mixtures"],
            "densities": int(state["qp"].active.sum()), "active_states": state["live"],
            "word_ends": state["ends"]}


def _ulps(prog: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap of two score vectors in float32 ULPs of max(|ref|, 1);
    0 where neither has a path, inf where one alone has."""
    none_p, none_r = ~np.isfinite(prog), ~np.isfinite(ref)
    if (none_p != none_r).any():
        return float("inf")
    keep = ~none_r
    if not keep.any():
        return 0.0
    unit = np.spacing(np.maximum(np.abs(ref[keep]), 1.0).astype(np.float32)).astype(np.float64)
    return float((np.abs(prog[keep] - ref[keep]) / unit).max())


def check(state, records):
    cell = state["cell"]
    ref = cell.reference()
    _unwrap(state.pop("scan"))
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
        gaps.append(lvcsr_jobs._score_gap(state["am"].pop(j), scores, state["jobs"][j][1], unit))
        expect[j] = ref.decode(cell.config, path, c.features, c.offsets, state["device"],
                               scores=scores)
        del scores
    exact = [w == d for j in checked for w, d in zip(expect[j][0], state["pool"][j].words)]
    core.log(f"wcts_jobs: the reference decodes {100 * sum(exact) / len(exact):.2f} % of "
             f"checked utterances as spoken")
    attempted = failed = frames = live_off = 0
    ulps = 0.0
    for j, hyps, starts, live in state["runs"]:
        words, ref_starts, ref_live = expect[j]
        attempted += len(hyps)
        failed += sum(h != e for h, e in zip(hyps, words))
        ulps = max(ulps, _ulps(starts.cpu().numpy(), ref_starts))
        for b, r in enumerate(ref_live):
            frames += len(r)
            live_off += int((live[:len(r), b] != r).sum())
    share = failed / attempted if attempted else float("nan")
    return ({"word_mismatch_share": share, "score_gap_units": max(gaps),
             "final_score_ulps": ulps if attempted else float("nan"),
             "active_states_mismatch_share": live_off / frames if frames else float("nan")},
            attempted, failed)
