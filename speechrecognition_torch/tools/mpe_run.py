"""Discriminative training (MPE) on SieTill — counterpart of the
repository's tools/mpe_run.py, with the corpora, features and model as
arguments and the card as the default device.

Starts from an ML model (by default bench/model.mix with its
bench/model.mix.json settings) and runs MPE iterations over the training
corpus: denominator word lattices from the zerogram word-loop decode,
approximate-accuracy payloads against the ML forced alignment,
accuracy-weighted forward-backward (gamma^MPE), sign-split EBW update with
I-smoothing (train/mpe.py; reference machinery:
Mm/EbwDiscriminativeMixtureSetEstimator.cc, Speech/AccuracyFsaBuilder.cc,
Lattice/Accuracy.cc:351-369). After each iteration a test corpus (if
given) and a held-out part of the training corpus (``--holdout``) are
decoded with the df32 recognizer.

Usage:
  python -m speechrecognition_torch.tools.mpe_run --train-corpus C \\
      --features F --normalization N --out DIR [--test-corpus T] \\
      [--iters 2] [--max-segments N] [--e 2.0] [--tau 50] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(f"[mpe {time.strftime('%H:%M:%S')}]", *a, file=sys.stderr, flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-corpus", required=True, help="SieTill training corpus JSON")
    ap.add_argument("--test-corpus", default=None, help="SieTill test corpus JSON")
    ap.add_argument("--features", required=True, help="feature directory (ends with /)")
    ap.add_argument("--normalization", required=True, help="normalization .bin")
    ap.add_argument("--model", default=os.path.join(REPO, "bench", "model.mix"))
    ap.add_argument("--meta", default=os.path.join(REPO, "bench", "model.mix.json"),
                    help="the model's pooling, tdp, word_penalty and am_threshold")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--max-segments", type=int, default=0,
                    help="train-corpus subset (0 = all)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--e", type=float, default=2.0)
    ap.add_argument("--tau", type=float, default=50.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--posterior-threshold", type=float, default=5.0)
    ap.add_argument("--decode-batch", type=int, default=512,
                    help="the test and held-out decodes' batch")
    ap.add_argument("--skip-test-decode", action="store_true")
    ap.add_argument("--holdout", type=int, default=0,
                    help="hold out the LAST N train segments from MPE training and "
                         "decode them each iteration (iteration selection from "
                         "held-out train WER instead of the test corpus)")
    ap.add_argument("--init-model", default=None,
                    help="resume from a saved mpe-<k>.mix instead of the ML model "
                         "(the alignment stays the ML alignment)")
    ap.add_argument("--start-iter", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import torch

    from ..align.viterbi import AlignerTables
    from ..config import Configuration
    from ..corpus import Corpus, CorpusDescription
    from ..features.frontend import SignalAnalysisConfig
    from ..io import read_mixture_set, write_mixture_set
    from ..lexicon import build_segment_automaton, build_sietill_lexicon
    from ..models.gmm import MixtureModel, VarianceModel
    from ..search.decoder import Recognizer
    from ..tdp import TdpModel
    from ..train.ebw import EbwConfig
    from ..train.em import Trainer, TrainerConfig
    from ..train.mpe import MpeTrainer
    from .partition import subset_corpus

    device = torch.device(args.device)
    log(f"device: {device}")
    lex = build_sietill_lexicon()
    train_desc = CorpusDescription.read(args.train_corpus, lex)
    corpus = Corpus.read(train_desc, args.features, SignalAnalysisConfig(),
                         normalization_path=args.normalization)
    if args.max_segments:
        corpus = subset_corpus(corpus, list(range(args.max_segments)))
    holdout_corpus = None
    if args.holdout:
        n = corpus.num_segments
        holdout_corpus = subset_corpus(corpus, list(range(n - args.holdout, n)))
        corpus = subset_corpus(corpus, list(range(n - args.holdout)))
        log(f"holding out the last {args.holdout} train segments for iteration selection")
    log(f"train corpus: {corpus.num_segments} segments, {corpus.total_frames} frames")

    with open(args.meta) as f:
        meta = json.load(f)
    pooling = VarianceModel.from_string(meta.get("pooling", "none"))
    model = MixtureModel.from_raw(read_mixture_set(args.model, 25), pooling, max_approx=True)
    tdp_vals = meta.get("tdp", [3.0, 0.0, 30.0])
    tdp = TdpModel(silence_state=lex.silence_state, loop=tdp_vals[0],
                   forward=tdp_vals[1], skip=tdp_vals[2])
    log(f"ML model: {model.num_densities()} densities, tdp {tdp_vals}")

    # numerator forced alignment with the ML model, cached on disk keyed by
    # corpus size so resumed runs skip the realignment
    t0 = time.perf_counter()
    align_cache = os.path.join(args.out, f"ml_alignment_{corpus.total_frames}.npy")
    if os.path.exists(align_cache):
        alignment = np.load(align_cache)
        log(f"forced alignment: loaded from {align_cache}")
    else:
        tables_all = AlignerTables.build([build_segment_automaton(lex, orth)
                                          for orth in corpus.orths], tdp)
        alignment = np.zeros(corpus.total_frames, np.int32)
        aligner = Trainer(TrainerConfig(pruning_threshold=200.0, batch_size=args.batch),
                          lex, model, tdp, dtype="df32", log=log, device=device)
        aligner._realign(corpus, tables_all, alignment)
        np.save(align_cache, alignment)
        log(f"forced alignment: {time.perf_counter() - t0:.1f}s (silence "
            f"{100.0 * (alignment == lex.silence_state).mean():.1f}%)")

    if args.init_model:
        model = MixtureModel.from_raw(read_mixture_set(args.init_model, 25), pooling,
                                      max_approx=True)
        log(f"resumed model from {args.init_model} ({model.num_densities()} densities)")

    cfg = EbwConfig(e_constant=args.e, i_smoothing_tau=args.tau,
                    posterior_threshold=args.posterior_threshold,
                    word_penalty=float(meta.get("word_penalty", 80.0)),
                    am_threshold=float(meta.get("am_threshold", 200.0)),
                    batch_size=args.batch)
    trainer = MpeTrainer(cfg, lex, model, tdp, dtype=torch.float32, device=device)

    corpora = {"holdout": holdout_corpus}
    #: one Recognizer per corpus, reused across iterations; only the pack is swapped
    recognizers = {}

    def decode(which, tag):
        c = corpora.get(which)
        if c is None and which == "test":
            desc = CorpusDescription.read(args.test_corpus, lex)
            c = corpora["test"] = Corpus.read(desc, args.features, SignalAnalysisConfig(),
                                              normalization_path=args.normalization)
        rec = recognizers.get(which)
        if rec is None:
            config = Configuration({
                "am-threshold": meta.get("am_threshold", 200.0),
                "word-penalty": meta.get("word_penalty", 80.0),
                "pruned-search": True, "max-recognition-runs": 10 ** 9})
            rec = recognizers[which] = Recognizer(config, lex, tdp,
                                                  model.pack_df(device=device), dtype="df32")
        else:
            rec.pack = model.pack_df(device=device)
        t = time.perf_counter()
        res = rec.recognize_corpus(c, batch_size=args.decode_batch)
        log(f"{which} decode [{tag}]: WER {res['wer']:.4f}% SER {res['ser']:.4f}% S/I/D "
            f"{res['substitutions']}/{res['insertions']}/{res['deletions']} "
            f"({time.perf_counter() - t:.1f}s)")
        return {"wer": res["wer"], "ser": res["ser"],
                "sid": [res["substitutions"], res["insertions"], res["deletions"]]}

    results_path = os.path.join(args.out, "results.json")
    if args.start_iter > 0 and os.path.exists(results_path):
        with open(results_path) as f:
            results = json.load(f)
    else:
        results = {"segments": corpus.num_segments,
                   "config": {"E": args.e, "tau": args.tau, "holdout": args.holdout,
                              "posterior_threshold": args.posterior_threshold},
                   "baseline_test": {"wer": 4.501682},
                   "align_silence_pct":
                       float(100.0 * (alignment == lex.silence_state).mean()),
                   "iterations": []}

    def finite(x):
        """NaN (the skipped after-pass) → null, keeping results.json strict JSON."""
        return None if isinstance(x, float) and math.isnan(x) else x

    for it in range(args.start_iter, args.start_iter + args.iters):
        t0 = time.perf_counter()
        # the after-pass runs only on the last iteration (iteration k's after
        # is iteration k+1's before)
        diag = trainer.iterate(corpus, alignment,
                               compute_after=(it == args.start_iter + args.iters - 1))
        dt = time.perf_counter() - t0
        n_seg = corpus.num_segments
        row = {"iteration": it + 1, "seconds": dt,
               "expected_accuracy_before": diag["expected_accuracy_before"],
               "expected_accuracy_after": finite(diag["expected_accuracy_after"]),
               "per_utt_acc_before": diag["expected_accuracy_before"] / n_seg,
               "per_utt_acc_after": finite(diag["expected_accuracy_after"] / n_seg),
               "num_mass": diag["num_mass"], "den_mass": diag["den_mass"]}
        after = (f"{row['per_utt_acc_after']:.4f}" if row["per_utt_acc_after"] is not None
                 else "(next iter)")
        log(f"iter {it + 1}: {dt:.1f}s, expected accuracy {row['per_utt_acc_before']:.4f} -> "
            f"{after} per utt, masses num {diag['num_mass']:.0f} den {diag['den_mass']:.0f}")
        row["holdout"] = decode("holdout", f"iter{it + 1}") if holdout_corpus else None
        row["test"] = (decode("test", f"iter{it + 1}")
                       if args.test_corpus and not args.skip_test_decode else None)
        results["iterations"].append(row)
        write_mixture_set(os.path.join(args.out, f"mpe-{it + 1}.mix"), model.to_raw())
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1)
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
