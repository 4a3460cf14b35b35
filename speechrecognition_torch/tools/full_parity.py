"""Transcript parity of a corpus decode against a golden file — counterpart
of the repository's tools/full_parity.py (the 13,117-utterance SieTill test
corpus against the C++ oracle's transcripts), with the corpus, features,
normalization and golden file as arguments.

    python -m speechrecognition_torch.tools.full_parity \\
        --corpus corpus_test.json --features new_features/ \\
        --normalization Normalization-eugen.bin \\
        [--golden tests/fixtures/test_recognition_full.json.gz] \\
        [--model bench/model.mix] [--method pallas|mxu] [--dtype f32|f64|df32] \\
        [--device cuda|cpu]

The golden file (JSON, gzipped or not) holds ``config`` (tdp, am_threshold,
word_penalty, optionally pooling), ``utts`` (idx, hyp) and ``corpus`` (wer,
sid). Prints the mismatching transcripts, WER, S/I/D and times; returns 0
when every transcript matches, 1 otherwise.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_golden(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", required=True, help="SieTill corpus JSON")
    ap.add_argument("--features", required=True, help="feature directory (ends with /)")
    ap.add_argument("--normalization", required=True, help="normalization .bin")
    ap.add_argument("--golden", default=os.path.join(
        REPO, "tests", "fixtures", "test_recognition_full.json.gz"))
    ap.add_argument("--model", default=os.path.join(REPO, "bench", "model.mix"))
    ap.add_argument("--pooling", default=None,
                    help="variance pooling (default: the golden config's, else none)")
    ap.add_argument("--method", default="mxu", choices=["pallas", "mxu"])
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64", "df32"])
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--buckets", default="",
                    help="comma-separated T buckets (fewer = fewer batch shapes)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..config import Configuration
    from ..corpus import Corpus, CorpusDescription
    from ..features.frontend import SignalAnalysisConfig
    from ..io import read_mixture_set
    from ..lexicon import build_sietill_lexicon
    from ..models.gmm import MixtureModel, VarianceModel
    from ..search.decoder import Recognizer
    from ..tdp import TdpModel

    golden = read_golden(args.golden)
    cfgm = golden["config"]
    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(args.corpus, lex)
    corpus = Corpus.read(desc, args.features, SignalAnalysisConfig(),
                         normalization_path=args.normalization)
    raw = read_mixture_set(args.model, 25)
    pooling = args.pooling or cfgm.get("pooling", "none")
    model = MixtureModel.from_raw(raw, VarianceModel.from_string(pooling), max_approx=True)
    if args.dtype == "df32":
        dtype = "df32"
        pack = model.pack_df(device=args.device)
    else:
        dtype = torch.float64 if args.dtype == "f64" else torch.float32
        pack = model.pack(dtype=dtype, method=args.method, device=args.device)
    tdp = TdpModel(silence_state=lex.silence_state, loop=cfgm["tdp"][0],
                   forward=cfgm["tdp"][1], skip=cfgm["tdp"][2])
    config = Configuration({"am-threshold": cfgm["am_threshold"],
                            "word-penalty": cfgm["word_penalty"],
                            "pruned-search": True, "max-recognition-runs": 10 ** 9})
    rec = Recognizer(config, lex, tdp, pack, dtype=dtype)
    if args.buckets:
        rec.buckets = tuple(int(b) for b in args.buckets.split(","))
    rec.warmup(corpus, batch_size=args.batch_size)
    t0 = time.perf_counter()
    res = rec.recognize_corpus(corpus, batch_size=args.batch_size)
    elapsed = time.perf_counter() - t0

    n = len(golden["utts"])
    mism = [u["idx"] for u in golden["utts"] if res["hyps"].get(u["idx"]) != u["hyp"]]
    print(f"method={args.method} dtype={args.dtype} device={args.device}")
    print(f"transcript mismatches: {len(mism)}/{n} ({100.0 * len(mism) / n:.4f}%)")
    for i in mism[:10]:
        print("  utt", i, "mine:", res["hyps"].get(i), "oracle:", golden["utts"][i]["hyp"])
    print(f"WER {res['wer']:.6f}% (oracle {golden['corpus']['wer']}%)  SER {res['ser']:.4f}%")
    print(f"S/I/D {res['substitutions']}/{res['insertions']}/{res['deletions']} "
          f"(oracle {golden['corpus']['sid']})")
    print(f"decode {res['time']:.2f}s, RTF {res['rtf']:.6f}, total incl. host {elapsed:.1f}s")
    return 0 if not mism else 1


if __name__ == "__main__":
    sys.exit(main())
