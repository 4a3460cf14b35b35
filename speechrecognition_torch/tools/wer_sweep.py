"""WER sweep tool: pruning-threshold and word-penalty/TDP tuning curves —
counterpart of the repository's tools/wer_sweep.py, with the corpus,
features and normalization as arguments.

  * threshold mode — WER vs am-threshold, the wer-plotting data format
    ``<threshold> <wer>`` (src/wer-plotting/gnuplot/test/time.data:1-6);
    with --time also appends decode seconds per line.
  * tuning mode — WER/SER over a (tdp, word-penalty) grid, the
    presentation's tuning table format ``<l>-<f>-<s> <wp> <wer> <ser>``
    (presentation.13-07-2016/tuning_parameters/tuning_word_penalty.data).

The threshold and the word penalty change only a scalar and the host's
entry tables, so every point reuses the same pack and kernels.

Usage:
  python -m speechrecognition_torch.tools.wer_sweep --corpus C --features F \\
      --normalization N --mode threshold --thresholds 25,50,100,250,500 \\
      [--max-segments 2000] [--out f.data] [--device cuda|cpu]
  python -m speechrecognition_torch.tools.wer_sweep ... --mode tuning \\
      --tdps 3-0-30,1-0-10 --word-penalties 60,80,100
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("threshold", "tuning"), default="threshold")
    ap.add_argument("--model", default=os.path.join(REPO, "bench", "model.mix"))
    ap.add_argument("--corpus", required=True, help="SieTill corpus JSON")
    ap.add_argument("--features", required=True, help="feature directory (ends with /)")
    ap.add_argument("--normalization", required=True, help="normalization .bin")
    ap.add_argument("--thresholds", default="25,50,100,250,500,1000000")
    ap.add_argument("--tdps", default="3-0-30", help="comma list of loop-forward-skip triples")
    ap.add_argument("--word-penalties", default="60,80,100,120")
    ap.add_argument("--pooling", default="none")
    ap.add_argument("--max-segments", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--time", action="store_true",
                    help="append decode seconds to threshold lines")
    ap.add_argument("--out", default=None)
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

    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(args.corpus, lex)
    corpus = Corpus.read(desc, args.features, SignalAnalysisConfig(),
                         normalization_path=args.normalization)
    raw = read_mixture_set(args.model, 25)
    model = MixtureModel.from_raw(raw, VarianceModel.from_string(args.pooling), max_approx=True)
    pack = model.pack(dtype=dtype, device=args.device)
    out = open(args.out, "w") if args.out else sys.stdout
    n = args.max_segments

    def decode(tdp_triple, wp, thr):
        l, f, s = tdp_triple
        tdp = TdpModel(silence_state=lex.silence_state, loop=l, forward=f, skip=s)
        cfg = Configuration({"am-threshold": thr, "word-penalty": wp,
                             "pruned-search": True, "max-recognition-runs": 10 ** 9})
        rec = Recognizer(cfg, lex, tdp, pack, dtype=dtype)
        t0 = time.perf_counter()
        r = rec.recognize_corpus(corpus, batch_size=args.batch_size, max_segments=n)
        r["wall"] = time.perf_counter() - t0
        return r

    if args.mode == "threshold":
        tdp = tuple(float(x) for x in args.tdps.split(",")[0].split("-"))
        wp = float(args.word_penalties.split(",")[0])
        for thr in (float(x) for x in args.thresholds.split(",")):
            r = decode(tdp, wp, thr)
            line = f"{thr:g} {r['wer']:.6f}"
            if args.time:
                line += f" {r['time']:.2f}"
            print(line, file=out, flush=True)
            print(f"# thr={thr:g}: WER {r['wer']:.4f}% RTF {r['rtf']:.6f}", file=sys.stderr)
    else:
        print("TDP # WP # WER # SER", file=out)
        thr = float(args.thresholds.split(",")[0])
        for tdp_s in args.tdps.split(","):
            tdp = tuple(float(x) for x in tdp_s.split("-"))
            for wp in (float(x) for x in args.word_penalties.split(",")):
                r = decode(tdp, wp, thr)
                print(f"{tdp_s} {wp:g} {r['wer']:.2f} {r['ser']:.2f}", file=out, flush=True)
                print(f"# tdp={tdp_s} wp={wp:g}: WER {r['wer']:.4f}%", file=sys.stderr)
    if args.out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
