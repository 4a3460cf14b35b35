"""Time kernel F (``align.viterbi.align_fwd_chunk_df``, csrc/align_scan_df.cu)
on seeded double-float inputs by CUDA events, for the port in a given
checkout, so that two checkouts can be compared in turns on one card:

    python3 speechrecognition_torch/tools/time_align_df.py --repo OLD
    python3 speechrecognition_torch/tools/time_align_df.py --repo .

The shapes are the SieTill trainer's chunk (B 256, C 320, A 70: the warp
instance) and the Sprint path's (B 130, C 320, A 303: the wide instance),
each with finite transition penalties and with an infinite skip into every
third position, which double-float splits into (inf, NaN), so that every
row then holds NaN costs. Prints the card's name and power limit, then one
JSON line. Needs a CUDA card; builds the checkout's kernels at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

#: (B, C, A) of the timed chunks
SHAPES = ((256, 320, 70), (130, 320, 303))
#: the beam of the timed chunks (the trainer's pruning threshold's scale)
THRESHOLD = 60.0


def inputs(B: int, C: int, A: int, infinite_skip: bool, seed: int = 0):
    """Seeded float64 scores [B, C, A] and penalties [B, A, 3]."""
    rng = np.random.default_rng(seed)
    ams = rng.uniform(0.0, 40.0, size=(B, C, A))
    tdp = rng.uniform(0.0, 20.0, size=(B, A, 3))
    if infinite_skip:
        tdp[:, 2::3, 2] = np.inf
    return ams, tdp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Time kernel F of the port in a checkout.")
    ap.add_argument("--repo", required=True, help="the checkout whose port is timed")
    ap.add_argument("--reps", type=int, default=20, help="launches timed at each shape")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.ops import doublefloat as dfm
    if not torch.cuda.is_available():
        raise SystemExit("time_align_df: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = []
    for B, C, A in SHAPES:
        for infinite_skip in (False, True):
            ams, tdp = inputs(B, C, A, infinite_skip)
            chunk = (dfm.DF(torch.zeros((B, A), device=dev), torch.zeros((B, A), device=dev)),
                     dfm.from_f64(ams, dev), dfm.from_f64(tdp, dev),
                     torch.ones((B, A), dtype=torch.uint8, device=dev),
                     torch.full((B,), C, dtype=torch.int32, device=dev),
                     dfm.from_f64(np.float64(THRESHOLD), dev), 0)
            vit.align_fwd_chunk_df(*chunk)
            torch.cuda.synchronize()
            before = vit.align_fwd_chunk_df.LAUNCHES
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(args.reps):
                vit.align_fwd_chunk_df(*chunk)
            stop.record()
            stop.synchronize()
            if vit.align_fwd_chunk_df.LAUNCHES - before != args.reps:
                raise SystemExit("time_align_df: kernel F was not launched on every call")
            ms = start.elapsed_time(stop) / args.reps
            rows.append({"B": B, "C": C, "A": A, "infinite_skip": infinite_skip,
                         "warps": vit._native.load().sr_align_fwd_df_warps(A), "ms": ms,
                         "us_a_frame": ms / C * 1e3})
    print(card)
    print(json.dumps({"repo": os.path.abspath(args.repo), "card": card, "reps": args.reps,
                      "rows": rows}))


if __name__ == "__main__":
    main()
