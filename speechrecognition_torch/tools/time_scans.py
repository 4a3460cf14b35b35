"""Time the search and alignment scans (kernels B, D, E, I, J, K, L and M) on
seeded inputs at their main paths' widths by CUDA events, for the port in a
given checkout, so that two checkouts can be compared in turns on one card:

    python3 speechrecognition_torch/tools/time_scans.py --repo OLD
    python3 speechrecognition_torch/tools/time_scans.py --repo .

Shapes: B (float32, float64) and D on the SieTill lattice (12 x 24) at B
1,024, T 320; E (float32, float64) at the SieTill trainer's chunk (B 256, C
320, A 70) and the Sprint path's (B 130, C 320, A 303), at A 303 also its
first design (the block instance, forced) where the checkout has one; I on
the SieTill tree (212 nodes), J on the SieTill lattice with a seeded bigram
LM, K on SieTill's 13 contexts x 212 nodes, each at B 1,024, T 960; L
(float32, float64) at the Sprint path's B 130, T 1,105, A 303, every
utterance and automaton whole; M on a linear lexicon of 129 words of 30
positions and a 3-state silence at B 130, T 464. Scores are uniform in
[0, 40) from a torch generator on the card and tables from numpy, both
seeded anew for each group of kernels (B and D; E; I, J and K; L; M).
Each kernel is timed over ``--reps`` calls after one warm-up call (B's and
D's wrappers also check their tables on the host). ``--kernels`` names the
kernels to time by letter (all by default). Prints the card's name and
power limit, then one JSON line. Needs a CUDA card; builds the checkout's
kernels at first use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Time the port's scans in a checkout.")
    ap.add_argument("--repo", required=True, help="the checkout whose port is timed")
    ap.add_argument("--reps", type=int, default=10, help="calls timed for each kernel")
    ap.add_argument("--kernels", default="BDEIJKLM",
                    help="the kernels to time, by letter (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    from speechrecognition_torch.align import baumwelch as bw
    from speechrecognition_torch.align import viterbi as vit
    from speechrecognition_torch.lexicon import Lexicon, build_sietill_lexicon
    from speechrecognition_torch.ops import doublefloat as dfm
    from speechrecognition_torch.search import decoder as dec
    from speechrecognition_torch.search import linear_lvcsr as tl
    from speechrecognition_torch.search import ngram_decoder as ng
    from speechrecognition_torch.search import tree_decoder as td
    from speechrecognition_torch.search import wcts
    from speechrecognition_torch.tdp import TdpModel
    if not torch.cuda.is_available():
        raise SystemExit("time_scans: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    rng = None

    def scores(*shape, dtype=torch.float32):
        return (torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 40.0
                ).to(dtype)

    def ms_of(fn, counter=None):
        """ms a call of ``fn`` by events; ``counter`` (a counted wrapper)
        must have launched on every call. An uncounted first design passes
        none."""
        fn()
        torch.cuda.synchronize()
        before = counter.LAUNCHES if counter else 0
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        stop.record()
        stop.synchronize()
        if counter and counter.LAUNCHES - before != args.reps:
            raise SystemExit("time_scans: a kernel was not launched on every call")
        return start.elapsed_time(stop) / args.reps

    def picked(letters, seed):
        """Whether any of ``letters`` is to be timed; if so, reseed the
        section's generators, so that its inputs do not depend on the
        kernels timed before it."""
        nonlocal rng
        if not set(letters) & set(args.kernels):
            return False
        gen.manual_seed(seed)
        rng = np.random.default_rng(seed)
        return True

    lex = build_sietill_lexicon()
    tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    S = lex.num_states
    tables = dec.DecoderTables.build(lex, tdp, 80.0)
    rows = {}

    # B and D: the word-loop lattice, B 1,024, T 320
    if picked("BD", 1):
        tab = [torch.as_tensor(a, device=dev) for a in (
            tables.state_table, tables.last_pos, tables.word_len, tables.first_state)]
        lens = torch.full((1024,), 320, dtype=torch.int32, device=dev)
        for dt, name in ((torch.float32, "B"), (torch.float64, "B f64")):
            am = scores(1024, 320, S, dtype=dt)
            targs = (*tab, torch.as_tensor(tables.tdp_within, device=dev),
                     torch.as_tensor(tables.entry_pen, device=dev), 200.0)
            rows[name] = ms_of(lambda: dec.decode_scan(am, lens, *targs), dec.decode_scan)
            del am
        am = dfm.from_f64(rng.uniform(0.0, 40.0, size=(1024, 320, S)), dev)
        dargs = (*tab, dfm.from_f64(tables.tdp_within, dev), dfm.from_f64(tables.entry_pen, dev),
                 200.0)
        rows["D"] = ms_of(lambda: dec.decode_scan_df(am, lens, *dargs), dec.decode_scan_df)
        del am

    # E: the alignment DP chunk
    if picked("E", 2):
        for B, A in ((256, 70), (130, 303)):
            tdp_e = rng.uniform(0.0, 20.0, size=(B, A, 3))
            valid = torch.ones((B, A), dtype=torch.bool, device=dev)
            elens = torch.full((B,), 320, dtype=torch.int32, device=dev)
            for dt, tag in ((torch.float32, ""), (torch.float64, " f64")):
                ams = scores(B, 320, A, dtype=dt)
                prev = torch.zeros((B, A), dtype=dt, device=dev)
                t = torch.as_tensor(tdp_e, dtype=dt, device=dev)
                rows[f"E{tag} A={A}"] = ms_of(
                    lambda: vit.align_fwd_chunk(prev, ams, t, valid, elens, 60.0, 0),
                    vit.align_fwd_chunk)
                if A > 128 and hasattr(vit, "align_fwd_chunk_cuda"):
                    rows[f"E{tag} first design A={A}"] = ms_of(
                        lambda: vit.align_fwd_chunk_cuda(prev, ams, t, valid, elens, 60.0, 0,
                                                         first_design=True))
                del ams

    # I, J, K: B 1,024, T 960
    if picked("IJK", 3):
        lens = torch.full((1024,), 960, dtype=torch.int32, device=dev)
        tree = td.TreeTables.build(lex, tdp, 80.0)
        lm = rng.uniform(0.0, 25.0, size=(lex.num_words, lex.num_words))
        lm_start = rng.uniform(0.0, 25.0, size=lex.num_words)
        wt = wcts.WctsTables.build(tree, tdp, lm, lm_start)
        for dt, tag in ((torch.float32, ""), (torch.float64, " f64")):
            am = scores(1024, 960, S, dtype=dt)
            iargs = tree.device_args(dev, dt, S)
            rows[f"I{tag}"] = ms_of(lambda: td.tree_scan(am, lens, *iargs, 200.0), td.tree_scan)
            jargs = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
                     for a in (tables.state_table, tables.last_pos, tables.word_len)]
            jargs += [torch.as_tensor(a, dtype=dt, device=dev)
                      for a in (tables.tdp_within, tables.entry_pen, lm, lm_start)]
            rows[f"J{tag}"] = ms_of(lambda: ng.decode_scan_bigram(am, lens, *jargs, 200.0),
                                    ng.decode_scan_bigram)
            kargs = wt.args(dev, dt, S)
            rows[f"K{tag}"] = ms_of(lambda: wcts.wcts_scan(am, lens, *kargs, 200.0),
                                    wcts.wcts_scan)
            del am

    # L: B 130, T 1,105, A 303
    if picked("L", 4):
        B, T, A = 130, 1105, 303
        fb_tdp = -torch.as_tensor(rng.uniform(0.0, 5.0, size=(B, A, 3)), device=dev)
        for dt, tag in ((torch.float32, ""), (torch.float64, " f64")):
            lams = -scores(B, T, A, dtype=dt) * 0.5
            largs = (fb_tdp.to(dt), torch.ones((B, A), dtype=torch.bool, device=dev),
                     torch.full((B,), T, dtype=torch.int32, device=dev),
                     torch.full((B,), A, dtype=torch.int32, device=dev))
            rows[f"L{tag} A={A}"] = ms_of(lambda: bw.forward_backward(lams, *largs),
                                          bw.forward_backward)
            del lams

    # M: a linear lexicon of 129 words of 30 positions, B 130, T 464
    if picked("M", 5):
        lin = Lexicon()
        lin.add_word("[silence]", 3, 1, silence=True)
        for w in range(129):
            lin.add_word(f"w{w}", 10, 3)
        ltdp = TdpModel(silence_state=lin.silence_state, loop=3.0, forward=0.0, skip=30.0)
        W = lin.num_words
        lt = tl.LinearTables.build(dec.DecoderTables.build(lin, ltdp, 0.0),
                                   rng.uniform(1.0, 8.0, size=(W, W)),
                                   rng.uniform(1.0, 8.0, size=W), 0)
        mlens = torch.full((130,), 464, dtype=torch.int32, device=dev)
        for dt, tag in ((torch.float32, ""), (torch.float64, " f64")):
            am = scores(130, 464, lin.num_states, dtype=dt)
            margs = lt.args(dev, dt, lin.num_states)
            rows[f"M{tag}"] = ms_of(lambda: tl.decode_scan_linear(am, mlens, *margs, 200.0),
                                    tl.decode_scan_linear)
            del am
    print(card)
    print(json.dumps({"repo": os.path.abspath(args.repo), "card": card, "reps": args.reps,
                      "ms": rows}))


if __name__ == "__main__":
    main()
