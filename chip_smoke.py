#!/usr/bin/env python3
"""Smoke run of the PyTorch port's recognition path on one CUDA card.

    python3 chip_smoke.py

Drives speechrecognition_torch's recognizers on the card — the f32 "pallas"
path (Corpus.read → MixtureModel.from_raw → pack(method="pallas") →
Recognizer.recognize_corpus) and the production double-float path
(pack_df() → Recognizer(dtype="df32")), each at full width — and holds each
hand-written kernel against its plain PyTorch version on the same tensors:

  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from speechrecognition_torch/csrc;
  3. kernel A (Mahalanobis scores) at the path's shape N=32768, J=1696,
     dim=25 and at a ragged shape: ≤ 1e-6 relative to the plain version
     over active slots, ≤ 3e-6 relative to a float64 centered computation;
  4. kernel B (word-loop Viterbi chunk) at B=1024, T=320 on real acoustic
     scores, over two chunks with carry: bit-equal to the plain version;
  5. the golden demo run: iter-2.mix on the 35 demo utterances reproduces
     tests/fixtures/demo_recognition.json (WER 19.587629 %, S/I/D 4/14/1),
     through both kernels;
  6. full width: bench/model.mix (106 mixtures × 16 densities) on the demo
     utterances repeated to one batch of 1024, decoded through the kernels
     (the main path; launch counts are read from this run) and through the
     plain versions: equal transcripts, each equal to the 35-utterance run;
  7. kernel C (double-float GMM scores, min over densities and cap) at
     N=32768, J=1696 and at a ragged N with iter-2.mix (J=424): equal hi and
     lo words to its plain version; max error against float64 printed;
  8. kernel D (double-float Viterbi chunk) and the float64 kernel B at
     B=1024, T=320 on real scores of both models, two chunks with carry:
     bit-equal to their plain versions;
  9. times of kernels C, D and f64 B against their plain versions, in turns;
 10. golden demo runs in df32 and f64 on iter-2.mix: 35/35 transcripts,
     WER 19.587629 %, S/I/D 4/14/1, through the new kernels;
 11. full width, df32 (the production path; launch counts are read from this
     run): bench/model.mix on the 1024-utterance batch through kernels C and D
     and through the plain versions: equal transcripts, each equal to the
     35-utterance df32 run; the count that differ from the f64 decode;
 12. the CLI's recognize on a temporary demo config with --device cuda:
     exit 0 and the golden WER line.

Every check that fails raises, so the script exits non-zero. It exits
non-zero without a result when no CUDA device is present. The last line of
standard output is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON summary.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FIX = REPO / "tests" / "fixtures"
SETTINGS = {"am-threshold": 200.0, "word-penalty": 80.0, "pruned-search": True,
            "max-recognition-runs": 10 ** 9}
FULL_BATCH = 1024
A_REL_TOL = 1e-6
A_F64_TOL = 3e-6
#: double-float scores against float64: tests/test_decode_demo.py's bound
C_F64_REL = 2.0 ** -38
C_F64_ABS = 2.0 ** -30
#: seconds of plain full-width df32 decode past which the plain comparison
#: is cut to the first PLAIN_CUT utterances
PLAIN_BUDGET_S = 240.0
PLAIN_CUT = 128


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps):
    """Mean device milliseconds of one call, over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps_plain, reps_kernel):
    """Time plain, kernel, kernel, plain; return (kernel ms, plain ms, all)."""
    p1 = cuda_ms(plain, reps_plain)
    k1 = cuda_ms(kernel, reps_kernel)
    k2 = cuda_ms(kernel, reps_kernel)
    p2 = cuda_ms(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, [p1, k1, k2, p2]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from speechrecognition_torch.config import Configuration
    from speechrecognition_torch.corpus import Corpus, CorpusDescription
    from speechrecognition_torch.features.frontend import SignalAnalysisConfig
    from speechrecognition_torch.io import read_mixture_set
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.models import gmm
    from speechrecognition_torch.ops import _native, mahalanobis as maha
    from speechrecognition_torch.search import decoder as dec
    from speechrecognition_torch.tdp import TdpModel
    check("jax" not in sys.modules, "the port imported jax")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. the card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(smi)
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _native.load()
    log(f"[2] kernels: {_native.library_path().relative_to(REPO)} "
        f"(nvcc {_native.build_seconds:.2f} s, load {time.perf_counter() - t0:.2f} s)")
    for line in _native.build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            log(f"    {line.strip()}")

    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(str(FIX / "demo_corpus.json"), lex)
    corpus = Corpus.read(desc, str(FIX / "demo_features") + "/", SignalAnalysisConfig(),
                         normalization_path=str(FIX / "normalization-demo.bin"))
    check(corpus.num_segments == 35, "demo corpus has 35 utterances")
    tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0, skip=30.0)
    config = Configuration(SETTINGS)
    iter2 = gmm.MixtureModel.from_raw(read_mixture_set(str(FIX / "iter-2.mix"), 25),
                                      gmm.VarianceModel.MIXTURE_POOLING, max_approx=True)
    bench = gmm.MixtureModel.from_raw(read_mixture_set(str(REPO / "bench" / "model.mix"), 25),
                                      gmm.VarianceModel.NO_POOLING, max_approx=True)
    pack_iter2 = iter2.pack(method="pallas", device=dev)
    pack_bench = bench.pack(method="pallas", device=dev)

    # -- 3. kernel A against its plain version -----------------------------------
    def f64_tables(model):
        mu, _a, _c, active = maha.pack_to_mahalanobis(model)
        S, D = active.shape
        mu64 = np.zeros((S * D, model.dim))
        a64 = np.zeros((S * D, model.dim))
        c64 = np.zeros(S * D)
        for s in range(S):
            for d, (mi, vi) in enumerate(model.mixtures[s]):
                if active[s, d]:
                    j = s * D + d
                    mu64[j], a64[j] = model.means[mi], 0.5 * model.vars_inv[vi]
                    c64[j] = model.norm[vi] - model.mean_weights_log[mi]
        return ([torch.as_tensor(v, device=dev) for v in (mu64, a64, c64)],
                torch.as_tensor(active.reshape(-1), device=dev))

    a_err = {}
    for label, model, pack, n in (("main", bench, pack_bench, gmm.AM_CHUNK),
                                  ("ragged", iter2, pack_iter2, 1000)):
        x = torch.as_tensor(np.resize(corpus.features, (n, 25)), device=dev)
        got = maha.mahalanobis_scores(x, pack.mu, pack.a, pack.c)
        ref = maha.mahalanobis_scores_reference(x, pack.mu, pack.a, pack.c)
        (mu64, a64, c64), active = f64_tables(model)
        exact = maha.mahalanobis_scores_reference(x.double(), mu64, a64, c64)
        torch.cuda.synchronize()
        g = got[:, active].double()
        r = ref[:, active].double()
        e = exact[:, active]
        rel = ((g - r).abs() / (1 + r.abs())).max().item()
        rel64 = ((g - e).abs() / (1 + e.abs())).max().item()
        rel64_plain = ((r - e).abs() / (1 + e.abs())).max().item()
        abs_err = (g - r).abs().max().item()
        inactive_equal = torch.equal(got[:, ~active], ref[:, ~active])
        log(f"[3] kernel A {label} N={n} J={pack.mu.shape[0]} dim=25: "
            f"max rel vs plain {rel:.3e}, max abs vs plain {abs_err:.3e}, "
            f"max rel vs f64 {rel64:.3e} (plain vs f64 {rel64_plain:.3e}), "
            f"inactive slots equal {inactive_equal}")
        check(tuple(got.shape) == (n, pack.mu.shape[0]), "kernel A output shape")
        check(bool(torch.isfinite(got).all()), "kernel A output finite")
        check(rel <= A_REL_TOL, f"kernel A vs plain {rel} > {A_REL_TOL}")
        check(rel64 <= A_F64_TOL, f"kernel A vs f64 {rel64} > {A_F64_TOL}")
        check(inactive_equal, "kernel A inactive slots")
        a_err[label] = abs_err

    x = torch.as_tensor(np.resize(corpus.features, (gmm.AM_CHUNK, 25)), device=dev)
    a_ms, a_plain_ms, a_all = in_turns(
        lambda: maha.mahalanobis_scores_reference(x, pack_bench.mu, pack_bench.a, pack_bench.c),
        lambda: maha.mahalanobis_scores(x, pack_bench.mu, pack_bench.a, pack_bench.c), 5, 20)
    log(f"[3] kernel A time at N={gmm.AM_CHUNK} J=1696: kernel {a_ms:.4f} ms, "
        f"plain {a_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in a_all)}) on {card}")

    # -- 4. kernel B against its plain version -----------------------------------
    big = repeat_corpus(corpus, FULL_BATCH, Corpus)
    rec_bench = dec.Recognizer(config, lex, tdp, pack_bench, dtype=torch.float32)
    T = rec_bench._bucket(big.max_seq_length)
    check(T == 960, f"full batch bucket {T} != 960")
    feats = dec.DeviceCorpus(big, dev).batch(list(range(FULL_BATCH)), T)
    lens = torch.as_tensor(big.lengths, dtype=torch.int32, device=dev)
    tables = rec_bench.tables
    targs = tuple(torch.as_tensor(a, device=dev) for a in (
        tables.state_table, tables.last_pos, tables.word_len, tables.first_state,
        tables.tdp_within, tables.entry_pen))
    chunk = dec.DECODE_CHUNK
    b_abs = 0.0
    for label, pack in (("bench/model.mix", pack_bench), ("iter-2.mix", pack_iter2)):
        ams = [gmm.am_scores(pack, feats[:, c * chunk:(c + 1) * chunk].reshape(-1, 25))
               .reshape(FULL_BATCH, chunk, -1).contiguous() for c in range(2)]
        carry_k = carry_p = None
        b_equal = True
        for c in range(2):
            carry_k, out_k = dec.decode_scan(ams[c], lens, *targs, 200.0, prune=True,
                                             carry_in=carry_k, t0=c * chunk)
            carry_p, out_p = dec.decode_scan_reference(ams[c], lens, *targs, 200.0,
                                                       prune=True, carry_in=carry_p,
                                                       t0=c * chunk)
            torch.cuda.synchronize()
            for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"),
                                  (*carry_k, *out_k), (*carry_p, *out_p)):
                same = k.dtype == p.dtype and torch.equal(k, p)
                b_equal &= same
                if k.is_floating_point():
                    b_abs = max(b_abs, (k.double() - p.double()).abs().max().item())
                if not same:
                    log(f"[4] kernel B chunk {c}: {name} differs")
        log(f"[4] kernel B B={FULL_BATCH} T={chunk} S=106 W=12 P=24 on {label} scores, "
            f"2 chunks with carry: bit-equal {b_equal}, max abs {b_abs:.3e}; "
            f"distinct best words over the 2 chunks: "
            f"{torch.unique(out_k[1]).numel()} (chunk 2)")
        check(b_equal, f"kernel B is not bit-equal to its plain version on {label} scores")
    b_ms, b_plain_ms, b_all = in_turns(
        lambda: dec.decode_scan_reference(ams[0], lens, *targs, 200.0, prune=True, t0=0),
        lambda: dec.decode_scan(ams[0], lens, *targs, 200.0, prune=True, t0=0), 2, 10)
    log(f"[4] kernel B time at B={FULL_BATCH} T={chunk}: kernel {b_ms:.4f} ms, "
        f"plain {b_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in b_all)}) on {card}")
    del ams, feats, carry_k, carry_p, out_k, out_p
    torch.cuda.empty_cache()

    # -- 5. golden demo run --------------------------------------------------------
    with open(FIX / "demo_recognition.json") as f:
        golden = json.load(f)
    rec_iter2 = dec.Recognizer(config, lex, tdp, pack_iter2, dtype=torch.float32)
    maha.mahalanobis_scores.LAUNCHES = dec.decode_scan.LAUNCHES = 0
    res = rec_iter2.recognize_corpus(corpus, batch_size=35)
    counts = (maha.mahalanobis_scores.LAUNCHES, dec.decode_scan.LAUNCHES)
    mism = [u["idx"] for u in golden["utts"] if res["hyps"][u["idx"]] != u["hyp"]]
    sid = [res["substitutions"], res["insertions"], res["deletions"]]
    log(f"[5] golden iter-2.mix: WER {res['wer']:.6f} % SER {res['ser']:.6f} % "
        f"S/I/D {sid[0]}/{sid[1]}/{sid[2]}, {len(mism)} mismatches of 35, "
        f"launches A {counts[0]} B {counts[1]}")
    check(not mism, f"golden transcripts differ at {mism}")
    check(abs(res["wer"] - golden["corpus"]["wer"]) < 1e-5, "golden WER")
    check(abs(res["ser"] - golden["corpus"]["ser"]) < 1e-9, "golden SER")
    check(sid == golden["corpus"]["sid"], "golden S/I/D")
    check(counts[0] > 0 and counts[1] > 0, "golden run did not launch both kernels")

    # -- 6. full width: the main path -------------------------------------------------
    hyps35 = rec_bench.recognize_corpus(corpus, batch_size=35)["hyps"]
    rec_bench.warmup(big, batch_size=FULL_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    maha.mahalanobis_scores.LAUNCHES = dec.decode_scan.LAUNCHES = 0
    res = rec_bench.recognize_corpus(big, batch_size=FULL_BATCH)
    launches = {"mahalanobis_scores": maha.mahalanobis_scores.LAUNCHES,
                "decode_scan": dec.decode_scan.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    with mock.patch.object(maha, "mahalanobis_scores", maha.mahalanobis_scores_reference), \
            mock.patch.object(dec, "decode_scan", dec.decode_scan_reference):
        res_plain = rec_bench.recognize_corpus(big, batch_size=FULL_BATCH)
    check(res["num_decoded"] == res_plain["num_decoded"] == FULL_BATCH, "full batch decoded")
    diff = [s for s in range(FULL_BATCH) if res["hyps"][s] != res_plain["hyps"][s]]
    vs35 = [s for s in range(FULL_BATCH) if res["hyps"][s] != hyps35[s % 35]]
    log(f"[6] full width bench/model.mix, {FULL_BATCH} utterances "
        f"({res['audio_seconds']:.1f} s audio, padded to {T} frames): "
        f"kernel-vs-plain transcript differences {len(diff)}, "
        f"differences from the 35-utterance run {len(vs35)}; WER {res['wer']:.6f} %")
    log(f"[6] decode through the kernels: {res['time']:.4f} s, RTF {res['rtf']:.3e}; "
        f"through the plain versions: {res_plain['time']:.4f} s, RTF {res_plain['rtf']:.3e}; "
        f"peak device memory {peak / 2 ** 20:.1f} MiB; launches {launches}; on {card}")
    check(not diff, f"kernel and plain transcripts differ at {diff[:10]}")
    check(not vs35, f"full-batch transcripts differ from the 35-utterance run at {vs35[:10]}")
    check(all(v > 0 for v in launches.values()), f"main path skipped a kernel: {launches}")

    f32_launches = launches
    from speechrecognition_torch.ops import doublefloat as dfm
    del pack_bench, pack_iter2, rec_bench, rec_iter2, res_plain
    torch.cuda.empty_cache()

    # -- 7. kernel C against its plain version -----------------------------------
    packdf_bench = bench.pack_df(device=dev)
    packdf_iter2 = iter2.pack_df(device=dev)
    c_err = {}
    for label, model, packdf, n in (("main", bench, packdf_bench, gmm.AM_CHUNK),
                                    ("ragged", iter2, packdf_iter2, 4133)):
        x = torch.as_tensor(np.resize(corpus.features, (n, 25)), device=dev)
        got = gmm.am_scores_df(packdf, x)
        ref = gmm.am_scores_df_reference(packdf, x)
        (mu64, a64, c64), active = f64_tables(model)
        exact = maha.mahalanobis_scores_reference(x.double(), mu64, a64, c64)
        exact = torch.where(active[None, :], exact, torch.inf)
        exact = exact.reshape(n, model.num_mixtures, -1).amin(-1).clamp(max=gmm.MIN_SCORE_INIT)
        torch.cuda.synchronize()
        equal = torch.equal(got.hi, ref.hi) and torch.equal(got.lo, ref.lo)
        g64 = got.hi.double() + got.lo.double()
        err64 = (g64 - exact).abs()
        excess = (err64 - (exact.abs() * C_F64_REL + C_F64_ABS)).max().item()
        c_err[label] = (g64 - (ref.hi.double() + ref.lo.double())).abs().max().item()
        log(f"[7] kernel C {label} N={n} J={packdf.mu.hi.shape[0]} S={packdf.num_mixtures} "
            f"dim=25: hi and lo equal to plain {equal}; vs f64 max abs "
            f"{err64.max().item():.3e}, max rel {(err64 / exact.abs()).max().item():.3e}, "
            f"worst excess over |ref|*2^-38+2^-30 {excess:.3e}")
        check(tuple(got.hi.shape) == (n, packdf.num_mixtures), "kernel C output shape")
        check(bool(torch.isfinite(got.hi).all() & torch.isfinite(got.lo).all()),
              "kernel C output finite")
        check(equal, f"kernel C differs from its plain version ({label})")
        check(excess <= 0, f"kernel C vs f64 beyond the bound ({label})")
    del got, ref, exact, g64, err64

    # -- 8. kernel D and f64 kernel B against their plain versions -------------------
    rec_df = dec.Recognizer(config, lex, tdp, packdf_bench, dtype="df32")
    feats = dec.DeviceCorpus(big, dev).batch(list(range(FULL_BATCH)), T)
    lens = torch.as_tensor(big.lengths, dtype=torch.int32, device=dev)
    tables = rec_df.tables
    largs = tuple(torch.as_tensor(a, device=dev) for a in (
        tables.state_table, tables.last_pos, tables.word_len, tables.first_state))
    df_tabs = (dfm.from_f64(tables.tdp_within, dev), dfm.from_f64(tables.entry_pen, dev))
    d_abs = b64_abs = 0.0
    # bench/model.mix last: its scores are the ones timed in phase 9
    for label, model, packdf in (("iter-2.mix", iter2, packdf_iter2),
                                 ("bench/model.mix", bench, packdf_bench)):
        chunks_df = []
        for c in range(2):
            a = gmm.am_scores_df(packdf, feats[:, c * chunk:(c + 1) * chunk].reshape(-1, 25))
            chunks_df.append(dfm.DF(a.hi.reshape(FULL_BATCH, chunk, -1),
                                    a.lo.reshape(FULL_BATCH, chunk, -1)))
        carry_k = carry_p = None
        d_equal = True
        for c in range(2):
            carry_k, out_k = dec.decode_scan_df(chunks_df[c], lens, *largs, *df_tabs, 200.0,
                                                prune=True, carry_in=carry_k, t0=c * chunk)
            carry_p, out_p = dec.decode_scan_df_reference(
                chunks_df[c], lens, *largs, *df_tabs, 200.0, prune=True,
                carry_in=carry_p, t0=c * chunk)
            torch.cuda.synchronize()
            flat_k = (carry_k[0].hi, carry_k[0].lo, carry_k[1], carry_k[2].hi, carry_k[2].lo,
                      *out_k)
            flat_p = (carry_p[0].hi, carry_p[0].lo, carry_p[1], carry_p[2].hi, carry_p[2].lo,
                      *out_p)
            for name, k, p in zip(("hyp.hi", "hyp.lo", "bkp", "book.hi", "book.lo", "score",
                                   "word", "bkp_t"), flat_k, flat_p):
                same = k.dtype == p.dtype and torch.equal(k, p)
                d_equal &= same
                if k.is_floating_point():
                    d_abs = max(d_abs, (k.double() - p.double()).abs().max().item())
                if not same:
                    log(f"[8] kernel D chunk {c}: {name} differs")
        log(f"[8] kernel D B={FULL_BATCH} T={chunk} on {label} df32 scores, 2 chunks with "
            f"carry: bit-equal {d_equal} (hi, lo, carry and outputs), max abs {d_abs:.3e}; "
            f"distinct best words in chunk 2: {torch.unique(out_k[1]).numel()}")
        check(d_equal, f"kernel D is not bit-equal to its plain version on {label} scores")

        pack64 = model.pack(dtype=torch.float64, device=dev)
        ams64 = [gmm.am_scores(pack64, feats[:, c * chunk:(c + 1) * chunk].reshape(-1, 25))
                 .reshape(FULL_BATCH, chunk, -1).contiguous() for c in range(2)]
        targs64 = (*largs[:4], torch.as_tensor(tables.tdp_within, device=dev),
                   torch.as_tensor(tables.entry_pen, device=dev))
        carry_k = carry_p = None
        b64_equal = True
        for c in range(2):
            carry_k, out_k = dec.decode_scan(ams64[c], lens, *targs64, 200.0, prune=True,
                                             carry_in=carry_k, t0=c * chunk)
            carry_p, out_p = dec.decode_scan_reference(ams64[c], lens, *targs64, 200.0,
                                                       prune=True, carry_in=carry_p,
                                                       t0=c * chunk)
            torch.cuda.synchronize()
            for name, k, p in zip(("hyp", "bkp", "book", "score", "word", "bkp_t"),
                                  (*carry_k, *out_k), (*carry_p, *out_p)):
                same = k.dtype == p.dtype and torch.equal(k, p)
                b64_equal &= same
                if k.is_floating_point():
                    b64_abs = max(b64_abs, (k - p).abs().max().item())
                if not same:
                    log(f"[8] f64 kernel B chunk {c}: {name} differs")
        log(f"[8] f64 kernel B B={FULL_BATCH} T={chunk} on {label} float64 scores, 2 chunks "
            f"with carry: bit-equal {b64_equal}, max abs {b64_abs:.3e}")
        check(carry_k[0].dtype == torch.float64, "f64 kernel B carries float64")
        check(b64_equal, f"f64 kernel B is not bit-equal to its plain version on {label}")

    # -- 9. times of C, D and f64 B against their plain versions ---------------------
    x = torch.as_tensor(np.resize(corpus.features, (gmm.AM_CHUNK, 25)), device=dev)
    c_ms, c_plain_ms, c_all = in_turns(
        lambda: gmm.am_scores_df_reference(packdf_bench, x),
        lambda: gmm.am_scores_df(packdf_bench, x), 1, 10)
    log(f"[9] kernel C time at N={gmm.AM_CHUNK} J=1696: kernel {c_ms:.4f} ms, plain "
        f"{c_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in c_all)}) on {card}")
    am0 = chunks_df[0]
    d_ms, d_plain_ms, d_all = in_turns(
        lambda: dec.decode_scan_df_reference(am0, lens, *largs, *df_tabs, 200.0, t0=0),
        lambda: dec.decode_scan_df(am0, lens, *largs, *df_tabs, 200.0, t0=0), 1, 10)
    log(f"[9] kernel D time at B={FULL_BATCH} T={chunk}: kernel {d_ms:.4f} ms, plain "
        f"{d_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in d_all)}) on {card}")
    a64 = ams64[0]
    b64_ms, b64_plain_ms, b64_all = in_turns(
        lambda: dec.decode_scan_reference(a64, lens, *targs64, 200.0, t0=0),
        lambda: dec.decode_scan(a64, lens, *targs64, 200.0, t0=0), 2, 10)
    log(f"[9] f64 kernel B time at B={FULL_BATCH} T={chunk}: kernel {b64_ms:.4f} ms, plain "
        f"{b64_plain_ms:.4f} ms (plain, kernel, kernel, plain: "
        f"{', '.join(f'{v:.4f}' for v in b64_all)}) on {card}")
    del x, chunks_df, ams64, am0, a64, carry_k, carry_p, out_k, out_p, feats
    torch.cuda.empty_cache()

    # -- 10. golden demo runs, df32 and f64 --------------------------------------------
    for kind in ("df32", "f64"):
        if kind == "df32":
            rec = dec.Recognizer(config, lex, tdp, packdf_iter2, dtype="df32")
            counters = {"am_scores_df": gmm.am_scores_df, "decode_scan_df": dec.decode_scan_df}
        else:
            rec = dec.Recognizer(config, lex, tdp, iter2.pack(dtype=torch.float64, device=dev),
                                 dtype=torch.float64)
            counters = {"decode_scan[f64]": dec.decode_scan}
        for fn in counters.values():
            fn.LAUNCHES = 0
        res = rec.recognize_corpus(corpus, batch_size=35)
        counts = {k: fn.LAUNCHES for k, fn in counters.items()}
        mism = [u["idx"] for u in golden["utts"] if res["hyps"][u["idx"]] != u["hyp"]]
        sid = [res["substitutions"], res["insertions"], res["deletions"]]
        log(f"[10] golden iter-2.mix {kind}: WER {res['wer']:.6f} % SER {res['ser']:.6f} % "
            f"S/I/D {sid[0]}/{sid[1]}/{sid[2]}, {len(mism)} mismatches of 35, "
            f"launches {counts}")
        check(not mism, f"{kind} golden transcripts differ at {mism}")
        check(abs(res["wer"] - golden["corpus"]["wer"]) < 1e-5, f"{kind} golden WER")
        check(abs(res["ser"] - golden["corpus"]["ser"]) < 1e-9, f"{kind} golden SER")
        check(sid == golden["corpus"]["sid"], f"{kind} golden S/I/D")
        check(all(v > 0 for v in counts.values()), f"{kind} golden run skipped a kernel")

    # -- 11. full width, df32: the production path ------------------------------------------
    hyps35_df = rec_df.recognize_corpus(corpus, batch_size=35)["hyps"]
    rec_df.warmup(big, batch_size=FULL_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gmm.am_scores_df.LAUNCHES = dec.decode_scan_df.LAUNCHES = 0
    res = rec_df.recognize_corpus(big, batch_size=FULL_BATCH)
    launches = {"am_scores_df": gmm.am_scores_df.LAUNCHES,
                "decode_scan_df": dec.decode_scan_df.LAUNCHES}
    peak_df = torch.cuda.max_memory_allocated(dev)
    log(f"[11] full width df32 bench/model.mix, {FULL_BATCH} utterances "
        f"({res['audio_seconds']:.1f} s audio, padded to {T} frames): decode through "
        f"kernels C and D {res['time']:.4f} s, RTF {res['rtf']:.3e}, peak device memory "
        f"{peak_df / 2 ** 20:.1f} MiB; launches {launches}; on {card}")
    check(all(v > 0 for v in launches.values()), f"df32 main path skipped a kernel: {launches}")
    check(res["num_decoded"] == FULL_BATCH, "df32 full batch decoded")

    # the plain decode's projected time from phase 9: T/chunk scans and
    # FULL_BATCH*T/AM_CHUNK scoring calls
    projected = (T // chunk * d_plain_ms + FULL_BATCH * T / gmm.AM_CHUNK * c_plain_ms) / 1e3
    n_plain = FULL_BATCH if projected <= PLAIN_BUDGET_S else PLAIN_CUT
    with mock.patch.object(gmm, "am_scores_df", gmm.am_scores_df_reference), \
            mock.patch.object(dec, "decode_scan_df", dec.decode_scan_df_reference):
        res_plain = rec_df.recognize_corpus(big, batch_size=n_plain, max_segments=n_plain)
    diff = [s for s in range(n_plain) if res["hyps"][s] != res_plain["hyps"][s]]
    vs35 = [s for s in range(FULL_BATCH) if res["hyps"][s] != hyps35_df[s % 35]]
    cut = "" if n_plain == FULL_BATCH else f" (cut: the full plain decode projects to {projected:.0f} s)"
    log(f"[11] df32 plain comparison on {n_plain} of {FULL_BATCH} utterances{cut}: "
        f"{res_plain['time']:.4f} s, RTF {res_plain['rtf']:.3e}; kernel-vs-plain transcript "
        f"differences {len(diff)}, differences from the 35-utterance df32 run {len(vs35)}")
    check(not diff, f"df32 kernel and plain transcripts differ at {diff[:10]}")
    check(not vs35, f"df32 full-batch transcripts differ from the 35-utterance run at {vs35[:10]}")

    rec64 = dec.Recognizer(config, lex, tdp, bench.pack(dtype=torch.float64, device=dev),
                           dtype=torch.float64)
    rec64.warmup(big, batch_size=FULL_BATCH)
    dec.decode_scan.LAUNCHES = 0
    res64 = rec64.recognize_corpus(big, batch_size=FULL_BATCH)
    launches["decode_scan[f64]"] = dec.decode_scan.LAUNCHES
    vs64 = [s for s in range(FULL_BATCH) if res["hyps"][s] != res64["hyps"][s]]
    log(f"[11] f64 decode of the same batch (kernel B f64, scores from the float64 "
        f"[x^2, x, 1] product): {res64['time']:.4f} s, RTF {res64['rtf']:.3e}; df32 "
        f"transcripts that differ from f64: {len(vs64)} of {FULL_BATCH}; launches "
        f"{launches['decode_scan[f64]']}")
    check(launches["decode_scan[f64]"] > 0, "the f64 decode skipped kernel B")
    del rec64, res64, res_plain
    torch.cuda.empty_cache()

    # -- 12. the CLI's recognize on the card ------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "demo.json")
        with open(cfg_path, "w") as f:
            json.dump({"corpus": str(FIX / "demo_corpus.json"),
                       "feature-path": str(FIX / "demo_features") + "/",
                       "normalization-path": str(FIX / "normalization-demo.bin"),
                       "load-mixtures-from": str(FIX / "iter-2.mix"), "pooling": "mixture",
                       "tdp-loop": 3.0, "tdp-forward": 0.0, "tdp-skip": 30.0,
                       **SETTINGS}, f)
        cli = subprocess.run([sys.executable, "-m", "speechrecognition_torch.cli", cfg_path,
                              "recognize", "--device", "cuda"], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
    cli_lines = cli.stderr.strip().splitlines()
    log(f"[12] CLI recognize --device cuda: exit {cli.returncode}; "
        + " | ".join(ln for ln in cli_lines if ln.split(":")[0] in ("WER", "SER", "Time", "RTF")))
    check(cli.returncode == 0, f"CLI recognize failed:\n{cli.stderr[-2000:]}")
    check("WER: 19.587629% (S/I/D) 4/14/1" in cli_lines, "CLI recognize golden WER line")

    kernels = [
        {"name": "mahalanobis_scores", "route": "cuda",
         "source": "speechrecognition_torch/csrc/mahalanobis.cu",
         "replaces": "speechrecognition_tpu/ops/mahalanobis.py:90",
         "launches": f32_launches["mahalanobis_scores"], "max_abs_err": a_err["main"],
         "ms": a_ms, "plain_ms": a_plain_ms},
        {"name": "decode_scan", "route": "cuda",
         "source": "speechrecognition_torch/csrc/decode_scan.cu",
         "replaces": "speechrecognition_tpu/search/decoder.py:108",
         "launches": f32_launches["decode_scan"], "max_abs_err": b_abs,
         "ms": b_ms, "plain_ms": b_plain_ms},
        {"name": "decode_scan[f64]", "route": "cuda",
         "source": "speechrecognition_torch/csrc/decode_scan.cu",
         "replaces": "speechrecognition_tpu/search/decoder.py:108",
         "launches": launches["decode_scan[f64]"], "max_abs_err": b64_abs,
         "ms": b64_ms, "plain_ms": b64_plain_ms},
        {"name": "am_scores_df", "route": "cuda",
         "source": "speechrecognition_torch/csrc/am_scores_df.cu",
         "replaces": "speechrecognition_tpu/models/gmm.py:568",
         "launches": launches["am_scores_df"], "max_abs_err": c_err["main"],
         "ms": c_ms, "plain_ms": c_plain_ms},
        {"name": "decode_scan_df", "route": "cuda",
         "source": "speechrecognition_torch/csrc/decode_scan_df.cu",
         "replaces": "speechrecognition_tpu/search/decoder.py:220",
         "launches": launches["decode_scan_df"], "max_abs_err": d_abs,
         "ms": d_ms, "plain_ms": d_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def repeat_corpus(corpus, n, corpus_cls):
    """The corpus's utterances repeated in order to ``n`` segments."""
    ids = [i % corpus.num_segments for i in range(n)]
    lengths = [corpus.seq_length(s) for s in ids]
    return corpus_cls(
        features=np.concatenate([corpus.feature_sequence(s) for s in ids]),
        feature_offsets=np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64),
        orths=[list(corpus.orths[s]) for s in ids], names=[corpus.names[s] for s in ids],
        frame_duration=corpus.frame_duration, dim=corpus.dim)


if __name__ == "__main__":
    main()
