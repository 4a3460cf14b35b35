#!/usr/bin/env python3
"""Smoke run of the PyTorch port's recognition path on one CUDA card.

    python3 chip_smoke.py

Drives speechrecognition_torch's f32 "pallas" recognizer (Corpus.read →
MixtureModel.from_raw → pack(method="pallas") → Recognizer.recognize_corpus)
on the card, and holds each hand-written kernel against its plain PyTorch
version on the same tensors:

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
     plain versions: equal transcripts, each equal to the 35-utterance run.

Every check that fails raises, so the script exits non-zero. It exits
non-zero without a result when no CUDA device is present. The last line of
standard output is {"ok": true, "device": {...}}; the line before it is the
per-kernel JSON summary.
"""

import json
import subprocess
import sys
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

    kernels = [
        {"name": "mahalanobis_scores", "route": "cuda",
         "source": "speechrecognition_torch/csrc/mahalanobis.cu",
         "replaces": "speechrecognition_tpu/ops/mahalanobis.py:90",
         "launches": launches["mahalanobis_scores"], "max_abs_err": a_err["main"],
         "ms": a_ms, "plain_ms": a_plain_ms},
        {"name": "decode_scan", "route": "cuda",
         "source": "speechrecognition_torch/csrc/decode_scan.cu",
         "replaces": "speechrecognition_tpu/search/decoder.py:108",
         "launches": launches["decode_scan"], "max_abs_err": b_abs,
         "ms": b_ms, "plain_ms": b_plain_ms},
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
