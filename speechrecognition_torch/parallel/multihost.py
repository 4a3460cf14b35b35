"""Multi-host (N processes, a card each) runner — counterpart of
speechrecognition_tpu/parallel/multihost.py on ``torch.distributed``.

The reference is a single-machine program (OpenMP corpus loop,
Recognizer.cpp:46); the port scales the same embarrassingly-parallel corpus
work across processes:

  * ``initialize`` — ``torch.distributed.init_process_group`` over tcp://
    from explicit args or the SPEECH_TPU_{COORDINATOR,NUM_PROCS,PROC_ID}
    environment (the coordinator as "host:port");
  * ``host_shard`` — contiguous per-host segment stripes (each host reads
    only its own features: per-host data loading, no cross-host feature
    traffic);
  * ``allgather_rows`` — gather per-host result rows to every host with an
    all-gather (the only cross-host collective a data-parallel decode needs:
    final WER aggregation);
  * ``scaling_rows`` — the audio-seconds/s per card report at 1 card / 1
    host / N hosts.

``python -m speechrecognition_torch.parallel.multihost --out F --fixtures D``
is one worker: tests/test_torch_multihost.py drives two of them over
localhost (gloo, on the CPU) and the gathered WER equals the
single-process golden numbers. The demo decode reads the committed
``demo_corpus.json`` under ``--fixtures``.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: str = "gloo") -> bool:
    """Start the process group. Returns True if a multi-process setup was
    configured, False for single-process operation.

    Resolution order: explicit args → SPEECH_TPU_* environment → no-op.
    ``local_device_ids``: this process's card, cuda:{local_device_ids[0]}
    (for the nccl backend)."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("SPEECH_TPU_COORDINATOR")
    if num_processes is None and "SPEECH_TPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["SPEECH_TPU_NUM_PROCS"])
    if process_id is None and "SPEECH_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["SPEECH_TPU_PROC_ID"])
    if coordinator_address is None or num_processes is None or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("initialize: a process id is needed with several processes")
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes)
    return True


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def num_hosts() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if _initialized() else 1


def host_id() -> int:
    import torch.distributed as dist
    return dist.get_rank() if _initialized() else 0


def host_shard(n_segments: int, hosts: Optional[int] = None,
               host: Optional[int] = None) -> np.ndarray:
    """Contiguous stripe of segment indices owned by this host (per-host
    corpus loading: each host touches only its stripe's feature files)."""
    H = hosts if hosts is not None else num_hosts()
    h = host if host is not None else host_id()
    bounds = np.linspace(0, n_segments, H + 1).astype(np.int64)
    return np.arange(bounds[h], bounds[h + 1])


def allgather_rows(row: np.ndarray) -> np.ndarray:
    """Gather a per-host result row (e.g. [S, I, D, n_words, frames]) from
    every process; returns [num_hosts, len(row)] on every host."""
    import torch.distributed as dist

    row = np.asarray(row)
    if num_hosts() == 1:
        return row[None, :]
    t = torch.as_tensor(row)
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    out = torch.empty((num_hosts(), *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t.contiguous())
    return out.cpu().numpy()


def decode_host_shard(recognizer, corpus, seg_ids: Sequence[int],
                      batch_size: int = 128) -> dict:
    """Decode this host's stripe with any Recognizer; returns the stats
    row every host contributes to the corpus totals."""
    from ..tools.partition import subset_corpus

    sub = subset_corpus(corpus, list(seg_ids))
    res = recognizer.recognize_corpus(sub, batch_size=batch_size)
    errors = (res["substitutions"] + res["insertions"] + res["deletions"])
    n_words = sum(len(corpus.orths[s]) for s in seg_ids)
    return {
        "segments": len(seg_ids),
        "errors": errors,
        "substitutions": res["substitutions"],
        "insertions": res["insertions"],
        "deletions": res["deletions"],
        "sentence_errors": round(res["ser"] * len(seg_ids) / 100.0),
        "n_words": n_words,
        "audio_seconds": res["audio_seconds"],
        "decode_seconds": res["time"],
        "hyps": res["hyps"],
    }


def combine_rows(rows: np.ndarray) -> dict:
    """[H, 6] rows of (errors, n_words, sent_err, segments, audio_s,
    decode_s) → corpus WER/SER/throughput (decode time = max over hosts:
    they run concurrently)."""
    errors, n_words, sent, segs, audio, secs = rows.sum(axis=0)
    wall = rows[:, 5].max()
    return {
        "wer": 100.0 * errors / max(n_words, 1),
        "ser": 100.0 * sent / max(segs, 1),
        "audio_seconds": float(audio),
        "decode_seconds": float(wall),
        "audio_s_per_s": float(audio) / max(float(wall), 1e-9),
    }


def scaling_rows(decode_fn: Callable[[int], dict],
                 chip_counts: Sequence[int]) -> List[dict]:
    """Run ``decode_fn(num_chips)`` for each card count and annotate the
    audio-s/s-per-card rows (1 card / 1 host / N hosts report)."""
    out = []
    for n in chip_counts:
        r = decode_fn(n)
        r = dict(r)
        r["chips"] = n
        r["audio_s_per_s_per_chip"] = r["audio_s_per_s"] / n
        out.append(r)
    return out


def _decode_stripe(fixtures: str, device) -> dict:
    """Decode this host's demo-corpus stripe with the fixture model, on
    ``device``."""
    from ..config import Configuration
    from ..corpus import Corpus, CorpusDescription
    from ..features.frontend import SignalAnalysisConfig
    from ..io import read_mixture_set
    from ..lexicon import build_sietill_lexicon
    from ..models.gmm import MixtureModel, VarianceModel
    from ..search.decoder import Recognizer
    from ..tdp import TdpModel

    lex = build_sietill_lexicon()
    desc = CorpusDescription.read(os.path.join(fixtures, "demo_corpus.json"), lex)
    corpus = Corpus.read(
        desc, os.path.join(fixtures, "demo_features/"),
        SignalAnalysisConfig(),
        normalization_path=os.path.join(fixtures, "normalization-demo.bin"))
    raw = read_mixture_set(os.path.join(fixtures, "iter-2.mix"), 25)
    model = MixtureModel.from_raw(raw, VarianceModel.MIXTURE_POOLING,
                                  max_approx=True)
    tdp = TdpModel(silence_state=lex.silence_state, loop=3.0, forward=0.0,
                   skip=30.0)
    config = Configuration({"am-threshold": 200.0, "word-penalty": 80.0,
                            "pruned-search": True,
                            "max-recognition-runs": 10 ** 9})
    rec = Recognizer(config, lex, tdp, model.pack(dtype=torch.float64, device=device),
                     dtype=torch.float64)
    ids = host_shard(corpus.num_segments)
    return decode_host_shard(rec, corpus, ids, batch_size=32)


def _score_golden_stripe(golden_path: str) -> dict:
    """This host's stats row from precomputed hypotheses (no decode):
    the cross-process machinery — process group, striping, all-gather,
    combination — runs for real; only the device compute is substituted."""
    import json

    from ..search.edit_distance import EDAccumulator, edit_distance

    with open(golden_path) as f:
        golden = json.load(f)
    utts = golden["utts"]
    ids = host_shard(len(utts))
    acc = EDAccumulator()
    n_words = 0
    sent_err = 0
    for i in ids:
        ed = edit_distance(utts[i]["ref"], utts[i]["hyp"])
        acc += ed
        n_words += len(utts[i]["ref"])
        if ed.total_count > 0:
            sent_err += 1
    return {
        "segments": len(ids),
        "errors": acc.total_count,
        "substitutions": acc.substitute_count,
        "insertions": acc.insert_count,
        "deletions": acc.delete_count,
        "sentence_errors": sent_err,
        "n_words": n_words,
        "audio_seconds": 1.0,
        "decode_seconds": 1.0,
        "hyps": {},
    }


def _worker_main(argv=None) -> int:
    """Multi-host demo-corpus decode worker (tests/test_torch_multihost.py
    drives two of these over localhost): start the process group from the
    environment, decode this host's stripe, gather, write results."""
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--fixtures", required=True,
                    help="directory of demo_corpus.json, demo_features/, "
                         "normalization-demo.bin and iter-2.mix (tests/fixtures)")
    ap.add_argument("--golden-hyps", default=None,
                    help="score precomputed hypotheses from this "
                         "demo_recognition.json instead of decoding: "
                         "exercises the process group + stripe + all-gather "
                         "machinery without a decode")
    ap.add_argument("--device", default="cuda",
                    help="where the stripe is decoded (the card unless 'cpu')")
    args = ap.parse_args(argv)

    dist = initialize()
    if args.golden_hyps:
        stats = _score_golden_stripe(args.golden_hyps)
    else:
        stats = _decode_stripe(args.fixtures, args.device)
    row = np.asarray([stats["errors"], stats["n_words"],
                      stats["sentence_errors"], stats["segments"],
                      stats["audio_seconds"], stats["decode_seconds"]],
                     np.float64)
    rows = allgather_rows(row)
    if host_id() == 0:
        combined = combine_rows(rows)
        combined.update({
            "num_hosts": num_hosts(),
            "distributed": bool(dist),
            "devices": num_hosts(),
            "local_devices": 1,
            "substitutions": int(stats["substitutions"]),
        })
        with open(args.out, "w") as f:
            json.dump(combined, f)
    if dist:
        # leave together: neither process tears the group down while its
        # peer still has work on it
        import torch.distributed as tdist

        tdist.barrier()
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_worker_main())
