"""Rank processes of the port's parallel paths (speechrecognition_torch/
parallel/mesh.py), shared by tests/test_torch_parallel.py (gloo ranks on
the CPU) and chip_smoke.py (two ranks on one card over the host-staged gloo
transport).

    python tests/torch_parallel_ranks.py --rank R --world N --port P \\
        --out DIR [--device cpu|cuda:0] [--transport gloo|nccl] \\
        [--cases wcts,decode,recognize,accumulate] [--model iter2|bench] \\
        [--utterances U] [--pad-to T] [--dtypes f32,f64]

Each rank builds the same inputs (the committed demo corpus, repeated or cut
to U utterances; a seeded bigram LM), runs the cases and writes what it got
to DIR/rank<R>.npz and DIR/rank<R>.json. ``spawn`` starts the N processes
on a free port and returns their results. A plain module (no pytest, no
jax): chip_smoke.py loads it by path.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"

#: the seed of the WCTS cases' bigram LM (torch_search_tables.random_lm)
LM_SEED = 3
THRESHOLD = 200.0


def _tables_module():
    if str(TESTS) not in sys.path:
        sys.path.insert(0, str(TESTS))
    import torch_search_tables
    return torch_search_tables


def inputs(model: str = "iter2", utterances: int = 8, pad_to: int = 0):
    """(lex, corpus of U utterances, tdp, MixtureModel, feats [U, T, 25],
    lens [U], lm, lm_start): the demo corpus's utterances in order, repeated
    past 35; ``pad_to`` 0 pads to the longest."""
    from speechrecognition_torch.corpus import Corpus
    from speechrecognition_torch.io import read_mixture_set
    from speechrecognition_torch.models import gmm
    tst = _tables_module()
    lex, corpus, tdp, iter2 = tst.demo_setup()
    if model == "bench":
        iter2 = gmm.MixtureModel.from_raw(
            read_mixture_set(str(REPO / "bench" / "model.mix"), 25),
            gmm.VarianceModel.NO_POOLING, max_approx=True)
    ids = [i % corpus.num_segments for i in range(utterances)]
    lengths = [corpus.seq_length(s) for s in ids]
    corpus = Corpus(
        features=np.concatenate([corpus.feature_sequence(s) for s in ids]),
        feature_offsets=np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64),
        orths=[list(corpus.orths[s]) for s in ids], names=[corpus.names[s] for s in ids],
        frame_duration=corpus.frame_duration, dim=corpus.dim)
    feats, lens = corpus.padded_batch(list(range(utterances)), pad_to=pad_to or None)
    lm, lm_start = tst.random_lm(lex.num_words, LM_SEED)
    return lex, corpus, tdp, iter2, feats, np.asarray(lens, np.int32), lm, lm_start


#: tie inputs: utterances, frames, the NaN's (utterance, frame, state)
TIE_SHAPE = (4, 40)
TIE_NAN = (1, 7, 4)


def tie_inputs(lex, nan: bool):
    """(am [B, T, S] float64, lens, lm, lm_start) whose scores are small
    integers and whose LM entries are multiples of 5, so that entries,
    within-word moves, word ends and contexts tie; with ``nan`` one score is
    NaN. Two utterances end early."""
    B, T = TIE_SHAPE
    rng = np.random.default_rng(7)
    am = rng.integers(0, 6, size=(B, T, lex.num_states)).astype(np.float64)
    if nan:
        am[TIE_NAN] = np.nan
    lm, lm_start = _tables_module().random_lm(lex.num_words, LM_SEED)
    lens = np.asarray([T, T - 9, T, T - 23][:B], np.int32)
    return am, lens, np.round(lm / 5) * 5, np.round(lm_start / 5) * 5


def wcts_pack(model, name: str, device):
    """The WCTS cases' scoring pack: f32 "pallas" (kernel A's fused entry on
    the card), f64 "mxu"."""
    import torch
    if name == "f32":
        return model.pack(method="pallas", device=device)
    return model.pack(dtype=torch.float64, device=device)


def accumulate_inputs(corpus, frames: int, num_states: int):
    """(feats, states, mask) of the first ``frames`` frames (at most the
    corpus's, a multiple of 8): states from a seed, the mask 1."""
    frames = min(frames, corpus.total_frames) // 8 * 8
    states = np.random.default_rng(0).integers(0, num_states, frames).astype(np.int32)
    return corpus.features[:frames], states, np.ones(frames, np.float32)


def virtual_ranks(am, lens, lex, tdp, lm, lm_start, ranks: int, prune: bool = True):
    """The ShardStates of ``ranks`` ranks in one process, on am's device
    (the card tests and chip_smoke.py drive kernel P against its plain
    version this way, without a process group)."""
    from speechrecognition_torch.parallel.mesh import shard_state
    from speechrecognition_torch.search.tree_decoder import TreeTables
    tree = TreeTables.build(lex, tdp, 0.0)
    return [shard_state(am, lens, tree, tdp, lm, lm_start, THRESHOLD, r, ranks, prune)
            for r in range(ranks)]


def lockstep(kernel_states, plain_states, frames=None, first_design=False) -> int:
    """Advance two copies of the same virtual ranks frame by frame, one
    through kernel P's launches, one through its plain version, exchanging
    in-process (the minimum of the floor keys, the stacked send buffers);
    after every launch each rank's written tensors must be equal. Returns
    the launches compared. ``frames`` stops after that many frames;
    ``first_design`` forces P1's block instance (its launches uncounted)."""
    from speechrecognition_torch.parallel import wcts_step as ws
    import torch
    T = kernel_states[0].am.shape[1] if frames is None else frames
    n = 0

    def entries(st, t, recombine, step):
        if first_design:
            return ws.shard_entries_cuda(st, t, recombine, step, first_design=True)
        return ws.shard_entries(st, t, recombine, step)

    def exchange(states, floor):
        if floor:
            k = torch.stack([st.floor_key for st in states]).amin(dim=0)
            for st in states:
                st.floor_key.copy_(k)
        else:
            g = torch.stack([st.send for st in states])
            for st in states:
                st.gathered.copy_(g)

    def both(kernel, plain, *args):
        nonlocal n
        for k, p in zip(kernel_states, plain_states):
            kernel(k, *args)
            plain(p, *args)
            if not k.written_equal(p):
                raise AssertionError(f"kernel P differs from its plain version: "
                                     f"{plain.__name__}{args} at rank {k.ctx0}")
            n += 1

    for t in range(1, T + 1):
        both(entries, ws.shard_entries_reference, t, t > 1, True)
        exchange(kernel_states, True)
        exchange(plain_states, True)
        both(ws.shard_ends, ws.shard_ends_reference, t)
        exchange(kernel_states, False)
        exchange(plain_states, False)
    both(entries, ws.shard_entries_reference, T + 1, True, False)
    return n


def run_rank(args) -> None:
    import torch
    from speechrecognition_torch.parallel import mesh as pm
    from speechrecognition_torch.parallel import wcts_step
    from speechrecognition_torch.search.decoder import DecoderTables, Recognizer
    from speechrecognition_torch.search.tree_decoder import TreeTables
    from speechrecognition_torch.config import Configuration

    tst = _tables_module()
    torch.set_num_threads(1)
    device = torch.device(args.device)
    lex, corpus, tdp, model, feats, lens, lm, lm_start = inputs(args.model, args.utterances,
                                                                args.pad_to)
    init = f"tcp://localhost:{args.port}"
    mesh = pm.make_mesh(args.world, ("model",), device=device, transport=args.transport,
                        init_method=init, rank=args.rank, world_size=args.world)
    data = pm.make_mesh(args.world, ("data",), device=device, transport=args.transport)
    out, info = {}, {"rank": mesh.rank, "world": mesh.world_size}
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    for case in args.cases.split(","):
        t0 = time.perf_counter()
        if case == "wcts":
            tree = TreeTables.build(lex, tdp, 0.0)
            for name in args.dtypes.split(","):
                pack = wcts_pack(model, name, device)
                transport = mesh.transports["model"]
                calls, secs = transport.calls, transport.seconds
                wcts_step.LAUNCHES = 0
                t1 = time.perf_counter()
                books, bkps, preds = pm.wcts_sharded(mesh, pack, feats, lens, tree, tdp, lm,
                                                     lm_start, THRESHOLD, dtype=dtypes[name])
                info[f"wcts_{name}_seconds"] = time.perf_counter() - t1
                info[f"wcts_{name}_launches"] = wcts_step.LAUNCHES
                info[f"wcts_{name}_collectives"] = transport.calls - calls
                info[f"wcts_{name}_collective_seconds"] = transport.seconds - secs
                out.update({f"wcts_{name}_books": books, f"wcts_{name}_bkps": bkps,
                            f"wcts_{name}_preds": preds})
        elif case in ("wcts-ties", "wcts-nan"):
            tree = TreeTables.build(lex, tdp, 0.0)
            am, tl, tlm, tlm_start = tie_inputs(lex, case == "wcts-nan")
            tfeats = np.zeros((*am.shape[:2], 25), np.float32)
            for name in args.dtypes.split(","):
                books, bkps, preds = pm.wcts_sharded(
                    mesh, None, tfeats, tl, tree, tdp, tlm, tlm_start, THRESHOLD,
                    dtype=dtypes[name], am=torch.as_tensor(am))
                out.update({f"{case}_{name}_books": books, f"{case}_{name}_bkps": bkps,
                            f"{case}_{name}_preds": preds})
        elif case == "mesh2d":
            grid = pm.make_mesh(args.world, ("data", "model"), device=device,
                                transport=args.transport)
            info["mesh2d_shape"] = grid.shape
            info["mesh2d_coords"] = grid.coords
            for ax in grid.axis_names:
                tr, _i, size = grid.axis(ax)
                got = torch.empty((size, 1), dtype=torch.int64, device=device)
                tr.all_gather(got, torch.tensor([grid.rank], device=device))
                info[f"mesh2d_{ax}_ranks"] = got[:, 0].tolist()
        elif case == "decode":
            tables = DecoderTables.build(lex, tdp, 80.0)
            pack = model.pack(dtype=torch.float32, device=device)
            n = len(lens) - len(lens) % args.world
            s, w, b = pm.decode_sharded(data, pack, feats[:n], lens[:n], tables, THRESHOLD)
            out.update({"decode_scores": s, "decode_words": w, "decode_bkps": b})
        elif case == "recognize":
            cfg = Configuration(tst.DEMO_SETTINGS)
            for name, pack, dt in (
                    ("f32", model.pack(method="pallas", device=device), torch.float32),
                    ("df32", model.pack_df(device=device), "df32")):
                rec = Recognizer(cfg, lex, tdp, pack, dtype=dt)
                t1 = time.perf_counter()
                res = pm.recognize_corpus_sharded(data, pack, corpus, rec.tables, THRESHOLD,
                                                  lex.silence_idx, batch_size=args.batch,
                                                  dtype=dt)
                info[f"recognize_{name}_seconds"] = time.perf_counter() - t1
                info[f"recognize_{name}"] = {k: res[k] for k in ("wer", "ser", "substitutions",
                                                               "insertions", "deletions")}
                info[f"recognize_{name}_hyps"] = [res["hyps"][s] for s in range(len(res["hyps"]))]
        elif case == "accumulate":
            pack = model.pack(dtype=torch.float32, device=device)
            f, st, m = accumulate_inputs(corpus, args.frames, model.num_mixtures)
            w, xs, x2s = pm.accumulate_sharded(data, pack, f, st, m, first_pass=False)
            out.update({"acc_w": w, "acc_xs": xs, "acc_x2s": x2s})
        else:
            raise ValueError(f"unknown case {case}")
        info[f"{case}_case_seconds"] = time.perf_counter() - t0
    path = Path(args.out)
    np.savez(path / f"rank{mesh.rank}.npz", **out)
    with open(path / f"rank{mesh.rank}.json", "w") as f:
        json.dump(info, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(world: int, out_dir, cases: str, **opts):
    """Start ``world`` rank processes of this script on a free port (opts:
    device, transport, model, utterances, pad_to, dtypes, batch, frames);
    ``collect`` waits for them."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    extra = []
    for k, v in opts.items():
        extra += [f"--{k.replace('_', '-')}", str(v)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--world", str(world),
         "--port", str(port), "--out", str(out_dir), "--cases", cases] + extra,
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(world)]
    return out_dir, procs


def collect(started, timeout: float = 300.0):
    """Wait for ``start``'s processes, each with its own timeout; raise with a
    rank's error output if one fails. Returns [(npz dict, json dict)] in rank
    order."""
    out_dir, procs = started
    errors = []
    try:
        for r, p in enumerate(procs):
            try:
                _so, se = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                _so, se = p.communicate()
                errors.append(f"rank {r} timed out after {timeout} s:\n{se.decode()[-3000:]}")
                continue
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{se.decode()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errors:
        raise RuntimeError("\n".join(errors))
    results = []
    for r in range(len(procs)):
        with np.load(out_dir / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(out_dir / f"rank{r}.json") as f:
            results.append((arrays, json.load(f)))
    return results


def spawn(world: int, out_dir, cases: str, timeout: float = 300.0, **opts):
    """``start`` then ``collect``."""
    return collect(start(world, out_dir, cases, **opts), timeout)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--transport", default="gloo")
    ap.add_argument("--cases", default="wcts")
    ap.add_argument("--model", default="iter2")
    ap.add_argument("--utterances", type=int, default=8)
    ap.add_argument("--pad-to", type=int, default=0)
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=2400)
    run_rank(ap.parse_args(argv))


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
