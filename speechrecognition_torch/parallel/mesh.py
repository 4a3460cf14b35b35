"""Multi-card scaling: data-parallel decode and EM, and the context-sharded
word-conditioned tree search, over a group of ranks — counterpart of
speechrecognition_tpu/parallel/mesh.py on ``torch.distributed``.

The reference's only parallelism is an OpenMP loop over test segments
(src/sietill/Recognizer.cpp:46) and over MLP timesteps. Here one process is
one rank on one device:

  * decode: utterance batches split over the mesh's ``data`` axis; each rank
    scores and decodes its rows with the single-card kernels (A fused or
    the "mxu" product and B, or C and D), then the per-frame tables are
    all-gathered in rank order, which is batch order;
  * EM accumulation: each rank's frames through ``accumulate_chunk``, then
    an all-reduce SUM of the float64 statistics;
  * ``wcts_sharded``: the predecessor contexts split over the ``model``
    axis; each frame is kernel P's two launches with an all-reduce MIN of
    the beam floors between them and an all-gather of the word-end
    candidates after them (parallel/wcts_step.py), replayed a chunk of
    frames at a time from a CUDA graph on the nccl and local transports
    (``run_frames``).

A ``Mesh`` is this rank's view of the group: its rank, the world size, its
device and the axis sizes, and one ``Transport`` an axis. The transports,
chosen by name and never switched on their own:

  * ``"nccl"``: device tensors, NCCL collectives (the default on the card);
  * ``"gloo"``: gloo collectives on host tensors (the default on the CPU);
    a CUDA tensor is staged through a pinned host buffer and back, so that
    several ranks can share one card (NCCL refuses two ranks on a device);
  * ``"local"``: one rank and no process group; every collective is the
    identity.

A failed ``init_process_group`` or collective raises.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

TRANSPORTS = ("nccl", "gloo", "local")


class Transport:
    """Collectives of one axis group: ``all_reduce`` in place and
    ``all_gather`` into a [size, ...] tensor, in rank order. ``calls`` and
    ``seconds`` count the host's calls and their host time; a CUDA graph
    that captured calls replays them without counting."""

    def __init__(self, name: str, group=None, size: int = 1):
        if name not in TRANSPORTS:
            raise ValueError(f"unknown transport {name!r}; one of {TRANSPORTS}")
        self.name = name
        self.group = group
        self.size = size
        self._pinned: Dict[Tuple, torch.Tensor] = {}
        self.calls = 0
        self.seconds = 0.0

    def _host(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """A pinned host buffer shaped as ``t``, reused from call to call."""
        key = (slot, tuple(t.shape), t.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _check(self, t: torch.Tensor) -> None:
        if self.name == "nccl" and t.device.type != "cuda":
            raise ValueError(f"the nccl transport takes CUDA tensors, got {t.device}")

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group in place (op "sum" or "min")."""
        import torch.distributed as dist
        self._check(t)
        t0 = time.perf_counter()
        self.calls += 1
        if self.name != "local":
            rop = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op]
            if self.name == "gloo" and t.device.type == "cuda":
                h = self._host(t, "reduce")
                h.copy_(t)
                dist.all_reduce(h, op=rop, group=self.group)
                t.copy_(h, non_blocking=True)
            else:
                dist.all_reduce(t, op=rop, group=self.group)
        self.seconds += time.perf_counter() - t0
        return t

    def all_gather(self, out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` into ``out`` [size, *t.shape], in rank order."""
        import torch.distributed as dist
        self._check(t)
        if tuple(out.shape) != (self.size, *t.shape):
            raise ValueError(f"all_gather: out has shape {tuple(out.shape)}, expected "
                             f"{(self.size, *t.shape)}")
        t0 = time.perf_counter()
        self.calls += 1
        if self.name == "local":
            out[0].copy_(t)
        elif self.name == "gloo" and t.device.type == "cuda":
            h = self._host(t, "send")
            h.copy_(t)
            hout = self._host(out, "gathered")
            dist.all_gather(list(hout.unbind(0)), h, group=self.group)
            out.copy_(hout, non_blocking=True)
        elif self.name == "nccl":
            # one flat output buffer: no copies into a list of views
            flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            flat(out, t.contiguous(), group=self.group)
        else:
            dist.all_gather(list(out.unbind(0)), t.contiguous(), group=self.group)
        self.seconds += time.perf_counter() - t0
        return out


@dataclass
class Mesh:
    """This rank's view of the group: ``shape`` maps each axis name to its
    size; ``coords`` to this rank's index on it; ``transports`` to the
    collectives over the ranks that share this rank's other coordinates."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    world_size: int
    device: torch.device
    transport: str
    coords: Dict[str, int] = field(default_factory=dict)
    transports: Dict[str, Transport] = field(default_factory=dict)

    def axis(self, name: str) -> Tuple[Transport, int, int]:
        """(transport, this rank's index, size) of an axis."""
        if name not in self.shape:
            raise ValueError(f"the mesh has no axis {name!r} (axes {self.axis_names})")
        return self.transports[name], self.coords[name], self.shape[name]


def mesh_dims(world: int, axis_names: Tuple[str, ...]) -> Tuple[int, ...]:
    """The axis sizes of a mesh over ``world`` ranks: all of them on one
    axis; on ("data", "model") the model axis takes factors of 2, at most 4."""
    if len(axis_names) == 1:
        return (world,)
    if len(axis_names) != 2:
        raise ValueError("a mesh has one or two axes")
    n, model = world, 1
    while n % 2 == 0 and model < 4:
        model *= 2
        n //= 2
    return (world // model, model)


def make_mesh(num_devices: Optional[int] = None, axis_names: Tuple[str, ...] = ("data",), *,
              device=None, transport: Optional[str] = None, init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None) -> Mesh:
    """1-D mesh over every rank by default; ("data", "model") factors the
    world size as the reference does (the model axis takes factors of 2, at
    most 4). ``device`` is this rank's device (cuda:{LOCAL_RANK} unless the
    caller asks for the CPU); ``transport`` "nccl" (the default on the card),
    "gloo" (the default on the CPU) or "local" (one rank, no process group).

    Without a process group one is started with ``transport``'s backend from
    ``init_method`` (e.g. "tcp://localhost:29500"), ``rank`` and
    ``world_size``, or from the env:// variables; an existing group of
    another backend gets a new group of this one over the same ranks.
    ``num_devices``, if given, must be the world size (a rank is a device)."""
    import torch.distributed as dist

    device = (torch.device(device) if device is not None
              else torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))))
    if transport is None:
        transport = "nccl" if device.type == "cuda" else "gloo"
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; one of {TRANSPORTS}")
    if transport == "nccl" and device.type != "cuda":
        raise ValueError("the nccl transport needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = None
    if transport == "local":
        rank_, world = 0, 1
    else:
        if not dist.is_initialized():
            dist.init_process_group(backend=transport, init_method=init_method or "env://",
                                    rank=rank if rank is not None else -1,
                                    world_size=world_size if world_size is not None else -1)
        elif dist.get_backend() != transport:
            group = dist.new_group(backend=transport)
        rank_, world = dist.get_rank(), dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"make_mesh: {num_devices} devices asked, {world} ranks in the group")

    dims = mesh_dims(world, tuple(axis_names))
    shape = dict(zip(axis_names, dims))
    grid = np.arange(world).reshape(dims)
    coords = dict(zip(axis_names, (int(c) for c in np.argwhere(grid == rank_)[0])))
    mesh = Mesh(tuple(axis_names), shape, rank_, world, device, transport, coords)
    for k, name in enumerate(axis_names):
        if transport == "local" or len(axis_names) == 1:
            mesh.transports[name] = Transport(transport, group, dims[k])
            continue
        # one group per line of the grid along this axis; every rank makes
        # every group, in the same order
        lines = np.moveaxis(grid, k, -1).reshape(-1, dims[k])
        mine = None
        for line in lines:
            g = dist.new_group(ranks=[int(r) for r in line], backend=transport)
            if rank_ in line:
                mine = g
        mesh.transports[name] = Transport(transport, mine, dims[k])
    return mesh


def shard_batch(mesh: Mesh, x, batch_axis: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``batch_axis`` (split over
    the data axis, in rank order), on the rank's device."""
    _t, index, n = mesh.axis("data")
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    size = x.shape[batch_axis]
    if size % n:
        raise ValueError(f"batch {size} not divisible by data axis {n}")
    k = size // n
    return x.narrow(batch_axis, index * k, k).to(mesh.device)


def _gather_rows(transport: Transport, t: torch.Tensor) -> torch.Tensor:
    """[T, B_local] on each rank → [T, B] in rank order."""
    out = torch.empty((transport.size, *t.shape), dtype=t.dtype, device=t.device)
    transport.all_gather(out, t.contiguous())
    return out.permute(1, 0, 2).reshape(t.shape[0], -1)


def decode_sharded(mesh: Mesh, pack, feats: np.ndarray, feat_len: np.ndarray, tables,
                   am_threshold: float, prune: bool = True, dtype=torch.float32):
    """Data-parallel batched decode: [B, T, dim] with B split over the data
    axis. Returns (book_score, book_word, book_bkp), each [T, B] on the host,
    on every rank. B must be divisible by the data-axis size (pad with
    repeats). ``pack`` lives on the mesh's device."""
    from ..search.decoder import decode_batch_tables

    B, T, dim = feats.shape
    transport, _index, n_data = mesh.axis("data")
    if B % n_data:
        raise ValueError(f"batch {B} not divisible by data axis {n_data}")
    feats_d = shard_batch(mesh, np.asarray(feats, np.float32))
    len_d = shard_batch(mesh, np.asarray(feat_len, np.int32))
    outs = decode_batch_tables(pack, feats_d, len_d.cpu().numpy(), tables, am_threshold,
                               prune=prune, dtype=dtype)
    return tuple(_gather_rows(transport, o).cpu().numpy() for o in outs)


def recognize_corpus_sharded(mesh: Mesh, pack, corpus, tables, am_threshold: float,
                             silence_idx: int, batch_size: int = 512, dtype=torch.float32,
                             max_segments: Optional[int] = None,
                             buckets: Tuple[int, ...] = (320, 640, 960, 1280, 1600)) -> dict:
    """Whole-corpus decode with utterance batches split over the mesh's
    ``data`` axis — the multi-card form of ``Recognizer.recognize_corpus``
    (the reference's OpenMP segment loop, Recognizer.cpp:46-79). Returns the
    same WER/SER/RTF result dict on every rank.

    ``dtype="df32"`` (with ``pack`` a ScorePackDF) runs the double-float
    path: per-utterance results are independent, so the split never changes
    a transcript."""
    from ..search.decoder import _traceback_host, decode_batch_df_tables, decode_batch_tables
    from ..search.edit_distance import EDAccumulator, edit_distance

    is_df = dtype == "df32"
    n = min(corpus.num_segments, max_segments or corpus.num_segments)
    transport, _index, n_data = mesh.axis("data")
    if batch_size % n_data:
        batch_size += n_data - batch_size % n_data

    def bucket(length: int) -> int:
        for b in buckets:
            if length <= b:
                return b
        return -(-length // buckets[-1]) * buckets[-1]

    hyps: dict = {}
    t0 = time.perf_counter()
    order = np.argsort(corpus.lengths[:n], kind="stable")
    for i in range(0, n, batch_size):
        ids = order[i: i + batch_size].tolist()
        n_real = len(ids)
        while len(ids) < batch_size:         # keep shapes static
            ids.append(ids[-1])
        T = bucket(max(corpus.seq_length(s) for s in ids))
        feats, lens = corpus.padded_batch(ids, pad_to=T)
        lens = np.asarray(lens).copy()
        lens[n_real:] = 0                    # mask duplicate tail slots
        feats_d = shard_batch(mesh, np.asarray(feats, np.float32))
        lens_local = shard_batch(mesh, lens.astype(np.int32)).cpu().numpy()
        if is_df:
            outs = decode_batch_df_tables(pack, feats_d, lens_local, tables, am_threshold)
        else:
            outs = decode_batch_tables(pack, feats_d, lens_local, tables, am_threshold,
                                       dtype=dtype)
        words = _gather_rows(transport, outs[1]).cpu().numpy()
        bkps = _gather_rows(transport, outs[2]).cpu().numpy()
        seqs = _traceback_host(words[:, :n_real], bkps[:, :n_real], lens[:n_real],
                               silence_idx)
        for s, seq in zip(ids[:n_real], seqs):
            hyps[s] = seq
    elapsed = time.perf_counter() - t0

    acc = EDAccumulator()
    ref_total = 0
    sentence_errors = 0
    for s in range(n):
        ed = edit_distance(corpus.orths[s], hyps[s])
        acc += ed
        ref_total += len(corpus.orths[s])
        if ed.total_count > 0:
            sentence_errors += 1
    audio_seconds = float(corpus.lengths[:n].sum()) * corpus.frame_duration
    return {
        "wer": 100.0 * acc.total_count / ref_total,
        "ser": 100.0 * sentence_errors / n,
        "substitutions": acc.substitute_count,
        "insertions": acc.insert_count,
        "deletions": acc.delete_count,
        "time": elapsed,
        "rtf": elapsed / audio_seconds,
        "audio_seconds": audio_seconds,
        "hyps": hyps,
    }


def wcts_sharded(mesh: Mesh, pack, feats: np.ndarray, feat_len: np.ndarray, tree_tables,
                 tdp_model, lm_matrix: np.ndarray, lm_start: np.ndarray, am_threshold: float,
                 prune: bool = True, dtype=torch.float32, axis: str = "model",
                 am: Optional[torch.Tensor] = None):
    """Decode-graph sharding with collective beam exchange: the
    word-conditioned tree search's predecessor-context axis (C tree copies,
    padded with BIG LM rows to a multiple of the axis size) is split over
    the mesh's ``axis``. Each rank advances its own tree copies with kernel
    P (parallel/wcts_step.py); per frame the ranks exchange

      * the global beam floor (renormalization and pruning base): an
        all-reduce MIN of the local minima as order keys, and
      * the word-end candidates: an all-gather of each rank's [B, W] book
        minima with their entry frames and context ids, recombined by the
        first minimum over ranks (the reference's bigram recombination,
        Teaching/WordConditionedTreeSearch.cc:919-956).

    Semantics are those of the single-device scan without lookahead
    (search/wcts.wcts_scan; ties: rank order == ascending context ids, NaN
    first); returns (books, bkps, preds) as [T, B, W] host arrays on every
    rank. ``am`` may carry precomputed [B, T, S] scores (``pack`` unused);
    else every rank scores the whole batch on its device."""
    from ..models import gmm as gmm_mod

    transport, index, n_dev = mesh.axis(axis)
    if am is None:
        B, T, dim = feats.shape
        x = torch.as_tensor(np.asarray(feats, np.float32).reshape(B * T, dim), device=mesh.device)
        am = gmm_mod.am_scores(pack, x).reshape(B, T, -1)
    st = shard_state(am.to(device=mesh.device, dtype=dtype), feat_len, tree_tables, tdp_model,
                     lm_matrix, lm_start, am_threshold, index, n_dev, prune)
    run_frames(st, transport)
    return st.out_book.cpu().numpy(), st.out_bkp.cpu().numpy(), st.out_pred.cpu().numpy()


def shard_state(am: torch.Tensor, feat_len, tree_tables, tdp_model, lm_matrix, lm_start,
                am_threshold: float, index: int, n_dev: int, prune: bool = True):
    """Rank ``index`` of ``n_dev``'s ``wcts_step.ShardState`` on am's device:
    its contexts [index·n_local, (index+1)·n_local) of the context-extended
    LM, padded with BIG rows to n_dev·n_local."""
    from ..search.decoder import BIG
    from ..search.wcts import build_entry_tables, extend_lm
    from . import wcts_step

    device, dtype = am.device, am.dtype
    lm_ext = extend_lm(lm_matrix, lm_start)           # [C, W]
    C, W = lm_ext.shape
    if W != tree_tables.num_words:
        raise ValueError(f"the LM has {W} words, the tree {tree_tables.num_words}")
    n_local = -(-C // n_dev)
    lm_pad = np.full((n_local * n_dev, W), float(BIG))
    lm_pad[:C] = lm_ext
    entry_state, entry_pen = build_entry_tables(tree_tables, tdp_model)
    tree_tables.check(am.shape[2])
    if entry_state.size and (entry_state.min() < 0 or entry_state.max() >= am.shape[2]):
        raise ValueError(f"entry_state outside [0, {am.shape[2]})")

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def floats(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    tb = tree_tables
    tables = {"state": ints(tb.state), "parent": ints(tb.parent), "grand": ints(tb.grand),
              "tdp": floats(tb.tdp), "loop_allowed": ints(tb.loop_allowed),
              "entry_state": ints(entry_state), "entry_pen": floats(entry_pen),
              "end_node": ints(tb.end_node)}
    return wcts_step.ShardState.build(
        am, torch.as_tensor(np.asarray(feat_len), dtype=torch.int32), tables,
        floats(lm_pad[index * n_local:(index + 1) * n_local]), index * n_local, n_dev,
        am_threshold, prune)


#: frames a chunk that run_frames replays from a CUDA graph
FRAME_CHUNK = 8
#: transports whose collectives a CUDA graph captures (gloo stages through
#: host buffers, which a graph cannot)
GRAPH_TRANSPORTS = ("nccl", "local")


def frame_schedule(T: int, chunk: int):
    """The frame loop's segments, (first frame, frames, captured): frame 1
    alone (it recombines nothing), then from frame 2 whole chunks of
    ``chunk`` frames (captured; none where ``chunk`` is 0), then the frames
    past the last whole chunk one at a time. Together they cover frames
    1..T once each, in order; the recombination at T + 1 follows them."""
    segments = [(1, 1, False)] if T >= 1 else []
    whole = (T - 1) // chunk if chunk > 0 and T > 1 else 0
    segments += [(2 + k * chunk, chunk, True) for k in range(whole)]
    segments += [(t, 1, False) for t in range(2 + whole * chunk, T + 1)]
    return segments


def run_frames(st, transport: Transport) -> None:
    """Every frame of ``st``'s batch: P1, the floor's all-reduce MIN, P2, the
    candidates' all-gather; then the last frame's recombination.

    The route is chosen by the transport's name and the state's device: a
    CUDA state on the nccl or local transport replays whole chunks of
    FRAME_CHUNK frames from a CUDA graph (``wcts_step.FrameChunk``, captured
    once per call), and launches frame 1, the frames past the last whole chunk
    and the recombination eagerly; the gloo transport, whose host staging a
    graph cannot capture, and the CPU run every frame eagerly
    (``run_frames_eager``). Both launch the same kernels, 2T + 1 a call."""
    graph = st.am.device.type == "cuda" and transport.name in GRAPH_TRANSPORTS
    _run_frames(st, transport, FRAME_CHUNK if graph else 0)


def run_frames_eager(st, transport: Transport) -> None:
    """``run_frames`` with every frame launched eagerly, each launch through
    ``wcts_step.shard_entries`` / ``shard_ends`` (the gloo and CPU route)."""
    _run_frames(st, transport, 0)


def _run_frames(st, transport: Transport, chunk: int) -> None:
    from . import wcts_step

    T = st.am.shape[1]
    stream = wcts_step.current_stream(st) if st.am.device.type == "cuda" else None
    captured = None
    for t0, n, graph in frame_schedule(T, chunk):
        if graph:
            if captured is None:
                captured = wcts_step.FrameChunk(st, n, transport)
            captured.replay(t0)
            continue
        wcts_step.shard_entries(st, t0, recombine=t0 > 1, stream=stream)
        transport.all_reduce(st.floor_key, "min")
        wcts_step.shard_ends(st, t0, stream=stream)
        transport.all_gather(st.gathered, st.send)
    wcts_step.shard_entries(st, T + 1, recombine=True, step=False, stream=stream)


def accumulate_sharded(mesh: Mesh, pack, feats: np.ndarray, states: np.ndarray,
                       mask: np.ndarray, first_pass: bool):
    """Data-parallel E-step: frames split over the data axis, each rank's
    statistics from ``accumulate_chunk`` on its device, then an all-reduce
    SUM (the reference's global accumulators). Returns (w, xs, x2s) float64
    host arrays on every rank."""
    from ..models.gmm import accumulate_chunk

    transport, _index, _n = mesh.axis("data")
    f = shard_batch(mesh, np.asarray(feats, np.float32))
    s = shard_batch(mesh, np.asarray(states, np.int32))
    m = shard_batch(mesh, np.asarray(mask, np.float32))
    out = accumulate_chunk(pack, f, s, m, first_pass)
    return tuple(transport.all_reduce(o.contiguous(), "sum").cpu().numpy() for o in out)
