"""Kernel P: one rank's frame step of the context-sharded word-conditioned
tree search (``mesh.wcts_sharded``), the per-device body of the
reference's ``wcts_sharded`` (speechrecognition_tpu/parallel/mesh.py:300-364)
for one rank's slice of predecessor contexts.

A frame is two launches with the ranks' exchange between and after them:

* ``shard_entries`` (P1): recombine the previous frame's gathered word-end
  candidates (first minimum over ranks, NaN first), write that frame's
  outputs and the carried book of a live utterance; read the carry's raw
  cells renormalised and pruned by the floor of the frame that wrote them
  (``carry_floor``); the within-word step and word entries of every local
  slot; a live utterance's raw cells back over the carry, every
  utterance's end-node cells into ``ends``, and the local minimum as an
  order key;
* the host issues an all-reduce MIN of the keys (the beam floor);
* ``shard_ends`` (P2): each word's end cells renormalised and pruned by the
  floor, folded over the local contexts into the rank's send buffer
  (score, entry frame, global context id); a live utterance's
  ``carry_floor`` becomes the frame's floor;
* the host issues an all-gather of the send buffers.

After the last frame one more ``shard_entries`` recombines it
(``step=False``). CUDA tensors launch ``csrc/wcts_shard_step.cu`` through a
``Launcher`` that binds a state's arguments once (counted in ``LAUNCHES``,
one a launch); CPU tensors take the plain versions
``shard_entries_reference`` and ``shard_ends_reference``. Both act on a
``ShardState`` in place. ``FrameChunk`` captures a chunk of frames, their
collectives included, in a CUDA graph (mesh.run_frames).

Order keys: a float's bits as a signed integer whose order is the value's,
with a NaN the least key, so an integer MIN over ranks is exact and keeps a
NaN floor as the single-device scan's minimum does.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import _native
from ..search.decoder import BIG

_KEY = {torch.float32: torch.int32, torch.float64: torch.int64}
_MIN = {torch.int32: -2 ** 31, torch.int64: -2 ** 63}
_MAX = {torch.int32: 2 ** 31 - 1, torch.int64: 2 ** 63 - 1}

#: launches of kernel P (P1 and P2 each count one)
LAUNCHES = 0


def order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32, float64 → int64 keys: a < b as values (−0 below +0)
    iff key(a) < key(b); every NaN maps to the least key."""
    kd = _KEY[x.dtype]
    i = x.view(kd)
    k = torch.where(i < 0, torch.bitwise_xor(i, _MAX[kd]), i)
    return torch.where(torch.isnan(x), torch.full_like(k, _MIN[kd]), k)


def key_value(k: torch.Tensor) -> torch.Tensor:
    """The value of an order key (the least key: a NaN)."""
    dt = {torch.int32: torch.float32, torch.int64: torch.float64}[k.dtype]
    v = torch.where(k < 0, torch.bitwise_xor(k, _MAX[k.dtype]), k).view(dt)
    return torch.where(k == _MIN[k.dtype], torch.full_like(v, float("nan")), v)


def end_lists(end_node: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(end_first [N], end_next [W]) int32: each node's first word ending
    there and each word's next word ending at the same node (−1: none), so
    that a node's owner writes every word's end cell (homophones share an
    end node)."""
    end_node = np.asarray(end_node, np.int64)
    first = np.full(num_nodes, -1, np.int32)
    nxt = np.full(len(end_node), -1, np.int32)
    for w in range(len(end_node) - 1, -1, -1):
        nxt[w] = first[end_node[w]]
        first[end_node[w]] = w
    return first, nxt


@dataclass
class ShardState:
    """Everything one rank's frame steps read and write, on one device.

    Tables (read): am [B, T, S]; feat_len int32 [B]; the tree's state,
    parent, grand, loop_allowed [N] int32 and tdp [N, 3]; entry_state int32
    and entry_pen [N]; end_node int32 [W] and its lists end_first [N],
    end_next [W] (``end_lists``); lm_local [n_local, W] (this rank's rows of
    the padded context-extended LM). Written: the carry, hyp [B, n_local, N]
    raw cells (before the renormalisation of the frame that wrote them),
    bkp int32, carry_floor [B] (that frame's floor key) and book [B, W]; the
    end-node cells ends [B, n_local, W] and ends_bkp int32; floor_key [B];
    send (this rank's candidates: score [B, W], bkp and pred [B, W] int32,
    as bytes) and gathered [ranks, send bytes]; the outputs out_book [T, B,
    W], out_bkp, out_pred int32."""

    am: torch.Tensor
    feat_len: torch.Tensor
    state: torch.Tensor
    parent: torch.Tensor
    grand: torch.Tensor
    tdp: torch.Tensor
    loop_allowed: torch.Tensor
    entry_state: torch.Tensor
    entry_pen: torch.Tensor
    end_node: torch.Tensor
    end_first: torch.Tensor
    end_next: torch.Tensor
    lm_local: torch.Tensor
    hyp: torch.Tensor
    bkp: torch.Tensor
    carry_floor: torch.Tensor
    book: torch.Tensor
    ends: torch.Tensor
    ends_bkp: torch.Tensor
    floor_key: torch.Tensor
    send: torch.Tensor
    gathered: torch.Tensor
    out_book: torch.Tensor
    out_bkp: torch.Tensor
    out_pred: torch.Tensor
    ctx0: int
    thr: float
    prune: bool
    #: the bound launches of this state's tensors, by first_design
    launchers: Dict[bool, "Launcher"] = field(default_factory=dict, repr=False, compare=False)

    #: the tensors the steps write
    WRITTEN = ("hyp", "bkp", "carry_floor", "book", "ends", "ends_bkp", "floor_key", "send",
               "gathered", "out_book", "out_bkp", "out_pred")

    @staticmethod
    def build(am: torch.Tensor, feat_len: torch.Tensor, tables: Dict[str, torch.Tensor],
              lm_local: torch.Tensor, ctx0: int, ranks: int, am_threshold: float,
              prune: bool = True) -> "ShardState":
        """Fresh carry and buffers for ``am``'s batch; ``tables`` holds state,
        parent, grand, tdp, loop_allowed, entry_state, entry_pen, end_node
        (each on am's device, in the step's types)."""
        B, T, S = am.shape
        dtype, device = am.dtype, am.device
        if dtype not in _KEY:
            raise TypeError(f"wcts_sharded: the frame step runs float32 or float64, got {dtype}")
        n_local, W = lm_local.shape
        N = tables["state"].shape[0]
        nbytes = B * W * (am.element_size() + 8)
        big = float(BIG)
        first, nxt = end_lists(tables["end_node"].cpu().numpy(), N)

        def empty(shape, dt):
            return torch.empty(shape, dtype=dt, device=device)

        return ShardState(
            am=am.contiguous(), feat_len=feat_len.to(device=device, dtype=torch.int32),
            **{k: tables[k].contiguous() for k in ("state", "parent", "grand", "tdp",
                                                   "loop_allowed", "entry_state",
                                                   "entry_pen", "end_node")},
            end_first=torch.as_tensor(first, device=device),
            end_next=torch.as_tensor(nxt, device=device),
            lm_local=lm_local.to(device=device, dtype=dtype).contiguous(),
            hyp=torch.full((B, n_local, N), big, dtype=dtype, device=device),
            bkp=torch.zeros((B, n_local, N), dtype=torch.int32, device=device),
            carry_floor=torch.zeros((B,), dtype=_KEY[dtype], device=device),
            book=torch.full((B, W), big, dtype=dtype, device=device),
            ends=empty((B, n_local, W), dtype), ends_bkp=empty((B, n_local, W), torch.int32),
            floor_key=empty((B,), _KEY[dtype]),
            send=torch.zeros((nbytes,), dtype=torch.uint8, device=device),
            gathered=torch.zeros((ranks, nbytes), dtype=torch.uint8, device=device),
            out_book=empty((T, B, W), dtype), out_bkp=empty((T, B, W), torch.int32),
            out_pred=empty((T, B, W), torch.int32), ctx0=int(ctx0),
            thr=float(am_threshold), prune=bool(prune))

    def clone(self) -> "ShardState":
        """A copy whose written tensors are new (the tables are shared; the
        copy binds its own launches)."""
        return replace(self, launchers={},
                       **{k: getattr(self, k).clone() for k in self.WRITTEN})

    def written_equal(self, other: "ShardState") -> bool:
        """Every written tensor equal, value for value (a NaN equals a NaN:
        the card's arithmetic gives its own NaN payload): the raw carry,
        carry_floor, the book, the end cells, the floor key, the candidate
        buffers and the outputs."""
        for k in self.WRITTEN:
            a, b = getattr(self, k), getattr(other, k)
            pairs = (zip(self.candidates(a), other.candidates(b)) if k in ("send", "gathered")
                     else ((a, b),))
            if not all(same(x, y) for x, y in pairs):
                return False
        return True

    @property
    def ranks(self) -> int:
        return self.gathered.shape[0]

    def candidates(self, buf: torch.Tensor):
        """(score, bkp, pred) views [..., B, W] of a send or gathered buffer."""
        B, W = self.book.shape
        n = B * W * self.am.element_size()
        lead = buf.shape[:-1]
        score = buf[..., :n].view(self.am.dtype).view(*lead, B, W)
        bkp = buf[..., n:n + 4 * B * W].view(torch.int32).view(*lead, B, W)
        pred = buf[..., n + 4 * B * W:].view(torch.int32).view(*lead, B, W)
        return score, bkp, pred


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch.equal``, with a NaN equal to a NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


# -- the plain versions ------------------------------------------------------------


def _carried(st: ShardState, cells: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Raw cells [B, ...] renormalised by their frame's floor key [B] (a
    floor >= BIG/2 counts as 0; a cell >= BIG/2 stays BIG) and pruned."""
    dtype, device = cells.dtype, cells.device
    big = torch.tensor(float(BIG), dtype=dtype, device=device)
    half = big * 0.5
    best = key_value(key).view(-1, *([1] * (cells.dim() - 1)))
    best = torch.where(best >= half, torch.zeros_like(best), best)
    out = torch.where(cells >= half, big, cells - best)
    if st.prune:
        out = torch.where(out > torch.tensor(st.thr, dtype=dtype, device=device), big, out)
    return out


def shard_entries_reference(st: ShardState, t: int, recombine: bool, step: bool) -> None:
    """Plain PyTorch version of ``shard_entries`` (any device). Same contract."""
    B, T, S = st.am.shape
    W = st.book.shape[1]
    n_local, N = st.hyp.shape[1:]
    dtype, device = st.am.dtype, st.am.device
    big = torch.tensor(float(BIG), dtype=dtype, device=device)
    half = big * 0.5
    if recombine:
        g_score, g_bkp, g_pred = st.candidates(st.gathered)        # [R, B, W]
        win = g_score.argmin(dim=0)[None]                           # first minimum, NaN first
        best = g_score.gather(0, win)[0]
        best = torch.where(best >= half, big, best)
        st.out_book[t - 2] = best
        st.out_bkp[t - 2] = g_bkp.gather(0, win)[0]
        st.out_pred[t - 2] = g_pred.gather(0, win)[0]
        alive = (t - 1) <= st.feat_len
        st.book.copy_(torch.where(alive[:, None], best, st.book))
    if not step:
        return
    ctx = st.ctx0 + torch.arange(n_local, device=device)
    start = torch.zeros((), dtype=dtype, device=device) if t == 1 else big
    ext = torch.where((ctx < W)[None, :], st.book[:, ctx.clamp(0, W - 1)],
                      torch.where((ctx == W)[None, :], start, big))    # [B, n_local]
    par, gr = st.parent.long(), st.grand.long()
    hyp, bkp, tdp = _carried(st, st.hyp, st.carry_floor), st.bkp, st.tdp
    loop = torch.where(st.loop_allowed.bool()[None, None, :], hyp + tdp[None, None, :, 0], big)
    fwd = hyp[:, :, par] + tdp[None, None, :, 1]
    skip = hyp[:, :, gr] + tdp[None, None, :, 2]
    within, wbkp = skip, bkp[:, :, gr]
    for c, b in ((fwd, bkp[:, :, par]), (loop, bkp)):
        take = c < within
        within = torch.where(take, c, within)
        wbkp = torch.where(take, b, wbkp)
    am_t = st.am[:, t - 1]
    within = within + am_t[:, None, st.state.long()]
    entry = (ext[:, :, None] + st.entry_pen[None, None, :]) + am_t[:, None, st.entry_state.long()]
    take_entry = entry <= within
    new = torch.where(take_entry, entry, within)
    nbkp = torch.where(take_entry, torch.tensor(t - 1, dtype=torch.int32, device=device), wbkp)
    new[:, :, 0] = big
    new = torch.minimum(new, big)
    alive = (t <= st.feat_len)[:, None, None]
    st.hyp.copy_(torch.where(alive, new, st.hyp))
    st.bkp.copy_(torch.where(alive, nbkp, st.bkp))
    en = st.end_node.long()
    st.ends.copy_(new[:, :, en])
    st.ends_bkp.copy_(nbkp[:, :, en])
    st.floor_key.copy_(order_key(new.reshape(B, -1)).amin(dim=1))


def shard_ends_reference(st: ShardState, t: int) -> None:
    """Plain PyTorch version of ``shard_ends`` (any device). Same contract."""
    big = torch.tensor(float(BIG), dtype=st.am.dtype, device=st.am.device)
    half = big * 0.5
    ends = _carried(st, st.ends, st.floor_key)                      # [B, n_local, W]
    cand = torch.where(ends >= half, big, ends + st.lm_local[None, :, :])
    arg = cand.argmin(dim=1)[:, None, :]                            # first context, NaN first
    score, bkp, pred = st.candidates(st.send)
    score.copy_(cand.gather(1, arg)[:, 0])
    bkp.copy_(st.ends_bkp.gather(1, arg)[:, 0])
    pred.copy_((st.ctx0 + arg[:, 0]).to(torch.int32))
    st.carry_floor.copy_(torch.where(t <= st.feat_len, st.floor_key, st.carry_floor))


# -- the kernels -----------------------------------------------------------------


def _check_cuda(st: ShardState, what: str) -> None:
    if st.am.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {st.am.device}")


def current_stream(st: ShardState) -> int:
    """The handle of the current stream on the state's device."""
    return torch.cuda.current_stream(st.am.device).cuda_stream


class Launcher:
    """Kernel P's two launches on one CUDA ``ShardState``, their arguments
    bound once, so that a launch is one call into the C entry.

    ``first_design`` forces P1's block instance (the first design, for
    timing in turns); else the C entry launches the instance the shape
    chooses (``instance``: 1 the owner instance, 0 the block instance). The
    block instance gets its scratch rows here. A frame-relative launch
    (``relative=True``) runs frame ``frame[0] + t``: ``frame`` is a device
    int32 that a CUDA graph's replays rewrite."""

    def __init__(self, st: ShardState, first_design: bool = False):
        _check_cuda(st, "kernel P")
        lib = _native.load()
        B, T, S = st.am.shape
        n_local, N = st.hyp.shape[1:]
        W = st.book.shape[1]
        f64 = int(st.am.dtype == torch.float64)
        self.instance = 0 if first_design else lib.sr_wcts_shard_instance(n_local, N, W, f64)
        self.scratch = ((torch.empty_like(st.hyp), torch.empty_like(st.bkp))
                        if self.instance == 0 else (None, None))
        self.frame = torch.zeros(1, dtype=torch.int32, device=st.am.device)
        self._frame = self.frame.data_ptr()
        self._entries = lib.sr_wcts_shard_entries
        self._ends = lib.sr_wcts_shard_ends
        p = _native.ptr
        self._e_args = (
            f64, p(st.am), p(st.feat_len), p(st.state), p(st.parent), p(st.grand), p(st.tdp),
            p(st.loop_allowed), p(st.entry_state), p(st.entry_pen), p(st.end_first),
            p(st.end_next), p(st.hyp), p(st.bkp), p(st.carry_floor), p(st.book),
            p(st.gathered), st.gathered.shape[1], st.ranks, p(st.out_book), p(st.out_bkp),
            p(st.out_pred), p(st.ends), p(st.ends_bkp), p(st.floor_key), p(self.scratch[0]),
            p(self.scratch[1]), B, T, S, n_local, N, W, st.ctx0, st.thr, int(st.prune))
        self._n_args = (f64, p(st.feat_len), p(st.lm_local), p(st.floor_key),
                        p(st.carry_floor), p(st.ends), p(st.ends_bkp), p(st.send), B, n_local,
                        W, st.ctx0, st.thr, int(st.prune))
        self._tail = (int(first_design), st.am.device.index)

    def entries(self, t: int, recombine: bool, step: bool, stream: int,
                relative: bool = False) -> None:
        """P1 of frame ``t`` (``frame[0] + t`` where ``relative``)."""
        err = self._entries(*self._e_args, self._frame if relative else None, t,
                            int(recombine), int(step), *self._tail, stream)
        if err:
            _native.check(err, "shard_entries")

    def ends(self, t: int, stream: int, relative: bool = False) -> None:
        """P2 of frame ``t`` (``frame[0] + t`` where ``relative``)."""
        err = self._ends(*self._n_args, self._frame if relative else None, t,
                         self._tail[1], stream)
        if err:
            _native.check(err, "shard_ends")


def launcher(st: ShardState, first_design: bool = False) -> Launcher:
    """The state's bound launches (made at the first call)."""
    got = st.launchers.get(first_design)
    if got is None:
        got = st.launchers[first_design] = Launcher(st, first_design)
    return got


def shard_entries(st: ShardState, t: int, recombine: bool, step: bool = True,
                  stream=None) -> None:
    """P1 of frame ``t`` (1-based): with ``recombine``, frame t − 1's
    gathered candidates first (2 <= t <= T + 1); with ``step``, frame t's
    entries and within-word step into the carry (a live utterance), the end
    cells and the local minimum key. CPU tensors take the plain version;
    CUDA tensors launch kernel P's first launch (counted in ``LAUNCHES``) on
    ``stream`` (a handle; the current stream by default)."""
    global LAUNCHES
    if st.am.device.type == "cpu":
        shard_entries_reference(st, t, recombine, step)
        return
    launcher(st).entries(t, recombine, step, current_stream(st) if stream is None else stream)
    LAUNCHES += 1


def shard_ends(st: ShardState, t: int, stream=None) -> None:
    """P2 of frame ``t``, after the all-reduce MIN of ``floor_key``: the
    send buffer and a live utterance's carry_floor. CPU tensors take the
    plain version; CUDA tensors launch kernel P's second launch (counted in
    ``LAUNCHES``)."""
    global LAUNCHES
    if st.am.device.type == "cpu":
        shard_ends_reference(st, t)
        return
    launcher(st).ends(t, current_stream(st) if stream is None else stream)
    LAUNCHES += 1


def shard_entries_cuda(st: ShardState, t: int, recombine: bool, step: bool = True,
                       first_design: bool = False) -> None:
    """Kernel P's first launch on a CUDA state, as ``shard_entries`` makes it
    but not counted; ``first_design`` forces the block instance."""
    _check_cuda(st, "shard_entries")
    launcher(st, first_design).entries(t, recombine, step, current_stream(st))


def shard_ends_cuda(st: ShardState, t: int) -> None:
    """Kernel P's second launch on a CUDA state, as ``shard_ends`` makes it
    but not counted."""
    _check_cuda(st, "shard_ends")
    launcher(st).ends(t, current_stream(st))


class FrameChunk:
    """``frames`` consecutive frames of a CUDA state captured once in a CUDA
    graph: each frame is P1 (recombining the frame before), ``transport``'s
    all-reduce MIN of the floor keys, P2 and its all-gather of the
    candidates. The launches are frame-relative (the offset in the chunk,
    added to the launcher's ``frame``), so one capture serves every chunk.
    The transport's collectives must be capturable (nccl, local)."""

    def __init__(self, st: ShardState, frames: int, transport):
        _check_cuda(st, "FrameChunk")
        self.st, self.frames = st, frames
        self.launcher = launcher(st)
        self.graph = torch.cuda.CUDAGraph()
        # captured on a side stream that joins the current one, without
        # torch.cuda.graph's synchronise and emptying of the allocator cache
        device = st.am.device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            for k in range(frames):
                self.launcher.entries(k, True, True, side.cuda_stream, relative=True)
                transport.all_reduce(st.floor_key, "min")
                self.launcher.ends(k, side.cuda_stream, relative=True)
                transport.all_gather(st.gathered, st.send)
            self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)

    def replay(self, t0: int) -> None:
        """Frames t0 .. t0 + frames − 1 (2 <= t0, the last <= T), counted in
        ``LAUNCHES`` (two a frame)."""
        global LAUNCHES
        T = self.st.am.shape[1]
        if not 2 <= t0 <= T - self.frames + 1:
            raise ValueError(f"FrameChunk: frames {t0}..{t0 + self.frames - 1} outside 2..{T}")
        self.launcher.frame.fill_(t0)
        self.graph.replay()
        LAUNCHES += 2 * self.frames
