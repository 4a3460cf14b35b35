"""Kernel P: one rank's frame step of the context-sharded word-conditioned
tree search (``mesh.wcts_sharded``), the per-device body of the
reference's ``wcts_sharded`` (speechrecognition_tpu/parallel/mesh.py:300-364)
for one rank's slice of predecessor contexts.

A frame is two launches with the ranks' exchange between and after them:

* ``shard_entries`` (P1): recombine the previous frame's gathered word-end
  candidates (first minimum over ranks, NaN first), write that frame's
  outputs and the carried book of a live utterance; then the within-word
  step and word entries of every local slot and the utterance's local
  minimum as an order key;
* the host issues an all-reduce MIN of the keys (the beam floor);
* ``shard_ends`` (P2): renormalise, prune, update the carry and fold each
  word's end over the local contexts into the rank's send buffer (score,
  entry frame, global context id);
* the host issues an all-gather of the send buffers.

After the last frame one more ``shard_entries`` recombines it
(``step=False``). CUDA tensors launch ``csrc/wcts_shard_step.cu`` (counted
in ``LAUNCHES``, one a launch); CPU tensors take the plain versions
``shard_entries_reference`` and ``shard_ends_reference``. Both act on a
``ShardState`` in place.

Order keys: a float's bits as a signed integer whose order is the value's,
with a NaN the least key, so an integer MIN over ranks is exact and keeps a
NaN floor as the single-device scan's minimum does.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

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


@dataclass
class ShardState:
    """Everything one rank's frame steps read and write, on one device.

    Tables (read): am [B, T, S]; feat_len int32 [B]; the tree's state,
    parent, grand, loop_allowed [N] int32 and tdp [N, 3]; entry_state int32
    and entry_pen [N]; end_node int32 [W]; lm_local [n_local, W] (this
    rank's rows of the padded context-extended LM). Written: the carry hyp
    [B, n_local, N], bkp int32, book [B, W]; the scratch rows nhyp, nbkp;
    floor_key [B]; send (this rank's candidates: score [B, W], bkp and pred
    [B, W] int32, as bytes) and gathered [ranks, send bytes]; the outputs
    out_book [T, B, W], out_bkp, out_pred int32."""

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
    lm_local: torch.Tensor
    hyp: torch.Tensor
    bkp: torch.Tensor
    book: torch.Tensor
    nhyp: torch.Tensor
    nbkp: torch.Tensor
    floor_key: torch.Tensor
    send: torch.Tensor
    gathered: torch.Tensor
    out_book: torch.Tensor
    out_bkp: torch.Tensor
    out_pred: torch.Tensor
    ctx0: int
    thr: float
    prune: bool

    #: the tensors the steps write
    WRITTEN = ("hyp", "bkp", "book", "nhyp", "nbkp", "floor_key", "send", "gathered",
               "out_book", "out_bkp", "out_pred")

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

        def empty(shape, dt):
            return torch.empty(shape, dtype=dt, device=device)

        return ShardState(
            am=am.contiguous(), feat_len=feat_len.to(device=device, dtype=torch.int32),
            **{k: tables[k].contiguous() for k in ("state", "parent", "grand", "tdp",
                                                   "loop_allowed", "entry_state",
                                                   "entry_pen", "end_node")},
            lm_local=lm_local.to(device=device, dtype=dtype).contiguous(),
            hyp=torch.full((B, n_local, N), big, dtype=dtype, device=device),
            bkp=torch.zeros((B, n_local, N), dtype=torch.int32, device=device),
            book=torch.full((B, W), big, dtype=dtype, device=device),
            nhyp=empty((B, n_local, N), dtype), nbkp=empty((B, n_local, N), torch.int32),
            floor_key=empty((B,), _KEY[dtype]),
            send=torch.zeros((nbytes,), dtype=torch.uint8, device=device),
            gathered=torch.zeros((ranks, nbytes), dtype=torch.uint8, device=device),
            out_book=empty((T, B, W), dtype), out_bkp=empty((T, B, W), torch.int32),
            out_pred=empty((T, B, W), torch.int32), ctx0=int(ctx0),
            thr=float(am_threshold), prune=bool(prune))

    def clone(self) -> "ShardState":
        """A copy whose written tensors are new (the tables are shared)."""
        return replace(self, **{k: getattr(self, k).clone() for k in self.WRITTEN})

    def written_equal(self, other: "ShardState") -> bool:
        """Every written tensor equal, value for value (a NaN equals a NaN:
        the card's arithmetic gives its own NaN payload)."""
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
    hyp, bkp, tdp = st.hyp, st.bkp, st.tdp
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
    st.nhyp.copy_(new)
    st.nbkp.copy_(nbkp)
    st.floor_key.copy_(order_key(new.reshape(B, -1)).amin(dim=1))


def shard_ends_reference(st: ShardState, t: int) -> None:
    """Plain PyTorch version of ``shard_ends`` (any device). Same contract."""
    dtype, device = st.am.dtype, st.am.device
    big = torch.tensor(float(BIG), dtype=dtype, device=device)
    half = big * 0.5
    best = key_value(st.floor_key)[:, None, None]
    best = torch.where(best >= half, torch.zeros_like(best), best)
    new = torch.where(st.nhyp >= half, big, st.nhyp - best)
    if st.prune:
        new = torch.where(new > torch.tensor(st.thr, dtype=dtype, device=device), big, new)
    st.nhyp.copy_(new)
    alive = (t <= st.feat_len)[:, None, None]
    st.hyp.copy_(torch.where(alive, new, st.hyp))
    st.bkp.copy_(torch.where(alive, st.nbkp, st.bkp))
    en = st.end_node.long()
    ends = new[:, :, en]                                            # [B, n_local, W]
    cand = torch.where(ends >= half, big, ends + st.lm_local[None, :, :])
    arg = cand.argmin(dim=1)[:, None, :]                            # first context, NaN first
    score, bkp, pred = st.candidates(st.send)
    score.copy_(cand.gather(1, arg)[:, 0])
    bkp.copy_(st.nbkp[:, :, en].gather(1, arg)[:, 0])
    pred.copy_((st.ctx0 + arg[:, 0]).to(torch.int32))


# -- the kernels -----------------------------------------------------------------


def shard_entries(st: ShardState, t: int, recombine: bool, step: bool = True) -> None:
    """P1 of frame ``t`` (1-based): with ``recombine``, frame t − 1's
    gathered candidates first (2 <= t <= T + 1); with ``step``, frame t's
    entries and within-word step into the scratch rows and the local
    minimum key. CPU tensors take the plain version; CUDA tensors launch
    kernel P's first launch (counted in ``LAUNCHES``)."""
    global LAUNCHES
    if st.am.device.type == "cpu":
        shard_entries_reference(st, t, recombine, step)
        return
    shard_entries_cuda(st, t, recombine, step)
    LAUNCHES += 1


def shard_ends(st: ShardState, t: int) -> None:
    """P2 of frame ``t``, after the all-reduce MIN of ``floor_key``: the
    renormalised and pruned rows, the carry and the send buffer. CPU tensors
    take the plain version; CUDA tensors launch kernel P's second launch
    (counted in ``LAUNCHES``)."""
    global LAUNCHES
    if st.am.device.type == "cpu":
        shard_ends_reference(st, t)
        return
    shard_ends_cuda(st, t)
    LAUNCHES += 1


def _check_cuda(st: ShardState, what: str) -> None:
    if st.am.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {st.am.device}")


def shard_entries_cuda(st: ShardState, t: int, recombine: bool, step: bool = True) -> None:
    """Kernel P's first launch on a CUDA state, as ``shard_entries`` makes it
    but not counted."""
    _check_cuda(st, "shard_entries")
    B, T, S = st.am.shape
    n_local, N = st.hyp.shape[1:]
    W = st.book.shape[1]
    dev = st.am.device
    lib = _native.load()
    err = lib.sr_wcts_shard_entries(
        int(st.am.dtype == torch.float64), st.am.data_ptr(), st.feat_len.data_ptr(),
        st.state.data_ptr(), st.parent.data_ptr(), st.grand.data_ptr(), st.tdp.data_ptr(),
        st.loop_allowed.data_ptr(), st.entry_state.data_ptr(), st.entry_pen.data_ptr(),
        st.hyp.data_ptr(), st.bkp.data_ptr(), st.book.data_ptr(), st.gathered.data_ptr(),
        st.gathered.shape[1], st.ranks, st.out_book.data_ptr(), st.out_bkp.data_ptr(),
        st.out_pred.data_ptr(), st.nhyp.data_ptr(), st.nbkp.data_ptr(),
        st.floor_key.data_ptr(), B, T, S, n_local, N, W, st.ctx0, int(t), int(recombine),
        int(step), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _native.check(err, "shard_entries")


def shard_ends_cuda(st: ShardState, t: int) -> None:
    """Kernel P's second launch on a CUDA state, as ``shard_ends`` makes it
    but not counted."""
    _check_cuda(st, "shard_ends")
    B = st.am.shape[0]
    n_local, N = st.hyp.shape[1:]
    W = st.book.shape[1]
    dev = st.am.device
    lib = _native.load()
    err = lib.sr_wcts_shard_ends(
        int(st.am.dtype == torch.float64), st.feat_len.data_ptr(), st.end_node.data_ptr(),
        st.lm_local.data_ptr(), st.floor_key.data_ptr(), st.nhyp.data_ptr(),
        st.nbkp.data_ptr(), st.hyp.data_ptr(), st.bkp.data_ptr(), st.send.data_ptr(), B,
        n_local, N, W, st.ctx0, int(t), st.thr, int(st.prune), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _native.check(err, "shard_ends")
