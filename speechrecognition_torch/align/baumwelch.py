"""Baum-Welch (forward-backward) soft alignment over the banded [B, A]
position lattice — counterpart of speechrecognition_tpu/align/baumwelch.py.

The Sprint aligner's ``modeBaumWelch`` (rwth-asr-0.5/src/Search/Aligner.hh:
41-43) weights each alignment arc with its posterior. Here the posteriors
come from a dense forward-backward over every utterance of a batch at once:
per frame a three-way logsumexp over the 0-1-2 jumps in place of the
Viterbi minimum, each row shifted by its maximum.

``forward_backward`` runs the two scans: its plain PyTorch version
``forward_backward_reference`` for CPU tensors, kernel L
(``csrc/forward_backward.cu``) for CUDA tensors, with no fallback from one to
the other. The plain version is three phases, as the kernel's instance for
A <= 1024 runs them: the forward rows and log_z (``forward_reference``), the
backward rows (``backward_reference``), both independent of each other,
and the posterior rows from the two (``posterior_reference``). Both follow
the reference's ``_forward_backward`` step for step, with two choices the
reference leaves open:

  * every constant is in the score type. The reference's NEG_BIG is a
    float64 numpy scalar, which promotes a float32 scan's carry to float64,
    and its float32 scan does not trace; here float32 runs in float32;
  * the posterior row's sum and the shift sum are taken in one fixed order
    (``_row_sum``; the shifts in frame order), which the kernel repeats.

Posterior pruning mirrors Sprint's minimum-weight cut on the weighted
alignment: weights below the threshold are dropped and each frame
renormalized, so the accumulation sees the reference's weighted
AlignmentItem semantics (src/sietill/Types.hpp:36-43,
src/sietill/Mixtures.cpp:278-372).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models import gmm as gmm_mod
from ..ops import _native
from .viterbi import AlignerTables

NEG_BIG = -1e30


def _lse3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, neg_big: torch.Tensor,
          half: torch.Tensor) -> torch.Tensor:
    """Elementwise logsumexp of three log-domain terms, NaN-free at NEG_BIG:
    the three exponentials summed in order."""
    m = torch.maximum(torch.maximum(a, b), c)
    safe = torch.maximum(m, half)  # all-dead triples stay at NEG_BIG
    out = safe + torch.log(torch.exp(a - safe) + torch.exp(b - safe) + torch.exp(c - safe))
    return torch.where(m <= half, neg_big, out)


def _row_sum(p: torch.Tensor) -> torch.Tensor:
    """[..., A] → [..., 1]: the row sum in kernel L's order. The row, padded
    with zeros, is cut into 32 chunks of K = ceil(A/32) positions; each
    chunk is summed in position order, then the 32 chunk sums pairwise at
    offsets 16, 8, 4, 2, 1 (the warp's butterfly)."""
    A = p.shape[-1]
    K = -(-A // 32)
    x = torch.nn.functional.pad(p, (0, 32 * K - A)).reshape(*p.shape[:-1], 32, K)
    s = x[..., 0]
    for k in range(1, K):
        s = s + x[..., k]
    for off in (16, 8, 4, 2, 1):
        s = s[..., :off] + s[..., off:2 * off]
    return s


def _from_below(x: torch.Tensor, tdp_k: torch.Tensor, k: int,
                neg_big: torch.Tensor) -> torch.Tensor:
    """x[:, a-k] + tdp_k[:, a] for a >= k, NEG_BIG below (the forward jump-k
    candidate)."""
    B, A = x.shape
    n = min(k, A)
    return torch.cat([neg_big.expand(B, n), x[:, :A - n] + tdp_k[:, n:]], dim=1)


def _from_above(y: torch.Tensor, k: int, neg_big: torch.Tensor) -> torch.Tensor:
    """y[:, a+k] for a+k < A, NEG_BIG above (the backward jump-k candidate)."""
    B, A = y.shape
    n = min(k, A)
    return torch.cat([y[:, n:], neg_big.expand(B, n)], dim=1)


def _renorm(x: torch.Tensor, neg_big: torch.Tensor,
            half: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row shifted by its maximum (0 for a dead row), cells at or below
    NEG_BIG/2 set to NEG_BIG; returns (row, shift [B])."""
    row_max = x.amax(dim=1, keepdim=True)
    shift = torch.where(row_max <= half, torch.zeros_like(row_max), row_max)
    return torch.where(x <= half, neg_big, x - shift), shift[:, 0]


def order_key_max(x: torch.Tensor) -> torch.Tensor:
    """[..., n] → [...]: the maximum over the last axis as kernel L's two
    chains and posterior pass take it (``keys::warp_maximum`` in
    ``csrc/keys.cuh``). Each value becomes its order-preserving unsigned key
    (formed from x + 0, so −0 counts as +0), the keys' maximum is taken and
    mapped back; in float64 the high 32 bits first, then the low 32 bits
    among the values whose high half is the largest, as redux.sync takes
    32-bit operands. Exact, so equal to ``amax`` wherever no −0 is the
    maximum (which comes back as +0). A plain version for the tests: the
    plain recursions take ``amax``."""
    x = x + 0.0
    if x.dtype == torch.float32:
        u = x.view(torch.int32).long() & 0xFFFFFFFF
        key = torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | 1 << 31)
        km = key.amax(dim=-1)
        v = torch.where(km >= 1 << 31, km & 0x7FFFFFFF, ~km & 0xFFFFFFFF)
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32).view(torch.float32)
    if x.dtype != torch.float64:
        raise TypeError(f"order_key_max: float32 or float64, got {x.dtype}")
    u = x.view(torch.int64)
    key = torch.where(u < 0, ~u, u | -(1 << 63))      # as unsigned 64-bit bits
    hi, lo = (key >> 32) & 0xFFFFFFFF, key & 0xFFFFFFFF
    hi_max = hi.amax(dim=-1, keepdim=True)
    lo_max = torch.where(hi == hi_max, lo, torch.zeros_like(lo)).amax(dim=-1, keepdim=True)
    km = ((hi_max << 32) | lo_max)[..., 0]
    return torch.where(km < 0, km & ~(-(1 << 63)), ~km).view(torch.float64)


def _fb_tables(lams: torch.Tensor, ltdp: torch.Tensor, pos_valid: torch.Tensor,
               feat_len: torch.Tensor, aut_len: torch.Tensor):
    """The plain phases' shared inputs on the emissions' device and type:
    (NEG_BIG, its half, ltdp, invalid positions, feat_len, aut_len, the
    position index)."""
    dtype, device = lams.dtype, lams.device
    neg_big = torch.tensor(NEG_BIG, dtype=dtype, device=device)
    return (neg_big, neg_big * 0.5, ltdp.to(device=device, dtype=dtype),
            ~pos_valid.to(device=device, dtype=torch.bool),
            feat_len.to(device=device, dtype=torch.long),
            aut_len.to(device=device, dtype=torch.long), torch.arange(lams.shape[2],
                                                                      device=device))


def forward_reference(lams: torch.Tensor, ltdp: torch.Tensor, pos_valid: torch.Tensor,
                      feat_len: torch.Tensor, aut_len: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward phase, one frame per loop step: (alpha rows [B, T, A],
    each row shifted by its maximum and kept from feat_len on; log_z [B],
    alpha at the forced final position of the last frame, a negative index
    wrapping once as take_along_axis does, plus the shifts summed in frame
    order). Kernel L's forward chain computes the rows below feat_len."""
    B, T, A = lams.shape
    neg_big, half, ltdp, invalid, fl, al, pos = _fb_tables(lams, ltdp, pos_valid, feat_len,
                                                           aut_len)
    alpha = torch.where(invalid, neg_big, torch.where(pos[None, :] == 0, lams[:, 0, :],
                                                      neg_big))
    alphas = [alpha]
    shift_sum = torch.zeros(B, dtype=lams.dtype, device=lams.device)
    for t in range(1, T):
        c0 = alpha + ltdp[:, :, 0]
        c1 = _from_below(alpha, ltdp[:, :, 1], 1, neg_big)
        c2 = _from_below(alpha, ltdp[:, :, 2], 2, neg_big)
        new, shift = _renorm(torch.where(invalid, neg_big,
                                         _lse3(c0, c1, c2, neg_big, half) + lams[:, t]),
                             neg_big, half)
        alive = t < fl
        alpha = torch.where(alive[:, None], new, alpha)
        shift_sum = shift_sum + torch.where(alive, shift, torch.zeros_like(shift))
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)
    last_t = torch.where(fl - 1 < 0, fl - 1 + T, fl - 1).clamp(0, T - 1)
    fz = torch.where(al - 1 < 0, al - 1 + A, al - 1).clamp(0, A - 1)
    log_z = alphas[torch.arange(B, device=lams.device), last_t, fz] + shift_sum
    return alphas, log_z


def backward_reference(lams: torch.Tensor, ltdp: torch.Tensor, pos_valid: torch.Tensor,
                       feat_len: torch.Tensor, aut_len: torch.Tensor) -> torch.Tensor:
    """The backward phase, one frame per loop step: beta rows [B, T, A], 0
    at the final position aut_len - 1 and NEG_BIG elsewhere from frame
    feat_len - 1 on, below it masked and shifted by its maximum as the
    forward rows. Kernel L's backward chain computes the rows up to
    feat_len - 1."""
    T = lams.shape[1]
    neg_big, half, ltdp, invalid, fl, al, pos = _fb_tables(lams, ltdp, pos_valid, feat_len,
                                                           aut_len)
    beta_T = torch.where(pos[None, :] == (al - 1)[:, None],
                         torch.zeros((), dtype=lams.dtype, device=lams.device), neg_big)
    betas = [beta_T]
    beta = beta_T
    for t in range(T - 2, -1, -1):
        term = beta + lams[:, t + 1]
        b0 = term + ltdp[:, :, 0]
        b1 = _from_above(term + ltdp[:, :, 1], 1, neg_big)
        b2 = _from_above(term + ltdp[:, :, 2], 2, neg_big)
        new, _ = _renorm(torch.where(invalid, neg_big, _lse3(b0, b1, b2, neg_big, half)),
                         neg_big, half)
        beta = torch.where((t >= fl - 1)[:, None], beta_T, new)
        betas.append(beta)
    betas.reverse()
    return torch.stack(betas, dim=1)


def posterior_reference(alphas: torch.Tensor, betas: torch.Tensor,
                        feat_len: torch.Tensor) -> torch.Tensor:
    """The posterior rows [B, T, A] from the alpha and beta rows: post =
    alpha + beta, shifted by its maximum floored at NEG_BIG/2,
    exponentiated (0 at or below NEG_BIG/2), divided by max(the row sum in
    ``_row_sum``'s order, 1e-30); rows at or past feat_len are 0. Kernel
    L's posterior pass computes the same rows."""
    dtype, device = alphas.dtype, alphas.device
    T = alphas.shape[1]
    half = torch.tensor(NEG_BIG, dtype=dtype, device=device) * 0.5
    zero = torch.zeros((), dtype=dtype, device=device)
    post = alphas + betas
    safe = torch.maximum(post.amax(dim=2, keepdim=True), half)
    p = torch.where(post <= half, zero, torch.exp(post - safe))
    gamma = p / torch.clamp(_row_sum(p), min=1e-30)
    fl = feat_len.to(device=device, dtype=torch.long)
    frame_valid = torch.arange(T, device=device)[None, :] < fl[:, None]
    return torch.where(frame_valid[:, :, None], gamma, zero)


def forward_backward_reference(lams: torch.Tensor, ltdp: torch.Tensor,
                               pos_valid: torch.Tensor, feat_len: torch.Tensor,
                               aut_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``forward_backward`` (any float dtype, any
    device): the forward phase, the backward phase and the posterior rows
    from their rows. Same contract."""
    alphas, log_z = forward_reference(lams, ltdp, pos_valid, feat_len, aut_len)
    betas = backward_reference(lams, ltdp, pos_valid, feat_len, aut_len)
    return posterior_reference(alphas, betas, feat_len), log_z


def forward_backward(lams: torch.Tensor, ltdp: torch.Tensor, pos_valid: torch.Tensor,
                     feat_len: torch.Tensor, aut_len: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior occupation over the banded lattice.

    lams [B, T, A]: log-domain emission (= −score) per position; ltdp
    [B, A, 3]: log-domain transition (= −penalty) into position a with jump
    j; pos_valid bool [B, A]; feat_len, aut_len int [B]. Returns (gamma
    [B, T, A], posteriors summing to 1 over the valid positions of each
    frame < feat_len and 0 elsewhere, log_z [B] the total path
    log-probability). The automaton starts in position 0 and ends in
    position aut_len - 1 (src/sietill/Alignment.cpp:60-66,139).

    CPU tensors take the plain version; CUDA tensors launch kernel L
    (float32 or float64, ``forward_backward_cuda``), whose C entry chooses
    its instance from A alone (``sr_forward_backward_instance``): any A is
    taken. ``forward_backward.LAUNCHES`` counts the calls that launch it,
    one a call, though the instance of A <= 1024 makes two launches (its
    chains, then its posterior pass); calls whose rows live in device
    scratch (A > 1024) are also counted in ``SCRATCH_LAUNCHES``. The
    lengths are not range-checked here (``baum_welch_posteriors`` does
    that once, on the host)."""
    device = lams.device
    if device.type == "cpu":
        return forward_backward_reference(lams, ltdp, pos_valid, feat_len, aut_len)
    gamma, log_z, in_scratch = forward_backward_cuda(lams, ltdp, pos_valid, feat_len, aut_len)
    forward_backward.LAUNCHES += 1
    forward_backward.SCRATCH_LAUNCHES += in_scratch
    return gamma, log_z


forward_backward.LAUNCHES = forward_backward.SCRATCH_LAUNCHES = 0


def _cuda_args(lams: torch.Tensor, ltdp: torch.Tensor, pos_valid: torch.Tensor,
               feat_len: torch.Tensor, aut_len: torch.Tensor):
    """Kernel L's checked arguments: (pos_valid as uint8, feat_len and
    aut_len as int32) on the emissions' card; raises on what it does not
    take."""
    device = lams.device
    if device.type != "cuda":
        raise ValueError(f"forward_backward: unsupported device {device}")
    dtype = lams.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"forward_backward: the CUDA kernel runs float32 or float64, got {dtype}")
    if lams.dim() != 3 or not lams.is_contiguous():
        raise ValueError("forward_backward: lams must be a contiguous [B, T, A] tensor")
    B, T, A = lams.shape
    if ltdp.device != device or ltdp.dtype != dtype or tuple(ltdp.shape) != (B, A, 3) \
            or not ltdp.is_contiguous():
        raise ValueError(f"forward_backward: ltdp must be a contiguous {dtype} {(B, A, 3)} "
                         f"tensor on {device}")
    pv = _native.typed_args("forward_backward", device, torch.uint8,
                            pos_valid=(pos_valid, (B, A)))["pos_valid"]
    ints = _native.typed_args("forward_backward", device, torch.int32,
                              feat_len=(feat_len, (B,)), aut_len=(aut_len, (B,)))
    return pv, ints["feat_len"], ints["aut_len"]


def forward_backward_cuda(lams: torch.Tensor, ltdp: torch.Tensor, pos_valid: torch.Tensor,
                          feat_len: torch.Tensor, aut_len: torch.Tensor,
                          first_design: bool = False):
    """Kernel L's launch on CUDA tensors, as ``forward_backward`` makes it
    but not counted: returns (gamma, log_z, whether the rows lived in device
    scratch). For A <= 1024 the wrapper allocates the backward chain's rows
    ([B, T, A] in the score type); ``first_design`` launches the first
    design there instead (up to A = 96 a warp an utterance, past it a block
    an utterance, the posterior on the backward chain), so that the two can
    be timed in turns."""
    pv, fl, al = _cuda_args(lams, ltdp, pos_valid, feat_len, aut_len)
    B, T, A = lams.shape
    dtype, device = lams.dtype, lams.device
    gamma = torch.empty((B, T, A), dtype=dtype, device=device)
    log_z = torch.empty((B,), dtype=dtype, device=device)
    lib = _native.load()
    inst = lib.sr_forward_backward_instance(A)
    # the block instance keeps its rows in device scratch past A = 1024
    scratch = torch.empty(3 * B * A, dtype=dtype, device=device) if inst < 0 else None
    beta = (torch.empty((B, T, A), dtype=dtype, device=device)
            if inst > 0 and not first_design else None)
    err = lib.sr_forward_backward(
        int(dtype == torch.float64), lams.data_ptr(), ltdp.data_ptr(), pv.data_ptr(),
        fl.data_ptr(), al.data_ptr(), gamma.data_ptr(), log_z.data_ptr(), _native.ptr(scratch),
        _native.ptr(beta), B, T, A, int(bool(first_design)), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "forward_backward")
    return gamma, log_z, scratch is not None


def forward_backward_chain_cuda(chain: int, lams: torch.Tensor, ltdp: torch.Tensor,
                                pos_valid: torch.Tensor, feat_len: torch.Tensor,
                                aut_len: torch.Tensor) -> torch.Tensor:
    """One chain of kernel L's two chains (A <= 1024) alone, not counted,
    for timing the two chains apart: chain 0 returns the
    forward rows ([B, T, A], as ``forward_reference``'s below feat_len) and
    log_z in a tuple, chain 1 the backward rows (as
    ``backward_reference``'s up to feat_len - 1). Rows past those are not
    written."""
    pv, fl, al = _cuda_args(lams, ltdp, pos_valid, feat_len, aut_len)
    B, T, A = lams.shape
    dtype, device = lams.dtype, lams.device
    rows = torch.empty((B, T, A), dtype=dtype, device=device)
    log_z = torch.empty((B,), dtype=dtype, device=device)
    err = _native.load().sr_forward_backward_chain(
        int(dtype == torch.float64), int(chain), lams.data_ptr(), ltdp.data_ptr(), pv.data_ptr(),
        fl.data_ptr(), al.data_ptr(), rows.data_ptr() if chain == 0 else None,
        log_z.data_ptr(), rows.data_ptr() if chain == 1 else None, B, T, A, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "forward_backward_chain")
    return (rows, log_z) if chain == 0 else rows


def _check_lengths(feat_len: np.ndarray, T: int, tables: AlignerTables) -> None:
    """Raise unless every utterance has 1..T frames and an automaton of
    1..A positions (once, on the host, before the tables go to a device)."""
    A = tables.states.shape[1]
    if feat_len.size and (feat_len.min() < 1 or feat_len.max() > T):
        raise ValueError(f"baum_welch_posteriors: feat_len outside [1, {T}]")
    if tables.lengths.size and (tables.lengths.min() < 1 or tables.lengths.max() > A):
        raise ValueError(f"baum_welch_posteriors: automaton lengths outside [1, {A}]")


def baum_welch_posteriors(pack, feats, feat_len, tables: AlignerTables,
                          weight_threshold: float = 0.0, dtype=torch.float32,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior position occupancies for a padded batch, on the pack's
    device.

    pack: gmm.ScorePack; feats float32 [B, T, dim] (numpy, or a tensor on
    the pack's device); feat_len int [B]. Returns (gamma [B, T, A], log_z
    [B]) in ``dtype``. ``weight_threshold`` drops posteriors below the cut
    and renormalizes each frame (Sprint's minimum-weight pruning on
    weighted alignments)."""
    device = pack.device
    feats = torch.as_tensor(feats, dtype=torch.float32, device=device)
    B, T, dim = feats.shape
    fl = np.asarray(feat_len).astype(np.int32)
    _check_lengths(fl, T, tables)
    am = gmm_mod.am_scores(pack, feats.reshape(B * T, dim)).reshape(B, T, pack.num_mixtures)
    states = torch.as_tensor(tables.states, dtype=torch.long, device=device)
    A = states.shape[1]
    ams = am.gather(2, states[:, None, :].expand(B, T, A)).to(dtype)
    lengths = torch.as_tensor(tables.lengths, dtype=torch.int32, device=device)
    pos_valid = torch.arange(A, device=device)[None, :] < lengths[:, None]
    ltdp = -torch.as_tensor(tables.tdp, dtype=dtype, device=device)
    gamma, log_z = forward_backward((-ams).contiguous(), ltdp.contiguous(), pos_valid,
                                    torch.as_tensor(fl, device=device), lengths)
    if weight_threshold > 0.0:
        gamma = torch.where(gamma < weight_threshold, torch.zeros((), dtype=dtype,
                                                                  device=device), gamma)
        denom = gamma.sum(dim=2, keepdim=True)
        gamma = torch.where(denom > 0, gamma / torch.clamp(denom, min=1e-30),
                            torch.zeros((), dtype=dtype, device=device))
    return gamma, log_z


def accumulate_baum_welch(pack, feats: torch.Tensor, gamma: torch.Tensor,
                          states_tbl: torch.Tensor,
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EM sufficient statistics from soft (posterior-weighted) alignments,
    on the pack's device.

    feats float32 [B, T, dim]; gamma [B, T, A] position posteriors (0 on
    padding); states_tbl int [B, A] global state per position. Returns
    (w [S, D], xs [S, D, dim], x2s [S, D, dim]) in float64, the layout of
    gmm.accumulate_chunk, each (frame, position) pair counted at its
    posterior weight (src/sietill/Mixtures.cpp:278-372 in weighted form).
    Density membership follows the pack's max-approx / sum setting on the
    frame's features, as the hard path does. The posterior is folded onto
    states and the two sums over frames are products: a fixed order on the
    card, where index_add_ would add in the order its atomics land."""
    device = pack.device
    feats = torch.as_tensor(feats, dtype=torch.float32, device=device)
    gamma = torch.as_tensor(gamma, device=device)
    B, T, A = gamma.shape
    dim = feats.shape[2]
    S, D = pack.num_mixtures, pack.density_cap
    flat = feats.reshape(B * T, dim)
    sc = gmm_mod.density_scores(pack, flat)                    # [B·T, S, D]
    if pack.max_approx:
        memb = torch.nn.functional.one_hot(sc.argmin(dim=-1), D).to(pack.dtype)
    else:
        p = torch.exp(-(sc - sc.amin(dim=-1, keepdim=True)))
        memb = p / p.sum(dim=-1, keepdim=True)
        memb = torch.where(memb < gmm_mod.MEMBERSHIP_EPS, 0.0, memb)
    # occ[b, t, s] = Σ_a γ[b, t, a] · 1[state(b, a) = s]
    onehot = torch.nn.functional.one_hot(torch.as_tensor(states_tbl, device=device).long(),
                                         S).to(gamma.dtype)              # [B, A, S]
    with gmm_mod._full_f32_matmul():
        occ = torch.bmm(gamma, onehot).reshape(B * T, S)
    g64 = (occ[:, :, None] * memb).to(torch.float64).reshape(B * T, S * D)
    f64 = flat.to(torch.float64)
    w = g64.sum(dim=0).reshape(S, D)
    gT = g64.t()
    xs = (gT @ f64).reshape(S, D, dim)
    x2s = (gT @ (f64 * f64)).reshape(S, D, dim)
    return w, xs, x2s


def best_path_from_posteriors(gamma, tables: AlignerTables) -> np.ndarray:
    """Per-frame argmax state from the posterior lattice (the 1-best view of
    a Baum-Welch alignment). Returns int32 [B, T] global states."""
    g = gamma.cpu().numpy() if isinstance(gamma, torch.Tensor) else np.asarray(gamma)
    pos = g.argmax(axis=2)
    return np.take_along_axis(tables.states, pos, axis=1).astype(np.int32)
