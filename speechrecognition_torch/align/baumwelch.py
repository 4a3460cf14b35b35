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
the other. Both follow the reference's ``_forward_backward`` step for step,
with two choices the reference leaves open:

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


def forward_backward_reference(lams: torch.Tensor, ltdp: torch.Tensor,
                               pos_valid: torch.Tensor, feat_len: torch.Tensor,
                               aut_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``forward_backward``, one frame per loop step
    (any float dtype, any device). Same contract."""
    B, T, A = lams.shape
    dtype, device = lams.dtype, lams.device
    neg_big = torch.tensor(NEG_BIG, dtype=dtype, device=device)
    half = neg_big * 0.5
    ltdp = ltdp.to(device=device, dtype=dtype)
    invalid = ~pos_valid.to(device=device, dtype=torch.bool)
    fl = feat_len.to(device=device, dtype=torch.long)
    al = aut_len.to(device=device, dtype=torch.long)
    pos = torch.arange(A, device=device)

    def mask(x):
        return torch.where(invalid, neg_big, x)

    # -- forward
    alpha = mask(torch.where(pos[None, :] == 0, lams[:, 0, :], neg_big))
    alphas = [alpha]
    shift_sum = torch.zeros(B, dtype=dtype, device=device)
    for t in range(1, T):
        c0 = alpha + ltdp[:, :, 0]
        c1 = _from_below(alpha, ltdp[:, :, 1], 1, neg_big)
        c2 = _from_below(alpha, ltdp[:, :, 2], 2, neg_big)
        new, shift = _renorm(mask(_lse3(c0, c1, c2, neg_big, half) + lams[:, t]), neg_big, half)
        alive = t < fl
        alpha = torch.where(alive[:, None], new, alpha)
        shift_sum = shift_sum + torch.where(alive, shift, torch.zeros_like(shift))
        alphas.append(alpha)

    # -- backward: beta at the last real frame allows only the final position
    beta_T = torch.where(pos[None, :] == (al - 1)[:, None], torch.zeros((), dtype=dtype,
                                                                        device=device), neg_big)
    betas = [beta_T]
    beta = beta_T
    for t in range(T - 2, -1, -1):
        term = beta + lams[:, t + 1]
        b0 = term + ltdp[:, :, 0]
        b1 = _from_above(term + ltdp[:, :, 1], 1, neg_big)
        b2 = _from_above(term + ltdp[:, :, 2], 2, neg_big)
        new, _ = _renorm(mask(_lse3(b0, b1, b2, neg_big, half)), neg_big, half)
        beta = torch.where((t >= fl - 1)[:, None], beta_T, new)
        betas.append(beta)
    betas.reverse()

    # -- posteriors
    alphas = torch.stack(alphas, dim=1)                     # [B, T, A]
    post = alphas + torch.stack(betas, dim=1)
    safe = torch.maximum(post.amax(dim=2, keepdim=True), half)
    p = torch.where(post <= half, torch.zeros((), dtype=dtype, device=device),
                    torch.exp(post - safe))
    gamma = p / torch.clamp(_row_sum(p), min=1e-30)
    frame_valid = torch.arange(T, device=device)[None, :] < fl[:, None]
    gamma = torch.where(frame_valid[:, :, None], gamma, torch.zeros((), dtype=dtype,
                                                                    device=device))
    # total log-probability: alpha at the forced final position of the last
    # frame (a negative index wraps once, as take_along_axis does) plus the
    # shifts
    last_t = torch.where(fl - 1 < 0, fl - 1 + T, fl - 1).clamp(0, T - 1)
    fz = torch.where(al - 1 < 0, al - 1 + A, al - 1).clamp(0, A - 1)
    rows = torch.arange(B, device=device)
    log_z = alphas[rows, last_t, fz] + shift_sum
    return gamma, log_z


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
    (float32 or float64; counted in ``forward_backward.LAUNCHES``), whose C
    entry chooses its instance from A alone
    (``sr_forward_backward_instance``): any A is taken. Launches whose rows
    live in device scratch (A > 1024) are also counted in
    ``SCRATCH_LAUNCHES``. The lengths are not range-checked here
    (``baum_welch_posteriors`` does that once, on the host)."""
    device = lams.device
    if device.type == "cpu":
        return forward_backward_reference(lams, ltdp, pos_valid, feat_len, aut_len)
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
    gamma = torch.empty((B, T, A), dtype=dtype, device=device)
    log_z = torch.empty((B,), dtype=dtype, device=device)
    lib = _native.load()
    # the block instance keeps its rows in device scratch past A = 1024
    scratch = (torch.empty(3 * B * A, dtype=dtype, device=device)
               if lib.sr_forward_backward_instance(A) < 0 else None)
    err = lib.sr_forward_backward(
        int(dtype == torch.float64), lams.data_ptr(), ltdp.data_ptr(), pv.data_ptr(),
        ints["feat_len"].data_ptr(), ints["aut_len"].data_ptr(), gamma.data_ptr(),
        log_z.data_ptr(), _native.ptr(scratch), B, T, A, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "forward_backward")
    forward_backward.LAUNCHES += 1
    forward_backward.SCRATCH_LAUNCHES += scratch is not None
    return gamma, log_z


forward_backward.LAUNCHES = forward_backward.SCRATCH_LAUNCHES = 0


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
