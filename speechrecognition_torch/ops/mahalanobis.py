"""Batched diagonal-Mahalanobis GMM density scoring (kernel A).

score[n, j] = Σᵢ (x[n,i] − μ[j,i])² · a[j,i] + c[j]

with a = 1/(2σ²) and c = norm − log w, i.e. the reference's density score
(Mixtures.cpp:590-628). Counterpart of speechrecognition_tpu/ops/mahalanobis.py:
the centered form keeps f32 accumulation at the result's own magnitude
(~1e-6 relative), where the quadratic-expansion matmul loses ~1e-4 to
cancellation.

Two entry points of the hand-written CUDA kernel ``csrc/mahalanobis.cu``:

  * ``mahalanobis_scores``: every score, [N, J], the Pallas call's function;
  * ``mahalanobis_min_scores``: each mixture's minimum over its D density
    slots ``j = s·D + d``, capped at MIN_SCORE_INIT, [N, S] — the
    max-approximation's mixture scores, without the [N, J] scores ever
    reaching device memory.

Each launches the kernel on CUDA tensors and runs its plain PyTorch version
(``*_reference``) on CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _native

#: the Pallas wrapper's limit (its lane count); the kernel sizes its shared
#: memory from dim
MAX_DIM = 128
#: the max-approximation's cap on a mixture score (Mixtures.cpp:699), as
#: models/gmm.py's
MIN_SCORE_INIT = 1e10


def mahalanobis_scores_reference(x: torch.Tensor, mu: torch.Tensor,
                                 a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x [N, dim], mu/a [J, dim], c [J] → [N, J].

    Accumulates over the feature dim in ascending order, as the reference
    kernel's fori_loop does; works in the inputs' dtype and on their device."""
    N, dim = x.shape
    acc = torch.zeros((N, mu.shape[0]), dtype=x.dtype, device=x.device)
    for i in range(dim):
        d = x[:, i, None] - mu[None, :, i]
        acc = acc + d * d * a[None, :, i]
    return acc + c[None, :]


def mahalanobis_min_scores_reference(x: torch.Tensor, mu: torch.Tensor, a: torch.Tensor,
                                     c: torch.Tensor, D: int) -> torch.Tensor:
    """Plain PyTorch version of ``mahalanobis_min_scores``: the minimum of
    ``mahalanobis_scores_reference`` over each run of D slots, capped."""
    scores = mahalanobis_scores_reference(x, mu, a, c)
    return torch.clamp(scores.reshape(x.shape[0], -1, D).amin(dim=-1), max=MIN_SCORE_INIT)


def _check_inputs(what: str, x: torch.Tensor, mu: torch.Tensor, a: torch.Tensor,
                  c: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [N, dim], got shape {tuple(x.shape)}")
    N, dim = x.shape
    J = mu.shape[0]
    for name, t, shape in (("x", x, (N, dim)), ("mu", mu, (J, dim)),
                           ("a", a, (J, dim)), ("c", c, (J,))):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"{what}: feature dim {dim} outside 1..{MAX_DIM}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def mahalanobis_scores(x: torch.Tensor, mu: torch.Tensor, a: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """x [N, dim] f32, mu/a [J, dim] f32, c [J] f32 → scores [N, J] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``mahalanobis_scores.LAUNCHES``)."""
    if x.device.type == "cpu":
        return mahalanobis_scores_reference(x, mu, a, c)
    if x.device.type != "cuda":
        raise ValueError(f"mahalanobis_scores: unsupported device {x.device}")
    _check_inputs("mahalanobis_scores", x, mu, a, c)
    N, dim = x.shape
    J = mu.shape[0]
    if -(-J // 32) > 65535:
        raise ValueError(f"mahalanobis_scores: {J} density slots exceed one launch")
    out = torch.empty((N, J), dtype=torch.float32, device=x.device)
    err = _native.load().sr_mahalanobis_scores(
        x.data_ptr(), mu.data_ptr(), a.data_ptr(), c.data_ptr(), out.data_ptr(),
        N, J, dim, x.device.index, _stream(x))
    _native.check(err, "mahalanobis_scores")
    mahalanobis_scores.LAUNCHES += 1
    return out


mahalanobis_scores.LAUNCHES = 0


def mahalanobis_min_scores(x: torch.Tensor, mu: torch.Tensor, a: torch.Tensor,
                           c: torch.Tensor, D: int) -> torch.Tensor:
    """x [N, dim] f32, mu/a [J, dim] f32, c [J] f32, J = S·D → [N, S] f32:
    ``min(min_d score[n, s·D + d], MIN_SCORE_INIT)``.

    CPU tensors take the plain version; CUDA tensors launch the fused kernel
    (counted in ``mahalanobis_min_scores.LAUNCHES``)."""
    J = mu.shape[0]
    if D < 1 or J % D:
        raise ValueError(f"mahalanobis_min_scores: {J} density slots are not S·D with D = {D}")
    if x.device.type == "cpu":
        return mahalanobis_min_scores_reference(x, mu, a, c, D)
    if x.device.type != "cuda":
        raise ValueError(f"mahalanobis_min_scores: unsupported device {x.device}")
    _check_inputs("mahalanobis_min_scores", x, mu, a, c)
    N, dim = x.shape
    S = J // D
    if -(-S // 2) > 65535:
        raise ValueError(f"mahalanobis_min_scores: {S} mixtures exceed one launch")
    out = torch.empty((N, S), dtype=torch.float32, device=x.device)
    err = _native.load().sr_mahalanobis_min(
        x.data_ptr(), mu.data_ptr(), a.data_ptr(), c.data_ptr(), out.data_ptr(),
        N, S, D, dim, x.device.index, _stream(x))
    _native.check(err, "mahalanobis_min_scores")
    mahalanobis_min_scores.LAUNCHES += 1
    return out


mahalanobis_min_scores.LAUNCHES = 0


def pack_to_mahalanobis(model) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Flatten a host MixtureModel into (mu, a, c, active) arrays keyed by
    flat slot j = s·D + d, padded like ScorePack (inactive → c huge)."""
    from ..models.gmm import INACTIVE_SCORE

    S = model.num_mixtures
    D = model.max_densities_per_mixture
    dim = model.dim
    mu = np.zeros((S * D, dim), np.float32)
    a = np.zeros((S * D, dim), np.float32)
    c = np.full(S * D, np.float32(INACTIVE_SCORE), np.float32)
    active = np.zeros((S, D), bool)
    for s in range(S):
        for d, (mean_idx, var_idx) in enumerate(model.mixtures[s]):
            m_vec = model.means[mean_idx]
            iv = model.vars_inv[var_idx]
            cc = model.norm[var_idx] - model.mean_weights_log[mean_idx]
            if not (np.isfinite(m_vec).all() and np.isfinite(iv).all()
                    and np.isfinite(cc)):
                continue
            j = s * D + d
            mu[j] = m_vec
            a[j] = 0.5 * iv
            c[j] = cc
            active[s, d] = True
    return mu, a, c, active
