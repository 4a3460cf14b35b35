"""Batched diagonal-Mahalanobis GMM density scoring (kernel A).

score[n, j] = Σᵢ (x[n,i] − μ[j,i])² · a[j,i] + c[j]

with a = 1/(2σ²) and c = norm − log w, i.e. the reference's density score
(Mixtures.cpp:590-628). Counterpart of speechrecognition_tpu/ops/mahalanobis.py:
the centered form keeps f32 accumulation at the result's own magnitude
(~1e-6 relative), where the quadratic-expansion matmul loses ~1e-4 to
cancellation.

``mahalanobis_scores`` launches the hand-written CUDA kernel
``csrc/mahalanobis.cu`` on CUDA tensors and runs the plain PyTorch version
``mahalanobis_scores_reference`` on CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _native

#: the kernel stages [dim][64]-tiles of x, μ and a in 48 KB of shared memory
MAX_DIM = 64


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


def mahalanobis_scores(x: torch.Tensor, mu: torch.Tensor, a: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """x [N, dim] f32, mu/a [J, dim] f32, c [J] f32 → scores [N, J] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``mahalanobis_scores.LAUNCHES``)."""
    if x.device.type == "cpu":
        return mahalanobis_scores_reference(x, mu, a, c)
    if x.device.type != "cuda":
        raise ValueError(f"mahalanobis_scores: unsupported device {x.device}")
    N, dim = x.shape
    J = mu.shape[0]
    for name, t, shape in (("x", x, (N, dim)), ("mu", mu, (J, dim)),
                           ("a", a, (J, dim)), ("c", c, (J,))):
        if t.device != x.device:
            raise ValueError(f"mahalanobis_scores: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"mahalanobis_scores: {name} is {t.dtype}, the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"mahalanobis_scores: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"mahalanobis_scores: {name} is not contiguous")
    if dim > MAX_DIM:
        raise ValueError(f"mahalanobis_scores: feature dim {dim} exceeds {MAX_DIM}")
    if N > 65535 * 64:
        raise ValueError(f"mahalanobis_scores: {N} frames exceed one launch; chunk them")
    out = torch.empty((N, J), dtype=torch.float32, device=x.device)
    lib = _native.load()
    err = lib.sr_mahalanobis_scores(
        x.data_ptr(), mu.data_ptr(), a.data_ptr(), c.data_ptr(), out.data_ptr(),
        N, J, dim, x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _native.check(err, "mahalanobis_scores")
    mahalanobis_scores.LAUNCHES += 1
    return out


mahalanobis_scores.LAUNCHES = 0


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
