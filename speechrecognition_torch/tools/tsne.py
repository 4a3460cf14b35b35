"""t-SNE for NN-activation visualization — counterpart of
speechrecognition_tpu/tools/tsne.py.

The reference's vendored van-der-Maaten t-SNE (src/tSNE-plotting/tsne.py,
applied to activations dumped by the plot-activations action,
SieTill.cpp:152-179): exact O(N²) t-SNE. The perplexity search runs on the
host in numpy; the gradient loop runs on the device in float64, its
pairwise affinities and gradients dense matrix and elementwise ops; fine for
the few thousand frames one visualizes.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..models.gmm import pack_device


def _hbeta(D_row: np.ndarray, beta: float):
    P = np.exp(-D_row * beta)
    sumP = max(P.sum(), 1e-12)
    H = np.log(sumP) + beta * (D_row * P).sum() / sumP
    return H, P / sumP


def binary_search_perplexity(D: np.ndarray, perplexity: float = 30.0,
                             tol: float = 1e-5) -> np.ndarray:
    """Row-wise conditional affinities with the target perplexity
    (reference tsne.py x2p)."""
    n = D.shape[0]
    P = np.zeros((n, n))
    logU = np.log(perplexity)
    for i in range(n):
        idx = np.concatenate([np.arange(i), np.arange(i + 1, n)])
        beta, betamin, betamax = 1.0, -np.inf, np.inf
        Di = D[i, idx]
        H, thisP = _hbeta(Di, beta)
        for _ in range(50):
            if abs(H - logU) < tol:
                break
            if H > logU:
                betamin = beta
                beta = beta * 2 if betamax == np.inf else (beta + betamax) / 2
            else:
                betamax = beta
                beta = beta / 2 if betamin == -np.inf else (beta + betamin) / 2
            H, thisP = _hbeta(Di, beta)
        P[i, idx] = thisP
    return P


def _tsne_optimize(P: torch.Tensor, Y0: torch.Tensor, n_iter: int = 500) -> torch.Tensor:
    """``n_iter`` gradient steps with momentum and gains from ``Y0`` [N, 2]
    (float64, on P's device); the step count restarts at 0 on every call, so
    each call's first 20 steps take momentum 0.5."""
    n = P.shape[0]
    off_diag = 1.0 - torch.eye(n, dtype=P.dtype, device=P.device)
    Y, dY, gains = Y0, torch.zeros_like(Y0), torch.ones_like(Y0)
    for it in range(n_iter):
        sum_Y = (Y * Y).sum(dim=1)
        num = 1.0 / (1.0 + sum_Y[:, None] + sum_Y[None, :] - 2.0 * (Y @ Y.T))
        num = num * off_diag
        Q = torch.clamp(num / torch.clamp(num.sum(), min=1e-12), min=1e-12)
        PQ = (P - Q) * num
        grad = 4.0 * ((torch.diag(PQ.sum(dim=1)) - PQ) @ Y)
        momentum = 0.5 if it < 20 else 0.8
        gains = torch.where(torch.sign(grad) != torch.sign(dY), gains + 0.2, gains * 0.8)
        gains = torch.clamp(gains, min=0.01)
        dY = momentum * dY - 50.0 * gains * grad
        Y = Y + dY
        Y = Y - Y.mean(dim=0, keepdim=True)
    return Y


def tsne(X: np.ndarray, perplexity: float = 30.0, n_iter: int = 500,
         seed: int = 0, early_exaggeration: float = 4.0, device="cuda") -> np.ndarray:
    """[N, D] → [N, 2] embedding; the gradient loop runs on ``device`` (the
    card unless the caller asks for the CPU)."""
    device = pack_device(device, "t-SNE")
    X = np.asarray(X, np.float64)
    X = X - X.mean(axis=0)
    sq = (X * X).sum(axis=1)
    D = np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0)
    P = binary_search_perplexity(D, perplexity)
    P = (P + P.T) / max(P.sum(), 1e-12)
    rng = np.random.default_rng(seed)
    Y0 = torch.as_tensor(rng.normal(0, 1e-4, (X.shape[0], 2)), device=device)
    P = torch.as_tensor(P, device=device)
    Y = _tsne_optimize(P * early_exaggeration, Y0, n_iter=n_iter // 2)
    Y = _tsne_optimize(P, Y, n_iter=n_iter - n_iter // 2)
    return Y.cpu().numpy()


def dump_activations(mlp, params: Dict, feats: np.ndarray,
                     layer_names, out_dir: str) -> None:
    """Forward a batch on the MLP's device and write each named layer's
    activations as raw float32 (the plot-activations action,
    SieTill.cpp:152-179)."""
    os.makedirs(out_dir, exist_ok=True)
    x = torch.as_tensor(feats, dtype=torch.float32, device=mlp.device)
    with torch.no_grad():
        acts = mlp.apply(params, x)
    for name in layer_names:
        acts[name].cpu().numpy().astype(np.float32).tofile(
            os.path.join(out_dir, f"{name}.activations"))


def plot_tsne(Y: np.ndarray, labels: np.ndarray, out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(Y[:, 0], Y[:, 1], c=labels, s=4, cmap="tab20")
    fig.colorbar(sc, ax=ax, label="state")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
