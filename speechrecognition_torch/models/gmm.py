"""Diagonal-covariance GMM acoustic model: host state and device scoring.

Counterpart of speechrecognition_tpu/models/gmm.py, scoring half. The
bookkeeping (density lists, finalization) lives on the host in float64 numpy
and mirrors the reference exactly (src/sietill/Mixtures.cpp). Scoring runs on
the pack's device, by one of two methods:

    "mxu":    score[t, (s,d)] = [x², x, 1]ₜ · P[:, (s,d)]      (one matmul)
    "pallas": score[t, (s,d)] = Σᵢ (xᵢ−μᵢ)²·aᵢ + c            (kernel A)

The names follow the reference package: "mxu" is the quadratic expansion as
a plain matrix product, "pallas" the centered form that
ops/mahalanobis.py computes with a hand-written CUDA kernel.

Score semantics match Mixtures.cpp:590-744: score = norm + ½·Mahalanobis
− log w; mixture score is the min over densities clipped at 1e10
(max-approx, ::696-713) or −log Σ exp(−score) (sum, ::719-728).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io import RawMixtureSet

MIN_SCORE_INIT = 1e10      # Mixtures.cpp:699
INACTIVE_SCORE = 5e17      # sentinel for padded density slots (f32-safe, < inf)
MIN_VARIANCE = 1e-4        # Mixtures.cpp:167 (var accumulator floor)


class VarianceModel(enum.Enum):
    GLOBAL_POOLING = "global"
    MIXTURE_POOLING = "mixture"
    NO_POOLING = "none"

    @staticmethod
    def from_string(s: str) -> "VarianceModel":
        for v in VarianceModel:
            if v.value == s:
                return v
        raise ValueError(f"invalid pooling option: {s}")


@dataclass
class ScorePack:
    """Device-side packed scoring tables for one model snapshot.

    Two scoring methods:
      * "mxu": quadratic expansion [x², x, 1] · P as one matmul — fastest,
        but float32 loses ~1e-4 to cancellation;
      * "pallas": centered (x−μ)²·a kernel (ops/mahalanobis.py) — f32 with
        ~1e-6 accuracy, used for decode paths that must reproduce the
        reference's double-precision decisions.
    """

    P: torch.Tensor           # f32/f64 [2·dim+1, S·D] quadratic-expansion matrix
    active: torch.Tensor      # bool [S, D]
    num_mixtures: int
    density_cap: int
    dim: int
    max_approx: bool
    dtype: torch.dtype
    method: str = "mxu"
    mu: Optional[torch.Tensor] = None   # f32 [S·D, dim] (pallas)
    a: Optional[torch.Tensor] = None    # f32 [S·D, dim] (pallas)
    c: Optional[torch.Tensor] = None    # f32 [S·D] (pallas)

    @property
    def device(self) -> torch.device:
        return self.P.device

    def features_expanded(self, x: torch.Tensor) -> torch.Tensor:
        """[N, dim] → [N, 2·dim+1] = [x², x, 1]."""
        ones = torch.ones((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
        return torch.cat([x * x, x, ones], dim=-1)


class MixtureModel:
    """Host-side GMM state (flat f64 arrays, reference-identical indices)."""

    def __init__(self, dim: int, num_mixtures: int,
                 var_model: VarianceModel = VarianceModel.MIXTURE_POOLING,
                 max_approx: bool = True):
        self.dim = dim
        self.num_mixtures = num_mixtures
        self.var_model = var_model
        self.max_approx = max_approx

        # flat per-mean / per-var arrays (grow on split, never shrink)
        self.means = np.zeros((0, dim))
        self.mean_acc = np.zeros((0, dim))
        self.mean_weights = np.zeros(0)
        self.mean_weights_log = np.zeros(0)
        self.mean_weight_acc = np.zeros(0)
        self.mean_refs = np.zeros(0, dtype=np.int64)

        self.vars = np.zeros((0, dim))
        self.vars_inv = np.zeros((0, dim))
        self.var_acc = np.zeros((0, dim))
        self.var_weight_acc = np.zeros(0)
        self.var_refs = np.zeros(0, dtype=np.int64)
        self.norm = np.zeros(0)

        # mixtures_[m] = list of (mean_idx, var_idx)
        self.mixtures: List[List[Tuple[int, int]]] = [[] for _ in range(num_mixtures)]

        for m in range(num_mixtures):
            if var_model != VarianceModel.GLOBAL_POOLING:
                md = self._create_density(len(self.mean_refs), len(self.var_refs))
            else:
                md = self._create_density(len(self.mean_refs), 0)
            self.mixtures[m].append(md)

    # -- construction helpers ------------------------------------------------

    def _append_mean_slot(self) -> None:
        self.means = np.vstack([self.means, np.zeros((1, self.dim))])
        self.mean_acc = np.vstack([self.mean_acc, np.zeros((1, self.dim))])
        self.mean_weights = np.append(self.mean_weights, 0.0)
        self.mean_weights_log = np.append(self.mean_weights_log, 0.0)
        self.mean_weight_acc = np.append(self.mean_weight_acc, 0.0)
        self.mean_refs = np.append(self.mean_refs, 1)

    def _append_var_slot(self) -> None:
        self.vars = np.vstack([self.vars, np.zeros((1, self.dim))])
        self.vars_inv = np.vstack([self.vars_inv, np.zeros((1, self.dim))])
        self.var_acc = np.vstack([self.var_acc, np.full((1, self.dim), MIN_VARIANCE)])
        self.var_weight_acc = np.append(self.var_weight_acc, 0.0)
        self.var_refs = np.append(self.var_refs, 1)
        self.norm = np.append(self.norm, 0.0)

    def _create_density(self, mean_idx: int, var_idx: int) -> Tuple[int, int]:
        """Mirrors Mixtures.cpp:205-233 (reuses var slot when it exists)."""
        self._append_mean_slot()
        if var_idx >= len(self.var_refs):
            self._append_var_slot()
        return (mean_idx, var_idx)

    # -- EM bookkeeping ------------------------------------------------------

    def _calculate_variance(self, var_idx: int, mean_vec: np.ndarray) -> None:
        """E[X²]−E[X]² + norm term (Mixtures.cpp:251-275). Degenerate
        inputs flow through as nan/inf, like the C++ double math."""
        with np.errstate(divide="ignore", invalid="ignore"):
            v = self.var_acc[var_idx] / self.var_weight_acc[var_idx]
            v = v - mean_vec * mean_vec
            self.vars[var_idx] = v
            self.vars_inv[var_idx] = 1.0 / v
            self.norm[var_idx] = (self.dim * math.log(2 * math.pi)
                                  + np.log(v).sum()) / 2.0

    def finalize(self) -> None:
        """M-step (Mixtures.cpp:374-461). Zero-count densities yield nan
        means and −inf log-weights exactly like the C++ double arithmetic;
        they are skipped by scoring (see pack()) — do not raise."""
        total_observations = 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            for m in range(self.num_mixtures):
                total_mix = 0.0
                for (mean_idx, var_idx) in self.mixtures[m]:
                    total_mix += self.mean_weight_acc[mean_idx]
                    self.means[mean_idx] = self.mean_acc[mean_idx] / self.mean_weight_acc[mean_idx]
                    if self.var_model == VarianceModel.NO_POOLING:
                        self._calculate_variance(var_idx, self.means[mean_idx])
                for (mean_idx, _var_idx) in self.mixtures[m]:
                    self.mean_weights[mean_idx] = self.mean_weight_acc[mean_idx] / total_mix
                    self.mean_weights_log[mean_idx] = np.log(self.mean_weights[mean_idx])
                if self.var_model == VarianceModel.MIXTURE_POOLING \
                        and self.mixtures[m]:
                    # empty mixtures occur when elimination drops every
                    # density of an unobserved class (LVCSR state tying)
                    mixture_mean = np.zeros(self.dim)
                    for (mean_idx, _v) in self.mixtures[m]:
                        mixture_mean += self.mean_acc[mean_idx]
                    mixture_mean /= total_mix
                    self._calculate_variance(self.mixtures[m][0][1], mixture_mean)
                total_observations += total_mix

            if self.var_model == VarianceModel.GLOBAL_POOLING:
                global_mean = np.zeros(self.dim)
                for m in range(self.num_mixtures):
                    for (mean_idx, _v) in self.mixtures[m]:
                        global_mean += self.mean_acc[mean_idx]
                global_mean /= total_observations
                self._calculate_variance(0, global_mean)

    @property
    def max_densities_per_mixture(self) -> int:
        return max(len(m) for m in self.mixtures)

    @staticmethod
    def from_raw(raw: RawMixtureSet, var_model: VarianceModel,
                 max_approx: bool) -> "MixtureModel":
        """Load + re-finalize, as Mixtures.cpp::read() (::748-830)."""
        model = MixtureModel.__new__(MixtureModel)
        model.dim = raw.dim
        model.num_mixtures = len(raw.mixtures)
        model.var_model = var_model
        model.max_approx = max_approx

        n_means = raw.mean_acc.shape[0]
        n_vars = raw.var_acc.shape[0]
        model.mean_acc = raw.mean_acc.copy()
        model.mean_weight_acc = raw.mean_weight.copy()
        model.means = np.zeros_like(model.mean_acc)
        model.mean_weights = np.zeros(n_means)
        model.mean_weights_log = np.zeros(n_means)
        model.mean_refs = np.zeros(n_means, dtype=np.int64)

        model.var_acc = raw.var_acc.copy()
        model.var_weight_acc = raw.var_weight.copy()
        model.vars = np.zeros_like(model.var_acc)
        model.vars_inv = np.zeros_like(model.var_acc)
        model.var_refs = np.zeros(n_vars, dtype=np.int64)
        model.norm = np.zeros(n_vars)

        model.mixtures = []
        for ids in raw.mixtures:
            lst = []
            for d in ids:
                mean_idx, var_idx = int(raw.densities[d, 0]), int(raw.densities[d, 1])
                model.mean_refs[mean_idx] += 1
                model.var_refs[var_idx] += 1
                lst.append((mean_idx, var_idx))
            model.mixtures.append(lst)
        model.finalize()
        return model

    # -- device packing ------------------------------------------------------

    def pack(self, dtype: torch.dtype = torch.float32,
             density_cap: Optional[int] = None, method: str = "mxu",
             device="cpu") -> ScorePack:
        """Scoring tables on ``device``. ``method="pallas"`` also uploads the
        f32 centered-form tables (mu, a, c) that kernel A reads."""
        if method not in ("mxu", "pallas"):
            raise ValueError(f"unknown scoring method: {method}")
        S = self.num_mixtures
        D = density_cap or self.max_densities_per_mixture
        dim = self.dim
        A = np.zeros((S, D, dim))
        B = np.zeros((S, D, dim))
        C = np.full((S, D), float(INACTIVE_SCORE))
        active = np.zeros((S, D), dtype=bool)
        for s in range(S):
            for d, (mean_idx, var_idx) in enumerate(self.mixtures[s]):
                iv = self.vars_inv[var_idx]
                mu = self.means[mean_idx]
                a = 0.5 * iv
                b = -mu * iv
                c = (0.5 * np.sum(mu * mu * iv) + self.norm[var_idx]
                     - self.mean_weights_log[mean_idx])
                # zero-count densities have nan means / −inf log-weights;
                # the reference's nan scores are skipped by every strict-<
                # comparison (Mixtures.cpp:706), equivalent to "inactive"
                if not (np.isfinite(a).all() and np.isfinite(b).all()
                        and np.isfinite(c)):
                    continue
                A[s, d] = a
                B[s, d] = b
                C[s, d] = c
                active[s, d] = True
        P = np.concatenate([A.reshape(S * D, dim).T,
                            B.reshape(S * D, dim).T,
                            C.reshape(1, S * D)], axis=0)
        mu = a = c = None
        if method == "pallas":
            from ..ops.mahalanobis import pack_to_mahalanobis
            mu_np, a_np, c_np, _act = pack_to_mahalanobis(self)
            if D != self.max_densities_per_mixture:
                raise ValueError("pallas pack does not support density_cap override")
            mu, a, c = (torch.as_tensor(v, device=device) for v in (mu_np, a_np, c_np))
        return ScorePack(P=torch.as_tensor(P, dtype=dtype, device=device),
                         active=torch.as_tensor(active, device=device),
                         num_mixtures=S, density_cap=D, dim=dim,
                         max_approx=self.max_approx, dtype=dtype,
                         method=method, mu=mu, a=a, c=c)


# -- device-side scoring -------------------------------------------------------


def density_scores(pack: ScorePack, feats: torch.Tensor) -> torch.Tensor:
    """[N, dim] → [N, S, D] per-density scores (−log p, padded slots huge)."""
    if pack.method == "pallas":
        from ..ops.mahalanobis import mahalanobis_scores
        scores = mahalanobis_scores(feats.to(torch.float32).contiguous(),
                                    pack.mu, pack.a, pack.c)
        return scores.to(pack.dtype).reshape(
            feats.shape[0], pack.num_mixtures, pack.density_cap)
    X = pack.features_expanded(feats.to(pack.dtype))
    # full-precision f32 product: the expansion already loses ~1e-4 to
    # cancellation in f32 (see ScorePack); TF32's 10-bit mantissa would
    # lose ~1e-3 of every score on top of that
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        scores = X @ pack.P  # [N, S·D]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return scores.reshape(X.shape[0], pack.num_mixtures, pack.density_cap)


def mixture_scores_from_density(pack: ScorePack, scores_sd: torch.Tensor) -> torch.Tensor:
    """[.., S, D] → [.., S] mixture-level scores (min-clip or −logΣexp)."""
    if pack.max_approx:
        return torch.clamp(scores_sd.amin(dim=-1), max=MIN_SCORE_INIT)
    neg = torch.where(pack.active, -scores_sd, -math.inf)
    return -torch.logsumexp(neg, dim=-1)


AM_CHUNK = 1 << 15  # frames per chunk: bounds the [chunk, S·D] intermediate


def am_scores(pack: ScorePack, feats: torch.Tensor) -> torch.Tensor:
    """[N, dim] → [N, S] state-level acoustic scores.

    Chunked over frames so the [chunk, S·D] per-density tensor never exceeds
    ~0.2 GB at the SieTill widths (the density dimension is reduced
    immediately)."""
    N = feats.shape[0]
    if N <= AM_CHUNK:
        return mixture_scores_from_density(pack, density_scores(pack, feats))
    return torch.cat([
        mixture_scores_from_density(pack, density_scores(pack, feats[s:s + AM_CHUNK]))
        for s in range(0, N, AM_CHUNK)])
