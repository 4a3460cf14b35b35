"""Diagonal-covariance GMM acoustic model: host state and device scoring.

Counterpart of speechrecognition_tpu/models/gmm.py. The EM bookkeeping
(density lists, split/eliminate, finalization, the .mix accumulators) lives
on the host in float64 numpy and mirrors the reference exactly
(src/sietill/Mixtures.cpp). Scoring and the E-step passes run on the pack's
device; scoring by one of two methods:

    "mxu":    score[t, (s,d)] = [x², x, 1]ₜ · P[:, (s,d)]      (one matmul)
    "pallas": score[t, (s,d)] = Σᵢ (xᵢ−μᵢ)²·aᵢ + c            (kernel A; with the
              max-approximation, its fused entry takes the per-mixture minimum)

The names follow the reference package: "mxu" is the quadratic expansion as
a plain matrix product, "pallas" the centered form that
ops/mahalanobis.py computes with a hand-written CUDA kernel.

The production decode scores in double-float instead (``pack_df`` →
``am_scores_df``): the centered sum in (hi, lo) float32 pairs, in the
reference's operation order, which kernel C (``csrc/am_scores_df.cu``)
computes on the card. The trainer's double-float E-step (``em_pass_sorted``)
is kernel H (``csrc/em_pass_df.cu``).

Score semantics match Mixtures.cpp:590-744: score = norm + ½·Mahalanobis
− log w; mixture score is the min over densities clipped at 1e10
(max-approx, ::696-713) or −log Σ exp(−score) (sum, ::719-728).
"""

from __future__ import annotations

import contextlib
import enum
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io import RawMixtureSet
from ..ops import _native
from ..ops import doublefloat as dfm

MIN_SCORE_INIT = 1e10      # Mixtures.cpp:699
INACTIVE_SCORE = 5e17      # sentinel for padded density slots (f32-safe, < inf)
MIN_VARIANCE = 1e-4        # Mixtures.cpp:167 (var accumulator floor)
MEMBERSHIP_EPS = 1e-8      # Mixtures.cpp:336


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


@dataclass
class ScorePackDF:
    """Double-float (two-f32) scoring tables: exact float32-pair splits of
    the host float64 tables, the stand-in for the reference's float64
    accumulation (Mixtures.cpp:590-628) with float32 arithmetic only.

    Fields are DF pairs (ops/doublefloat.py); ``mu``/``iv`` are the raw
    means and inverse variances (not pre-halved: the reference multiplies by
    vars_inv_ and halves the final sum, density_score_sse Mixtures.cpp:645-690
    — the same operation order is kept)."""

    mu: dfm.DF                # [S·D, dim]
    iv: dfm.DF                # [S·D, dim]
    norm: dfm.DF              # [S·D]
    logw: dfm.DF              # [S·D]
    active: torch.Tensor      # bool [S, D]
    num_mixtures: int
    density_cap: int
    dim: int
    max_approx: bool

    @property
    def device(self) -> torch.device:
        return self.mu.hi.device


def pack_device(device, what: str = "scoring pack") -> torch.device:
    """The device a scoring pack (or another ``what``: the NN's weights, its
    trainer) is built on. They default to "cuda"; a CUDA device that is not
    there raises, and nothing falls back to the CPU: CPU use passes
    ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} on {device}, but no CUDA device is "
                           f"available; pass device=\"cpu\" to build it on the CPU")
    return device


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

    def reset_accumulators(self) -> None:
        self.mean_acc[:] = 0.0
        self.mean_weight_acc[:] = 0.0
        self.var_acc[:] = MIN_VARIANCE
        self.var_weight_acc[:] = 0.0

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

    def sync_accumulators_to_parameters(self) -> None:
        """Rewrite the sufficient-statistic accumulators so finalize()
        reproduces the CURRENT parameters exactly.

        The .mix checkpoint stores accumulators only and re-finalizes on load
        (Mixtures.cpp:748-830 / from_raw), so a direct parameter update would
        revert on a save/load round trip unless the accumulators are
        re-derived: means·weights back into mean_acc, E[X²]-form variances
        back into var_acc, per-mixture mass preserved."""
        with np.errstate(divide="ignore", invalid="ignore"):
            for m in range(self.num_mixtures):
                total_mix = sum(self.mean_weight_acc[mi]
                                for (mi, _vi) in self.mixtures[m])
                if not np.isfinite(total_mix) or total_mix <= 0:
                    continue
                for (mi, vi) in self.mixtures[m]:
                    if not (np.all(np.isfinite(self.means[mi]))
                            and np.isfinite(self.mean_weights[mi])):
                        continue
                    self.mean_weight_acc[mi] = (self.mean_weights[mi]
                                                * total_mix)
                    self.mean_acc[mi] = (self.means[mi]
                                         * self.mean_weight_acc[mi])
                    if self.var_model == VarianceModel.NO_POOLING:
                        self.var_weight_acc[vi] = self.mean_weight_acc[mi]
                        self.var_acc[vi] = ((self.vars[vi]
                                             + self.means[mi] ** 2)
                                            * self.var_weight_acc[vi])
                if (self.var_model == VarianceModel.MIXTURE_POOLING
                        and self.mixtures[m]):
                    vi0 = self.mixtures[m][0][1]
                    mixture_mean = np.zeros(self.dim)
                    for (mi, _v) in self.mixtures[m]:
                        mixture_mean += self.mean_acc[mi]
                    mixture_mean /= total_mix
                    self.var_weight_acc[vi0] = total_mix
                    self.var_acc[vi0] = ((self.vars[vi0]
                                          + mixture_mean ** 2) * total_mix)
            if self.var_model == VarianceModel.GLOBAL_POOLING:
                total_obs = 0.0
                global_mean = np.zeros(self.dim)
                for m in range(self.num_mixtures):
                    for (mi, _v) in self.mixtures[m]:
                        if np.isfinite(self.mean_weight_acc[mi]):
                            total_obs += self.mean_weight_acc[mi]
                            global_mean += self.mean_acc[mi]
                if total_obs > 0:
                    global_mean /= total_obs
                    self.var_weight_acc[0] = total_obs
                    self.var_acc[0] = ((self.vars[0] + global_mean ** 2)
                                       * total_obs)

    def split(self, min_obs: float) -> None:
        """Split densities with enough mass, μ ± √σ² (Mixtures.cpp:465-543).
        Iterates densities in reverse, appends the new density at the end."""
        for m in range(self.num_mixtures):
            for di in range(len(self.mixtures[m]) - 1, -1, -1):
                mean_idx, var_idx = self.mixtures[m][di]
                if self.mean_weight_acc[mean_idx] >= min_obs:
                    if self.var_model == VarianceModel.NO_POOLING:
                        new_md = self._create_density(len(self.mean_refs), len(self.var_refs))
                    else:
                        new_md = self._create_density(len(self.mean_refs), var_idx)
                    self._update_split_densities((mean_idx, var_idx), new_md)
                    self.mixtures[m].append(new_md)

    def _update_split_densities(self, orig: Tuple[int, int], new: Tuple[int, int]) -> None:
        mo, vo = orig
        mn, vn = new
        self.mean_weights[mn] = self.mean_weights[mo]
        self.mean_weights_log[mn] = self.mean_weights_log[mo]
        self.mean_weight_acc[mn] = self.mean_weight_acc[mo]
        shift = np.sqrt(self.vars[vo])
        mean_plus = self.means[mo] + shift
        mean_minus = self.means[mo] - shift
        self.means[mo] = mean_plus
        self.means[mn] = mean_minus
        if self.var_model == VarianceModel.NO_POOLING:
            self.var_weight_acc[vn] = self.var_weight_acc[vo]
            self.var_acc[vn] = self.var_acc[vo]
            self.vars[vn] = self.vars[vo]
            self.vars_inv[vn] = self.vars_inv[vo]
            self.norm[vn] = self.norm[vo]

    def eliminate(self, min_obs: float) -> None:
        """Drop underpopulated densities (Mixtures.cpp:547-576)."""
        for m in range(self.num_mixtures):
            for di in range(len(self.mixtures[m]) - 1, -1, -1):
                mean_idx, var_idx = self.mixtures[m][di]
                if self.mean_weight_acc[mean_idx] < min_obs:
                    del self.mixtures[m][di]
                    self.mean_refs[mean_idx] = 0
                    if self.var_model == VarianceModel.NO_POOLING:
                        self.var_refs[var_idx] = 0

    def num_densities(self) -> int:
        return int(len(self.mean_refs) - np.count_nonzero(self.mean_refs == 0))

    @property
    def max_densities_per_mixture(self) -> int:
        return max(len(m) for m in self.mixtures)

    def apply_statistics(self, w: np.ndarray, xs: np.ndarray, x2s: np.ndarray) -> None:
        """Fold dense per-(mixture, density-slot) float64 statistics
        (w [S, D], xs and x2s [S, D, dim], D >= the model's densities per
        mixture) into the flat reference-indexed accumulators (handles shared
        var slots)."""
        self.reset_accumulators()
        for s in range(self.num_mixtures):
            for d, (mean_idx, var_idx) in enumerate(self.mixtures[s]):
                self.mean_weight_acc[mean_idx] += w[s, d]
                self.var_weight_acc[var_idx] += w[s, d]
                self.mean_acc[mean_idx] += xs[s, d]
                self.var_acc[var_idx] += x2s[s, d]

    # -- serialization (reference .mix format) -------------------------------

    def to_raw(self) -> RawMixtureSet:
        """Compacted accumulator state, as Mixtures.cpp::write()."""
        mean_map = -np.ones(len(self.mean_refs), dtype=np.int64)
        mean_map[self.mean_refs > 0] = np.arange(int((self.mean_refs > 0).sum()))
        var_map = -np.ones(len(self.var_refs), dtype=np.int64)
        var_map[self.var_refs > 0] = np.arange(int((self.var_refs > 0).sum()))

        density_list = []
        mixtures_out: List[np.ndarray] = []
        for m in range(self.num_mixtures):
            ids = []
            for (mean_idx, var_idx) in self.mixtures[m]:
                ids.append(len(density_list))
                density_list.append((mean_map[mean_idx], var_map[var_idx]))
            mixtures_out.append(np.asarray(ids, dtype=np.int64))

        keep_m = self.mean_refs > 0
        keep_v = self.var_refs > 0
        return RawMixtureSet(
            dim=self.dim,
            mean_acc=self.mean_acc[keep_m].copy(),
            mean_weight=self.mean_weight_acc[keep_m].copy(),
            var_acc=self.var_acc[keep_v].copy(),
            var_weight=self.var_weight_acc[keep_v].copy(),
            densities=np.asarray(density_list, dtype=np.int64).reshape(-1, 2),
            mixtures=mixtures_out,
        )

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
             device="cuda") -> ScorePack:
        """Scoring tables on ``device`` (the card unless the caller asks for
        the CPU: see ``pack_device``). ``method="pallas"`` also uploads the
        f32 centered-form tables (mu, a, c) that kernel A reads."""
        if method not in ("mxu", "pallas"):
            raise ValueError(f"unknown scoring method: {method}")
        device = pack_device(device)
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

    def pack_df(self, density_cap: Optional[int] = None,
                device="cuda") -> ScorePackDF:
        """Double-float scoring pack on ``device`` (the card unless the
        caller asks for the CPU: see ``pack_device``): exact f32-pair splits
        of the host float64 tables (see am_scores_df). ``density_cap`` pads
        the density slots to a fixed capacity."""
        device = pack_device(device)
        S = self.num_mixtures
        D = density_cap or self.max_densities_per_mixture
        dim = self.dim
        mu = np.zeros((S * D, dim))
        iv = np.zeros((S * D, dim))
        norm = np.full(S * D, float(INACTIVE_SCORE))
        logw = np.zeros(S * D)
        active = np.zeros((S, D), bool)
        for s in range(S):
            for d, (mean_idx, var_idx) in enumerate(self.mixtures[s]):
                m_vec = self.means[mean_idx]
                iv_vec = self.vars_inv[var_idx]
                nrm = self.norm[var_idx]
                lw = self.mean_weights_log[mean_idx]
                if not (np.isfinite(m_vec).all() and np.isfinite(iv_vec).all()
                        and np.isfinite(nrm) and np.isfinite(lw)):
                    continue
                j = s * D + d
                mu[j] = m_vec
                iv[j] = iv_vec
                norm[j] = nrm
                logw[j] = lw
                active[s, d] = True
        return ScorePackDF(
            mu=dfm.from_f64(mu, device), iv=dfm.from_f64(iv, device),
            norm=dfm.from_f64(norm, device), logw=dfm.from_f64(logw, device),
            active=torch.as_tensor(active, device=device), num_mixtures=S,
            density_cap=D, dim=dim, max_approx=self.max_approx)


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
    with _full_f32_matmul():
        scores = X @ pack.P  # [N, S·D]
    return scores.reshape(X.shape[0], pack.num_mixtures, pack.density_cap)


@contextlib.contextmanager
def _full_f32_matmul():
    """Full-precision float32 products on the card: the [x², x, 1] expansion
    already loses ~1e-4 to cancellation in f32 (see ScorePack); TF32's
    10-bit mantissa would lose ~1e-3 of every score on top of that."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def mixture_scores_from_density(pack: ScorePack, scores_sd: torch.Tensor) -> torch.Tensor:
    """[.., S, D] → [.., S] mixture-level scores (min-clip or −logΣexp)."""
    if pack.max_approx:
        return torch.clamp(scores_sd.amin(dim=-1), max=MIN_SCORE_INIT)
    neg = torch.where(pack.active, -scores_sd, -math.inf)
    return -torch.logsumexp(neg, dim=-1)


AM_CHUNK = 1 << 15  # frames per chunk: bounds the [chunk, S·D] intermediate


def _am_chunk(pack: ScorePack, feats: torch.Tensor) -> torch.Tensor:
    """One chunk of ``am_scores``. A "pallas" pack with the max-approximation
    takes kernel A's fused entry: the per-mixture minimum and cap in the
    kernel, converted to the pack's dtype after the minimum (the same values:
    conversion keeps the order, and the cap 1e10 is exact in float32)."""
    if pack.method == "pallas" and pack.max_approx:
        from ..ops.mahalanobis import mahalanobis_min_scores
        scores = mahalanobis_min_scores(feats.to(torch.float32).contiguous(),
                                        pack.mu, pack.a, pack.c, pack.density_cap)
        return scores.to(pack.dtype)
    return mixture_scores_from_density(pack, density_scores(pack, feats))


def am_scores(pack: ScorePack, feats: torch.Tensor) -> torch.Tensor:
    """[N, dim] → [N, S] state-level acoustic scores.

    Chunked over frames so the [chunk, S·D] per-density tensor never exceeds
    ~0.2 GB at the SieTill widths (the density dimension is reduced
    immediately)."""
    N = feats.shape[0]
    if N <= AM_CHUNK:
        return _am_chunk(pack, feats)
    return torch.cat([_am_chunk(pack, feats[s:s + AM_CHUNK]) for s in range(0, N, AM_CHUNK)])


AM_CHUNK_DF = 1 << 12  # df scoring holds several [chunk, S·D] f32 pairs


def density_scores_df_reference(packdf: ScorePackDF, x: torch.Tensor) -> dfm.DF:
    """x [n, dim] → DF [n, S·D] density scores, reference op order:
    d = Σᵢ (x−μ)²·iv  (double in C++, DF here);  score = norm + d/2 − logw.
    Plain PyTorch, on the inputs' device."""
    mu, iv = packdf.mu, packdf.iv
    dfm.require_f32("density_scores_df", mu.hi, mu.lo, iv.hi, iv.lo,
                    packdf.norm.hi, packdf.norm.lo, packdf.logw.hi, packdf.logw.lo)
    n = x.shape[0]
    J = mu.hi.shape[0]
    x = x.to(torch.float32)
    # [dim, J] rows: column i of the tables as one contiguous row
    mu_t = dfm.DF(mu.hi.t().contiguous(), mu.lo.t().contiguous())
    iv_t = dfm.DF(iv.hi.t().contiguous(), iv.lo.t().contiguous())
    zeros = torch.zeros((n, J), dtype=torch.float32, device=x.device)
    acc = dfm.DF(zeros, zeros)
    for i in range(packdf.dim):
        mu_i = dfm.DF(mu_t.hi[i][None, :], mu_t.lo[i][None, :])
        iv_i = dfm.DF(iv_t.hi[i][None, :], iv_t.lo[i][None, :])
        diff = dfm.add_f(dfm.neg(mu_i), x[:, i, None])          # [n, J]
        acc = dfm.add(acc, dfm.mul(dfm.mul(diff, diff), iv_i))
    half = dfm.DF(acc.hi * 0.5, acc.lo * 0.5)                   # exact ×2⁻¹
    score = dfm.add(dfm.DF(packdf.norm.hi[None, :], packdf.norm.lo[None, :]), half)
    return dfm.add(score, dfm.neg(dfm.DF(packdf.logw.hi[None, :],
                                         packdf.logw.lo[None, :])))


def _am_chunk_df_reference(packdf: ScorePackDF, x: torch.Tensor) -> dfm.DF:
    sc = density_scores_df_reference(packdf, x)
    S, D = packdf.num_mixtures, packdf.density_cap
    m = dfm.min_axis(dfm.DF(sc.hi.reshape(-1, S, D), sc.lo.reshape(-1, S, D)), -1)
    cap = dfm.df(MIN_SCORE_INIT, device=x.device)
    return dfm.minimum(m, dfm.DF(cap.hi.expand(m.hi.shape), cap.lo.expand(m.lo.shape)))


def am_scores_df_reference(packdf: ScorePackDF, feats: torch.Tensor) -> dfm.DF:
    """Plain PyTorch version of ``am_scores_df`` (any device): chunks of
    AM_CHUNK_DF frames bound the [chunk, S·D] intermediates."""
    if not packdf.max_approx:
        raise NotImplementedError("df32 path covers max-approx scoring only")
    N = feats.shape[0]
    if N <= AM_CHUNK_DF:
        return _am_chunk_df_reference(packdf, feats)
    parts = [_am_chunk_df_reference(packdf, feats[s:s + AM_CHUNK_DF])
             for s in range(0, N, AM_CHUNK_DF)]
    return dfm.DF(torch.cat([p.hi for p in parts]), torch.cat([p.lo for p in parts]))


def am_scores_df(packdf: ScorePackDF, feats: torch.Tensor) -> dfm.DF:
    """[N, dim] → DF [N, S] state-level scores in double-float: the min over
    each mixture's densities, capped at MIN_SCORE_INIT.

    CPU tensors take the plain version; CUDA tensors launch kernel C
    (``csrc/am_scores_df.cu``, counted in ``am_scores_df.LAUNCHES``), which
    never writes the [N, S·D] density scores to memory."""
    if not packdf.max_approx:
        raise NotImplementedError("df32 path covers max-approx scoring only")
    if feats.device.type == "cpu":
        return am_scores_df_reference(packdf, feats)
    if feats.device.type != "cuda":
        raise ValueError(f"am_scores_df: unsupported device {feats.device}")
    x = feats.to(torch.float32).contiguous()
    if x.dim() != 2 or x.shape[1] != packdf.dim:
        raise ValueError(f"am_scores_df: feats has shape {tuple(x.shape)}, "
                         f"expected [N, {packdf.dim}]")
    N, dim = x.shape
    S, D = packdf.num_mixtures, packdf.density_cap
    J = S * D
    tables = {"mu": (packdf.mu, (J, dim)), "iv": (packdf.iv, (J, dim)),
              "norm": (packdf.norm, (J,)), "logw": (packdf.logw, (J,))}
    words = []
    for name, (pair, shape) in tables.items():
        for t in pair:
            if t.device != x.device:
                raise ValueError(f"am_scores_df: {name} on {t.device}, feats on {x.device}")
            if tuple(t.shape) != shape:
                raise ValueError(f"am_scores_df: {name} has shape {tuple(t.shape)}, "
                                 f"expected {shape}")
            if not t.is_contiguous():
                raise ValueError(f"am_scores_df: {name} is not contiguous")
            words.append(t)
    dfm.require_f32("am_scores_df", *words)
    lib = _native.load()
    out_hi = torch.empty((N, S), dtype=torch.float32, device=x.device)
    out_lo = torch.empty((N, S), dtype=torch.float32, device=x.device)
    err = lib.sr_am_scores_df(
        x.data_ptr(), *(t.data_ptr() for t in words), out_hi.data_ptr(),
        out_lo.data_ptr(), N, S, D, dim, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _native.check(err, "am_scores_df")
    am_scores_df.LAUNCHES += 1
    return dfm.DF(out_hi, out_lo)


am_scores_df.LAUNCHES = 0


# -- E-step passes under a fixed alignment -------------------------------------
# The trainer's passes (train/em.py): the state-sorted pass for max-approx EM
# (every precision) and the chunked sum-mode passes (max-approx=false, f32
# and f64). The reference's hard-membership and df32 branches of the chunked
# passes have no caller on this path: the sorted pass covers them. Every sum
# over frames is a product with a one-hot matrix, in float64: a fixed
# reduction order on the card, where index_add_ would add in the order its
# atomics land.


def aligned_density_scores(pack: ScorePack, feats: torch.Tensor,
                           states: torch.Tensor) -> torch.Tensor:
    """Per-density scores of each frame's ALIGNED mixture only:
    [N, dim] × int [N] → [N, D] (Mixtures.cpp:296-305 scores only
    ``mixtures_[aligned]``): the aligned mixture's expansion columns,
    gathered per frame, contracted with [x², x, 1]."""
    X = pack.features_expanded(feats.to(pack.dtype))              # [N, K]
    K = X.shape[-1]
    P3 = pack.P.reshape(K, pack.num_mixtures, pack.density_cap).permute(1, 0, 2)
    Pg = P3[states.long()]                                        # [N, K, D]
    with _full_f32_matmul():
        return torch.bmm(X[:, None, :], Pg)[:, 0]


def aligned_density_scores_df(packdf: ScorePackDF, feats: torch.Tensor,
                              states: torch.Tensor) -> dfm.DF:
    """Double-float twin of ``aligned_density_scores``: [N, dim] × int [N]
    → DF [N, D] scores of the aligned mixture's densities, with exactly
    ``density_scores_df_reference``'s operation order (so decisions match
    the decode path's). Plain PyTorch on the pack's device: the aligned
    mixture's [N, D, dim] tables are gathered a frame at a time."""
    S, D, dim = packdf.num_mixtures, packdf.density_cap, packdf.dim
    device = packdf.device
    st = torch.as_tensor(states, device=device).long()
    mu_hi = packdf.mu.hi.reshape(S, D, dim)[st]              # [N, D, dim]
    mu_lo = packdf.mu.lo.reshape(S, D, dim)[st]
    iv_hi = packdf.iv.hi.reshape(S, D, dim)[st]
    iv_lo = packdf.iv.lo.reshape(S, D, dim)[st]
    x = torch.as_tensor(feats, device=device).to(torch.float32)
    N = x.shape[0]
    zeros = torch.zeros((N, D), dtype=torch.float32, device=device)
    acc = dfm.DF(zeros, zeros)
    for i in range(dim):
        mu_i = dfm.DF(mu_hi[:, :, i], mu_lo[:, :, i])
        iv_i = dfm.DF(iv_hi[:, :, i], iv_lo[:, :, i])
        diff = dfm.add_f(dfm.neg(mu_i), x[:, i, None])
        acc = dfm.add(acc, dfm.mul(dfm.mul(diff, diff), iv_i))
    half = dfm.DF(acc.hi * 0.5, acc.lo * 0.5)
    score = dfm.add(dfm.DF(packdf.norm.hi.reshape(S, D)[st],
                           packdf.norm.lo.reshape(S, D)[st]), half)
    return dfm.add(score, dfm.neg(dfm.DF(packdf.logw.hi.reshape(S, D)[st],
                                         packdf.logw.lo.reshape(S, D)[st])))


def em_score_and_accumulate_corpus(pack, feats_chunks: torch.Tensor,
                                   states_chunks: torch.Tensor, mask_chunks: torch.Tensor,
                                   first_pass: bool = False, aligned_gather: bool = True):
    """The AM score pass and the E-step under ONE model in one pass over the
    corpus chunks, sharing each frame's scoring: feats_chunks f32 [K, C, dim],
    states int [K, C], mask f32 [K, C] → (score_total, w [S, D], xs [S, D,
    dim], x2s [S, D, dim]), all float64 on the pack's device.

    The frame score follows Training.cpp:585-612 (the aligned mixture's
    minimum capped at MIN_SCORE_INIT, or −log Σ exp over its active
    densities in sum mode); the statistics take the first density at the
    minimum (max-approx) or density 0 (``first_pass``). ``pack`` may be a
    ScorePackDF: the scores are then ``aligned_density_scores_df``'s and the
    minimum is exact in double-float pairs. ``aligned_gather`` scores only
    the aligned mixture (``aligned_density_scores``); else every density is
    scored and the aligned block gathered, as a "pallas" pack always does.
    A loop over the chunks; every sum over frames is a one-hot product in
    float64."""
    is_df = isinstance(pack, ScorePackDF)
    S, D = pack.num_mixtures, pack.density_cap
    device = pack.device
    feats_chunks = torch.as_tensor(feats_chunks, device=device)
    states_chunks = torch.as_tensor(states_chunks, device=device)
    mask_chunks = torch.as_tensor(mask_chunks, device=device)
    dim = feats_chunks.shape[-1]
    if is_df and not pack.max_approx:
        raise NotImplementedError("df32 EM covers max-approx scoring only")
    if not (first_pass or pack.max_approx):
        raise NotImplementedError("fused pass covers max-approx membership only")
    total = torch.zeros((), dtype=torch.float64, device=device)
    w = torch.zeros((S * D,), dtype=torch.float64, device=device)
    xs = torch.zeros((S * D, dim), dtype=torch.float64, device=device)
    x2s = torch.zeros((S * D, dim), dtype=torch.float64, device=device)
    for f, st, m in zip(feats_chunks, states_chunks.long(), mask_chunks):
        m64 = m.to(torch.float64)
        if is_df:
            sc = aligned_density_scores_df(pack, f, st)
            mn = dfm.min_axis(sc, -1)
            capped_hi = torch.clamp(mn.hi, max=MIN_SCORE_INIT)
            capped_lo = torch.where(mn.hi < MIN_SCORE_INIT, mn.lo, 0.0)
            fs64 = capped_hi.to(torch.float64) + capped_lo.to(torch.float64)
            eq = (sc.hi == mn.hi[:, None]) & (sc.lo == mn.lo[:, None])
            best = torch.argmax(eq.to(torch.uint8), dim=-1)         # first minimum
        else:
            if aligned_gather and pack.method != "pallas":
                sc = aligned_density_scores(pack, f, st)
            else:
                sc = density_scores(pack, f)[torch.arange(f.shape[0], device=device), st]
            if pack.max_approx:
                fs = torch.clamp(sc.amin(dim=-1), max=MIN_SCORE_INIT)
            else:
                fs = -torch.logsumexp(torch.where(pack.active[st], -sc, -math.inf), dim=-1)
            fs64 = fs.to(torch.float64)
            best = sc.argmin(dim=-1)
        total = total + (fs64 * m64).sum()
        if first_pass:
            best = torch.zeros_like(best)
        onehot = torch.nn.functional.one_hot(st * D + best, S * D).to(torch.float64).t()
        f64 = f.to(torch.float64)
        w = w + onehot @ m64
        xs = xs + onehot @ (f64 * m64[:, None])
        x2s = x2s + onehot @ (f64 * f64 * m64[:, None])
    return total, w.reshape(S, D), xs.reshape(S, D, dim), x2s.reshape(S, D, dim)


#: frames per step of the sum-mode passes: bounds aligned_density_scores'
#: [rows, 2·dim+1, D] parameter gather (~50 MB in float64 at SieTill widths)
SUM_ROWS = 8192


def _state_sums(gamma: torch.Tensor, f64: torch.Tensor, states: torch.Tensor,
                S: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Σ γ, Σ γ·x and Σ γ·x² per aligned state: gamma f64 [n, D], f64
    [n, dim], states [n] → [S, D], [S, D, dim], [S, D, dim]."""
    n, D = gamma.shape
    onehot = torch.nn.functional.one_hot(states.long(), S).to(torch.float64).t()  # [S, n]
    gx = (gamma[:, :, None] * f64[:, None, :]).reshape(n, -1)
    gx2 = (gamma[:, :, None] * (f64 * f64)[:, None, :]).reshape(n, -1)
    return (onehot @ gamma, (onehot @ gx).reshape(S, D, -1),
            (onehot @ gx2).reshape(S, D, -1))


def accumulate_chunk(pack: ScorePack, feats: torch.Tensor, states: torch.Tensor,
                     frame_mask: torch.Tensor, first_pass: bool,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sufficient statistics for one chunk of weighted aligned frames, on
    the pack's device.

    feats [N, dim], states int [N] (aligned mixture per frame), frame_mask
    [N] (each frame's weight: 0 for padding, 1 for a hard alignment, an arc
    posterior in discriminative training). Returns (w [S, D], xs [S, D, dim],
    x2s [S, D, dim]) in float64. Membership over the aligned mixture's
    densities: one-hot first minimum for max-approx (Mixtures.cpp:296-305),
    normalized exp(−score) with the 1e-8 cutoff, not renormalized, for sum
    (::307-336); it is weighted in the pack's dtype and then widened, as the
    reference rounds it. Only the aligned mixture is scored
    (``aligned_density_scores``; a "pallas" pack takes kernel A's scores of
    every mixture and gathers the aligned one, as the reference does)."""
    S, D = pack.num_mixtures, pack.density_cap
    device = pack.device
    feats = torch.as_tensor(feats, device=device)
    states = torch.as_tensor(states, device=device).long()
    N = feats.shape[0]
    if first_pass:
        gamma = torch.zeros((N, D), dtype=pack.dtype, device=device)
        gamma[:, 0] = 1.0
    else:
        if pack.method == "pallas":
            sc = density_scores(pack, feats)[torch.arange(N, device=device), states]
        else:
            sc = aligned_density_scores(pack, feats, states)        # [N, D]
        if pack.max_approx:
            gamma = torch.nn.functional.one_hot(sc.argmin(dim=-1), D).to(pack.dtype)
        else:
            p = torch.exp(-(sc - sc.amin(dim=-1, keepdim=True)))
            p = p / p.sum(dim=-1, keepdim=True)
            gamma = torch.where(p < MEMBERSHIP_EPS, 0.0, p)
    gamma = gamma * torch.as_tensor(frame_mask, device=device).to(pack.dtype)[:, None]
    return _state_sums(gamma.to(torch.float64), feats.to(torch.float64), states, S)


def _sum_mode_steps(feats_chunks, states_chunks, mask_chunks):
    """(features, states, mask) of SUM_ROWS frames at a time, in order."""
    K, C, _ = feats_chunks.shape
    for k in range(K):
        for r in range(0, C, SUM_ROWS):
            yield (feats_chunks[k, r:r + SUM_ROWS], states_chunks[k, r:r + SUM_ROWS].long(),
                   mask_chunks[k, r:r + SUM_ROWS])


def _require_sum_mode(pack) -> None:
    if isinstance(pack, ScorePackDF) or pack.max_approx:
        raise NotImplementedError("the sum-mode passes take a ScorePack with max_approx=False; "
                                  "max-approx EM (every precision) is em_pass_sorted")


def em_accumulate_corpus(pack: ScorePack, feats_chunks: torch.Tensor,
                         states_chunks: torch.Tensor, mask_chunks: torch.Tensor):
    """Sum-mode E-step (max-approx=false): feats_chunks f32 [K, C, dim];
    states int [K, C]; mask f32 [K, C]. Returns (w [S,D], xs [S,D,dim],
    x2s [S,D,dim]) in float64 on the chunks' device, from normalized
    exp(−score) memberships over the aligned mixture's densities with the
    1e-8 cutoff (Mixtures.cpp:307-336)."""
    _require_sum_mode(pack)
    S, D = pack.num_mixtures, pack.density_cap
    dim = feats_chunks.shape[-1]
    device = feats_chunks.device
    w = torch.zeros((S, D), dtype=torch.float64, device=device)
    xs = torch.zeros((S, D, dim), dtype=torch.float64, device=device)
    x2s = torch.zeros((S, D, dim), dtype=torch.float64, device=device)
    for f, st, m in _sum_mode_steps(feats_chunks, states_chunks, mask_chunks):
        sc = aligned_density_scores(pack, f, st)
        p = torch.exp(-(sc - sc.amin(dim=-1, keepdim=True)))
        p = p / p.sum(dim=-1, keepdim=True)
        gamma = (torch.where(p < MEMBERSHIP_EPS, 0.0, p)
                 * m.to(pack.dtype)[:, None]).to(torch.float64)
        dw, dxs, dx2s = _state_sums(gamma, f.to(torch.float64), st, S)
        w, xs, x2s = w + dw, xs + dxs, x2s + dx2s
    return w, xs, x2s


def em_am_score_corpus(pack: ScorePack, feats_chunks: torch.Tensor,
                       states_chunks: torch.Tensor, mask_chunks: torch.Tensor) -> torch.Tensor:
    """Sum-mode AM score: the sum over frames of −log Σ exp(−score) over the
    aligned mixture's active densities (Training.cpp:585-612,
    Mixtures.cpp:719-728), a float64 0-dim tensor."""
    _require_sum_mode(pack)
    total = torch.zeros((), dtype=torch.float64, device=feats_chunks.device)
    for f, st, m in _sum_mode_steps(feats_chunks, states_chunks, mask_chunks):
        sc = aligned_density_scores(pack, f, st)
        fs = -torch.logsumexp(torch.where(pack.active[st], -sc, -math.inf), dim=-1)
        total = total + (fs.to(torch.float64) * m.to(torch.float64)).sum()
    return total


# -- state-sorted E-step pass ----------------------------------------------------
# Frames grouped by their aligned mixture: each block of EM_BLOCK rows scores
# against ONE mixture's [D, dim] parameters (Mixtures.cpp:296-305). The
# trainer builds the sorted block index once per realignment and reuses it
# for every pass under that alignment.

EM_BLOCK = 4096


def sorted_blocks(alignment: np.ndarray, num_mixtures: int, block: int = EM_BLOCK):
    """Host-side grouping: frame indices sorted by aligned state, cut into
    per-state blocks of ``block`` rows (padded with -1). Returns
    (frame_idx int64 [NB, block], block_state int32 [NB], NB_used) with NB
    padded to the alignment-independent capacity ceil(N/block) + S."""
    N = alignment.shape[0]
    order = np.argsort(alignment, kind="stable")
    counts = np.bincount(alignment, minlength=num_mixtures)
    nb_cap = -(-N // block) + num_mixtures
    frame_idx = np.full((nb_cap, block), -1, np.int64)
    block_state = np.zeros(nb_cap, np.int32)
    nb = 0
    pos = 0
    for s in range(num_mixtures):
        n_s = int(counts[s])
        for off in range(0, n_s, block):
            rows = order[pos + off: pos + min(off + block, n_s)]
            frame_idx[nb, : rows.shape[0]] = rows
            block_state[nb] = s
            nb += 1
        pos += n_s
    return frame_idx, block_state, nb


def _best_density_df(packdf: ScorePackDF, frames: torch.Tensor, mask: torch.Tensor,
                     block_state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Double-float scores of each live row (mask != 0) against its block's
    mixture, in ``density_scores_df_reference``'s op order: the first
    density at the exact minimum, and the minimum capped at MIN_SCORE_INIT
    as float64. Rows with mask 0 get density 0 and score 0."""
    NB, R, dim = frames.shape
    S, D = packdf.num_mixtures, packdf.density_cap
    device = frames.device
    rows = torch.nonzero(mask.reshape(-1) != 0)[:, 0]
    x = frames.reshape(-1, dim)[rows].to(torch.float32)
    st = block_state.repeat_interleave(R)[rows]
    tab = {k: (getattr(packdf, k).hi.reshape(S, D, -1), getattr(packdf, k).lo.reshape(S, D, -1))
           for k in ("mu", "iv", "norm", "logw")}
    zeros = torch.zeros((x.shape[0], D), dtype=torch.float32, device=device)
    acc = dfm.DF(zeros, zeros)
    for i in range(dim):
        mu_i = dfm.DF(tab["mu"][0][:, :, i][st], tab["mu"][1][:, :, i][st])    # [n, D]
        iv_i = dfm.DF(tab["iv"][0][:, :, i][st], tab["iv"][1][:, :, i][st])
        diff = dfm.add_f(dfm.neg(mu_i), x[:, i, None])
        acc = dfm.add(acc, dfm.mul(dfm.mul(diff, diff), iv_i))
    half = dfm.DF(acc.hi * 0.5, acc.lo * 0.5)
    sc = dfm.add(dfm.DF(tab["norm"][0][st, :, 0], tab["norm"][1][st, :, 0]), half)
    sc = dfm.add(sc, dfm.neg(dfm.DF(tab["logw"][0][st, :, 0], tab["logw"][1][st, :, 0])))
    mn = dfm.min_axis(sc, -1)
    eq = (sc.hi == mn.hi[:, None]) & (sc.lo == mn.lo[:, None])
    capped_hi = torch.clamp(mn.hi, max=MIN_SCORE_INIT)
    capped_lo = torch.where(mn.hi < MIN_SCORE_INIT, mn.lo, 0.0)
    best = torch.zeros(NB * R, dtype=torch.long, device=device)
    best[rows] = torch.argmax(eq.to(torch.uint8), dim=-1)      # first minimum
    fs64 = torch.zeros(NB * R, dtype=torch.float64, device=device)
    fs64[rows] = capped_hi.to(torch.float64) + capped_lo.to(torch.float64)
    return best.reshape(NB, R), fs64.reshape(NB, R)


def _sorted_sums(frames: torch.Tensor, mask: torch.Tensor, block_state: torch.Tensor,
                 best: torch.Tensor, fs64: torch.Tensor, S: int, D: int):
    """(score total, w, xs, x2s) from each row's density and score: per
    block a one-hot product, then per state a one-hot product over the
    blocks, all in float64."""
    NB = frames.shape[0]
    m64 = mask.to(torch.float64)
    total = (fs64 * m64).sum(dim=1).sum()
    gamma = torch.nn.functional.one_hot(best, D).to(torch.float64) * m64[:, :, None]
    gT = gamma.transpose(1, 2)                                  # [NB, D, R]
    f64 = frames.to(torch.float64)
    per_state = torch.nn.functional.one_hot(block_state, S).to(torch.float64).t()  # [S, NB]
    w = per_state @ gamma.sum(dim=1)
    xs = (per_state @ torch.bmm(gT, f64).reshape(NB, -1)).reshape(S, D, -1)
    x2s = (per_state @ torch.bmm(gT, f64 * f64).reshape(NB, -1)).reshape(S, D, -1)
    return total, w, xs, x2s


def em_pass_sorted_reference(pack, frames: torch.Tensor, mask: torch.Tensor,
                             block_state: torch.Tensor, first_pass: bool = False):
    """Plain PyTorch version of ``em_pass_sorted`` (any device, any pack).
    The f32/f64 branch is the reference's: one batched [x², x, 1] · P
    product per block, the first minimum, the cap. The df32 branch scores
    only the live rows, in kernel C's op order."""
    if not (first_pass or pack.max_approx):
        raise NotImplementedError("sorted EM pass covers max-approx only")
    S, D = pack.num_mixtures, pack.density_cap
    bs = block_state.to(device=frames.device, dtype=torch.long)
    if isinstance(pack, ScorePackDF):
        best, fs64 = _best_density_df(pack, frames, mask, bs)
    else:
        P3 = pack.P.reshape(-1, S, D)[:, bs, :].permute(1, 0, 2)   # [NB, K, D]
        X = pack.features_expanded(frames.to(pack.dtype))           # [NB, R, K]
        with _full_f32_matmul():
            sc = torch.bmm(X, P3)                                   # [NB, R, D]
        best = sc.argmin(dim=-1)
        fs64 = torch.clamp(sc.amin(dim=-1), max=MIN_SCORE_INIT).to(torch.float64)
    if first_pass:
        best = torch.zeros_like(best)
    return _sorted_sums(frames, mask, bs, best, fs64, S, D)


def em_pass_sorted(pack, frames: torch.Tensor, mask: torch.Tensor,
                   block_state: torch.Tensor, first_pass: bool = False):
    """One fused AM-score + E-step pass over state-sorted frame blocks.

    frames f32 [NB, R, dim] (rows gathered in sorted order, padding rows
    arbitrary), mask f32 [NB, R] (0 on padding rows), block_state int [NB].
    Returns float64 tensors (score total, w [S,D], xs [S,D,dim],
    x2s [S,D,dim]); ``first_pass`` assigns every frame to density 0.

    A ScorePackDF on CUDA tensors launches kernel H (``csrc/em_pass_df.cu``,
    counted in ``em_pass_sorted.LAUNCHES``); CPU tensors take the plain
    version. A ScorePack (f32/f64) always runs the plain version, whose
    product goes to cuBLAS on the card as the reference leaves it to XLA."""
    if not isinstance(pack, ScorePackDF) or frames.device.type == "cpu":
        return em_pass_sorted_reference(pack, frames, mask, block_state, first_pass)
    device = frames.device
    if device.type != "cuda":
        raise ValueError(f"em_pass_sorted: unsupported device {device}")
    if not (first_pass or pack.max_approx):
        raise NotImplementedError("sorted EM pass covers max-approx only")
    S, D, dim = pack.num_mixtures, pack.density_cap, pack.dim
    if frames.dim() != 3 or frames.dtype != torch.float32 or frames.shape[2] != dim \
            or not frames.is_contiguous():
        raise ValueError(f"em_pass_sorted: frames must be a contiguous float32 "
                         f"[NB, R, {dim}] tensor")
    NB, R, _ = frames.shape
    if tuple(mask.shape) != (NB, R) or tuple(block_state.shape) != (NB,) \
            or mask.device != device or block_state.device != device:
        raise ValueError(f"em_pass_sorted: mask must be [{NB}, {R}] and block_state "
                         f"[{NB}] on {device}")
    if NB and bool((block_state.min() < 0) | (block_state.max() >= S)):
        raise ValueError(f"em_pass_sorted: block_state outside [0, {S})")
    words = []
    for name, shape in (("mu", (S * D, dim)), ("iv", (S * D, dim)), ("norm", (S * D,)),
                        ("logw", (S * D,))):
        for t in getattr(pack, name):
            if t.device != device or tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"em_pass_sorted: {name} must be a contiguous {shape} "
                                 f"pair on {device}")
            words.append(t)
    dfm.require_f32("em_pass_sorted", *words)
    m32 = mask.to(torch.float32).contiguous()
    bs32 = block_state.to(torch.int32).contiguous()
    f64 = dict(dtype=torch.float64, device=device)
    lib = _native.load()
    # the kernel's per-tile and per-block partial sums, sized by the kernel
    n_scratch = lib.sr_em_pass_df_scratch(NB, R, D, dim)
    if n_scratch < 0:
        raise ValueError(f"em_pass_sorted: {NB} blocks of {R} rows at D={D}, dim={dim} "
                         f"need more partial sums than kernel H indexes")
    scratch = torch.empty((n_scratch,), **f64)
    out = (torch.empty((), **f64), torch.empty((S, D), **f64),
           torch.empty((S, D, dim), **f64), torch.empty((S, D, dim), **f64))
    err = lib.sr_em_pass_df(
        frames.data_ptr(), m32.data_ptr(), bs32.data_ptr(), *(t.data_ptr() for t in words),
        scratch.data_ptr(), *(t.data_ptr() for t in out),
        NB, R, S, D, dim, int(bool(first_pass)), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _native.check(err, "em_pass_sorted")
    em_pass_sorted.LAUNCHES += 1
    return out


em_pass_sorted.LAUNCHES = 0
