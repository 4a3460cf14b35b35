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

The production decode scores in double-float instead (``pack_df`` →
``am_scores_df``): the centered sum in (hi, lo) float32 pairs, in the
reference's operation order, which kernel C (``csrc/am_scores_df.cu``)
computes on the card.

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
from ..ops import _native
from ..ops import doublefloat as dfm

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

    def pack_df(self, density_cap: Optional[int] = None,
                device="cpu") -> ScorePackDF:
        """Double-float scoring pack on ``device``: exact f32-pair splits of
        the host float64 tables (see am_scores_df). ``density_cap`` pads the
        density slots to a fixed capacity."""
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
