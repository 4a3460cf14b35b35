"""Int8 quantized batch scoring with density preselection — counterpart of
speechrecognition_tpu/models/quantized.py.

The reference's SIMD batch feature scorers (rwth-asr-0.5/src/Mm/
BatchFeatureScorer.hh:199-333, ``BatchIntFeatureScorer`` and
``BatchPreselectionIntFeatureScorer``, the ``SIMD-diagonal-maximum`` scorer
of the AN4 recognition config, Mm/Module.cc:84) and the density
preselection clustering (Mm/DensityClustering.{hh,cc,tcc}), with the same
semantics as the JAX package:

* a globally pooled diagonal covariance and max-approximation only;
* means times scale · invsqrt(var), quantized to one byte (round to nearest
  even, clipped); features quantized the same way each frame;
* scale = 255 / (1.25 · 2·max|mean'|);
* the integer distance d = Σ (qx − qm)², plus c = ⌊scale²·logNorm −
  2·scale²·log w⌋, its minimum over a mixture's densities taken in integers,
  then one float32 division by 2·scale²;
* preselection: k-means over the quantized means (host numpy, 5 Lloyd
  iterations from a seeded draw); each frame selects the clusters whose
  distance is at most its n_selected-th smallest (ties admit more) and
  scores only their densities; a mixture with no selected density reads the
  backoff score.

``am_scores_q`` is the scorer: on CPU tensors it runs the plain PyTorch
version ``am_scores_q_reference`` (``quantize_features``,
``quantized_distances``, ``_select_mask`` spelled out; the integer products
in float64, where every partial sum is an exact integer), on CUDA tensors
the hand-written kernel O (``csrc/quantized_scores.cu``). Both give the
reference's integers and its float32 scores bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..ops import _native
from .gmm import VarianceModel, pack_device

INT_MAX = np.int32(2147483647)
#: sentinel for inactive/unselected densities: large enough to lose every
#: min, small enough that adding the max possible integer distance
#: (dim·255² ≈ 3e6) cannot overflow int32
INACTIVE_INT = np.int32(1 << 30)

#: reference defaults (DensityClustering.cc:18-29)
NUM_CLUSTERS = 256
SELECT_CLUSTERS = 32
CLUSTER_ITERATIONS = 5
BACKOFF_SCORE = 40000.0

#: the limits of kernel O's first design (forced with first_design=True):
#: feature dim (bytes a quantized frame) and clusters; its tensor-core
#: design takes any dim and any cluster count
FIRST_DESIGN_MAX_DIM = 128
FIRST_DESIGN_MAX_CLUSTERS = 256


def _quantize(x: np.ndarray) -> np.ndarray:
    """round-to-nearest + clip to int8 (Mm/Utilities.hh quantize<>,
    minus the u8 +128 offset which cancels in distances)."""
    return np.clip(np.round(x), -128, 127).astype(np.int8)


@dataclass
class QuantPack:
    """Device tables for the int8 max-approx scorer."""

    qmeans: torch.Tensor        # int8 [J, dim]
    qmeans_sq: torch.Tensor     # int32 [J]  Σ qm²
    consts: torch.Tensor        # int32 [J]  ⌊scale²·logNorm − 2scale²·logw⌋
    inv_sqrt_var: torch.Tensor  # f32 [dim]  scale · invsqrt(pooled var)
    scale2x: float              # 2·scale²  (reference scale_)
    active: torch.Tensor        # bool [S, D] real (non-padding) densities
    num_mixtures: int
    density_cap: int
    dim: int
    #: preselection tables (None → no preselection)
    qcenters: Optional[torch.Tensor] = None      # int8 [C, dim]
    qcenters_sq: Optional[torch.Tensor] = None   # int32 [C]
    cluster_of: Optional[torch.Tensor] = None    # int32 [S·D] (padded → 0)
    n_selected: int = SELECT_CLUSTERS
    backoff: float = BACKOFF_SCORE
    #: kernel O's tables a design ("mma", "first"), padded to its widths
    #: (built at first launch)
    kernel_tables: Dict[str, Dict] = field(default_factory=dict, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.qmeans.device


def _pooled_tables(model) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray, float]:
    """Extract (means [J,dim], logw [J], active [S,D], invsqrt pooled
    var [dim], logNorm) from a MixtureModel laid out like
    MixtureModel.pack (mixture-major, padded to density_cap)."""
    if model.var_model != VarianceModel.GLOBAL_POOLING:
        raise ValueError(
            "quantized scorer supports only globally pooled variance "
            "(the reference's BatchFeatureScorer.cc:399 contract)")
    if not model.max_approx:
        raise ValueError("quantized scorer is max-approx only "
                         "(BatchFeatureScorer.hh:283)")
    S = model.num_mixtures
    D = model.max_densities_per_mixture
    dim = model.dim
    var = np.asarray(model.vars[0], np.float64)     # global var_idx == 0
    isv = 1.0 / np.sqrt(var)
    # logNormalizationFactor = Σ log 2πσ² == 2 · the pack's half-norm
    log_norm = 2.0 * float(model.norm[0])
    means = np.zeros((S * D, dim), np.float64)
    logw = np.full(S * D, -1e30, np.float64)
    active = np.zeros((S, D), bool)
    for s in range(S):
        for d, (mi, vi) in enumerate(model.mixtures[s]):
            if vi != 0:
                raise ValueError("global pooling expects var index 0 "
                                 f"(mixture {s} density {d} has {vi})")
            mu = model.means[mi]
            lw = model.mean_weights_log[mi]
            if not (np.isfinite(mu).all() and np.isfinite(lw)):
                continue        # zero-count density (inactive, like pack())
            means[s * D + d] = mu
            logw[s * D + d] = lw
            active[s, d] = True
    return means, logw, active, isv, log_norm


def build_quant_pack(model, preselection: bool = False,
                     num_clusters: int = NUM_CLUSTERS,
                     n_selected: int = SELECT_CLUSTERS,
                     iterations: int = CLUSTER_ITERATIONS,
                     backoff: float = BACKOFF_SCORE,
                     seed: int = 1, device="cuda") -> QuantPack:
    """MixtureModel (global pooling, max-approx) → QuantPack on ``device``
    (the card unless the caller asks for the CPU).

    `seed` mirrors the reference's srand(1) deterministic cluster
    initialization (DensityClustering.tcc initializeClusters) — same
    algorithm, portable RNG instead of C rand()."""
    device = pack_device(device, "quantized scoring pack")
    means, logw, active, isv, log_norm = _pooled_tables(model)
    S, D = active.shape
    dim = means.shape[1]

    # quantizationScale (BatchFeatureScorer.cc:375-396)
    divided = means * isv[None, :]
    real = active.reshape(-1)
    maxabs = float(np.abs(divided[real]).max()) if real.any() else 1.0
    scale = 255.0 / (1.25 * 2.0 * maxabs)
    scale2x = 2.0 * scale * scale

    qmeans = _quantize(divided * scale)
    qmeans[~real] = 0
    consts = np.full(logw.shape, np.int64(INACTIVE_INT), np.int64)
    consts[real] = np.floor(scale * scale * log_norm
                            - scale2x * logw[real]).astype(np.int64)
    consts = np.clip(consts, -2 ** 31, 2 ** 31 - 1).astype(np.int32)

    def put(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    qcenters = qcenters_sq = cluster_of = None
    if preselection:
        C = min(num_clusters, int(real.sum()))
        centers, assign = _kmeans_int(qmeans[real].astype(np.int32),
                                      C, iterations, seed)
        cl = np.zeros(S * D, np.int32)
        cl[real] = assign
        qcenters = put(_quantize(centers))
        qcenters_sq = put((centers.astype(np.int64) ** 2).sum(1).astype(np.int32))
        cluster_of = put(cl)

    qm = qmeans.astype(np.int32)
    return QuantPack(
        qmeans=put(qmeans),
        qmeans_sq=put((qm * qm).sum(1).astype(np.int32)),
        consts=put(consts),
        inv_sqrt_var=put((isv * scale).astype(np.float32)),
        scale2x=scale2x,
        active=put(active),
        num_mixtures=S, density_cap=D, dim=dim,
        qcenters=qcenters, qcenters_sq=qcenters_sq, cluster_of=cluster_of,
        n_selected=min(n_selected, num_clusters), backoff=backoff)


def _kmeans_int(points: np.ndarray, C: int, iterations: int, seed: int,
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd k-means over integer points (the reference clusters the
    QUANTIZED means with integer distances,
    BatchPreselectionIntFeatureScorer / DensityClustering<u8, u32>).
    Deterministic: distinct random points as initial centers."""
    n = points.shape[0]
    rng = np.random.RandomState(seed)
    init = rng.permutation(n)[:C]
    centers = points[init].astype(np.float64)
    assign = np.zeros(n, np.int32)
    for _ in range(iterations):
        d = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(1).astype(np.int32)
        for c in range(C):
            sel = assign == c
            if sel.any():
                centers[c] = points[sel].mean(0)
    return np.round(centers), assign


def quantize_features(pack: QuantPack, feats: torch.Tensor) -> torch.Tensor:
    """f32 [N, dim] → int8 [N, dim] (setFeature: multiply by
    scale·invsqrt(var), round half to even, clip). A NaN product gives 0,
    as the reference's conversion does (XLA's float-to-int conversion
    saturates and maps NaN to 0); a cast of NaN is undefined in PyTorch."""
    x = feats.to(torch.float32) * pack.inv_sqrt_var[None, :]
    q = torch.clamp(torch.round(x), -128, 127)
    return torch.where(torch.isnan(q), torch.zeros_like(q), q).to(torch.int8)


def _int_products(qx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """int8 [N, dim] · int8 [M, dim]ᵀ → int32 [N, M], exactly: the products
    run in float64, where every partial sum (|Σ| ≤ dim·128²) is an integer
    below 2^53."""
    return (qx.to(torch.float64) @ table.to(torch.float64).T).to(torch.int32)


def _sq_norms(qx: torch.Tensor) -> torch.Tensor:
    xi = qx.to(torch.int32)
    return (xi * xi).sum(dim=1, dtype=torch.int32)


def quantized_distances(pack: QuantPack, qx: torch.Tensor) -> torch.Tensor:
    """int8 [N, dim] → int32 [N, J] exact integer distances
    Σ (qx − qm)² = Σqx² − 2·qx·qm + Σqm²."""
    return _sq_norms(qx)[:, None] - 2 * _int_products(qx, pack.qmeans) + pack.qmeans_sq[None, :]


def _select_mask(pack: QuantPack, qx: torch.Tensor) -> torch.Tensor:
    """bool [N, J]: densities whose cluster is among the n_selected
    closest centers for each frame (selectClusters); ties at the
    n_selected-th smallest distance admit every tied cluster."""
    cd = (_sq_norms(qx)[:, None] - 2 * _int_products(qx, pack.qcenters)
          + pack.qcenters_sq[None, :])                                  # [N, C]
    kth = torch.topk(cd, pack.n_selected, dim=1, largest=False).values[:, -1]
    sel = cd <= kth[:, None]
    return sel[:, pack.cluster_of.to(torch.long)]                       # [N, J]


def am_scores_q_reference(pack: QuantPack, feats: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``am_scores_q`` (any device). Same
    contract."""
    qx = quantize_features(pack, feats)
    total = quantized_distances(pack, qx) + pack.consts[None, :]
    if pack.qcenters is not None:
        total = torch.where(_select_mask(pack, qx), total,
                            torch.tensor(int(INACTIVE_INT), dtype=torch.int32,
                                         device=total.device))
    N = feats.shape[0]
    best = total.reshape(N, pack.num_mixtures, pack.density_cap).amin(dim=-1)
    bf = best.to(torch.float32)
    # one rounded float32 division by a same-shape divisor: PyTorch on the
    # CPU multiplies by the reciprocal of a scalar divisor
    scores = torch.div(bf, torch.full_like(bf, pack.scale2x))
    if pack.qcenters is not None:
        scores = torch.where(best >= int(INACTIVE_INT), torch.full_like(scores, pack.backoff),
                             scores)
    return scores


def am_scores_q(pack: QuantPack, feats: torch.Tensor) -> torch.Tensor:
    """f32 [N, dim] → f32 [N, S] max-approx state scores: the integer
    minimum over densities exactly like the reference's SSE loop, then the
    single float division by 2·scale² (fillScoreCacheTpl:529-531).

    CPU tensors take the plain version; CUDA tensors launch kernel O's
    tensor-core design (counted in ``am_scores_q.LAUNCHES``): a block a tile
    of frames quantized into shared memory, the products on the s8 tensor
    cores (mma.sync m16n8k32) over the dim padded to 64, 128 or a multiple
    of 256 bytes, the cluster selection through the same product, the
    minimum over each mixture's densities in registers and one division a
    score. Any dim and any cluster count."""
    if feats.device.type == "cpu":
        return am_scores_q_reference(pack, feats)
    out = am_scores_q_cuda(pack, feats)
    am_scores_q.LAUNCHES += 1
    return out


am_scores_q.LAUNCHES = 0


def kernel_dim4(dim: int) -> int:
    """The int32 words a quantized frame takes in kernel O's first design,
    one of its instances' widths: 4, 12 or 32 (dim up to 16, 48 or 128)."""
    return next(w for w in (4, 12, 32) if 4 * w >= dim)


def kernel_row_bytes(dim: int) -> int:
    """The bytes a quantized frame and a mean take in kernel O's tensor-core
    design, one of its instances' widths: 64, 128 or a multiple of 256 (two,
    four or eight k32 steps of the product a chunk)."""
    if dim <= 64:
        return 64
    if dim <= 128:
        return 128
    return -(-dim // 256) * 256


def _padded(t: torch.Tensor, rows: int, cols: Optional[int] = None) -> torch.Tensor:
    """``t`` zero-padded to ``rows`` rows (and ``cols`` columns), contiguous."""
    pad = (0, 0) if cols is None else (0, cols - t.shape[1])
    return torch.nn.functional.pad(t, pad + (0, rows - t.shape[0])).contiguous()


def _kernel_tables(pack: QuantPack, first_design: bool = False) -> Dict:
    """Kernel O's operands, built (and the shapes and cluster map checked) once
    a pack and design. The tensor-core design: the int8 means zero-padded to
    D8 (D rounded up to 8) densities a mixture and to ``kernel_row_bytes``
    bytes a row, qmeans_sq, consts and cluster_of padded alike (0), the
    centers padded to a multiple of 8 rows; all viewed as int32 words. The
    first design (dim <= 128, at most 256 clusters): the means and centers
    padded to ``kernel_dim4`` words a row, the rest as they are."""
    key = "first" if first_design else "mma"
    if key in pack.kernel_tables:
        return pack.kernel_tables[key]
    S, D, dim = pack.num_mixtures, pack.density_cap, pack.dim
    J = S * D
    if D < 1 or dim < 1:
        raise ValueError(f"QuantPack: {D} densities a mixture and dim {dim}; the kernel "
                         f"needs 1 or more of each")
    if (tuple(pack.qmeans.shape) != (J, dim) or pack.qmeans_sq.shape != (J,)
            or pack.consts.shape != (J,) or pack.inv_sqrt_var.shape != (dim,)):
        raise ValueError("QuantPack: the tables' shapes disagree with its mixtures, "
                         "density cap and dim")
    C = 0 if pack.qcenters is None else pack.qcenters.shape[0]
    if pack.qcenters is not None:
        if (tuple(pack.qcenters.shape) != (C, dim) or pack.qcenters_sq.shape != (C,)
                or pack.cluster_of.shape != (J,)):
            raise ValueError("QuantPack: the preselection tables' shapes disagree with its "
                             "clusters, densities and dim")
        if J and not 0 <= int(pack.cluster_of.min()) <= int(pack.cluster_of.max()) < C:
            raise ValueError(f"QuantPack.cluster_of outside [0, {C})")
        if not 1 <= pack.n_selected <= C:
            raise ValueError(f"QuantPack: {pack.n_selected} of {C} clusters selected; the "
                             f"kernel needs 1 <= selected <= clusters")
    if first_design and (dim > FIRST_DESIGN_MAX_DIM or C > FIRST_DESIGN_MAX_CLUSTERS):
        raise ValueError(f"am_scores_q: kernel O's first design takes dim <= "
                         f"{FIRST_DESIGN_MAX_DIM} and <= {FIRST_DESIGN_MAX_CLUSTERS} "
                         f"clusters, got dim {dim} and {C}")

    def ints(t):
        return t.to(torch.int32).contiguous()

    kt = {"isv": pack.inv_sqrt_var.to(torch.float32).contiguous()}
    if first_design:
        width = kernel_dim4(dim) * 4

        def words(t):
            return _padded(t, t.shape[0], width).view(torch.int32)

        kt.update(qmeans=words(pack.qmeans), qmeans_sq=ints(pack.qmeans_sq),
                  consts=ints(pack.consts), row_bytes=width)
        if C:
            kt.update(qcenters=words(pack.qcenters), qcenters_sq=ints(pack.qcenters_sq),
                      cluster_of=ints(pack.cluster_of))
    else:
        width = kernel_row_bytes(dim)
        D8 = -(-D // 8) * 8

        def per_density(t):     # [J, ...] → [S * D8, ...], padding densities 0
            t = t.reshape(S, D, *t.shape[1:])
            pad = (0, 0) * (t.dim() - 2) + (0, D8 - D)
            return torch.nn.functional.pad(t, pad).reshape(S * D8, *t.shape[2:])

        kt.update(qmeans=_padded(per_density(pack.qmeans), S * D8, width).view(torch.int32),
                  qmeans_sq=ints(per_density(pack.qmeans_sq)),
                  consts=ints(per_density(pack.consts)), row_bytes=width)
        if C:
            C8 = -(-C // 8) * 8
            kt.update(qcenters=_padded(pack.qcenters, C8, width).view(torch.int32),
                      qcenters_sq=ints(_padded(pack.qcenters_sq[:, None], C8)[:, 0]),
                      cluster_of=ints(per_density(pack.cluster_of)))
    pack.kernel_tables[key] = kt
    return kt


def am_scores_q_cuda(pack: QuantPack, feats: torch.Tensor,
                     first_design: bool = False) -> torch.Tensor:
    """Kernel O's launch on a CUDA tensor, as ``am_scores_q`` makes it but
    not counted; ``first_design=True`` launches the first design (a thread a
    mixture, ``__dp4a`` products; dim <= 128, at most 256 clusters) for
    timing in turns."""
    if feats.device.type != "cuda" or pack.device != feats.device:
        raise ValueError(f"am_scores_q: features on {feats.device}, pack on {pack.device}; "
                         f"the kernel needs both on one CUDA device")
    if feats.dim() != 2 or feats.shape[1] != pack.dim:
        raise ValueError(f"am_scores_q: features must be [N, {pack.dim}], "
                         f"got {tuple(feats.shape)}")
    S = pack.num_mixtures
    C = 0 if pack.qcenters is None else pack.qcenters.shape[0]
    kt = _kernel_tables(pack, first_design)
    x = feats.to(torch.float32).contiguous()
    N = x.shape[0]
    out = torch.empty((N, S), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    lib = _native.load()
    scratch = None
    if C and not first_design:
        per_block = lib.sr_quantized_scores_scratch(kt["row_bytes"], C)
        blocks = -(-N // lib.sr_quantized_scores_tile(kt["row_bytes"]))
        scratch = _native.scratch(blocks, per_block, x.device)
    err = lib.sr_quantized_scores(
        int(first_design), x.data_ptr(), kt["isv"].data_ptr(), kt["qmeans"].data_ptr(),
        kt["qmeans_sq"].data_ptr(), kt["consts"].data_ptr(), _native.ptr(kt.get("qcenters")),
        _native.ptr(kt.get("qcenters_sq")), _native.ptr(kt.get("cluster_of")), out.data_ptr(),
        _native.ptr(scratch), N, S, pack.density_cap, pack.dim, kt["row_bytes"], C,
        int(pack.n_selected), float(np.float32(pack.scale2x)), float(np.float32(pack.backoff)),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _native.check(err, "am_scores_q")
    return out


@tracing.span("quantized.scores")
def am_scores_q_chunked(pack: QuantPack, feats: torch.Tensor,
                        chunk: int = 1 << 15) -> torch.Tensor:
    """``am_scores_q`` over chunks of ``chunk`` frames (gmm.am_scores'
    memory bound): ⌈N/chunk⌉ calls, the same scores row for row."""
    N = feats.shape[0]
    if N <= chunk:
        return am_scores_q(pack, feats)
    return torch.cat([am_scores_q(pack, feats[i:i + chunk]) for i in range(0, N, chunk)])
