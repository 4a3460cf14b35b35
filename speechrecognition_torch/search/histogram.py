"""Histogram pruning: cap the number of active hypotheses per frame —
counterpart of speechrecognition_tpu/search/histogram.py.

The reference's score histogram (rwth-asr-0.5/src/Search/Histogram.hh:26-77)
and its use in the production decoder
(Search/WordConditionedTreeSearch.cc:1256-1287): after beam pruning, if more
than ``limit`` hypotheses survive, the threshold drops to the score quantile
of the ``limit``-th best hypothesis, read from a fixed-bin histogram:

  * bin(s) = trunc((s − lower)·scale) clamped to [0, bins − 1], with
    scale = (bins − 1)/max(upper − lower, 1e-30)     (Histogram.hh:32-39)
  * quantile(n) walks the bins until the cumulative count reaches n and
    returns bin_index/scale + lower                  (Histogram.hh:62-74)
  * pruning keeps the valid hypotheses with score <= threshold

Every float step is in the scores' dtype, as the reference computes it.
Here the functions run over a leading batch axis ([B, M] scores, one
histogram per row); kernel K (``csrc/wcts_scan.cu``) does the same
arithmetic per utterance in ``csrc/histogram.cuh``.
"""

from __future__ import annotations

import torch

DEFAULT_BINS = 101  # paramAcousticPruningBins default ("number of bins", WCTS.cc:1051-1055)


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b as one rounded division per element. A 0-d divisor is expanded
    first: PyTorch multiplies by the reciprocal of a scalar divisor, which
    can differ from the quotient by an ulp."""
    a, b = torch.broadcast_tensors(a.reshape(-1), b.reshape(-1))
    return torch.div(a, b.contiguous())


def _scale(lower: torch.Tensor, upper: torch.Tensor, bins: int) -> torch.Tensor:
    tiny = torch.tensor(1e-30, dtype=upper.dtype, device=upper.device)
    top = torch.tensor(bins - 1, dtype=upper.dtype, device=upper.device)
    return _div(top, torch.maximum(upper - lower, tiny))[0]


def histogram_quantile(scores: torch.Tensor, valid: torch.Tensor, lower, upper, n,
                       bins: int = DEFAULT_BINS) -> torch.Tensor:
    """Score of the ``n``-th best valid hypothesis of each row,
    histogram-quantized.

    scores [B, M] float; valid [B, M] bool (invalid entries are ignored).
    Returns [B]: the LOWER edge of the first bin whose cumulative count
    reaches ``n`` (Histogram.hh:69), or bins/scale + lower if none does."""
    dtype, device = scores.dtype, scores.device
    lower = torch.as_tensor(lower, dtype=dtype, device=device)
    upper = torch.as_tensor(upper, dtype=dtype, device=device)
    scale = _scale(lower, upper, bins)
    # invalid entries count nothing; binning them at `lower` keeps the
    # float -> int conversion in range
    s = torch.where(valid, scores, lower)
    idx = ((s - lower) * scale).to(torch.int32).clamp(0, bins - 1)
    counts = torch.zeros((scores.shape[0], bins), dtype=torch.int64, device=device)
    counts.scatter_add_(1, idx.long(), valid.long())
    hit = counts.cumsum(1) >= n
    b = torch.where(hit.any(1), hit.to(torch.uint8).argmax(1),
                    torch.full_like(hit[:, 0], bins, dtype=torch.int64))
    return _div(b.to(dtype), scale) + lower


def histogram_prune(scores: torch.Tensor, valid: torch.Tensor, limit, lower, upper,
                    bins: int = DEFAULT_BINS):
    """Tighten a beam threshold to keep at most ~``limit`` hypotheses a row
    (WordConditionedTreeSearch.cc:1256-1264): when a row's valid count
    exceeds ``limit`` (and lower < upper), its threshold drops to the
    histogram quantile. Returns (keep [B, M], threshold [B]); keep is
    ``valid & (scores <= threshold)``."""
    dtype, device = scores.dtype, scores.device
    lower = torch.as_tensor(lower, dtype=dtype, device=device)
    upper = torch.as_tensor(upper, dtype=dtype, device=device)
    count = valid.sum(1)
    q = histogram_quantile(scores, valid, lower, upper, limit, bins)
    thr = torch.where((count > limit) & (lower < upper), q, upper)
    return valid & (scores <= thr[:, None]), thr
