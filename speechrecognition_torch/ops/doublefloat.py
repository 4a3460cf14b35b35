"""Double-float (two-float32) arithmetic on tensors.

Counterpart of speechrecognition_tpu/ops/doublefloat.py. The reference
accumulates acoustic and path scores in C++ ``double``
(src/sietill/Mixtures.cpp:590-628, Recognizer.cpp:103-232); a pair of
float32 ``(hi, lo)`` with ``|lo| <= ulp(hi)/2`` carries ~49 bits of mantissa
with float32 arithmetic only (Dekker 1971, Knuth TAOCP vol. 2).

Every function is a plain elementwise function on float32 tensors, and every
step of an error-free transform is its own tensor op: no ``addcmul``, no
fused variant and no ``torch.compile``, so nothing contracts a multiply and
an add into one rounding. That keeps each result bit-equal to the JAX
package's, and to the device versions in ``csrc/df.cuh``. Comparisons are
lexicographic on (hi, lo), which equals numeric comparison because pairs are
normalized.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

#: Dekker splitting constant for float32 (2^12 + 1): splits a 24-bit
#: mantissa into two 12-bit halves so products are exact in float32
_SPLIT = 4097.0


class DF(NamedTuple):
    """A double-float value: hi + lo with |lo| <= ulp(hi)/2."""

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape


def df(hi, lo=None, device=None) -> DF:
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    return DF(hi, torch.zeros_like(hi) if lo is None
              else torch.as_tensor(lo, dtype=torch.float32, device=hi.device))


def from_f64(x, device=None) -> DF:
    """Split a float64 array into an exact (hi, lo) float32 pair, on the
    host in numpy (exact whenever |x| is within float32 range, which all
    scores are)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF(torch.as_tensor(hi, device=device), torch.as_tensor(lo, device=device))


def to_f64(a: DF) -> np.ndarray:
    return (a.hi.cpu().numpy().astype(np.float64)
            + a.lo.cpu().numpy().astype(np.float64))


def require_f32(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is float32: a float64 tensor that slips
    into a DF op would silently turn the pair into float64."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: double-float words must be float32, got {t.dtype}")


# -- error-free transformations ----------------------------------------------


def two_sum(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """s = fl(a+b); e = exact error. Knuth's branch-free version."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """two_sum requiring |a| >= |b| (used for renormalization)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dekker split of a float32 into two non-overlapping 12-bit halves."""
    t = a * _SPLIT
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """p = fl(a*b); e = exact error, via Dekker splitting (no FMA needed)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- double-float arithmetic ---------------------------------------------------


def add(a: DF, b: DF) -> DF:
    """Full double-float addition (Dekker/Linnainmaa, ~11 flops)."""
    s, e = two_sum(a.hi, b.hi)
    t, f = two_sum(a.lo, b.lo)
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    s, e = fast_two_sum(s, e)
    return DF(s, e)


def add_f(a: DF, b) -> DF:
    """DF + plain float32."""
    s, e = two_sum(a.hi, b)
    e = e + a.lo
    s, e = fast_two_sum(s, e)
    return DF(s, e)


def neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def sub(a: DF, b: DF) -> DF:
    return add(a, neg(b))


def mul(a: DF, b: DF) -> DF:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    p, e = fast_two_sum(p, e)
    return DF(p, e)


def mul_f(a: DF, b) -> DF:
    p, e = two_prod(a.hi, b)
    e = e + a.lo * b
    p, e = fast_two_sum(p, e)
    return DF(p, e)


def sq_f(x) -> DF:
    """Exact square of a float32 as a DF."""
    p, e = two_prod(x, x)
    return DF(p, e)


# -- comparison / selection ----------------------------------------------------


def less(a: DF, b: DF) -> torch.Tensor:
    """a < b, exact (lexicographic on normalized pairs)."""
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def less_equal(a: DF, b: DF) -> torch.Tensor:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo <= b.lo))


def where(cond, a: DF, b: DF) -> DF:
    return DF(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def minimum(a: DF, b: DF) -> DF:
    return where(less(a, b), a, b)


def min_axis(a: DF, axis) -> DF:
    """Exact min along axes by pairwise halving, one axis at a time from the
    highest down (the reference's reduction, step for step)."""
    if isinstance(axis, int):
        axis = (axis,)
    rank = a.hi.dim()
    out = a
    for ax in sorted([ax % rank for ax in axis], reverse=True):
        out = _min_one_axis(out, ax)
    return out


def _min_one_axis(a: DF, ax: int) -> DF:
    n = a.hi.shape[ax]
    hi, lo = a.hi, a.lo
    while n > 1:
        half = n // 2
        odd = n - 2 * half
        m = minimum(DF(hi.narrow(ax, 0, half), lo.narrow(ax, 0, half)),
                    DF(hi.narrow(ax, half, half), lo.narrow(ax, half, half)))
        if odd:
            hi = torch.cat([m.hi, hi.narrow(ax, 2 * half, odd)], dim=ax)
            lo = torch.cat([m.lo, lo.narrow(ax, 2 * half, odd)], dim=ax)
            n = half + 1
        else:
            hi, lo = m.hi, m.lo
            n = half
    return DF(hi.select(ax, 0), lo.select(ax, 0))
