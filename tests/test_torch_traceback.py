"""Kernel N's start of the walk: the plain version of ``traceback_linear``
against JAX's ``_traceback_device`` on books whose last live rows hold a
NaN (first, middle, last; in the word ends and in the silence ends), forced
ties across lane boundaries (indices 0, 31, 32, 63) and -0.0 tied with +0.0,
at W 1, 31, 32, 33, 130 and 300, in float32 and float64: the words equal.

The kernels cannot run here, so their fold is modelled: the warp design's
(32 lanes, a lane every 32nd entry in order, then a shuffle butterfly) and
the first design's serial loop under the same (value, index) order, NaN
first, both equal to ``torch.argmin``; the first design's strict ``<`` loop
as it was first written skipped a NaN after index 0, which this order repairs.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.search import linear_lvcsr as jl

from speechrecognition_torch.search import linear_lvcsr as tl
from torch_linear_tables import TRACEBACK_STARTS, TRACEBACK_WIDTHS, traceback_books

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]
T, B = 160, 5


def books(name, W, dtype):
    book, bkp, pred, origin, silend, silorg, lens = traceback_books(W, B=B, T=T, W=W,
                                                                    **TRACEBACK_STARTS[name])
    return book.astype(dtype), bkp, pred, origin, silend.astype(dtype), silorg, lens


def last_rows(book, silend, lens):
    last = np.minimum(np.maximum(lens, 1) - 1, book.shape[0] - 1)
    return book[last, np.arange(len(lens))], silend[last, np.arange(len(lens))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("W", TRACEBACK_WIDTHS)
@pytest.mark.parametrize("name", list(TRACEBACK_STARTS))
def test_plain_traceback_equals_jax(name, W, dtype):
    book, bkp, pred, origin, silend, silorg, lens = books(name, W, dtype)
    jw = np.asarray(jl._traceback_device(
        tuple(jnp.asarray(a) for a in (book, bkp, pred, np.zeros(bkp.shape, bool), origin,
                                       silend, silorg, np.zeros(book.shape[:2], dtype))),
        jnp.asarray(lens), W))
    tw = tl.traceback_linear(*(torch.as_tensor(a) for a in (
        book, bkp, pred, origin, silend, silorg)), torch.as_tensor(lens)).numpy()
    np.testing.assert_array_equal(tw, jw)
    assert (tw[:, lens == 0] == -1).all()
    # the forced start is the one the walk took
    fb, fs = last_rows(book, silend, lens)
    live = lens > 0
    opts = TRACEBACK_STARTS[name]
    if "nan" in opts and opts["nan"][0] == "book":
        assert np.isnan(fb).any(axis=1).all()
        np.testing.assert_array_equal(tw[0, live], np.isnan(fb[live]).argmax(axis=1))
    ties = opts.get("ties", ())
    in_book, in_sil = [i for i in ties if i < W], [i for i in ties if i <= W]
    if opts.get("sil_offset", 1.0) < 0 and in_sil:      # the first silence copy wins
        v = in_sil[0]
        last = np.maximum(lens, 1) - 1
        starts = silorg[last, np.arange(B), v] > 0
        np.testing.assert_array_equal(tw[0, live], np.where(starts & (v < W), v, -1)[live])
    elif in_book and not np.isnan(fs).any():            # the first word end wins
        np.testing.assert_array_equal(tw[0, live], in_book[0])


def fold_order(a, ia, b, ib):
    """argmin_before of csrc/linear_traceback.cu: NaN first, then value
    (-0.0 == +0.0), then index."""
    na, nb = math.isnan(a), math.isnan(b)
    if na != nb:
        return na
    if not na and a != b:
        return a < b
    return ia < ib


def warp_fold(row):
    """The warp design's fold: lane l folds entries l, l + 32, ... in
    order, lanes without an entry hold (+inf, INT_MAX), then a butterfly
    of shuffles over offsets 16, 8, 4, 2, 1."""
    lanes = [(math.inf, 2 ** 31 - 1)] * 32
    for k, x in enumerate(row):
        v, i = lanes[k % 32]
        if fold_order(x, k, v, i):
            lanes[k % 32] = (x, k)
    for o in (16, 8, 4, 2, 1):
        lanes = [lanes[lane ^ o] if fold_order(*lanes[lane ^ o], *lanes[lane]) else lanes[lane]
                 for lane in range(32)]
    assert len(set((repr(v), i) for v, i in lanes)) == 1
    return lanes[0]


def serial_fold(row, strict_less=False):
    """The first design's loop: under argmin_before, or (``strict_less``)
    by the strict ``<`` it was first written with."""
    best, i_best = row[0], 0
    for i in range(1, len(row)):
        if (row[i] < best) if strict_less else fold_order(row[i], i, best, i_best):
            best, i_best = row[i], i
    return best, i_best


@pytest.mark.parametrize("W", TRACEBACK_WIDTHS)
@pytest.mark.parametrize("name", list(TRACEBACK_STARTS))
def test_fold_models_equal_argmin(name, W):
    book, _bkp, _pred, _origin, silend, _silorg, lens = books(name, W, np.float32)
    fb, fs = last_rows(book, silend, lens)
    for rows in (fb, fs):
        want = torch.as_tensor(rows).argmin(dim=1).numpy()
        least = torch.as_tensor(rows).amin(dim=1).numpy()
        for r, w, m in zip(rows.tolist(), want, least):
            for v, i in (warp_fold(r), serial_fold(r)):
                assert i == w
                assert (math.isnan(v) and math.isnan(m)) or v == m
    # the silence test on the folded values is the reference's amin < book[w_best]
    sil = torch.as_tensor(fs).amin(dim=1) < torch.as_tensor(fb).gather(
        1, torch.as_tensor(fb).argmin(dim=1, keepdim=True))[:, 0]
    assert [warp_fold(s)[0] < warp_fold(w)[0] for s, w in zip(fs.tolist(), fb.tolist())] \
        == sil.tolist()


@pytest.mark.parametrize("where", ["book", "silend"])
def test_the_first_designs_strict_less_skipped_a_later_nan(where):
    """The fault the order repairs: a NaN after index 0 never compares
    less, so the strict loop kept a number where argmin keeps the NaN."""
    book, _bkp, _pred, _origin, silend, _silorg, lens = books(f"nan-{where}-middle", 33,
                                                                np.float64)
    fb, fs = last_rows(book, silend, lens)
    rows = fb if where == "book" else fs
    for r in rows.tolist():
        assert serial_fold(r, strict_less=True)[1] != len(r) // 2
        assert serial_fold(r)[1] == warp_fold(r)[1] == len(r) // 2


def test_argmin_takes_the_first_nan_and_ties_signed_zeros():
    """The premise, in both frameworks: the first NaN wins and the least
    value is NaN; -0.0 ties with +0.0 and the first index wins."""
    for xs, want in (([3.0, math.nan, 1.0, math.nan], 1), ([0.0, -0.0, -0.0], 0),
                     ([1.0, -0.0, 0.0], 1)):
        for dt in (np.float32, np.float64):
            a = np.asarray(xs, dt)
            assert int(torch.as_tensor(a).argmin()) == int(jnp.argmin(jnp.asarray(a))) == want
    assert math.isnan(float(torch.tensor([3.0, math.nan, 1.0]).amin()))
    assert math.isnan(float(jnp.min(jnp.asarray([3.0, math.nan, 1.0]))))
