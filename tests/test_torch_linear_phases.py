"""The arithmetic of kernels M's and O's Hopper designs, modelled in PyTorch
on the CPU and held to the JAX package.

Kernel M's warp instance takes each word's bigram recombination
(``cand.min`` / ``jnp.argmin`` over the predecessors,
speechrecognition_tpu/search/linear_lvcsr.py) over G lanes of a warp (G =
32 // words a warp: 3 at AN4's 130 words): lane k folds the predecessors
v = k (mod G) in order with a strict <, then the group's first lane takes
the least (value, v) pair of its lanes (search::pair_less: the value, then
the index among equal values, -0 equal to +0), the value the one that lane
computed. ``group_fold`` below is that model. On forced ties (equal books,
equal lm_ext columns and duplicated rows, predecessors reached through
their silence copy at a word's book, unreachable BIG predecessors, -0 and
+0 books) with 33 to 256 predecessors and G of 1 to 32, and on the books of
JAX's own scans of tests/torch_linear_tables.py's cases, it gives JAX's
``entry_base`` and ``entry_pred`` bit for bit.

Kernel O's tensor-core design sums the int8 products per 32-byte slice of
the zero-padded frame (``mma.sync`` m16n8k32 k-steps, exact int32),
forms xx + (qmeans_sq + consts) - 2 * cross modulo 2^32 over D rounded up
to 8 densities, takes the minimum over a mixture's n8 tiles (a lane's two
columns, then the quad), and divides once; with preselection the cluster
distances go through the same product and the n_selected-th smallest is
the least value with at least n_selected distances at or below it (a
binary search). ``sliced_scores`` below is that model; it gives JAX's
``quantized_distances``, ``_select_mask`` and ``am_scores_q`` bit for bit at
D = 6, 16 and 1, dims 13 to 200, with and without preselection.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.models import quantized as jq
from speechrecognition_tpu.search import linear_lvcsr as jl

from speechrecognition_torch import convert
from speechrecognition_torch.models import quantized as tq
from speechrecognition_torch.search import linear_lvcsr as tl
from test_torch_linear_lvcsr import JDT, jax_scan_args
from test_torch_quantized import frames, jax_model
from torch_linear_tables import LINEAR_CASES, linear_case, pooled_model, pooled_raw

torch.set_num_threads(1)

BIG = 1e30
NP = {torch.float32: np.float32, torch.float64: np.float64}


# -- kernel M: the predecessors over a word's lanes and their pair fold ------------


def pair_less(v, i, w, j) -> bool:
    """search.cuh's pair_less: the smaller value, the smaller index on ties."""
    return bool(v < w or (v == w and i < j))


def group_fold(ebook: np.ndarray, lm: np.ndarray, G: int):
    """(entry_base [W], entry_pred [W]) as kernel M's warp instance forms
    them: lane k < G of a word's group takes the first minimum over its
    predecessors v = k (mod G), in order, by a strict <; the group's first
    lane then folds lanes 1..G-1 into its pair by pair_less."""
    V, W = lm.shape
    dt = lm.dtype.type
    base, pred = np.empty(W, lm.dtype), np.empty(W, np.int32)
    for w in range(W):
        pv = np.full(G, np.inf, lm.dtype)
        pi = np.full(G, 2 ** 31 - 1, np.int64)
        for k in range(min(G, V)):
            pv[k], pi[k] = dt(ebook[k] + lm[k, w]), k      # one rounded add in the type
            for v in range(k + G, V, G):
                c = dt(ebook[v] + lm[v, w])
                if c < pv[k]:
                    pv[k], pi[k] = c, v
        bv, bi = pv[0], pi[0]
        for k in range(1, G):
            if pair_less(pv[k], pi[k], bv, bi):
                bv, bi = pv[k], pi[k]
        base[w], pred[w] = bv, bi
    return base, pred


def jax_entry(ebook: np.ndarray, lm: np.ndarray):
    """The reference's recombination (linear_lvcsr.py's ``cand.min`` and
    ``jnp.argmin`` over axis 1 of [B, V, W]), for one utterance."""
    cand = jnp.asarray(ebook)[None, :, None] + jnp.asarray(lm)[None, :, :]
    return np.asarray(cand.min(axis=1))[0], np.asarray(jnp.argmin(cand, axis=1))[0]


def forced_ties(case: str, V: int, W: int, dt, seed: int):
    """(ebook [V], lm [V, W]) with ties forced across lanes: ``books`` equal
    books and integer LM costs; ``columns`` equal lm_ext columns and
    duplicated rows; ``silence`` half the predecessors reach the minimum
    through their silence copy (their book BIG), half through their book;
    ``unreachable`` BIG books everywhere but a few; ``signed-zero`` books of
    -0 and +0."""
    rng = np.random.default_rng(seed)
    lm = rng.integers(1, 4, (V, W)).astype(dt)
    if case == "books":
        ebook = np.full(V, 2.0, dt)
    elif case == "columns":
        ebook = rng.integers(0, 3, V).astype(dt)
        lm[:, ::3] = lm[:1, ::3]
        lm[V // 2] = lm[1]
    elif case == "silence":
        book = rng.integers(0, 3, V).astype(dt)
        silend = np.full(V, BIG, dt)
        book[V - 1] = BIG                                  # the start context
        through = rng.uniform(size=V) < 0.5
        silend[through], book[through] = book[through], dt(BIG)
        ebook = np.minimum(book, silend)
        assert (silend < book).any() and (book < silend).any()
    elif case == "unreachable":
        ebook = np.full(V, BIG, dt)
        ebook[rng.choice(V, 3, replace=False)] = 1.0
    else:
        ebook = np.where(rng.uniform(size=V) < 0.5, dt(-0.0), dt(0.0)).astype(dt)
        lm[:] = 0.0
    return ebook.astype(dt), lm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("V,G", [(33, 1), (64, 2), (131, 3), (131, 8), (256, 32)])
@pytest.mark.parametrize("case", ["books", "columns", "silence", "unreachable", "signed-zero"])
def test_group_fold_gives_jax_entry_pred_on_forced_ties(case, V, G, dtype):
    dt = NP[dtype]
    ebook, lm = forced_ties(case, V, 12, dt, seed=V)
    base, pred = group_fold(ebook, lm, G)
    jbase, jpred = jax_entry(ebook, lm)
    ties = ((ebook[:, None] + lm) == jbase[None, :]).sum(0)
    assert (ties > 1).any()
    np.testing.assert_array_equal(pred, jpred)
    np.testing.assert_array_equal(base.view(np.uint8), jbase.astype(dt).view(np.uint8))
    # the port's plain version (torch's first argmin) agrees too
    cand = torch.as_tensor(ebook)[:, None] + torch.as_tensor(lm)
    assert torch.equal(cand.argmin(dim=0).to(torch.int32), torch.as_tensor(pred))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(LINEAR_CASES))
def test_group_fold_on_the_books_of_jax_scans(name, dtype):
    """Every live frame's effective books of JAX's scan of a case (word
    ends or, where smaller, silence copy ends; the start context at frame
    1): the model's recombination, with the G the kernel takes for the
    case's lexicon (32 // ceil(W / 16)), equals JAX's at every word."""
    lex, tm, lm, lm_start, am, lens, thr = linear_case(name)
    tables = tm.decoder_tables(lex)
    jargs = jax_scan_args(tables, lm, lm_start, 0, JDT[dtype])
    jout = jl._decode_scan_linear_ts(jnp.asarray(am, JDT[dtype]), jnp.asarray(lens), *jargs,
                                     jnp.asarray(thr, JDT[dtype]), prune=True)
    book, silend = np.asarray(jout[0]), np.asarray(jout[5])
    lm_ext = tl.LinearTables.build(tables, lm, lm_start, 0).lm_ext.astype(NP[dtype])
    W = lm_ext.shape[1]
    G = 32 // -(-W // 16)
    checked = 0
    for b, n in enumerate(lens):
        for t in range(1, int(n) + 1):
            start = np.asarray([0.0 if t == 1 else BIG], NP[dtype])
            prev = np.concatenate([book[t - 2, b] if t > 1 else np.full(book.shape[2], BIG),
                                   start]).astype(NP[dtype])
            ebook = np.minimum(prev, silend[t - 2, b] if t > 1 else np.full(prev.shape, BIG,
                                                                              NP[dtype]))
            base, pred = group_fold(ebook, lm_ext, G)
            jbase, jpred = jax_entry(ebook, lm_ext)
            np.testing.assert_array_equal(pred, jpred)
            np.testing.assert_array_equal(base, jbase)
            checked += 1
    assert checked == int(np.sum(lens))


# -- kernel O: the k-slice product and the n8 tiles ---------------------------------------


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2^32 (two's complement)."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def sliced_cross(qx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """int8 [N, dim] · int8 [M, dim]ᵀ as the tensor cores take it: both
    zero-padded to kernel_row_bytes, the int32 sum of each 32-byte slice
    (one m16n8k32 k-step), the slices' sums added in turn."""
    rb = tq.kernel_row_bytes(qx.shape[1])
    a = torch.nn.functional.pad(qx.to(torch.int64), (0, rb - qx.shape[1]))
    b = torch.nn.functional.pad(table.to(torch.int64), (0, rb - table.shape[1]))
    acc = torch.zeros((qx.shape[0], table.shape[0]), dtype=torch.int32)
    for k in range(0, rb, 32):
        acc = wrap32(acc.to(torch.int64) + wrap32(a[:, k:k + 32] @ b[:, k:k + 32].T))
    return acc


def kth_by_bisection(cd: torch.Tensor, k: int) -> torch.Tensor:
    """The least value with at least k distances at or below it, each row
    (the kernel's binary search on the value)."""
    lo, hi = cd.min(dim=1).values.to(torch.int64), cd.max(dim=1).values.to(torch.int64)
    while bool((lo < hi).any()):
        open_ = lo < hi
        mid = (lo + hi) >> 1
        enough = (cd.to(torch.int64) <= mid[:, None]).sum(dim=1) >= k
        hi = torch.where(open_ & enough, mid, hi)
        lo = torch.where(open_ & ~enough, mid + 1, lo)
    return lo.to(torch.int32)


def sliced_scores(pack, x: np.ndarray):
    """(distances [N, J], selection [N, J] or None, scores [N, S]) as kernel
    O's tensor-core design forms them."""
    S, D = pack.num_mixtures, pack.density_cap
    D8 = -(-D // 8) * 8
    qx = tq.quantize_features(pack, torch.as_tensor(x))
    xx = (qx.to(torch.int64) ** 2).sum(dim=1)
    cross = sliced_cross(qx, pack.qmeans)                                   # [N, J]
    dist = wrap32(xx[:, None] - 2 * cross.to(torch.int64) + pack.qmeans_sq.to(torch.int64))
    base = wrap32(pack.qmeans_sq.to(torch.int64) + pack.consts.to(torch.int64))
    total = wrap32(xx[:, None] + base.to(torch.int64) - 2 * cross.to(torch.int64))
    sel = None
    if pack.qcenters is not None:
        cd = wrap32(xx[:, None] + pack.qcenters_sq.to(torch.int64)
                    - 2 * sliced_cross(qx, pack.qcenters).to(torch.int64))
        chosen = cd <= kth_by_bisection(cd, pack.n_selected)[:, None]
        sel = chosen[:, pack.cluster_of.long()]
        total = torch.where(sel, total, torch.tensor(int(tq.INACTIVE_INT), dtype=torch.int32))
    N = x.shape[0]
    # D padded to D8 with INT_MAX, as n8 tiles: a lane tq's two columns, then
    # the tiles, then the quad (lanes tq = 0..3)
    tiles = torch.full((N, S, D8), 2 ** 31 - 1, dtype=torch.int32)
    tiles[:, :, :D] = total.reshape(N, S, D)
    lanes = tiles.reshape(N, S, D8 // 8, 4, 2).amin(dim=4).amin(dim=2)     # [N, S, 4]
    best = torch.minimum(torch.minimum(lanes[..., 0], lanes[..., 1]),
                         torch.minimum(lanes[..., 2], lanes[..., 3]))
    bf = best.to(torch.float32)
    scores = torch.div(bf, torch.full_like(bf, pack.scale2x))
    if pack.qcenters is not None:
        scores = torch.where(best >= int(tq.INACTIVE_INT),
                             torch.full_like(scores, pack.backoff), scores)
    return dist, sel, scores


@pytest.mark.parametrize("preselection", [False, True])
@pytest.mark.parametrize("D,dim", [(6, 13), (16, 45), (1, 70), (6, 200)])
def test_sliced_product_gives_jax_scores(D, dim, preselection):
    raw = pooled_raw(np.random.default_rng(D + dim), 40, D, dim, empty_share=0.2)
    model = pooled_model(raw)
    kw = dict(preselection=True, num_clusters=24, n_selected=5) if preselection else {}
    jp = jq.build_quant_pack(jax_model(raw), **kw)
    tp = convert.quant_pack_from_jax(jp, device="cpu")
    assert tp.density_cap == D
    x = frames(model, 64, dim)
    dist, sel, scores = sliced_scores(tp, x)
    jqx = jq.quantize_features(jp, jnp.asarray(x))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jq.quantized_distances(jp, jqx)))
    if preselection:
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jq._select_mask(jp, jqx)))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jq.am_scores_q(jp, jnp.asarray(x))))


def test_kth_by_bisection_counts_duplicates():
    """Duplicates count toward k, as ``top_k``'s k-th value does."""
    cd = torch.tensor([[5, 1, 1, 1, 9, 3], [7, 7, 7, 7, 7, 7], [-4, 2 ** 30, 0, -4, 8, 8]],
                      dtype=torch.int32)
    for k in range(1, 7):
        want = torch.topk(cd, k, dim=1, largest=False).values[:, -1]
        assert torch.equal(kth_by_bisection(cd, k), want)
