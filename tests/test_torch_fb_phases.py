"""Kernel L's plain phases on the CPU: the forward rows and log_z, the
backward rows and the posterior rows from the two, which kernel L's
instance for A <= 96 runs as two concurrent chains and a posterior pass.

* Their composition (``forward_backward_reference``) is bit for bit the
  single-function plain version it replaced (kept below as
  ``monolithic_reference``), over every ``L_INSTANCES`` shape at T 1, 2
  and 40, float32 and float64, with ragged lengths and
  ``fb_inputs``' unreachable final position.
* It stays within 1e-12 (float64) of JAX's ``_forward_backward`` on the same
  seeded inputs, and the port's float32 within 1e-5 of JAX's float64 run
  on the same float32 inputs (JAX's float32 scan does not trace), run as
  tests/test_torch_baumwelch.py runs it.
* ``order_key_max``, the plain version of the chains' and the posterior
  pass's row maximum (``keys::warp_maximum``: order-preserving keys and
  redux.sync), equals ``amax`` on rows with ties, a row whose maximum is 0
  (also with −0 in it), a dead row and rows of −inf padding; the renorm's
  v − shift at the maximum is +0.
* Each phase keeps the boundaries the kernel relies on: alpha rows from
  feat_len on repeat the last one, beta rows from feat_len − 1 on are β_T.
"""

import functools

import numpy as np
import pytest
import torch

import speechrecognition_torch.align.baumwelch as tbw
from test_torch_baumwelch import jax_fb
from torch_fb_tables import L_INSTANCES, fb_inputs

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
TOL = {"f64": 1e-12, "f32": 1e-5}
#: B of every case: ragged lengths, utterance 0 at full length, utterance 1
#: with an unreachable final position where the shape allows one
B = 5


def monolithic_reference(lams, ltdp, pos_valid, feat_len, aut_len):
    """The plain version as one function, as it stood before its split into
    phases: the forward scan, the backward scan, then the posteriors."""
    B, T, A = lams.shape
    dtype, device = lams.dtype, lams.device
    neg_big = torch.tensor(tbw.NEG_BIG, dtype=dtype, device=device)
    half = neg_big * 0.5
    ltdp = ltdp.to(device=device, dtype=dtype)
    invalid = ~pos_valid.to(device=device, dtype=torch.bool)
    fl = feat_len.to(device=device, dtype=torch.long)
    al = aut_len.to(device=device, dtype=torch.long)
    pos = torch.arange(A, device=device)

    def mask(x):
        return torch.where(invalid, neg_big, x)

    alpha = mask(torch.where(pos[None, :] == 0, lams[:, 0, :], neg_big))
    alphas = [alpha]
    shift_sum = torch.zeros(B, dtype=dtype, device=device)
    for t in range(1, T):
        c0 = alpha + ltdp[:, :, 0]
        c1 = tbw._from_below(alpha, ltdp[:, :, 1], 1, neg_big)
        c2 = tbw._from_below(alpha, ltdp[:, :, 2], 2, neg_big)
        new, shift = tbw._renorm(mask(tbw._lse3(c0, c1, c2, neg_big, half) + lams[:, t]),
                                 neg_big, half)
        alive = t < fl
        alpha = torch.where(alive[:, None], new, alpha)
        shift_sum = shift_sum + torch.where(alive, shift, torch.zeros_like(shift))
        alphas.append(alpha)

    beta_T = torch.where(pos[None, :] == (al - 1)[:, None], torch.zeros((), dtype=dtype,
                                                                        device=device), neg_big)
    betas = [beta_T]
    beta = beta_T
    for t in range(T - 2, -1, -1):
        term = beta + lams[:, t + 1]
        b0 = term + ltdp[:, :, 0]
        b1 = tbw._from_above(term + ltdp[:, :, 1], 1, neg_big)
        b2 = tbw._from_above(term + ltdp[:, :, 2], 2, neg_big)
        new, _ = tbw._renorm(mask(tbw._lse3(b0, b1, b2, neg_big, half)), neg_big, half)
        beta = torch.where((t >= fl - 1)[:, None], beta_T, new)
        betas.append(beta)
    betas.reverse()

    alphas = torch.stack(alphas, dim=1)
    post = alphas + torch.stack(betas, dim=1)
    safe = torch.maximum(post.amax(dim=2, keepdim=True), half)
    p = torch.where(post <= half, torch.zeros((), dtype=dtype, device=device),
                    torch.exp(post - safe))
    gamma = p / torch.clamp(tbw._row_sum(p), min=1e-30)
    frame_valid = torch.arange(T, device=device)[None, :] < fl[:, None]
    gamma = torch.where(frame_valid[:, :, None], gamma, torch.zeros((), dtype=dtype,
                                                                    device=device))
    last_t = torch.where(fl - 1 < 0, fl - 1 + T, fl - 1).clamp(0, T - 1)
    fz = torch.where(al - 1 < 0, al - 1 + A, al - 1).clamp(0, A - 1)
    rows = torch.arange(B, device=device)
    log_z = alphas[rows, last_t, fz] + shift_sum
    return gamma, log_z


def seeded(A, T, kind):
    """fb_inputs as numpy float64 (rounded through float32 for kind f32) and
    as tensors in the kind's type."""
    lams, ltdp, pv, fl, al = fb_inputs(B, T, A, seed=A * 10 + T)
    if kind == "f32":
        lams = lams.astype(np.float32).astype(np.float64)
        ltdp = ltdp.astype(np.float32).astype(np.float64)
    dt = DTYPES[kind]
    args = (torch.as_tensor(lams, dtype=dt), torch.as_tensor(ltdp, dtype=dt),
            torch.as_tensor(pv), torch.as_tensor(fl), torch.as_tensor(al))
    return (lams, ltdp, pv, fl, al), args


def phases(*args):
    alphas, log_z = tbw.forward_reference(*args)
    betas = tbw.backward_reference(*args)
    return tbw.posterior_reference(alphas, betas, args[3]), log_z


@functools.lru_cache(maxsize=None)
def jax_result(A, T):
    """JAX's float64 run on the f32 kind's inputs and on the f64 kind's,
    each compiled once per shape."""
    return {kind: jax_fb(*seeded(A, T, kind)[0]) for kind in DTYPES}


@pytest.mark.parametrize("A", list(L_INSTANCES))
@pytest.mark.parametrize("T", [1, 2, 40])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_phases_compose_to_the_monolithic_reference(A, T, kind):
    _, args = seeded(A, T, kind)
    g, z = phases(*args)
    gm, zm = monolithic_reference(*args)
    assert g.dtype == DTYPES[kind] and z.dtype == DTYPES[kind]
    assert torch.equal(g, gm) and torch.equal(z, zm)
    g2, z2 = tbw.forward_backward_reference(*args)
    assert torch.equal(g2, gm) and torch.equal(z2, zm)
    if A >= 4 and T >= 2:     # the unreachable final position: rows of 0, never NaN
        assert torch.equal(g[1], torch.zeros_like(g[1]))


@pytest.mark.parametrize("A", list(L_INSTANCES))
@pytest.mark.parametrize("T", [1, 2, 40])
@pytest.mark.parametrize("kind", list(DTYPES))
def test_phases_equal_jax(A, T, kind):
    _, args = seeded(A, T, kind)
    g, z = phases(*args)
    jg, jz = jax_result(A, T)[kind]
    g, z = g.numpy().astype(np.float64), z.numpy().astype(np.float64)
    assert np.isfinite(g).all() and np.isfinite(z).all()
    np.testing.assert_allclose(g, jg, rtol=0, atol=TOL[kind])
    np.testing.assert_allclose(z, jz, rtol=TOL[kind], atol=0)


NB = tbw.NEG_BIG
INF = float("inf")
#: rows of the order-preserving maximum's cases; the last axis is reduced
KEY_MAX_ROWS = {
    "ties": [[-3.5, -1.25, -1.25, -7.0, -1.25], [2.0, 2.0, 2.0, 2.0, 2.0]],
    "maximum 0": [[-5.0, 0.0, NB, -0.5, -2.0], [0.0, -0.0, NB, -1.0, -3.0]],
    "maximum -0 only": [[-0.0, -4.0, NB, -1.0, -0.0], [-0.0, -0.0, -0.0, -0.0, -0.0]],
    "dead row": [[NB, NB, NB, NB, NB], [NB, NB, -INF, -INF, -INF]],
    "-inf padding": [[-2.0, -INF, -INF, -INF, -INF], [-INF, -INF, -INF, -INF, -INF]],
    "positive and tiny": [[1e-30, 5e-31, 3.0e-38, -1e-30, 1.0], [1e-38, 2e-38, -1e-38, 0.0, NB]],
}


@pytest.mark.parametrize("case", list(KEY_MAX_ROWS))
@pytest.mark.parametrize("kind", list(DTYPES))
def test_order_key_max_equals_amax(case, kind):
    x = torch.tensor(KEY_MAX_ROWS[case], dtype=DTYPES[kind])
    got = tbw.order_key_max(x)
    assert got.dtype == x.dtype and got.shape == x.shape[:-1]
    assert torch.equal(got, x.amax(dim=-1))
    # a maximum of 0 comes back as +0, as the keys take -0 as +0
    assert not torch.signbit(got[got == 0]).any()


@pytest.mark.parametrize("kind", list(DTYPES))
def test_order_key_max_on_random_rows(kind):
    rng = np.random.default_rng(11)
    x = rng.normal(0.0, 1e3, (400, 70)) - rng.uniform(0.0, 1e4, (400, 1))
    x[::7, 3:] = NB
    x[::5, :] = np.round(x[::5, :])           # integers: many ties
    t = torch.as_tensor(x, dtype=DTYPES[kind])
    assert torch.equal(tbw.order_key_max(t), t.amax(dim=-1))


@pytest.mark.parametrize("kind", list(DTYPES))
def test_renorm_shifts_the_maximum_to_plus_zero(kind):
    """v - shift at a row's maximum is +0, never -0, so the chains' keys
    (which take -0 as +0) see the plain version's values; a dead row keeps
    its shift 0."""
    dt = DTYPES[kind]
    neg_big = torch.tensor(NB, dtype=dt)
    x = torch.tensor([[-5.0, -2.5, NB, -2.5], [NB, NB, NB, NB], [3.0, -1.0, 0.5, NB]], dtype=dt)
    row, shift = tbw._renorm(x, neg_big, neg_big * 0.5)
    assert torch.equal(shift, torch.tensor([-2.5, 0.0, 3.0], dtype=dt))
    live = torch.tensor([True, False, True])
    at_max = row[live][x[live] == x[live].amax(dim=1, keepdim=True)]   # 2 in row 0, 1 in row 2
    assert torch.equal(at_max, torch.zeros(3, dtype=dt)) and not torch.signbit(at_max).any()
    assert torch.equal(row[1], x[1])


@pytest.mark.parametrize("kind", list(DTYPES))
def test_phase_boundaries(kind):
    """The rows the kernel's chains do not write equal what the plain phases
    give there: alpha from feat_len on repeats row feat_len - 1, beta from
    feat_len - 1 on is 0 at aut_len - 1 and NEG_BIG elsewhere."""
    _, args = seeded(33, 40, kind)
    alphas, _ = tbw.forward_reference(*args)
    betas = tbw.backward_reference(*args)
    fl, al = args[3].tolist(), args[4].tolist()
    for b in range(B):
        n = fl[b]
        assert torch.equal(alphas[b, n:], alphas[b, n - 1:n].expand(40 - n, 33))
        beta_T = torch.full((33,), NB, dtype=DTYPES[kind])
        beta_T[al[b] - 1] = 0.0
        assert torch.equal(betas[b, n - 1:], beta_T.expand(41 - n, 33))
