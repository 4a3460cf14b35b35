"""The port's double-float ops against the JAX package's, and against float64.

Every op of speechrecognition_torch.ops.doublefloat must be bit-equal (hi and
lo) to speechrecognition_tpu.ops.doublefloat evaluated op by op on the same
float32 inputs, including the sentinels the decoder and scorer carry
(±1e30 = BIG, 5e17 = INACTIVE_SCORE, 1e10 = MIN_SCORE_INIT) and zeros. The
exactness checks of tests/test_doublefloat.py are mirrored against float64
with the same bounds.

Inputs stay clear of the float32 subnormal range: XLA on the CPU flushes
subnormal results to zero, where PyTorch (and the card, built without -ftz)
keeps them, so a product of two ~1e-30 words would differ there and nowhere
else. Scores never come near it (|score| >= ~1e-3, lo >= ~2^-24·|hi|).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.ops import doublefloat as jdf

from speechrecognition_torch.ops import doublefloat as tdf

SENTINELS = np.array([1e30, -1e30, 5e17, -5e17, 1e10, 0.0, -0.0, 200.0])


def values(seed, n=2000, scale=100.0):
    """float64 test values: random magnitudes spanning about 1e-4 .. 1e6, plus
    every sentinel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * scale * 10.0 ** rng.uniform(-6, 4, n)
    return np.concatenate([x, SENTINELS])


def pair(x64):
    """The same DF value in both packages (split once, by the JAX package)."""
    j = jdf.from_f64(x64)
    return j, tdf.DF(torch.from_numpy(np.array(j.hi)), torch.from_numpy(np.array(j.lo)))


def assert_bits(jax_out, torch_out):
    """Equal values and equal sign bits (so -0.0 is told from +0.0)."""
    for j, t in zip(jax_out if isinstance(jax_out, tuple) else (jax_out,),
                    torch_out if isinstance(torch_out, tuple) else (torch_out,)):
        j = np.asarray(j)
        t = t.numpy()
        assert j.dtype == t.dtype
        np.testing.assert_array_equal(j, t)
        np.testing.assert_array_equal(np.signbit(j), np.signbit(t))


def test_from_f64_splits_like_jax():
    x = values(0)
    j = jdf.from_f64(x)
    t = tdf.from_f64(x)
    assert t.hi.dtype == t.lo.dtype == torch.float32
    assert_bits((j.hi, j.lo), (t.hi, t.lo))
    np.testing.assert_array_equal(tdf.to_f64(t), jdf.to_f64(j))
    # the sentinels split with a non-zero lo where float32 cannot hold them
    big = tdf.from_f64(np.array([1e30, 5e17]))
    assert (big.lo != 0).all()


def test_df_and_require_f32():
    d = tdf.df(np.array([1.5, -2.0]))
    assert d.hi.dtype == torch.float32 and torch.equal(d.lo, torch.zeros(2))
    tdf.require_f32("ok", d.hi, d.lo)
    with pytest.raises(TypeError, match="float32"):
        tdf.require_f32("x", d.hi, d.lo.double())


@pytest.mark.parametrize("name", ["two_sum", "fast_two_sum", "two_prod"])
def test_error_free_transforms_bit_equal(name):
    x = values(1).astype(np.float32)
    y = np.roll(values(2), 7).astype(np.float32)
    if name == "fast_two_sum":           # its precondition |a| >= |b|
        x, y = np.where(np.abs(x) >= np.abs(y), x, y), np.where(np.abs(x) >= np.abs(y), y, x)
    if name == "two_prod":               # products stay inside float32 range
        x, y = np.clip(x, -1e15, 1e15), np.clip(y, -1e15, 1e15)
    assert_bits(getattr(jdf, name)(jnp.asarray(x), jnp.asarray(y)),
                getattr(tdf, name)(torch.from_numpy(x), torch.from_numpy(y)))


@pytest.mark.parametrize("name", ["split", "sq_f"])
def test_unary_transforms_bit_equal(name):
    x = np.clip(values(3), -1e15, 1e15).astype(np.float32)
    out_j = getattr(jdf, name)(jnp.asarray(x))
    out_t = getattr(tdf, name)(torch.from_numpy(x))
    assert_bits(tuple(out_j), tuple(out_t))


@pytest.mark.parametrize("name", ["add", "sub", "mul", "minimum"])
def test_binary_df_ops_bit_equal(name):
    a64 = values(4)
    b64 = np.roll(values(5), 3)
    if name == "mul":
        a64, b64 = np.clip(a64, -1e15, 1e15), np.clip(b64, -1e15, 1e15)
    (ja, ta), (jb, tb) = pair(a64), pair(b64)
    assert_bits(tuple(getattr(jdf, name)(ja, jb)), tuple(getattr(tdf, name)(ta, tb)))


@pytest.mark.parametrize("name", ["add_f", "mul_f"])
def test_mixed_df_ops_bit_equal(name):
    a64 = np.clip(values(6), -1e15, 1e15)
    b = np.clip(np.roll(values(7), 5), -1e15, 1e15).astype(np.float32)
    ja, ta = pair(a64)
    assert_bits(tuple(getattr(jdf, name)(ja, jnp.asarray(b))),
                tuple(getattr(tdf, name)(ta, torch.from_numpy(b))))


def test_neg_less_where_bit_equal():
    a64 = values(8)
    b64 = np.concatenate([a64[:500], np.roll(a64, 11)[500:]])   # many exact ties
    (ja, ta), (jb, tb) = pair(a64), pair(b64)
    assert_bits(tuple(jdf.neg(ja)), tuple(tdf.neg(ta)))
    for op in ("less", "less_equal"):
        np.testing.assert_array_equal(np.asarray(getattr(jdf, op)(ja, jb)),
                                      getattr(tdf, op)(ta, tb).numpy())
    cond = np.arange(a64.size) % 3 == 0
    assert_bits(tuple(jdf.where(jnp.asarray(cond), ja, jb)),
                tuple(tdf.where(torch.from_numpy(cond), ta, tb)))


@pytest.mark.parametrize("axis", [0, 1, 2, -1, (1, 2), (0, 1, 2)])
def test_min_axis_bit_equal(axis):
    x = values(9, n=7 * 33 * 5 - SENTINELS.size).reshape(7, 33, 5)
    x[0, 0, 0] = 5.0
    x[0, 1, 0] = 5.0 + 1e-11              # a near-tie float32 alone cannot order
    x[1, 2, :] = 1e30                     # a row of BIG
    (jx, tx) = pair(x)
    assert_bits(tuple(jdf.min_axis(jx, axis)), tuple(tdf.min_axis(tx, axis)))


# -- exactness against float64 (mirrors tests/test_doublefloat.py) -------------

RNG_SEED = 7


def _rand(rng, shape, scale=100.0):
    return (rng.standard_normal(shape) * scale).astype(np.float64)


def test_from_to_f64_roundtrip():
    """A DF pair carries ~49 mantissa bits: the roundtrip is within 2^-48
    relative, and |lo| <= ulp(hi)."""
    x = _rand(np.random.default_rng(RNG_SEED), (1000,))
    d = tdf.from_f64(x)
    np.testing.assert_allclose(tdf.to_f64(d), x, rtol=2.0 ** -48)
    hi = d.hi.numpy().astype(np.float64)
    ulp = np.spacing(np.abs(d.hi.numpy())).astype(np.float64)
    assert np.all(np.abs(d.lo.numpy().astype(np.float64)) <= ulp + 1e-300)
    assert np.all(np.abs(hi) > 0)


def test_two_sum_and_two_prod_exact():
    rng = np.random.default_rng(RNG_SEED)
    a = _rand(rng, (1000,)).astype(np.float32)
    b = (_rand(rng, (1000,)) * 1e-5).astype(np.float32)
    s, e = tdf.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(s.numpy().astype(np.float64) + e.numpy(),
                                  a.astype(np.float64) + b)
    c = _rand(rng, (1000,)).astype(np.float32)
    p, e = tdf.two_prod(torch.from_numpy(a), torch.from_numpy(c))
    np.testing.assert_array_equal(p.numpy().astype(np.float64) + e.numpy(),
                                  a.astype(np.float64) * c)


def test_sq_f_exact():
    x = _rand(np.random.default_rng(RNG_SEED + 1), (300,)).astype(np.float32)
    np.testing.assert_array_equal(tdf.to_f64(tdf.sq_f(torch.from_numpy(x))),
                                  x.astype(np.float64) ** 2)


def test_add_chain_tracks_f64():
    """Summing 10k mixed-magnitude terms stays within 2^-45 of float64."""
    rng = np.random.default_rng(RNG_SEED + 2)
    xs = _rand(rng, (10000,), scale=1.0) * np.logspace(0, 4, 10000)
    acc = tdf.df(np.zeros(()))
    for i in range(0, 10000, 500):
        acc = tdf.add(acc, tdf.from_f64(xs[i:i + 500].sum()))
    want = sum(xs[i:i + 500].sum() for i in range(0, 10000, 500))
    assert abs(float(tdf.to_f64(acc)) - want) <= abs(want) * 2.0 ** -45


def test_mul_tracks_f64():
    rng = np.random.default_rng(RNG_SEED + 3)
    a = tdf.from_f64(_rand(rng, (512,)))
    b = tdf.from_f64(_rand(rng, (512,)))
    np.testing.assert_allclose(tdf.to_f64(tdf.mul(a, b)), tdf.to_f64(a) * tdf.to_f64(b),
                               rtol=2.0 ** -45)


def test_comparisons_lexicographic():
    a64 = np.array([1.0, 1.0, 1.0 + 1e-12, 2.0, -3.0])
    b64 = np.array([1.0 + 1e-12, 1.0, 1.0, 2.0 + 1e-9, -3.0 + 1e-13])
    a, b = tdf.from_f64(a64), tdf.from_f64(b64)
    np.testing.assert_array_equal(tdf.less(a, b).numpy(), a64 < b64)
    np.testing.assert_array_equal(tdf.less_equal(a, b).numpy(), a64 <= b64)


def test_min_axis_matches_f64():
    x = _rand(np.random.default_rng(RNG_SEED + 4), (7, 33, 5))
    x[0, 0, 0] = 5.0
    x[0, 1, 0] = 5.0 + 1e-11
    d = tdf.from_f64(x)
    xr = tdf.to_f64(d).reshape(x.shape)
    for axis in (0, 1, 2, (1, 2), (0, 1, 2)):
        np.testing.assert_array_equal(tdf.to_f64(tdf.min_axis(d, axis)), xr.min(axis=axis))


# -- Dekker's exact product against the FMA's (the kernels' product) ----------
# Kernels C and H form the error of hi*hi with one FMA (csrc/df.cuh
# two_prod_fma); the plain versions keep Dekker's split product. The FMA
# rounds the exact a*b - fl(a*b) once; on the CPU that is
# float32(float64(a)*float64(b) - p), since the float64 product and
# difference are exact.


def fma_two_prod(a, b):
    p = a * b
    return p, (a.double() * b.double() - p.double()).float()


def error_words_differ(a, b):
    """Per pair: whether Dekker's and the FMA's error words differ in any bit."""
    _p, e_dekker = tdf.two_prod(a, b)
    _p, e_fma = fma_two_prod(a, b)
    return e_dekker.view(torch.int32) != e_fma.view(torch.int32)


def signed_magnitudes(rng, n, lo_exp, hi_exp):
    return torch.from_numpy((rng.choice([-1.0, 1.0], n)
                             * 10.0 ** rng.uniform(lo_exp, hi_exp, n)).astype(np.float32))


@pytest.mark.parametrize("lo_exp,hi_exp", [(-12, 12), (-6, 6), (-1, 1), (8, 12), (-12, -8)])
def test_dekker_error_equals_fma_error(lo_exp, hi_exp):
    """Equal bit for bit over random float32 pairs of the given decades."""
    rng = np.random.default_rng(abs(lo_exp) * 31 + abs(hi_exp))
    a, b = (signed_magnitudes(rng, 400_000, lo_exp, hi_exp) for _ in range(2))
    assert not bool(error_words_differ(a, b).any())


def test_dekker_and_fma_part_below_the_normal_range():
    """Where the error falls below 2^-126 the two part (Dekker's partial
    products lose bits there): pairs near 1e-20 differ often, and every
    differing product lies below 2^-100, which no score reaches."""
    rng = np.random.default_rng(3)
    a, b = (signed_magnitudes(rng, 200_000, -20.5, -18.0) for _ in range(2))
    differ = error_words_differ(a, b)
    assert int(differ.sum()) > 10_000
    prod = (a.double() * b.double()).abs()
    assert float(prod[differ].max()) < 2.0 ** -100
    assert not bool(differ[prod >= 2.0 ** -100].any())


def scorer_case(name):
    """(pack, frames) of a scorer case, all on the CPU."""
    from pathlib import Path

    from speechrecognition_torch.corpus import Corpus, CorpusDescription
    from speechrecognition_torch.features.frontend import SignalAnalysisConfig
    from speechrecognition_torch.io import read_mixture_set
    from speechrecognition_torch.lexicon import build_sietill_lexicon
    from speechrecognition_torch.models import gmm
    from torch_df_tables import wide_magnitude_pack_df
    if name == "wide":
        return wide_magnitude_pack_df(106, 16, 25, seed=1, n=300)
    repo = Path(__file__).resolve().parents[1]
    fix = repo / "tests" / "fixtures"
    path, pooling = ((fix / "iter-2.mix", gmm.VarianceModel.MIXTURE_POOLING)
                     if name == "iter-2.mix"
                     else (repo / "bench" / "model.mix", gmm.VarianceModel.NO_POOLING))
    model = gmm.MixtureModel.from_raw(read_mixture_set(str(path), 25), pooling, max_approx=True)
    lex = build_sietill_lexicon()
    corpus = Corpus.read(CorpusDescription.read(str(fix / "demo_corpus.json"), lex),
                         str(fix / "demo_features") + "/", SignalAnalysisConfig(),
                         normalization_path=str(fix / "normalization-demo.bin"))
    return model.pack_df(device="cpu"), torch.as_tensor(corpus.features[::40][:300])


@pytest.mark.parametrize("name", ["iter-2.mix", "bench/model.mix", "wide"])
def test_scorer_products_dekker_equals_fma(name, monkeypatch):
    """At the magnitudes the scorer meets: the error words of diff*diff and
    of (diff*diff)*iv agree, and the plain scorer gives the same hi and lo
    words with the FMA product in place of Dekker's (what kernels C and H
    compute)."""
    from speechrecognition_torch.models import gmm
    pack, x = scorer_case(name)
    diff = tdf.add_f(tdf.neg(tdf.DF(pack.mu.hi[None], pack.mu.lo[None])), x[:, None, :])
    sq = tdf.mul(diff, diff)
    assert not bool(error_words_differ(diff.hi, diff.hi).any())
    assert not bool(error_words_differ(sq.hi, pack.iv.hi[None].expand_as(sq.hi)).any())
    dekker = gmm.am_scores_df_reference(pack, x)
    monkeypatch.setattr(tdf, "two_prod", fma_two_prod)
    fma = gmm.am_scores_df_reference(pack, x)
    assert torch.equal(dekker.hi.view(torch.int32), fma.hi.view(torch.int32))
    assert torch.equal(dekker.lo.view(torch.int32), fma.lo.view(torch.int32))
