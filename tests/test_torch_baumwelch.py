"""The port's Baum-Welch soft alignment against the JAX package's, on the CPU.

* ``forward_backward_reference`` (kernel L's plain version) against JAX's
  ``_forward_backward`` on seeded inputs: ragged frame counts and automaton
  lengths in one batch, T = 1, A = 1 to 3, and utterances whose final
  position is unreachable (their posteriors are rows of 0, never NaN).
  Float64 within 1e-12 (gamma, absolute; log_z, relative). The reference's
  float32 scan does not trace (its NEG_BIG is a float64 numpy scalar, which
  promotes the carry) and its A = 1 scan neither (its jump-2 candidate row
  has two columns): the port's float32 is held to JAX's float64 run on the
  same float32 inputs within 1e-5, and A = 1 to JAX's run with the row
  padded to 3 invalid-past-the-end positions. Both reference faults are
  pinned.
* ``baum_welch_posteriors`` (with and without ``weight_threshold``),
  ``accumulate_baum_welch`` (f64 sums within 1e-9 relative) and
  ``best_path_from_posteriors`` (equal) on toy models in both packages;
  the sharp limit (scores and TDPs scaled by 40): the posterior's argmax
  path is the port's Viterbi alignment, as tests/test_baumwelch.py holds
  JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.align.baumwelch as jbw
import speechrecognition_tpu.align.viterbi as jvit
import speechrecognition_tpu.lexicon as jlex
import speechrecognition_tpu.models.gmm as jgmm
import speechrecognition_tpu.tdp as jtdp

import speechrecognition_torch.align.baumwelch as tbw
import speechrecognition_torch.align.viterbi as tvit
import speechrecognition_torch.lexicon as tlex
import speechrecognition_torch.tdp as ttdp
from speechrecognition_torch import convert
from torch_fb_tables import fb_inputs

torch.set_num_threads(1)

#: (B, T, A) of the seeded cases: T = 1, A = 1 to 3, ragged lengths
SHAPES = [(5, 1, 3), (6, 9, 1), (6, 9, 2), (6, 9, 3), (7, 23, 9), (4, 40, 33)]
TOL = {"f64": 1e-12, "f32": 1e-5}


def port_fb(lams, ltdp, pos_valid, feat_len, aut_len, dtype):
    g, z = tbw.forward_backward_reference(
        torch.as_tensor(lams, dtype=dtype), torch.as_tensor(ltdp, dtype=dtype),
        torch.as_tensor(pos_valid), torch.as_tensor(feat_len), torch.as_tensor(aut_len))
    assert g.dtype == dtype and z.dtype == dtype
    return g.numpy().astype(np.float64), z.numpy().astype(np.float64)


def jax_fb(lams, ltdp, pos_valid, feat_len, aut_len):
    """JAX's float64 scan; A = 1 runs with the row padded to 3 positions
    that are invalid past aut_len (it cannot trace A = 1)."""
    A = lams.shape[2]
    pad = max(0, 3 - A)
    if pad:
        lams = np.pad(lams, ((0, 0), (0, 0), (0, pad)))
        ltdp = np.pad(ltdp, ((0, 0), (0, pad), (0, 0)))
        pos_valid = np.pad(pos_valid, ((0, 0), (0, pad)))
    g, z = jbw._forward_backward(jnp.asarray(lams), jnp.asarray(ltdp), jnp.asarray(pos_valid),
                                 jnp.asarray(feat_len), jnp.asarray(aut_len))
    return np.asarray(g)[:, :, :A], np.asarray(z)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_forward_backward_equals_jax(shape, kind):
    B, T, A = shape
    lams, ltdp, pv, fl, al = fb_inputs(B, T, A, seed=B * 100 + T * 10 + A)
    if kind == "f32":   # both on the same float32 inputs
        lams, ltdp = lams.astype(np.float32).astype(np.float64), \
            ltdp.astype(np.float32).astype(np.float64)
    dtype = torch.float64 if kind == "f64" else torch.float32
    g, z = port_fb(lams, ltdp, pv, fl, al, dtype)
    jg, jz = jax_fb(lams, ltdp, pv, fl, al)
    assert np.isfinite(g).all() and np.isfinite(z).all()
    np.testing.assert_allclose(g, jg, rtol=0, atol=TOL[kind])
    np.testing.assert_allclose(z, jz, rtol=TOL[kind], atol=0)
    # a distribution on each frame whose final position is reachable, 0 on
    # padded frames and past each automaton
    reach = 2 * (fl - 1) >= al - 1
    sums = g.sum(axis=2)
    for b in range(B):
        want = 1.0 if reach[b] else 0.0
        np.testing.assert_allclose(sums[b, :fl[b]], want, atol=TOL[kind] * A)
        assert np.all(g[b, fl[b]:] == 0.0) and np.all(g[b, :, al[b]:] == 0.0)
    if A >= 4 and T >= 2:
        assert not reach[1] and np.all(g[1] == 0.0)


def test_reference_faults_are_what_the_port_differs_on():
    """JAX's float32 scan and its A = 1 scan raise; the port runs both."""
    lams, ltdp, pv, fl, al = fb_inputs(3, 5, 4, seed=1)
    with pytest.raises(TypeError, match="carry"):
        jbw._forward_backward(jnp.asarray(lams, jnp.float32), jnp.asarray(ltdp, jnp.float32),
                              jnp.asarray(pv), jnp.asarray(fl), jnp.asarray(al))
    lams1, ltdp1, pv1, fl1, al1 = fb_inputs(3, 5, 1, seed=2)
    with pytest.raises(TypeError, match="carry"):
        jbw._forward_backward(jnp.asarray(lams1), jnp.asarray(ltdp1), jnp.asarray(pv1),
                              jnp.asarray(fl1), jnp.asarray(al1))
    g, _ = port_fb(lams1, ltdp1, pv1, fl1, al1, torch.float64)
    np.testing.assert_array_equal(g[:, :, 0], (np.arange(5)[None, :] < fl1[:, None]) * 1.0)


def test_row_sum_order():
    """The fixed order: chunks of ceil(A/32) in position order, then the
    butterfly; equal to a float64 sum within rounding, exact on integers."""
    rng = np.random.default_rng(5)
    for A in (1, 2, 31, 32, 33, 70, 96, 97, 1025):
        p = torch.as_tensor(rng.integers(0, 9, (3, A)).astype(np.float64))
        s = tbw._row_sum(p)
        assert s.shape == (3, 1)
        np.testing.assert_array_equal(s[:, 0].numpy(), p.numpy().sum(axis=1))
    x = torch.as_tensor(rng.random(70), dtype=torch.float32)
    K = 3
    chunks = torch.nn.functional.pad(x, (0, 96 - 70)).reshape(32, K)
    want = chunks[:, 0] + chunks[:, 1] + chunks[:, 2]
    for off in (16, 8, 4, 2, 1):
        want = want[:off] + want[off:2 * off]
    assert tbw._row_sum(x)[0].item() == want[0].item()


def toy_models(dim, num_states, seed, max_approx=True):
    """A random GMM (tests/test_baumwelch.py's _toy_model) in both packages."""
    rng = np.random.default_rng(seed)
    jm = jgmm.MixtureModel(dim=dim, num_mixtures=num_states,
                           var_model=jgmm.VarianceModel.NO_POOLING, max_approx=max_approx)
    jm.mean_weight_acc[:] = 50.0
    jm.mean_acc[:] = rng.normal(0, 1, jm.mean_acc.shape) * 50.0
    jm.var_weight_acc[:] = 50.0
    jm.var_acc[:] = 50.0 * (1.0 + 0.2 * rng.random(jm.var_acc.shape)) + jm.mean_acc ** 2 / 50.0
    jm.finalize()
    return jm, convert.mixture_model_from_jax(jm)


def both_tables(state_lists, loop, forward, skip, silence):
    jt = jvit.AlignerTables.build([jlex.MarkovAutomaton(states=np.asarray(s, np.int32))
                                   for s in state_lists],
                                  jtdp.TdpModel(silence_state=silence, loop=loop,
                                                forward=forward, skip=skip))
    tt = tvit.AlignerTables.build([tlex.MarkovAutomaton(states=np.asarray(s, np.int32))
                                   for s in state_lists],
                                  ttdp.TdpModel(silence_state=silence, loop=loop,
                                                forward=forward, skip=skip))
    return jt, tt


@pytest.fixture(scope="module")
def batch():
    """Three utterances of a 12-state toy model, ragged, with one frame of
    padding past the longest's automaton; float64 packs in both."""
    jm, tm = toy_models(dim=4, num_states=12, seed=5)
    auts = [[0, 1, 2, 3, 4], [0, 5, 6, 7, 8, 9, 1], [10, 11, 10]]
    jt, tt = both_tables(auts, loop=2.0, forward=0.0, skip=5.0, silence=0)
    rng = np.random.default_rng(7)
    T = 15
    feats = rng.normal(0, 1, (3, T, 4)).astype(np.float32)
    lens = np.array([9, T, 6], np.int32)
    for b in range(3):
        feats[b, lens[b]:] = 0.0
    return jm, tm, jt, tt, feats, lens


@pytest.mark.parametrize("threshold", [0.0, 0.1])
def test_baum_welch_posteriors_equal_jax(batch, threshold):
    jm, tm, jt, tt, feats, lens = batch
    g, z = tbw.baum_welch_posteriors(tm.pack(dtype=torch.float64, device="cpu"), feats, lens,
                                     tt, weight_threshold=threshold, dtype=torch.float64)
    jg, jz = jbw.baum_welch_posteriors(jm.pack(dtype=jnp.float64), feats, lens, jt,
                                       weight_threshold=threshold, dtype=jnp.float64)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-12)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-12, atol=0)
    if threshold:
        gn = g.numpy()
        assert np.all(gn[gn > 0] >= threshold)
        np.testing.assert_allclose(gn.sum(axis=2)[0, :9], 1.0, atol=1e-12)
    np.testing.assert_array_equal(tbw.best_path_from_posteriors(g, tt),
                                  jbw.best_path_from_posteriors(np.asarray(jg), jt))


def test_baum_welch_posteriors_float32(batch):
    """float32 on an "mxu" float32 pack: within 1e-5 of the float64 run."""
    _jm, tm, _jt, tt, feats, lens = batch
    g32, z32 = tbw.baum_welch_posteriors(tm.pack(dtype=torch.float32, device="cpu"), feats, lens,
                                         tt, dtype=torch.float32)
    g64, z64 = tbw.baum_welch_posteriors(tm.pack(dtype=torch.float64, device="cpu"), feats, lens,
                                         tt, dtype=torch.float64)
    assert g32.dtype == torch.float32
    np.testing.assert_allclose(g32.numpy(), g64.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(z32.numpy(), z64.numpy(), rtol=1e-5)


def test_lengths_are_checked_once(batch):
    _jm, tm, _jt, tt, feats, lens = batch
    pack = tm.pack(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="feat_len"):
        tbw.baum_welch_posteriors(pack, feats, np.array([0, 3, 3]), tt)
    with pytest.raises(ValueError, match="feat_len"):
        tbw.baum_welch_posteriors(pack, feats, np.array([16, 3, 3]), tt)


@pytest.mark.parametrize("max_approx", [True, False], ids=["max-approx", "sum"])
@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_accumulate_baum_welch_equals_jax(batch, max_approx, kind):
    """The same posteriors (JAX's, as numpy) into both accumulators."""
    _jm, _tm, jt, tt, feats, lens = batch
    jm, tm = toy_models(dim=4, num_states=12, seed=9, max_approx=max_approx)
    jdt, dt = (jnp.float64, torch.float64) if kind == "f64" else (jnp.float32, torch.float32)
    jg, _ = jbw.baum_welch_posteriors(jm.pack(dtype=jnp.float64), feats, lens, jt,
                                      dtype=jnp.float64)
    gamma = np.asarray(jg).astype(np.float64 if kind == "f64" else np.float32)
    got = tbw.accumulate_baum_welch(tm.pack(dtype=dt, device="cpu"), feats,
                                    torch.as_tensor(gamma), torch.as_tensor(tt.states))
    want = jbw.accumulate_baum_welch(jm.pack(dtype=jdt), jnp.asarray(feats), jnp.asarray(gamma),
                                     jnp.asarray(jt.states))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)


def test_sharp_limit_is_the_viterbi_path():
    """Scores and TDPs scaled by 40 concentrate the posterior on the
    Viterbi path: the argmax path equals the port's full-DP alignment on
    more than 95 % of the frames, and JAX's argmax path."""
    lex = tlex.build_sietill_lexicon()
    jl = jlex.build_sietill_lexicon()
    jm, tm = toy_models(dim=25, num_states=lex.num_states, seed=1)
    states = np.asarray(tlex.MarkovAutomaton.concat(
        [lex.automata[lex.silence_idx], lex.automata[2], lex.automata[lex.silence_idx]]).states)
    jt, tt = both_tables([states], loop=3.0, forward=0.0, skip=30.0, silence=lex.silence_state)
    assert jl.silence_state == lex.silence_state
    rng = np.random.default_rng(2)
    T = 40
    feats = rng.normal(0, 1, (1, T, 25)).astype(np.float32)
    lens = np.array([T], np.int32)
    pack = tm.pack(dtype=torch.float64, device="cpu")
    vit, _ = tvit.align_batch(pack, feats, lens, tt, pruning_threshold=None, tie_pruned=False,
                              dtype=torch.float64)
    sharp = tvit.AlignerTables(states=tt.states, lengths=tt.lengths, tdp=tt.tdp * 40.0)
    g, _ = tbw.baum_welch_posteriors(dataclasses.replace(pack, P=pack.P * 40.0), feats, lens,
                                     sharp, dtype=torch.float64)
    bw = tbw.best_path_from_posteriors(g, tt)
    assert (bw[0] == vit[0]).mean() > 0.95
    jpack = jm.pack(dtype=jnp.float64)
    jsharp = jvit.AlignerTables(states=jt.states, lengths=jt.lengths, tdp=jt.tdp * 40.0)
    jg, _ = jbw.baum_welch_posteriors(dataclasses.replace(jpack, P=jpack.P * 40.0), feats, lens,
                                      jsharp, dtype=jnp.float64)
    np.testing.assert_array_equal(bw, jbw.best_path_from_posteriors(np.asarray(jg), jt))
