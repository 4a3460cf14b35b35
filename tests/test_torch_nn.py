"""The port's MLP (speechrecognition_torch/models/nn.py) against the JAX
package's on the same numpy-seeded inputs, on the CPU.

Tolerances: float32 activations and log-probabilities within 1e-5 relative
(+1e-6 absolute; the two packages' exp and matrix products round
differently in the last bits), float64 gradients within 1e-12 relative
(+1e-14 absolute), float32 gradients within 1e-5. Weight init, save/load,
the context windows, the prior and the SGD update are bit-equal. The
AdaDelta update is within two float32 ulps (2.4e-7 relative): its square
roots are correctly rounded in XLA and on the card, but torch's CPU sqrt of
a large float32 tensor (MKL's) is not, for about 0.7 % of the values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import speechrecognition_tpu.config as jcfg
import speechrecognition_tpu.models.nn as jnn

import speechrecognition_torch.config as tcfg
import speechrecognition_torch.convert as tconv
import speechrecognition_torch.models.nn as tnn

torch.set_num_threads(1)

F32_RTOL, F32_ATOL = 1e-5, 1e-6
F64_RTOL, F64_ATOL = 1e-12, 1e-14
ADADELTA_RTOL = 2.4e-7


def layers(nonlinearity="sigmoid", two_inputs=False):
    out = [
        {"layer-name": "hidden-layer1", "num-outputs": 20, "type": "feed-forward",
         "nonlinearity": nonlinearity, "input": ["data"]},
        {"layer-name": "hidden-layer2", "num-outputs": 20, "type": "feed-forward",
         "nonlinearity": nonlinearity, "input": ["hidden-layer1"]},
        {"layer-name": "output-layer", "num-outputs": 10, "type": "output",
         "input": ["hidden-layer2"]},
    ]
    if two_inputs:      # the output layer reads both hidden layers
        out[2]["input"] = ["hidden-layer1", "hidden-layer2"]
        # declared out of order: topo_sort must place it last
        out = [out[2], out[0], out[1]]
    return out


def both_mlps(layer_list, input_dim=15, **extra):
    cfg = {"layers": layer_list, **extra}
    j = jnn.MLP(jnn.layer_specs_from_config(jcfg.Configuration(cfg)), input_dim=input_dim)
    t = tnn.MLP(tnn.layer_specs_from_config(tcfg.Configuration(cfg)), input_dim=input_dim,
                device="cpu")
    return j, t


def both_params(j, t, seed=0):
    jp = j.init_params(np.random.default_rng(seed))
    tp = t.init_params(np.random.default_rng(seed))
    return jp, tp


def toy_batch(seed=5, T=12, B=4, D=15, C=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (T, B, D)).astype(np.float32)
    y = np.zeros((T, B, C), np.float32)
    y[np.arange(T)[:, None], np.arange(B)[None, :], rng.integers(0, C, (T, B))] = 1.0
    mask = np.ones((T, B), np.float32)
    mask[-3:, 0] = 0.0
    return x, y, mask


def close(port, ref, rtol=F32_RTOL, atol=F32_ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def test_layer_specs_equal_and_sorted():
    j, t = both_mlps(layers(two_inputs=True))
    assert [s.name for s in t.specs] == ["hidden-layer1", "hidden-layer2", "output-layer"]
    for a, b in zip(j.specs, t.specs):
        assert (a.name, a.num_outputs, a.kind, a.nonlinearity, a.inputs) == \
            (b.name, b.num_outputs, b.kind, b.nonlinearity, b.inputs)
    assert t.layer_input_dim(t.specs[2]) == 40
    with pytest.raises(ValueError, match="cycle or missing input"):
        tnn.topo_sort([tnn.LayerSpec("a", 3, "output", "", ("b",))])


@pytest.mark.parametrize("two_inputs", [False, True])
@pytest.mark.parametrize("nonlinearity", ["sigmoid", "tanh", "relu", ""])
def test_apply_and_log_probs_equal_jax(nonlinearity, two_inputs):
    j, t = both_mlps(layers(nonlinearity, two_inputs))
    jp, tp = both_params(j, t)
    x, _, _ = toy_batch()
    jacts = j.apply(jp, jnp.asarray(x))
    tacts = t.apply(tp, torch.from_numpy(x))
    assert set(jacts) == set(tacts)
    for name in jacts:
        close(tacts[name], jacts[name])
    close(t.log_probs(tp, torch.from_numpy(x)), j.log_probs(jp, jnp.asarray(x)))
    close(t(torch.from_numpy(x)).detach(), jacts["__log_probs__"])
    np.testing.assert_allclose(tacts["output-layer"].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_no_output_layer_raises():
    t = tnn.MLP([tnn.LayerSpec("h", 4, "feed-forward", "tanh", ("data",))], 3, device="cpu")
    with pytest.raises(ValueError, match="no output layer"):
        t.apply(t.params(), torch.zeros(2, 3))


@pytest.mark.parametrize("max_len", [None, 12])
def test_loss_equals_jax(max_len):
    lay = layers("tanh")
    for spec in lay[:2]:
        spec.update({"weight-decay": "l2", "weight-decay-factor": 0.01})
    j, t = both_mlps(lay)
    jp, tp = both_params(j, t)
    x, y, m = toy_batch()
    jl = float(j.loss(jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), max_len=max_len))
    tl = float(t.loss(tp, *map(torch.from_numpy, (x, y, m)), max_len=max_len))
    assert tl == pytest.approx(jl, rel=F32_RTOL)
    if max_len:
        # the per-timestep decay of the two l2 layers is in the loss
        plain = float(t.loss(tp, *map(torch.from_numpy, (x, y, m))))
        decay = sum(0.5 * 0.01 * max_len * float((tp[n]["W"] ** 2).sum())
                    for n in ("hidden-layer1", "hidden-layer2"))
        assert tl - plain == pytest.approx(decay, rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_autograd_equals_jax_grad(dtype):
    j, t = both_mlps(layers("tanh", two_inputs=True))
    jp, tp = both_params(j, t)
    x, y, m = toy_batch()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jd), jp)
    tp = {n: {k: v.to(td).requires_grad_(True) for k, v in d.items()} for n, d in tp.items()}
    jg = jax.grad(lambda p: j.loss(p, *(jnp.asarray(a, jd) for a in (x, y, m))))(jp)
    loss = t.loss(tp, *(torch.as_tensor(a, dtype=td) for a in (x, y, m)))
    names = [(n, k) for n in tp for k in tp[n]]
    tg = torch.autograd.grad(loss, [tp[n][k] for n, k in names])
    rtol, atol = (F64_RTOL, F64_ATOL) if dtype == "float64" else (F32_RTOL, F32_ATOL)
    for (n, k), g in zip(names, tg):
        assert g.dtype == td
        close(g, jg[n][k], rtol, atol)


def test_gradient_check_passes_as_in_jax():
    """Both packages' float64 central differences agree with their autograd
    far inside the reference's 1e-2; the port samples the same entries."""
    j, t = both_mlps(layers("sigmoid"))
    jp, tp = both_params(j, t)
    x, y, m = toy_batch()
    jw = j.gradient_check(jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), samples=40)
    tw = t.gradient_check(tp, *map(torch.from_numpy, (x, y, m)), samples=40)
    assert jw < 1e-6 and tw < 1e-6
    with pytest.raises(AssertionError, match="gradient check failed"):
        t.gradient_check(tp, *map(torch.from_numpy, (x, y, m)), eps=1.0, tolerance=1e-9)


def test_init_params_bit_equal():
    j, t = both_mlps(layers(two_inputs=True))
    jp, tp = both_params(j, t, seed=498061416)
    for n in jp:
        for k in ("W", "b"):
            assert tp[n][k].dtype == torch.float32
            np.testing.assert_array_equal(tp[n][k].numpy(), np.asarray(jp[n][k]))
            # the module's own parameters hold the same weights
            np.testing.assert_array_equal(getattr(t, k)[n].detach().numpy(), np.asarray(jp[n][k]))


def test_params_are_the_module_parameters():
    """The module's parameters are the only copy of the weights: params()
    hands them out, set_params and load write them, forward reads them."""
    j, t = both_mlps(layers("tanh"))
    jp, tp = both_params(j, t, seed=2)
    assert all(tp[n]["W"] is t.W[n] and tp[n]["b"] is t.b[n] for n in tp)
    assert {id(p) for p in t.parameters()} == {id(v) for d in tp.values() for v in d.values()}
    x, *_ = toy_batch()
    with torch.no_grad():
        close(t(torch.tensor(x)), j.log_probs(jp, jnp.asarray(x)))
    t.set_params({n: {k: v + 1.0 for k, v in d.items()} for n, d in tp.items()})
    np.testing.assert_array_equal(t.params()["output-layer"]["W"].numpy(),
                                  np.asarray(jp["output-layer"]["W"]) + np.float32(1.0))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_across_packages_bit_equal(writer, tmp_path):
    j, t = both_mlps(layers())
    jp, tp = both_params(j, t, seed=3)
    folder = str(tmp_path / "m") + "/"
    if writer == "jax":
        j.save(jp, folder)
    else:
        t.save(tp, folder)
    jl, tl = j.load(folder), t.load(folder)
    for n in jp:
        for k in ("W", "b"):
            np.testing.assert_array_equal(tl[n][k].numpy(), np.asarray(jp[n][k]))
            np.testing.assert_array_equal(np.asarray(jl[n][k]), np.asarray(jp[n][k]))
    (tmp_path / "m" / "output-layer").write_bytes(b"\0" * 8)
    with pytest.raises(ValueError, match="bad parameter file"):
        t.load(folder)


@pytest.mark.parametrize("updater", ["sgd", "adadelta"])
def test_updater_step_equals_jax(updater):
    j, t = both_mlps(layers())
    jp, tp = both_params(j, t)
    rng = np.random.default_rng(11)
    grads = {n: {k: rng.normal(0, 0.3, np.asarray(v).shape).astype(np.float32)
                 for k, v in d.items()} for n, d in jp.items()}
    if updater == "sgd":
        ju, tu = jnn.SGDUpdater(0.5), tnn.SGDUpdater(0.5)
    else:
        ju, tu = jnn.AdaDeltaUpdater(), tnn.AdaDeltaUpdater()
    js, ts = ju.init_state(jp), tu.init_state(tp)
    for _ in range(2):          # two steps, so AdaDelta's state is non-zero
        jp, js = ju.update(jp, jax.tree_util.tree_map(jnp.asarray, grads), js)
        tg = {n: {k: torch.from_numpy(v) for k, v in d.items()} for n, d in grads.items()}
        before = {n: {k: v.clone() for k, v in d.items()} for n, d in tp.items()}
        new, ts = tu.update(tp, tg, ts)
        for n in tp:            # a plain function: its argument is unchanged
            for k in tp[n]:
                assert torch.equal(tp[n][k], before[n][k])
        tp = new
    if updater == "sgd":
        for n in jp:
            for k in ("W", "b"):
                np.testing.assert_array_equal(tp[n][k].numpy(), np.asarray(jp[n][k]))
        return
    for n in jp:
        for k in ("W", "b"):
            close(tp[n][k], jp[n][k], ADADELTA_RTOL, 0.0)
            close(ts["grad_rms"][n][k], js["grad_rms"][n][k], ADADELTA_RTOL, 0.0)
            close(ts["update_rms"][n][k], js["update_rms"][n][k], 4 * ADADELTA_RTOL, 0.0)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_context_windows_bit_equal(k):
    x = np.random.default_rng(k).normal(size=(3, 7, 5)).astype(np.float32)
    got = tnn.build_context_windows(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnn.build_context_windows(jnp.asarray(x), k)))


def test_load_prior_bit_equal_with_a_zero_entry(tmp_path):
    vals = np.random.default_rng(2).uniform(0.0, 0.02, 110)
    vals[7] = 0.0
    path = tmp_path / "prior.txt"
    path.write_text(" ".join(str(v) for v in vals) + " ")
    for scale in (1.2, 0.0):
        with np.errstate(divide="ignore", invalid="ignore"):
            got = tnn.NNScorer.load_prior(str(path), 106, scale, device="cpu")
            ref = np.asarray(jnn.NNScorer.load_prior(str(path), 106, scale))
        assert got.dtype == torch.float32 and got.shape == (106,)
        # -inf at scale 1.2, NaN at scale 0.0: kept as the reference keeps them
        np.testing.assert_array_equal(got.numpy(), ref)
    assert np.isneginf(ref[7]) or np.isnan(ref[7])


def test_nn_scorer_am_batch_equals_jax():
    lay = [{"layer-name": "hidden-layer1", "num-outputs": 20, "type": "feed-forward",
            "nonlinearity": "tanh", "input": ["data"]},
           {"layer-name": "output-layer", "num-outputs": 106, "type": "output",
            "input": ["hidden-layer1"]}]
    j, _t = both_mlps(lay, input_dim=25 * 5)
    jp = j.init_params(np.random.default_rng(4))
    log_prior = jnp.asarray(1.2 * np.log(np.random.default_rng(5).uniform(0.001, 0.02, 106)),
                            jnp.float32)
    jscorer = jnn.NNScorer(j, jp, log_prior, context_frames=2)
    tscorer = tconv.nn_scorer_from_jax(jscorer, device="cpu")
    assert tscorer.base_dim == 25 and tscorer.device.type == "cpu"
    feats = np.random.default_rng(6).normal(size=(3, 40, 25)).astype(np.float32)
    got = tscorer.am_batch(feats)
    assert got.shape == (3, 40, 106) and got.dtype == torch.float32
    close(got, jscorer.am_batch(feats, 25))
    # the converted weights are the JAX pytree's, bit for bit
    for n in jp:
        for k in ("W", "b"):
            np.testing.assert_array_equal(tscorer.mlp.params()[n][k].numpy(),
                                          np.asarray(jp[n][k]))


def test_nn_defaults_to_the_card(monkeypatch):
    """The MLP, the prior and the converters default to device="cuda"; with
    no CUDA device they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs = tnn.layer_specs_from_config(tcfg.Configuration({"layers": layers()}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnn.MLP(specs, 15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconv.mlp_params_from_jax({})
