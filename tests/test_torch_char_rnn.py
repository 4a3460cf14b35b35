"""The port's char-RNN LM (speechrecognition_torch/lm/char_rnn.py) against
the JAX package's on the same parameters (carried across by
convert.char_rnn_params_from_jax), on the CPU.

In float64: the loss and gradients within rel 1e-10 of the reference's
hand-written backprop (tests/test_char_rnn.py's numpy port) and of
``jax.value_and_grad``; ``train_step``'s parameters, Adagrad state, loss and
hidden state within 1e-10 of JAX's jitted step; 20 steps of
``CharRnnLm.train`` (a text whose windows wrap) give JAX's losses within
1e-9. Float32 steps within 1e-5 over a short run (the two part by rounding).
``sample`` on JAX's own Gumbel draws gives JAX's ids exactly; with a
generator it repeats itself. The loss falls and the Adagrad state moves, as
tests/test_char_rnn.py checks for JAX. The card is the default device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechrecognition_tpu.lm import char_rnn as jcr

from speechrecognition_torch import convert
from speechrecognition_torch.lm import char_rnn as tcr
from test_char_rnn import numpy_loss_and_grads

torch.set_num_threads(1)
TEXT = "hello world. " * 10          # 130 characters: the 25-character windows wrap


def f64_tree(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def to_port(params):
    return convert.char_rnn_params_from_jax(params, device="cpu")


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / (1.0 + np.abs(want)), initial=0.0) <= tol


@pytest.fixture(scope="module")
def case():
    """V 7, H 11, T 13, f64 parameters from JAX's init_params (seed 3), ids
    and a start state from a seeded numpy generator."""
    V, H, T = 7, 11, 13
    params = jcr.init_params(V, H, seed=3, dtype=jnp.float64)
    rng = np.random.RandomState(0)
    inputs = rng.randint(0, V, size=T)
    targets = rng.randint(0, V, size=T)
    h0 = rng.randn(H) * 0.1
    return params, inputs, targets, h0


def test_loss_and_grads_equal_the_reference_backprop_and_jax(case):
    params, inputs, targets, h0 = case
    tp = {k: v.requires_grad_(True) for k, v in to_port(params).items()}
    loss, h_last = tcr.loss_fn(tp, inputs, targets, torch.as_tensor(h0))
    grads = dict(zip(tcr.NAMES, torch.autograd.grad(loss, [tp[k] for k in tcr.NAMES])))
    loss = loss.detach()
    loss_np, grads_np = numpy_loss_and_grads(params, inputs, targets, h0[:, None])
    (loss_jx, h_jx), grads_jx = jax.value_and_grad(jcr.loss_fn, has_aux=True)(
        params, jnp.asarray(inputs), jnp.asarray(targets), jnp.asarray(h0))
    assert float(loss) == pytest.approx(loss_np, rel=1e-10)
    assert float(loss) == pytest.approx(float(loss_jx), rel=1e-10)
    assert close(h_last.detach(), h_jx, 1e-10)
    for k in tcr.NAMES:
        g = grads[k].numpy()
        np.testing.assert_allclose(g.reshape(grads_np[k].shape), grads_np[k], atol=1e-10,
                                   err_msg=k)
        np.testing.assert_allclose(g, np.asarray(grads_jx[k]), atol=1e-10, rtol=1e-10,
                                   err_msg=k)


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-10), (jnp.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_train_step_equals_jax(case, dtype, tol):
    """Two steps (the second with the first's Adagrad state and hidden
    state): params, mem, loss and h."""
    params, inputs, targets, h0 = case
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), params)
    jm = jax.tree_util.tree_map(jnp.zeros_like, jp)
    tp, tm = to_port(jp), {k: torch.zeros_like(v) for k, v in to_port(jp).items()}
    jh = jnp.asarray(h0, dtype)
    th = torch.as_tensor(np.array(jh))
    for _ in range(2):
        jp, jm, jloss, jh = jcr.train_step(jp, jm, jnp.asarray(inputs), jnp.asarray(targets),
                                           jh, 0.1)
        tp, tm, tloss, th = tcr.train_step(tp, tm, inputs, targets, th, 0.1)
        assert tloss.dtype == th.dtype == tp["Wxh"].dtype == getattr(torch, np.dtype(dtype).name)
        assert not th.requires_grad and not tloss.requires_grad
        assert close(tloss, jloss, tol) and close(th, jh, tol)
        for k in tcr.NAMES:
            assert close(tp[k], jp[k], tol), k
            assert close(tm[k], jm[k], tol), k


@pytest.fixture(scope="module")
def trajectories():
    """20 steps of JAX's CharRnnLm and of the port's (on the CPU, from JAX's
    initial parameters), both in float64 from the start."""
    jlm = jcr.CharRnnLm(TEXT, hidden_size=16, seq_length=25, seed=1)
    jlm.params = f64_tree(jlm.params)
    jlm.mem = f64_tree(jlm.mem)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcr.CharRnnLm, "device", "cpu")
        tlm = tcr.CharRnnLm(TEXT, hidden_size=16, seq_length=25, seed=1)
    tlm.params = to_port(jlm.params)
    tlm.mem = {k: torch.zeros_like(v) for k, v in tlm.params.items()}
    return jlm, jlm.train(20), tlm, tlm.train(20)


def test_char_rnn_lm_gives_jax_losses(trajectories):
    jlm, jlosses, tlm, tlosses = trajectories
    assert tlm.vocab == jlm.vocab and np.array_equal(tlm.data, jlm.data)
    assert len(tlosses) == 20
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-9, atol=1e-9)
    assert tlm.smooth_loss == pytest.approx(jlm.smooth_loss, rel=1e-12)
    for k in tcr.NAMES:
        assert close(tlm.params[k], jlm.params[k], 1e-9), k
        assert close(tlm.mem[k], jlm.mem[k], 1e-9), k


def test_the_window_wraps_and_resets_h():
    """130 characters in windows of 25: steps 0-4 read frames 0-125, step 5
    wraps to 0 with h reset, so its loss equals step 0's only if h was
    reset and the parameters had not moved; with lr 0 they do not."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcr.CharRnnLm, "device", "cpu")
        lm = tcr.CharRnnLm(TEXT, hidden_size=16, seq_length=25, learning_rate=0.0, seed=2)
    lm.params = {k: v.double() for k, v in lm.params.items()}
    lm.mem = {k: torch.zeros_like(v) for k, v in lm.params.items()}
    losses = lm.train(7)
    assert losses[5] == losses[0] and losses[6] == losses[1]
    assert losses[1] != losses[0]


def test_training_reduces_loss_and_samples():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcr.CharRnnLm, "device", "cpu")
        lm = tcr.CharRnnLm("hello world. " * 80, hidden_size=32, seq_length=25, seed=1)
    losses = lm.train(300)
    assert np.mean(losses[-20:]) < 0.5 * np.mean(losses[:20])
    out = lm.sample_text(50, seed_char="h", rng_seed=4)
    assert len(out) == 50 and set(out) <= set(lm.vocab)


def test_adagrad_state_updates():
    V, H, T = 5, 8, 6
    params = tcr.init_params(V, H, seed=0, dtype=torch.float64, device="cpu")
    mem = {k: torch.zeros_like(v) for k, v in params.items()}
    rng = np.random.RandomState(2)
    inputs = rng.randint(0, V, size=T)
    targets = rng.randint(0, V, size=T)
    p2, m2, loss, h = tcr.train_step(params, mem, inputs, targets,
                                     torch.zeros(H, dtype=torch.float64))
    assert sum(float(m.abs().sum()) for m in m2.values()) > 0
    assert float(loss) > 0 and h.shape == (H,)
    assert any(not torch.equal(p2[k], params[k]) for k in params)
    assert all(torch.equal(mem[k], torch.zeros_like(mem[k])) for k in mem)   # inputs kept


def test_init_params_shapes_and_scale():
    p = tcr.init_params(40, 100, seed=5, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "Wxh": (100, 40), "Whh": (100, 100), "Why": (40, 100), "bh": (100,), "by": (40,)}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert not p["bh"].any() and not p["by"].any()
    assert 0.008 < float(p["Whh"].std()) < 0.012
    q = tcr.init_params(40, 100, seed=5, device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
def test_sample_on_jax_draws_gives_jax_ids(dtype):
    """jax.random.categorical is argmax(logits + gumbel(k)), a row of draws
    a key of split(key, n): the port fed those rows gives the same ids."""
    V, H, n = 9, 24, 60
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype),
                                    jcr.init_params(V, H, seed=7, dtype=jnp.float64))
    params = dict(params, Wxh=params["Wxh"] * 80, Why=params["Why"] * 80)   # peaked logits
    h = jnp.asarray(np.random.RandomState(3).randn(H) * 0.5, dtype)
    key = jax.random.PRNGKey(11)
    want = jcr.sample(params, h, 2, n, key)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (V,), dtype))
                       for k in jax.random.split(key, n)])
    got = tcr.sample(to_port(params), torch.as_tensor(np.array(h)), 2, n,
                     gumbel=torch.as_tensor(gumbel))
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) > 1


def test_sample_with_a_generator_repeats():
    params = tcr.init_params(12, 20, seed=1, dtype=torch.float64, device="cpu")
    h = torch.zeros(20, dtype=torch.float64)
    a = tcr.sample(params, h, 0, 80, torch.Generator().manual_seed(9))
    b = tcr.sample(params, h, 0, 80, torch.Generator().manual_seed(9))
    c = tcr.sample(params, h, 0, 80, torch.Generator().manual_seed(10))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == (80,) and a.min() >= 0 and a.max() < 12


def test_the_card_is_the_default(monkeypatch):
    """Without a card the parameters, the converter and the driver raise
    unless the caller asks for the CPU (nothing falls back)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcr.CharRnnLm.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcr.init_params(5, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcr.CharRnnLm("abcab")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.char_rnn_params_from_jax(jcr.init_params(5, 8))
    assert tcr.init_params(5, 8, device="cpu")["Wxh"].device.type == "cpu"
