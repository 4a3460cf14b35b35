"""Character-level vanilla-RNN language model — counterpart of
speechrecognition_tpu/lm/char_rnn.py.

Capability parity with the reference's vendored min-char-rnn demo
(src/language-model/min-char-rnn.py): a tanh RNN over one-hot characters
with softmax output, cross-entropy loss, gradient clipping to [-5, 5],
Adagrad updates (lr 0.1), exponentially smoothed loss reporting and
temperature-1 sampling.

The JAX package's ``lax.scan`` over the sequence is a Python loop of
``_step`` here, and ``jax.value_and_grad`` is autograd. A step is two
[H]-vector products (H 100), so a step is a chain of small launches; the
module has no hand kernel (the JAX module has no Pallas kernel). Parameters
are a dict of tensors on an explicit device, the card unless the caller asks
for the CPU, and every draw comes from an explicit ``torch.Generator`` or
from draws the caller passes.

``jax.random.categorical`` is ``argmax(logits + gumbel)``: ``sample`` draws
the same way, Gumbel-max, so given JAX's Gumbel draws it gives JAX's ids.
A torch generator cannot give ``jax.random``'s bits, so tests carry JAX's
initial parameters across with ``convert.char_rnn_params_from_jax``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.gmm import pack_device

Params = Dict[str, torch.Tensor]
NAMES = ("Wxh", "Whh", "Why", "bh", "by")


def init_params(vocab_size: int, hidden_size: int = 100, seed: int = 0,
                dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """W ~ 0.01·N(0,1), zero biases (min-char-rnn.py:24-28), drawn on the
    host from a generator seeded by ``seed`` and placed on ``device``."""
    device = pack_device(device, "char-RNN parameters")
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return (0.01 * torch.randn(shape, generator=g, dtype=dtype)).to(device)

    return {
        "Wxh": normal(hidden_size, vocab_size),
        "Whh": normal(hidden_size, hidden_size),
        "Why": normal(vocab_size, hidden_size),
        "bh": torch.zeros(hidden_size, dtype=dtype, device=device),
        "by": torch.zeros(vocab_size, dtype=dtype, device=device),
    }


def _step(params: Params, h: torch.Tensor, x_id) -> Tuple[torch.Tensor, torch.Tensor]:
    """h' = tanh(Wxh·x + Whh·h + bh); logits = Why·h' + by."""
    h = torch.tanh(params["Wxh"][:, x_id] + params["Whh"] @ h + params["bh"])
    return h, params["Why"] @ h + params["by"]


def _ids(ids, device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(ids), dtype=torch.long).to(device)


def loss_fn(params: Params, inputs, targets, h0: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed cross-entropy of ``targets`` given ``inputs`` (ids, [T]).
    Returns (loss, final hidden state) — min-char-rnn.py:30-46."""
    device = params["Wxh"].device
    inputs, targets = _ids(inputs, device), _ids(targets, device)
    h, nll = h0, []
    for t in range(inputs.shape[0]):
        h, logits = _step(params, h, inputs[t])
        nll.append(-torch.log_softmax(logits, dim=0)[targets[t]])
    return torch.stack(nll).sum(), h


def train_step(params: Params, mem: Params, inputs, targets, h0: torch.Tensor,
               lr: float = 0.1) -> Tuple[Params, Params, torch.Tensor, torch.Tensor]:
    """One Adagrad step with the reference's [-5, 5] gradient clip
    (min-char-rnn.py:59-61, :102-105). Returns (params, mem, loss, h), new
    tensors, with ``loss`` and ``h`` detached so that windows do not chain
    graphs."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in NAMES}
    loss, h_last = loss_fn(leaves, inputs, targets, h0.detach())
    grads = torch.autograd.grad(loss, [leaves[k] for k in NAMES])
    new_params, new_mem = {}, {}
    with torch.no_grad():
        for k, g in zip(NAMES, grads):
            g = g.clamp(-5.0, 5.0)
            new_mem[k] = mem[k] + g * g
            new_params[k] = params[k] - lr * g / torch.sqrt(new_mem[k] + 1e-8)
    return new_params, new_mem, loss.detach(), h_last.detach()


def sample(params: Params, h: torch.Tensor, seed_id: int, n: int,
           generator: Optional[torch.Generator] = None,
           gumbel: Optional[torch.Tensor] = None) -> np.ndarray:
    """Draw ``n`` character ids from the model (min-char-rnn.py:63-79):
    each id is argmax(logits + g) over one [V] row of Gumbel draws, fed back
    as the next input. The rows are ``gumbel`` ([n, V]) where the caller
    passes them, else -log(-log(U)) with U uniform in [tiny, 1) from
    ``generator`` (on the generator's device, then moved)."""
    device, dtype = params["by"].device, params["by"].dtype
    V = params["by"].shape[0]
    if gumbel is None:
        gen_device = generator.device if generator is not None else device
        u = torch.rand((n, V), generator=generator, dtype=dtype, device=gen_device)
        gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(dtype).tiny)))
    gumbel = torch.as_tensor(gumbel, dtype=dtype).to(device)
    ids = []
    x = torch.as_tensor(seed_id, device=device)
    with torch.no_grad():
        for i in range(n):
            h, logits = _step(params, h, x)
            x = torch.argmax(logits + gumbel[i])
            ids.append(x)
    return torch.stack(ids).cpu().numpy() if ids else np.zeros(0, np.int64)


class CharRnnLm:
    """Training driver over a plain-text corpus (min-char-rnn.py:8-16,
    :85-112): sequential seq_length windows, hidden state carried across
    windows and reset at epoch wrap, smoothed-loss reporting. Its
    parameters are built on ``CharRnnLm.device``, the card; a caller that
    wants the CPU sets that class attribute, or replaces ``params`` and
    ``mem`` (training runs where they are)."""

    device = "cuda"

    def __init__(self, text: str, hidden_size: int = 100, seq_length: int = 25,
                 learning_rate: float = 0.1, seed: int = 0):
        self.text = text
        self.hidden_size = hidden_size
        self.seq_length = seq_length
        self.learning_rate = learning_rate
        self.seed = seed
        chars = sorted(set(text))
        self.vocab = chars
        self.char_to_ix = {c: i for i, c in enumerate(chars)}
        self.data = np.asarray([self.char_to_ix[c] for c in text], np.int32)
        self.params = init_params(len(chars), hidden_size, seed, device=self.device)
        self.mem = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.smooth_loss = -np.log(1.0 / len(chars)) * seq_length

    def train(self, num_steps: int) -> List[float]:
        losses: List[float] = []
        p, n = 0, 0
        bh = self.params["bh"]
        data = _ids(self.data, bh.device)
        h = torch.zeros(self.hidden_size, dtype=bh.dtype, device=bh.device)
        while n < num_steps:
            if p + self.seq_length + 1 >= len(self.data) or n == 0:
                h = torch.zeros_like(h)
                p = 0
            inputs = data[p: p + self.seq_length]
            targets = data[p + 1: p + self.seq_length + 1]
            self.params, self.mem, loss, h = train_step(
                self.params, self.mem, inputs, targets, h, self.learning_rate)
            loss = float(loss)
            self.smooth_loss = self.smooth_loss * 0.999 + loss * 0.001
            losses.append(loss)
            p += self.seq_length
            n += 1
        return losses

    def sample_text(self, n: int, seed_char: str = None, rng_seed: int = 0) -> str:
        seed_id = self.char_to_ix[seed_char] if seed_char else 0
        bh = self.params["bh"]
        h = torch.zeros(self.hidden_size, dtype=bh.dtype, device=bh.device)
        ids = sample(self.params, h, seed_id, n, torch.Generator().manual_seed(rng_seed))
        return "".join(self.vocab[i] for i in ids)
