"""Hybrid MLP acoustic scorer — counterpart of speechrecognition_tpu/models/nn.py.

Replicates the semantics of src/sietill/{NetworkLayer,FeedForwardLayer,
OutputLayer,NeuralNetwork}.{hpp,cpp}: named layers built from the config's
"layers" array, topologically sorted by declared inputs, y=σ(Wx+b) layers
(sigmoid/tanh/relu/none) and a log-space-softmax output layer. The whole
(T·B, D) batch is one matrix product per layer, in full float32 on the card
(no TF32), as the reference package's products are on the CPU.

Scoring (NeuralNetwork.cpp:184-199): score(t, s) = −log softmax(t, s)
+ κ·log prior(s), with the prior loaded from a text file of state
frequencies (::293-305).

The backward pass is torch.autograd, which computes the reference's
hand-written gradients (CE+softmax error `p − y`, NeuralNetwork.cpp:266;
inner derivatives σ', FeedForwardLayer.cpp:254-279). The optional weight
decay replicates the reference quirk of adding the decay term once per
*timestep* (FeedForwardLayer.cpp:343-361), so its strength scales with
max_len.

The network's weights are an ``nn.Module``'s parameters (one W [H, D] and
b [H] per layer) and live nowhere else: ``params()`` hands out those
parameters themselves as a ``{layer: {"W", "b"}}`` dict, the shape of the
reference package's pytree. The functional methods (``apply``, ``loss``,
``gradient_check``) take such a dict, so that autograd and the trainer's
updates stay plain functions of tensors; the trainer writes each accepted
update back with ``set_params``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Configuration, ParameterFloat, ParameterString
from .gmm import _full_f32_matmul, pack_device

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class LayerSpec:
    name: str
    num_outputs: int
    kind: str            # "feed-forward" | "output"
    nonlinearity: str    # "sigmoid" | "tanh" | "relu" | "" (none)
    inputs: Tuple[str, ...]
    weight_decay: str = ""
    weight_decay_factor: float = 0.0


def layer_specs_from_config(config: Configuration) -> List[LayerSpec]:
    specs = []
    for c in config.get_array("layers"):
        specs.append(LayerSpec(
            name=ParameterString("layer-name", "")(c),
            num_outputs=c.get_value("num-outputs"),
            kind=ParameterString("type", "feed-forward")(c),
            nonlinearity=ParameterString("nonlinearity", "")(c),
            inputs=tuple(c.get_string_array("input")),
            weight_decay=ParameterString("weight-decay", "")(c),
            weight_decay_factor=ParameterFloat("weight-decay-factor", 0.0)(c),
        ))
    return topo_sort(specs)


def topo_sort(specs: List[LayerSpec]) -> List[LayerSpec]:
    """Order layers so every input is produced first (NeuralNetwork.cpp:73-166)."""
    placed: List[LayerSpec] = []
    have = {"data"}
    remaining = list(specs)
    while remaining:
        progress = False
        for s in list(remaining):
            if all(i in have for i in s.inputs):
                placed.append(s)
                have.add(s.name)
                remaining.remove(s)
                progress = True
        if not progress:
            raise ValueError(f"layer graph has a cycle or missing input: "
                             f"{[s.name for s in remaining]}")
    return placed


def _nonlin(name: str, x: torch.Tensor) -> torch.Tensor:
    # the reference package's formulas, not torch.sigmoid / torch.tanh,
    # which round differently in the last bits
    if name == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-x))
    if name == "tanh":
        return 2.0 / (1.0 + torch.exp(-2.0 * x)) - 1.0
    if name == "relu":
        return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))
    return x


def _leaves(params: Params) -> List[Tuple[str, str]]:
    """(layer, "W" | "b") in the order the reference package flattens its
    pytree (sorted keys), which its gradient check samples from."""
    return [(n, k) for n in sorted(params) for k in sorted(params[n])]


class MLP(nn.Module):
    """The network: one ``W [H, D]`` / ``b [H]`` parameter pair per layer, on
    ``device`` (the card unless the caller asks for the CPU). The parameters
    take no ``.grad``: gradients are taken with ``torch.autograd.grad`` on
    detached leaves (``NnTrainer.loss_and_grads``, ``gradient_check``)."""

    def __init__(self, specs: List[LayerSpec], input_dim: int, device="cuda"):
        super().__init__()
        self.specs = list(specs)
        self.input_dim = input_dim
        device = pack_device(device, "MLP")
        self.W = nn.ParameterDict()
        self.b = nn.ParameterDict()
        for s in self.specs:
            D = self.layer_input_dim(s)
            self.W[s.name] = nn.Parameter(torch.zeros(s.num_outputs, D, device=device),
                                          requires_grad=False)
            self.b[s.name] = nn.Parameter(torch.zeros(s.num_outputs, device=device),
                                          requires_grad=False)

    @property
    def device(self) -> torch.device:
        return next(iter(self.W.values())).device

    def layer_input_dim(self, spec: LayerSpec) -> int:
        dim = 0
        for inp in spec.inputs:
            if inp == "data":
                dim += self.input_dim
            else:
                dim += next(s.num_outputs for s in self.specs if s.name == inp)
        return dim

    def params(self) -> Params:
        """The module's weights as a ``{layer: {"W", "b"}}`` dict: the
        parameters themselves, not copies."""
        return {s.name: {"W": self.W[s.name], "b": self.b[s.name]} for s in self.specs}

    def set_params(self, params: Params) -> None:
        """Copy ``params`` into the module's weights."""
        with torch.no_grad():
            for s in self.specs:
                self.W[s.name].copy_(params[s.name]["W"])
                self.b[s.name].copy_(params[s.name]["b"])

    def init_params(self, rng: np.random.Generator, scale: float = 0.1) -> Params:
        """Normal(0, 0.1) init (NNTraining.cpp:300-301), drawn from ``rng``
        exactly as the reference package draws: W then b, layer by layer in
        topological order, in float64 rounded to float32. Sets the module's
        weights and returns them (``params()``)."""
        drawn = {}
        for s in self.specs:
            D = self.layer_input_dim(s)
            W = rng.normal(0.0, scale, (s.num_outputs, D)).astype(np.float32)
            b = rng.normal(0.0, scale, (s.num_outputs,)).astype(np.float32)
            drawn[s.name] = {"W": torch.from_numpy(W), "b": torch.from_numpy(b)}
        self.set_params(drawn)
        return self.params()

    def apply(self, params: Params, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [..., input_dim] → dict of layer activations; the output layer
        yields a stable log-softmax (OutputLayer.cpp:30-67) under
        ``"__log_probs__"`` and its probabilities under its own name."""
        acts: Dict[str, torch.Tensor] = {"data": x}
        log_probs = None
        with _full_f32_matmul():
            for s in self.specs:
                inp = torch.cat([acts[i] for i in s.inputs], dim=-1)
                z = inp @ params[s.name]["W"].T + params[s.name]["b"]
                if s.kind == "output":
                    log_probs = torch.log_softmax(z, dim=-1)
                    acts[s.name] = torch.exp(log_probs)
                else:
                    acts[s.name] = _nonlin(s.nonlinearity, z)
        if log_probs is None:
            raise ValueError("network has no output layer")
        acts["__log_probs__"] = log_probs
        return acts

    def log_probs(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)["__log_probs__"]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Log-probabilities of ``x`` under the module's own weights."""
        return self.log_probs(self.params(), x)

    # -- loss ---------------------------------------------------------------

    def loss(self, params: Params, x: torch.Tensor, targets: torch.Tensor,
             frame_mask: torch.Tensor, max_len: Optional[int] = None) -> torch.Tensor:
        """Masked cross-entropy, averaged over frames (NNTraining.cpp:432-455).
        targets: one-hot (or weighted) [T, B, C]; frame_mask [T, B]. With
        ``max_len``, each "l2" layer adds its per-timestep weight decay."""
        lp = self.log_probs(params, x)
        ce = -(targets * lp).sum(dim=-1) * frame_mask
        decay = 0.0
        if max_len is not None:
            for s in self.specs:
                if s.weight_decay == "l2" and s.weight_decay_factor:
                    W = params[s.name]["W"]
                    decay = decay + 0.5 * s.weight_decay_factor * max_len * (W * W).sum()
        return ce.sum() / frame_mask.sum() + decay

    # -- gradient check (NetworkLayer.cpp:36-112) ---------------------------

    def gradient_check(self, params: Params, x: torch.Tensor, targets: torch.Tensor,
                       frame_mask: torch.Tensor, eps: float = 1e-4,
                       tolerance: float = 1e-2, samples: int = 50,
                       rng: Optional[np.random.Generator] = None) -> float:
        """Central finite differences on a random parameter subset against
        torch.autograd; returns the max relative deviation. Runs in float64
        so the finite differences are meaningful (f32 FD noise alone is
        ~1e-3). Samples the same entries from ``rng`` as the reference
        package does."""
        rng = rng or np.random.default_rng(0)
        f64 = torch.float64
        p64 = {n: {k: v.detach().to(f64) for k, v in d.items()} for n, d in params.items()}
        x, targets, frame_mask = (t.to(f64) for t in (x, targets, frame_mask))
        leaves = _leaves(p64)
        with torch.enable_grad():
            for n, k in leaves:
                p64[n][k].requires_grad_(True)
            grads = torch.autograd.grad(self.loss(p64, x, targets, frame_mask),
                                        [p64[n][k] for n, k in leaves])
        worst = 0.0
        for _ in range(samples):
            li = int(rng.integers(len(leaves)))
            n, k = leaves[li]
            arr = p64[n][k].detach()
            idx = tuple(int(rng.integers(d)) for d in arr.shape)
            orig = float(arr[idx])
            fs = []
            for step in (eps, -eps):
                moved = arr.clone()
                moved[idx] = orig + step
                trial = {ln: {lk: (moved if (ln, lk) == (n, k) else v.detach())
                              for lk, v in d.items()} for ln, d in p64.items()}
                with torch.no_grad():
                    fs.append(float(self.loss(trial, x, targets, frame_mask)))
            fd = (fs[0] - fs[1]) / (2 * eps)
            an = float(grads[li][idx])
            denom = max(abs(fd), abs(an), 1e-8)
            worst = max(worst, abs(fd - an) / denom)
        if worst > tolerance:
            raise AssertionError(f"gradient check failed: {worst} > {tolerance}")
        return worst

    # -- reference-format serialization (raw float32 per layer) -------------

    def save(self, params: Params, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        for s in self.specs:
            W = params[s.name]["W"].detach().cpu().numpy().astype(np.float32)
            b = params[s.name]["b"].detach().cpu().numpy().astype(np.float32)
            with open(folder + s.name, "wb") as f:
                W.tofile(f)
                b.tofile(f)

    def load(self, folder: str) -> Params:
        """Read the weights of ``save`` (and of the reference package's
        ``MLP.save``); sets the module's weights and returns them
        (``params()``)."""
        params = {}
        for s in self.specs:
            D = self.layer_input_dim(s)
            raw = np.fromfile(folder + s.name, dtype=np.float32)
            if raw.size != s.num_outputs * D + s.num_outputs:
                raise ValueError(f"bad parameter file for layer {s.name}")
            params[s.name] = {"W": torch.from_numpy(raw[: s.num_outputs * D].reshape(s.num_outputs, D)),
                              "b": torch.from_numpy(raw[s.num_outputs * D:])}
        self.set_params(params)
        return self.params()


# -- updaters (NNTraining.cpp:211-260) ---------------------------------------
#
# Each ``update`` is a plain function of tensors: it returns the new
# parameters and state and changes neither argument, so that the trainer's
# finite guard can keep the previous ones.


class SGDUpdater:
    def __init__(self, learning_rate: float = 0.001):
        self.learning_rate = learning_rate

    def init_state(self, params: Params) -> Dict:
        return {}

    def update(self, params: Params, grads: Params, state: Dict) -> Tuple[Params, Dict]:
        new = {n: {k: p - self.learning_rate * grads[n][k] for k, p in d.items()}
               for n, d in params.items()}
        return new, state


class AdaDeltaUpdater:
    """AdaDelta with RMS accumulators (NNTraining.cpp:230-260;
    momentum 0.9, stability 1e-8, no learning-rate scaling)."""

    def __init__(self, momentum: float = 0.90, stability: float = 1e-8,
                 learning_rate: float = 0.001):
        self.momentum = momentum
        self.stability = stability
        self.learning_rate = learning_rate  # unused by the update, kept for parity

    def init_state(self, params: Params) -> Dict:
        zeros = lambda: {n: {k: torch.zeros_like(v) for k, v in d.items()}
                         for n, d in params.items()}
        return {"grad_rms": zeros(), "update_rms": zeros()}

    def update(self, params: Params, grads: Params, state: Dict) -> Tuple[Params, Dict]:
        m, eps = self.momentum, self.stability
        new, grad_rms, update_rms = {}, {}, {}
        for n, d in params.items():
            new[n], grad_rms[n], update_rms[n] = {}, {}, {}
            for k, p in d.items():
                g = grads[n][k]
                grms = m * state["grad_rms"][n][k] + (1 - m) * g * g
                step = torch.sqrt(state["update_rms"][n][k] + eps) / torch.sqrt(grms + eps) * -g
                update_rms[n][k] = m * state["update_rms"][n][k] + (1 - m) * step * step
                new[n][k] = p + step
                grad_rms[n][k] = grms
        return new, {"grad_rms": grad_rms, "update_rms": update_rms}


# -- scorer for the decoder ---------------------------------------------------


@dataclass
class NNScorer:
    """FeatureScorer-compatible: am[t, s] = −log p(s|x_t) + κ·log prior(s),
    with ``mlp``'s own weights, on the device of ``log_prior`` and ``mlp``."""

    mlp: MLP
    log_prior: torch.Tensor   # [num_classes], already scaled by prior_scale
    context_frames: int

    @staticmethod
    def load_prior(path: str, num_classes: int, prior_scale: float,
                   device="cuda") -> torch.Tensor:
        """``prior_scale · log p`` over the file's first ``num_classes``
        values, in float64 rounded to float32, kept as it is where p = 0."""
        vals = np.loadtxt(path).reshape(-1)[:num_classes]
        return torch.as_tensor(prior_scale * np.log(vals), dtype=torch.float32,
                               device=pack_device(device, "NN prior"))

    @property
    def device(self) -> torch.device:
        return self.log_prior.device

    @property
    def base_dim(self) -> int:
        """Features per frame before the context window."""
        return self.mlp.input_dim // (2 * self.context_frames + 1)

    def am_batch(self, feats) -> torch.Tensor:
        """feats f32 [B, T, base_dim] (numpy, or a tensor) → scores
        [B, T, C] on the scorer's device."""
        x = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            windows = build_context_windows(x, self.context_frames)
            return -self.mlp(windows) + self.log_prior


def build_context_windows(x: torch.Tensor, context_frames: int) -> torch.Tensor:
    """[B, T, D] → [B, T, (2k+1)·D] with *zero* padding outside the sequence
    (the reference leaves out-of-range context at 0, NNTraining.cpp:123-127)."""
    if context_frames == 0:
        return x
    k = context_frames
    T = x.shape[1]
    padded = torch.nn.functional.pad(x, (0, 0, k, k))
    return torch.cat([padded[:, d: d + T, :] for d in range(2 * k + 1)], dim=-1)
