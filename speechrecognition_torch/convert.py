"""Carry model state from the JAX package into the port.

Each function reads the fields of a speechrecognition_tpu object as numpy
arrays (``np.asarray`` accepts JAX arrays without this module importing
jax) and builds the port's object, so that both packages score with the same
tables (GMM packs) or weights (the NN scorer).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.gmm import MixtureModel, ScorePack, ScorePackDF, VarianceModel, pack_device
from .ops import doublefloat as dfm

_MODEL_ARRAYS = ("means", "mean_acc", "mean_weights", "mean_weights_log",
                 "mean_weight_acc", "mean_refs", "vars", "vars_inv", "var_acc",
                 "var_weight_acc", "var_refs", "norm")


def mixture_model_from_jax(m) -> MixtureModel:
    """A port MixtureModel with the same float64 host state as the JAX
    package's MixtureModel ``m``."""
    model = MixtureModel.__new__(MixtureModel)
    model.dim = int(m.dim)
    model.num_mixtures = int(m.num_mixtures)
    model.var_model = VarianceModel(m.var_model.value)
    model.max_approx = bool(m.max_approx)
    for name in _MODEL_ARRAYS:
        setattr(model, name, np.array(getattr(m, name)))
    model.mixtures = [[(int(mi), int(vi)) for (mi, vi) in mix]
                      for mix in m.mixtures]
    return model


def _tensor(x, device, dtype=None):
    # np.array copies: a JAX array's numpy view is read-only
    return None if x is None else torch.as_tensor(np.array(x), dtype=dtype,
                                                  device=device)


def score_pack_from_jax(pack, device="cuda") -> ScorePack:
    """A port ScorePack on ``device`` (the card unless the caller asks for
    the CPU) holding the JAX ScorePack's tables."""
    device = pack_device(device)
    dtype = getattr(torch, np.dtype(pack.dtype).name)
    return ScorePack(P=_tensor(pack.P, device, dtype),
                     active=_tensor(pack.active, device, torch.bool),
                     num_mixtures=int(pack.num_mixtures),
                     density_cap=int(pack.density_cap), dim=int(pack.dim),
                     max_approx=bool(pack.max_approx), dtype=dtype,
                     method=str(pack.method), mu=_tensor(pack.mu, device),
                     a=_tensor(pack.a, device), c=_tensor(pack.c, device))


def score_pack_df_from_jax(packdf, device="cuda") -> ScorePackDF:
    """A port ScorePackDF on ``device`` (the card unless the caller asks for
    the CPU) holding the hi and lo words of the JAX ScorePackDF's tables."""
    device = pack_device(device)
    def pair(x):
        return dfm.DF(_tensor(x.hi, device, torch.float32), _tensor(x.lo, device, torch.float32))

    return ScorePackDF(mu=pair(packdf.mu), iv=pair(packdf.iv), norm=pair(packdf.norm),
                       logw=pair(packdf.logw),
                       active=_tensor(packdf.active, device, torch.bool),
                       num_mixtures=int(packdf.num_mixtures),
                       density_cap=int(packdf.density_cap), dim=int(packdf.dim),
                       max_approx=bool(packdf.max_approx))


def mlp_params_from_jax(params, device="cuda"):
    """The JAX MLP's ``{layer: {"W", "b"}}`` pytree as the port's params
    dict of float32 tensors on ``device`` (the card unless the caller asks
    for the CPU)."""
    device = pack_device(device, "MLP parameters")
    return {name: {k: _tensor(v, device, torch.float32) for k, v in layer.items()}
            for name, layer in params.items()}


def nn_scorer_from_jax(scorer, device="cuda"):
    """A port NNScorer on ``device`` (the card unless the caller asks for the
    CPU) with the JAX NNScorer's layers, weights, log prior and context."""
    from .models.nn import MLP, LayerSpec, NNScorer
    device = pack_device(device, "NN scorer")
    specs = [LayerSpec(name=s.name, num_outputs=int(s.num_outputs), kind=s.kind,
                       nonlinearity=s.nonlinearity, inputs=tuple(s.inputs),
                       weight_decay=s.weight_decay,
                       weight_decay_factor=float(s.weight_decay_factor))
             for s in scorer.mlp.specs]
    mlp = MLP(specs, int(scorer.mlp.input_dim), device=device)
    mlp.set_params(mlp_params_from_jax(scorer.params, "cpu"))
    return NNScorer(mlp, _tensor(scorer.log_prior, device, torch.float32),
                    int(scorer.context_frames))


def quant_pack_from_jax(qp, device="cuda"):
    """A port QuantPack on ``device`` (the card unless the caller asks for
    the CPU) holding the JAX QuantPack's integer tables, scale, selection
    tables and backoff as they are."""
    from .models.quantized import QuantPack
    device = pack_device(device, "quantized scoring pack")
    return QuantPack(qmeans=_tensor(qp.qmeans, device, torch.int8),
                     qmeans_sq=_tensor(qp.qmeans_sq, device, torch.int32),
                     consts=_tensor(qp.consts, device, torch.int32),
                     inv_sqrt_var=_tensor(qp.inv_sqrt_var, device, torch.float32),
                     scale2x=float(qp.scale2x),
                     active=_tensor(qp.active, device, torch.bool),
                     num_mixtures=int(qp.num_mixtures), density_cap=int(qp.density_cap),
                     dim=int(qp.dim),
                     qcenters=_tensor(qp.qcenters, device, torch.int8),
                     qcenters_sq=_tensor(qp.qcenters_sq, device, torch.int32),
                     cluster_of=_tensor(qp.cluster_of, device, torch.int32),
                     n_selected=int(qp.n_selected), backoff=float(qp.backoff))


def char_rnn_params_from_jax(params, device="cuda"):
    """The JAX char-RNN's parameter dict (``Wxh``, ``Whh``, ``Why``, ``bh``,
    ``by``) as the port's, each array in its own float type on ``device``
    (the card unless the caller asks for the CPU)."""
    device = pack_device(device, "char-RNN parameters")
    return {k: _tensor(v, device) for k, v in params.items()}
