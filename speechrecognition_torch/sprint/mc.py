"""Scaled model combination (Mc tier).

Counterpart of rwth-asr's Mc module + Speech::ModelCombination
(Mc/Component.hh:26-80, Speech/ModelCombination.cc:27-106): every model in
a combination carries an *own* scale read from its config selection
(`<component>.scale`), and the effective scale of a component is the
product of its parent's effective scale and its own — Mc::Component keeps
``scale_ = parentScale * ownScale`` and propagates ScaleUpdate objects down
the tree. A ModelCombination bundles lexicon + acoustic model + language
model and adds a `pronunciation-scale` applied to pronunciation weights
(ModelCombination.hh:67: ``pronunciationScale_ * scale()``).

Here the combination is resolved eagerly into plain numbers and applied to
the dense score tables the batched decoders consume — there is no lazy
scale tree to keep in sync because tables are rebuilt functionally.

Port: a copy of speechrecognition_tpu/sprint/mc.py (host code).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .config import SprintConfig


class ScaledComponent:
    """Mc::Component semantics: effective = parent × own scale.

    Subclasses/users register children; `distribute_scale_update`
    re-propagates after any own-scale change (Mc/Component.hh:55-80).
    """

    def __init__(self, own_scale: float = 1.0) -> None:
        self._own = float(own_scale)
        self._parent = 1.0
        self._children: Dict[str, "ScaledComponent"] = {}

    @staticmethod
    def from_config(cfg: SprintConfig, selection: str,
                    default: float = 1.0) -> "ScaledComponent":
        return ScaledComponent(cfg.get_float(f"{selection}.scale", default))

    @property
    def own_scale(self) -> float:
        return self._own

    @property
    def scale(self) -> float:
        """Effective scale (parent × own)."""
        return self._parent * self._own

    def set_own_scale(self, s: float) -> None:
        self._own = float(s)
        self.distribute_scale_update()

    def add_child(self, name: str, child: "ScaledComponent") -> "ScaledComponent":
        self._children[name] = child
        child._parent = self.scale
        child.distribute_scale_update()
        return child

    def distribute_scale_update(self,
                                scale_map: Optional[Dict[str, float]] = None,
                                _prefix: str = "") -> None:
        """Mc::ScaleUpdate: optional name→scale overrides walk the tree;
        every node re-derives effective = parent × own."""
        for name, child in self._children.items():
            path = f"{_prefix}{name}"
            if scale_map and path in scale_map:
                child._own = float(scale_map[path])
            child._parent = self.scale
            child.distribute_scale_update(scale_map, _prefix=f"{path}.")


@dataclass
class ModelCombination:
    """Lexicon + acoustic model + LM with scales, decoder-ready.

    Mirrors Speech::ModelCombination: a top-level scale, a
    pronunciation-scale, and per-model scales resolved through the Mc
    tree. `lm_matrix`/`scaled_am`/`pronunciation_weights` apply the
    effective scales to the dense tables used by the search tier.
    """

    scale: float = 1.0
    pronunciation_scale: float = 0.0
    am_scale: float = 1.0
    lm_scale: float = 1.0
    tdp_scale: float = 1.0

    @staticmethod
    def from_config(cfg: SprintConfig, prefix: str = "x",
                    ) -> "ModelCombination":
        root = ScaledComponent.from_config(cfg, prefix)
        am = root.add_child("acoustic-model", ScaledComponent.from_config(
            cfg, f"{prefix}.acoustic-model"))
        lm = root.add_child("lm", ScaledComponent.from_config(
            cfg, f"{prefix}.lm"))
        tdp = am.add_child("tdp", ScaledComponent.from_config(
            cfg, f"{prefix}.acoustic-model.tdp"))
        return ModelCombination(
            scale=root.scale,
            pronunciation_scale=cfg.get_float(
                f"{prefix}.pronunciation-scale", 0.0) * root.scale,
            am_scale=am.scale, lm_scale=lm.scale, tdp_scale=tdp.scale)

    def scaled_am(self, am: np.ndarray) -> np.ndarray:
        """Acoustic −log scores × effective AM scale."""
        return am if self.am_scale == 1.0 else am * self.am_scale

    def lm_matrix(self, lm: np.ndarray) -> np.ndarray:
        """Dense bigram −log matrix × effective LM scale (the decoders'
        min-plus recombination input, search/ngram_decoder.py)."""
        return lm if self.lm_scale == 1.0 else lm * self.lm_scale

    def pronunciation_weights(self, pron_neg_log: np.ndarray) -> np.ndarray:
        """Pronunciation −log weights × pronunciationScale_ · scale()
        (added into per-word entry penalties)."""
        return pron_neg_log * self.pronunciation_scale
