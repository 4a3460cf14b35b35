"""MLLR speaker adaptation (mean transforms over a regression tree) —
counterpart of speechrecognition_tpu/train/mllr.py.

The reference's adaptation stack (rwth-asr-0.5/src/Mm/MllrAdaptation.cc +
Am/AdaptationTree.cc):

  * FullAdaptorViterbiEstimator (:794-930): per regression-tree node,
    accumulate  Z = sum_t w_t x_t [1, mu_t]^T   (D x D+1)
                G = sum_t w_t [1, mu_t][1, mu_t]^T
    (MllrAdaptation.cc:718-776), W = Z pinv(G) at every node with
    count > min-observations (:804-814); each leaf uses the deepest
    ancestor with enough counts, identity at a data-starved root
    (:870-930).  Applied as mu' = W [1; mu] (:168-194).
  * ShiftAdaptorViterbiEstimator (:446-540): variance-weighted bias only,
    shift_d = (sum w (x_d - mu_d)/var_d) / (sum w / var_d), applied as
    mu' = mu + shift (:66-88).

The Viterbi density selection scores every frame against every density in
one pass on the pack's device (gmm.density_scores); the accumulators, the
transforms and the adaptation are host numpy in float64, as the reference
package keeps them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..models import gmm as gmm_mod


@dataclass
class RegressionTree:
    """Binary regression-class tree (Am/AdaptationTree; Core/BinaryTree).

    Nodes 0..n_nodes-1; node 0 is the root.  ``leaf_of_mixture`` maps each
    mixture (HMM state / tied class) to a leaf id.  The reference derives
    the mapping by cutting a phonetic decision tree at ``base-classes``
    leaves (AdaptationTree.cc:22-63); any host-computed mapping works here
    (e.g. from sprint/cart trees or k-means over mixture means)."""

    parent: np.ndarray            # int32 [n_nodes], root = -1
    children: np.ndarray          # int32 [n_nodes, 2], -1 at leaves
    leaves: np.ndarray            # int32 [n_leaves] node ids
    leaf_of_mixture: np.ndarray   # int32 [n_mixtures] → index into leaves

    @property
    def num_nodes(self) -> int:
        return len(self.parent)

    @property
    def num_leaves(self) -> int:
        return len(self.leaves)

    @staticmethod
    def balanced(num_leaves: int, leaf_of_mixture: np.ndarray
                 ) -> "RegressionTree":
        """Complete binary tree over `num_leaves` regression classes."""
        parent = [-1]
        children: List[List[int]] = [[-1, -1]]
        frontier = [0]
        while len(frontier) < num_leaves:
            node = frontier.pop(0)
            ids = []
            for _ in range(2):
                nid = len(parent)
                parent.append(node)
                children.append([-1, -1])
                ids.append(nid)
            children[node] = ids
            frontier.extend(ids)
        leaves = np.asarray(sorted(frontier), np.int32)
        return RegressionTree(np.asarray(parent, np.int32),
                              np.asarray(children, np.int32),
                              leaves,
                              np.asarray(leaf_of_mixture, np.int32))

    @staticmethod
    def single_class(num_mixtures: int) -> "RegressionTree":
        """One global transform (the common small-data MLLR setup)."""
        return RegressionTree.balanced(1, np.zeros(num_mixtures, np.int64))

    def descendants_matrix(self) -> np.ndarray:
        """bool [n_nodes, n_leaves]: leaf j under node i — the propagate()
        recursion (MllrAdaptation.cc:291-311) as one mask matmul."""
        out = np.zeros((self.num_nodes, self.num_leaves), bool)
        for j, leaf in enumerate(self.leaves):
            n = int(leaf)
            while n != -1:
                out[n, j] = True
                n = int(self.parent[n])
        return out


def _mean_var_tables(model: gmm_mod.MixtureModel
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense [S, Dcap] → mean/var row tables for device gathers."""
    S = model.num_mixtures
    cap = model.max_densities_per_mixture
    mean_idx = np.full((S, cap), -1, np.int64)
    var_idx = np.full((S, cap), -1, np.int64)
    for s in range(S):
        for d, (mi, vi) in enumerate(model.mixtures[s]):
            mean_idx[s, d] = mi
            var_idx[s, d] = vi
    return mean_idx, var_idx, np.asarray(model.means)


def viterbi_density_means(model: gmm_mod.MixtureModel, pack: gmm_mod.ScorePack,
                          feats: np.ndarray, states: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Per frame, the best (Viterbi) density of the aligned mixture —
    the estimator's `density` argument (Speech feeds the max-approx best
    density).  One batched [N, S, D] scoring pass + masked argmin.
    Returns (means [N, D], vars [N, D]) of the selected densities."""
    mean_idx, var_idx, _ = _mean_var_tables(model)
    x = torch.as_tensor(np.asarray(feats), dtype=pack.dtype, device=pack.device)
    scores = gmm_mod.density_scores(pack, x).cpu().numpy()   # [N, S, Dcap]
    sel = scores[np.arange(len(states)), states]        # [N, Dcap]
    active = mean_idx[states] >= 0
    sel = np.where(active, sel, np.inf)
    best = sel.argmin(axis=1)                           # [N]
    mi = mean_idx[states, best]
    vi = var_idx[states, best]
    return np.asarray(model.means)[mi], np.asarray(model.vars)[vi]


class FullMllrEstimator:
    """W = Z G^-1 full mean transform per regression node."""

    def __init__(self, tree: RegressionTree, dim: int,
                 min_observations: float = 200.0):
        self.tree = tree
        self.dim = dim
        self.min_obs = min_observations
        L = tree.num_leaves
        self.z = np.zeros((L, dim, dim + 1))
        self.g = np.zeros((L, dim + 1, dim + 1))
        self.counts = np.zeros(L)

    def accumulate(self, feats: np.ndarray, mixtures: np.ndarray,
                   means: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> None:
        """feats [N, D] aligned to mixtures [N]; means [N, D] = Viterbi
        density means (viterbi_density_means).  Leaf-masked matmuls."""
        x = np.asarray(feats, np.float64)
        mu = np.asarray(means, np.float64)
        w = (np.ones(len(x)) if weights is None
             else np.asarray(weights, np.float64))
        ext = np.concatenate([np.ones((len(x), 1)), mu], axis=1)  # [N, D+1]
        leaf = self.tree.leaf_of_mixture[np.asarray(mixtures, np.int64)]
        for l in range(self.tree.num_leaves):
            m = leaf == l
            if not m.any():
                continue
            xw = x[m] * w[m, None]
            self.z[l] += xw.T @ ext[m]
            self.g[l] += (ext[m] * w[m, None]).T @ ext[m]
            self.counts[l] += m.sum()

    def merge(self, other: "FullMllrEstimator") -> None:
        self.z += other.z
        self.g += other.g
        self.counts += other.counts

    def estimate(self) -> Tuple[Dict[int, np.ndarray], np.ndarray]:
        """→ (per-leaf transform matrices W [D, D+1], node counts).
        Deepest-sufficient-ancestor selection; identity fallback."""
        desc = self.tree.descendants_matrix()               # [n_nodes, L]
        node_counts = desc @ self.counts
        node_z = np.einsum("nl,lij->nij", desc, self.z)
        node_g = np.einsum("nl,lij->nij", desc, self.g)
        unit = np.concatenate(
            [np.zeros((self.dim, 1)), np.eye(self.dim)], axis=1)
        w_cache: Dict[int, np.ndarray] = {}
        per_leaf: Dict[int, np.ndarray] = {}
        for j, leaf in enumerate(self.tree.leaves):
            n = int(leaf)
            while self.tree.parent[n] != -1 and node_counts[n] <= self.min_obs:
                n = int(self.tree.parent[n])
            if node_counts[n] <= self.min_obs:
                per_leaf[j] = unit                          # starved root
                continue
            if n not in w_cache:
                w_cache[n] = node_z[n] @ np.linalg.pinv(node_g[n])
            per_leaf[j] = w_cache[n]
        return per_leaf, node_counts

    def adapt(self, model: gmm_mod.MixtureModel) -> None:
        """mu' = W [1; mu] for every density, in place
        (FullAdaptor::adaptMixtureSet)."""
        per_leaf, _ = self.estimate()
        mean_idx, _vi, _ = _mean_var_tables(model)
        for s in range(model.num_mixtures):
            W = per_leaf[int(self.tree.leaf_of_mixture[s])]
            for mi in mean_idx[s]:
                if mi < 0:
                    continue
                mu = model.means[mi]
                model.means[mi] = W @ np.concatenate([[1.0], mu])


class ShiftMllrEstimator:
    """Variance-weighted bias-only adaptation
    (ShiftAdaptorViterbiEstimator)."""

    def __init__(self, tree: RegressionTree, dim: int,
                 min_observations: float = 200.0):
        self.tree = tree
        self.dim = dim
        self.min_obs = min_observations
        L = tree.num_leaves
        self.beta = np.zeros((L, dim))
        self.shift = np.zeros((L, dim))
        self.counts = np.zeros(L)

    def accumulate(self, feats: np.ndarray, mixtures: np.ndarray,
                   means: np.ndarray, variances: np.ndarray,
                   weights: Optional[np.ndarray] = None) -> None:
        x = np.asarray(feats, np.float64)
        mu = np.asarray(means, np.float64)
        var = np.asarray(variances, np.float64)
        w = (np.ones(len(x)) if weights is None
             else np.asarray(weights, np.float64))
        leaf = self.tree.leaf_of_mixture[np.asarray(mixtures, np.int64)]
        contrib_b = w[:, None] / var
        contrib_s = w[:, None] * (x - mu) / var
        np.add.at(self.beta, leaf, contrib_b)
        np.add.at(self.shift, leaf, contrib_s)
        np.add.at(self.counts, leaf, 1.0)

    def merge(self, other: "ShiftMllrEstimator") -> None:
        self.beta += other.beta
        self.shift += other.shift
        self.counts += other.counts

    def estimate(self) -> Tuple[Dict[int, np.ndarray], np.ndarray]:
        desc = self.tree.descendants_matrix()
        node_counts = desc @ self.counts
        node_beta = desc @ self.beta
        node_shift = desc @ self.shift
        per_leaf: Dict[int, np.ndarray] = {}
        for j, leaf in enumerate(self.tree.leaves):
            n = int(leaf)
            while self.tree.parent[n] != -1 and node_counts[n] <= self.min_obs:
                n = int(self.tree.parent[n])
            if node_counts[n] <= self.min_obs:
                per_leaf[j] = np.zeros(self.dim)
            else:
                per_leaf[j] = node_shift[n] / node_beta[n]
        return per_leaf, node_counts

    def adapt(self, model: gmm_mod.MixtureModel) -> None:
        per_leaf, _ = self.estimate()
        mean_idx, _vi, _ = _mean_var_tables(model)
        for s in range(model.num_mixtures):
            shift = per_leaf[int(self.tree.leaf_of_mixture[s])]
            for mi in mean_idx[s]:
                if mi >= 0:
                    model.means[mi] = model.means[mi] + shift


def adapt_model(model: gmm_mod.MixtureModel, pack: gmm_mod.ScorePack,
                feats: np.ndarray, states: np.ndarray,
                tree: Optional[RegressionTree] = None,
                mode: str = "full", min_observations: float = 200.0,
                weights: Optional[np.ndarray] = None
                ) -> gmm_mod.MixtureModel:
    """One-call Viterbi MLLR: estimate transforms from aligned adaptation
    data (feats [N, D], states [N]) and return an adapted copy."""
    import copy
    tree = tree or RegressionTree.single_class(model.num_mixtures)
    means, variances = viterbi_density_means(model, pack, feats, states)
    if mode == "full":
        est = FullMllrEstimator(tree, model.dim, min_observations)
        est.accumulate(feats, states, means, weights)
    elif mode == "shift":
        est = ShiftMllrEstimator(tree, model.dim, min_observations)
        est.accumulate(feats, states, means, variances, weights)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    adapted = copy.deepcopy(model)
    est.adapt(adapted)
    return adapted
