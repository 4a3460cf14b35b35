"""Plain reference of the SieTill configuration's EM training, in PyTorch
float64: the reference trainer's realign-and-estimate iteration
(src/sietill/Training.cpp:138-225 without a split; Alignment.cpp:149-288,
Mixtures.cpp:296-461), written from the reference's semantics: the pruned
forced alignment of each utterance's silence-word-silence automaton over the
max-approximated GMM scores, then the max-approximated E-step (each frame to
the first best density of its aligned mixture), the M-step, and the AM score
of the new model under the same alignment.

Imports NumPy, PyTorch and the benchmark's plain model reader only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from benchmark.harness import mixfile, traffic

BIG = 1e30
#: frames scored at once (the [n, densities, dim] differences in float64)
SCORE_CHUNK = 2048


def am_scores(model: mixfile.Model, x: torch.Tensor) -> torch.Tensor:
    """[n, dim] float64 → [n, S]: per mixture the least of its densities'
    norm + ½ Σ (x − μ)² / σ² − log w, capped at 1e10."""
    dev = x.device
    S, D, dim = model.means.shape
    mu = torch.as_tensor(model.means, device=dev).reshape(S * D, dim)
    iv = torch.as_tensor(1.0 / model.variances, device=dev).reshape(S * D, dim)
    const = torch.as_tensor(np.where(model.active, model.norms, np.inf), device=dev).reshape(-1)
    logw = torch.as_tensor(np.where(model.active, model.log_weights, 0.0), device=dev).reshape(-1)
    out = []
    for i in range(0, x.shape[0], SCORE_CHUNK):
        xc = x[i:i + SCORE_CHUNK]
        d = xc[:, None, :] - mu[None]
        m = ((d * d * iv[None]).sum(-1) * 0.5 + const[None]) - logw[None]
        out.append(torch.clamp(m.reshape(-1, S, D).amin(-1), max=mixfile.SCORE_CAP))
    return torch.cat(out)


#: the variance accumulators' floor (Mixtures.cpp:167)
MIN_VARIANCE = 1e-4
ALIGN_BATCH = 2048
ESTEP_CHUNK = 1 << 17


@dataclass
class Params:
    means: np.ndarray   # [S, D, dim]
    var: np.ndarray     # [S, D, dim]
    logw: np.ndarray    # [S, D]
    norms: np.ndarray   # [S, D]
    active: np.ndarray  # [S, D]


def _params_of(model: mixfile.Model) -> Params:
    return Params(model.means.copy(), model.variances.copy(), model.log_weights.copy(),
                  model.norms.copy(), model.active.copy())


def _density_scores(p: Params, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[n, dim] frames and their mixtures [n] → [n, D] float64 scores (+inf
    for a slot without an active density)."""
    dev = x.device
    mu = torch.as_tensor(p.means, device=dev)[s]
    iv = torch.as_tensor(1.0 / p.var, device=dev)[s]
    const = torch.as_tensor(np.where(p.active, p.norms, np.inf), device=dev)[s]
    logw = torch.as_tensor(np.where(p.active, p.logw, 0.0), device=dev)[s]
    d = x[:, None, :] - mu
    return ((d * d * iv).sum(-1) * 0.5 + const) - logw


def _align(p: Params, cfg, lex, features, offsets, words, device) -> np.ndarray:
    """Each frame's state under the pruned forced alignment."""
    lengths = np.diff(offsets)
    sil = lex.states[lex.silence]
    auts = [np.concatenate([np.concatenate([sil, lex.states[w]]) for w in ws] + [sil])
            for ws in words]
    t = cfg["tdp"]
    base = np.array([t["loop"], t["forward"], t["skip"]])
    sil_state = int(sil[0])
    thr = float(cfg["train_pruning_threshold"])
    model = mixfile.Model(cfg["dim"], p.means, p.var, p.logw, p.norms, p.active)
    out = np.zeros(int(offsets[-1]), np.int32)
    order = np.argsort(lengths, kind="stable")
    big = torch.tensor(BIG, dtype=torch.float64, device=device)
    for i in range(0, len(order), ALIGN_BATCH):
        ids = order[i:i + ALIGN_BATCH]
        B, T = len(ids), int(lengths[ids].max())
        A = max(len(auts[u]) for u in ids)
        st = np.zeros((B, A), np.int64)
        al = np.array([len(auts[u]) for u in ids])
        for k, u in enumerate(ids):
            st[k, :al[k]] = auts[u]
            st[k, al[k]:] = auts[u][-1]
        tdp = np.where((st == sil_state)[..., None], t["forward"], base[None, None, :])
        tdp_t = torch.as_tensor(tdp, device=device)
        st_t = torch.as_tensor(st, device=device)
        invalid = torch.as_tensor(np.arange(A)[None, :] >= al[:, None], device=device)
        lens = torch.as_tensor(lengths[ids], device=device)
        idx = offsets[ids][:, None] + np.minimum(np.arange(T)[None, :],
                                                 lengths[ids][:, None] - 1)
        x = torch.as_tensor(features[idx.reshape(-1)], device=device).double()
        am = am_scores(model, x).reshape(B, T, -1)
        jumps = torch.zeros((T, B, A), dtype=torch.int8, device=device)
        prev = big.expand(B, A).clone()
        for tt in range(T):
            a_t = am[:, tt].gather(1, st_t)
            if tt == 0:
                cost = torch.where(torch.arange(A, device=device)[None, :] == 0, a_t, big)
            else:
                best, jump = None, None
                for j in (2, 1, 0):       # the largest jump wins a tie
                    c = prev + tdp_t[:, :, j] if j == 0 else torch.cat(
                        [big.expand(B, j), prev[:, :A - j] + tdp_t[:, j:, j]], 1)
                    if best is None:
                        best, jump = c, torch.full((B, A), j, dtype=torch.int8, device=device)
                    else:
                        take = c < best
                        best = torch.where(take, c, best)
                        jump = jump.masked_fill(take, j)
                jumps[tt] = jump
                cost = torch.minimum(torch.where(invalid, big, best + a_t), big)
                m = cost.amin(1, keepdim=True)
                m = torch.where(m >= BIG / 2, torch.zeros_like(m), m)
                cost = torch.where(cost >= BIG / 2, big, cost - m)
                cost = torch.where(cost > thr, big, cost)
            prev = torch.where((tt < lens)[:, None], cost, prev)
        # backtrack from the highest position reached in the last frame
        finite = prev < BIG / 2
        cur = torch.where(finite, torch.arange(A, device=device)[None, :], -1).amax(1)
        cur = cur.clamp(min=0)[:, None]
        states = torch.empty((B, T), dtype=torch.int64, device=device)
        for tt in range(T - 1, -1, -1):
            states[:, tt] = st_t.gather(1, cur)[:, 0]
            back = cur - jumps[tt].gather(1, cur).long()
            cur = torch.where((tt <= lens - 1)[:, None], back, cur)
        states = states.cpu().numpy()
        for k, u in enumerate(ids):
            out[offsets[u]:offsets[u + 1]] = states[k, :lengths[u]]
    return out


def _estep(p: Params, features, alignment, device):
    """(score total, w [S, D], xs [S, D, dim], x2s [S, D, dim]) in float64."""
    S, D, dim = p.means.shape
    w = torch.zeros(S * D, dtype=torch.float64, device=device)
    xs = torch.zeros((S * D, dim), dtype=torch.float64, device=device)
    x2s = torch.zeros((S * D, dim), dtype=torch.float64, device=device)
    total = 0.0
    for i in range(0, len(alignment), ESTEP_CHUNK):
        x = torch.as_tensor(features[i:i + ESTEP_CHUNK], device=device).double()
        s = torch.as_tensor(alignment[i:i + ESTEP_CHUNK], dtype=torch.long, device=device)
        sc = _density_scores(p, x, s)
        d = sc.argmin(1)
        total += float(torch.clamp(sc.amin(1), max=mixfile.SCORE_CAP).sum())
        j = s * D + d
        w.index_add_(0, j, torch.ones_like(j, dtype=torch.float64))
        xs.index_add_(0, j, x)
        x2s.index_add_(0, j, x * x)
    return (total, w.reshape(S, D).cpu().numpy(), xs.reshape(S, D, dim).cpu().numpy(),
            x2s.reshape(S, D, dim).cpu().numpy())


def _mstep(w, xs, x2s, dim) -> Params:
    """Means, mixture weights and a variance a density (no pooling)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        means = xs / w[..., None]
        total = w.sum(1, keepdims=True)
        logw = np.log(w / total)
        var = (MIN_VARIANCE + x2s) / w[..., None] - means * means
        norms = (dim * np.log(2 * np.pi) + np.log(var).sum(-1)) / 2.0
    active = (np.isfinite(means).all(-1) & np.isfinite(var).all(-1) & np.isfinite(logw)
              & np.isfinite(norms))
    return Params(np.where(active[..., None], means, 0.0), np.where(active[..., None], var, 1.0),
                  np.where(active, logw, 0.0), np.where(active, norms, 0.0), active)


def train(cfg: dict, model_path: str, features: np.ndarray, offsets: np.ndarray,
          words, device, iterations: int) -> List[dict]:
    """``iterations`` realign-and-estimate iterations from the model file:
    each one's alignment, its E-step's statistics, the model after its
    M-step (means, variances, log-weights) and its AM score."""
    model = mixfile.read_model(model_path, cfg["dim"], cfg["pooling"])
    lex = traffic.lexicon_from_config(cfg["lexicon"], model)
    p = _params_of(model)
    n = int(offsets[-1])
    out = []
    with torch.no_grad():
        for _ in range(iterations):
            align = _align(p, cfg, lex, features, offsets, words, device)
            _total, w, xs, x2s = _estep(p, features, align, device)
            p = _mstep(w, xs, x2s, cfg["dim"])
            total = _estep(p, features, align, device)[0]
            out.append({"alignment": align, "stats": (w, xs, x2s), "score": total / n,
                        "params": (np.where(p.active[..., None], p.means, np.nan),
                                   np.where(p.active[..., None], p.var, np.nan),
                                   np.where(p.active, p.logw, np.nan))})
    return out
