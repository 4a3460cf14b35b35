"""Sprint Mm MixtureSet text-format IO.

Counterpart of the reference's Mm/MixtureSet.cc read/write (text
format, `#Version: 2.0`, log-weight mixtures — MixtureSet.cc:144-218)
and the per-object formats Mixture::write (Mixture.cc:87-96),
GaussDensityTopology::write (MixtureSetTopology.cc:18-22), Mean::write
/ DiagonalCovariance::write (GaussDensity.cc:26-57).

Purpose: export THIS framework's trained acoustic models in the format
the reference's C++ `speech-recognizer` loads (`[*.mixture-set] file`),
enabling system-level A/B between the two implementations on the AN4
setup (the reference's own trained AM is not shipped).

Port: a copy of speechrecognition_tpu/sprint/mm_io.py (host code).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def write_sprint_mixture_set(path: str, model) -> None:
    """MixtureModel (any pooling; global pooling → 1 covariance) →
    Sprint text MixtureSet v2.0.

    Densities with non-finite means or log-weights (zero-count classes)
    are dropped, like the framework's own pack(); empty mixtures stay
    (the C++ Mixture reads `0` densities and scores to +inf, exactly as
    our inactive states do).
    """
    dim = model.dim
    # collect densities mixture-major, renumbering means compactly
    mean_rows: List[np.ndarray] = []
    density_rows: List[Tuple[int, int]] = []       # (mean_idx, cov_idx)
    mixture_rows: List[List[Tuple[int, float]]] = []
    mean_of: dict = {}
    for s in range(model.num_mixtures):
        row: List[Tuple[int, float]] = []
        for (mi, vi) in model.mixtures[s]:
            mu = model.means[mi]
            lw = model.mean_weights_log[mi]
            if not (np.isfinite(mu).all() and np.isfinite(lw)):
                continue
            if mi not in mean_of:
                mean_of[mi] = len(mean_rows)
                mean_rows.append(np.asarray(mu, np.float64))
            density_rows.append((mean_of[mi], int(vi)))
            row.append((len(density_rows) - 1, float(lw)))
        mixture_rows.append(row)

    n_cov = int(max((vi for s in range(model.num_mixtures)
                     for (_mi, vi) in model.mixtures[s]), default=0)) + 1
    covs = [np.asarray(model.vars[c], np.float64) for c in range(n_cov)]

    with open(path, "w") as f:
        f.write("#Version: 2.0\n")
        f.write("#CovarianceType: DiagonalCovariance\n")
        f.write(f"{dim} {len(mixture_rows)} {len(density_rows)} "
                f"{len(mean_rows)} {n_cov}\n")
        for row in mixture_rows:
            f.write(str(len(row)))
            for dns, lw in row:
                f.write(f" {dns} {lw:.17g}")
            f.write("\n")
        for mi, ci in density_rows:
            f.write(f"{mi} {ci}\n")
        for mu in mean_rows:
            f.write(str(dim) + "".join(f" {v:.17g}" for v in mu) + "\n")
        for cov in covs:
            # MixtureSet::write emits a leading space before each
            # covariance; weights are the per-dim accumulation weights
            # (not used by the scorers) — written as 1
            f.write(" " + str(dim)
                    + "".join(f" {v:.17g} 1" for v in cov) + "\n")


def read_sprint_mixture_set(path: str):
    """Parse the text MixtureSet back (round-trip check):
    returns (dim, mixtures [[(dns, logw)]], densities [(mean, cov)],
    means [np], covs [np])."""
    with open(path) as f:
        tok_lines = f.read().split("\n")
    assert tok_lines[0].startswith("#Version: 2")
    assert "DiagonalCovariance" in tok_lines[1]
    toks = " ".join(tok_lines[2:]).split()
    pos = 0

    def take(n=1):
        nonlocal pos
        out = toks[pos:pos + n]
        pos += n
        return out

    dim, n_mix, n_dns, n_mean, n_cov = (int(x) for x in take(5))
    mixtures = []
    for _ in range(n_mix):
        n = int(take()[0])
        row = []
        for _ in range(n):
            d, w = take(2)
            row.append((int(d), float(w)))
        mixtures.append(row)
    densities = []
    for _ in range(n_dns):
        m, c = take(2)
        densities.append((int(m), int(c)))
    means = []
    for _ in range(n_mean):
        n = int(take()[0])
        means.append(np.array([float(x) for x in take(n)]))
    covs = []
    for _ in range(n_cov):
        n = int(take()[0])
        pairs = [float(x) for x in take(2 * n)]
        covs.append(np.array(pairs[0::2]))
    return dim, mixtures, densities, means, covs
