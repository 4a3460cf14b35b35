"""Double-float scorer tables for the port's tests and chip_smoke.py.

A plain module (no pytest), so chip_smoke.py loads it by path and the CPU
and card tests import it from tests/.
"""

import numpy as np
import torch

from speechrecognition_torch.models import gmm
from speechrecognition_torch.ops import doublefloat as dfm


def wide_magnitude_pack_df(S, D, dim, seed, n, device="cpu"):
    """A ScorePackDF and n frames whose magnitudes span 1e-6 .. 1e6 across
    the feature dimensions (x and mu scaled by s_i, iv by 1/s_i), with mu and
    iv carrying lo words of 2^-27 .. 2^-26 of their hi words, and every third
    frame equal to the mu.hi of one density (diff = -mu.lo there)."""
    rng = np.random.default_rng(seed)
    J = S * D
    scale = 10.0 ** np.linspace(-6.0, 6.0, dim)

    def pair(v):
        hi = v.astype(np.float32)
        lo = (hi.astype(np.float64) * rng.choice([-1.0, 1.0], hi.shape)
              * rng.uniform(2.0 ** -27, 2.0 ** -26, hi.shape)).astype(np.float32)
        return dfm.DF(torch.as_tensor(hi, device=device), torch.as_tensor(lo, device=device))

    mu = pair(rng.normal(size=(J, dim)) * scale)
    iv = pair(rng.uniform(0.5, 2.0, size=(J, dim)) / scale)
    x = (rng.normal(size=(n, dim)) * scale).astype(np.float32)
    hit = np.arange(0, n, 3)
    x[hit] = mu.hi.cpu().numpy()[(hit * 7) % J]
    pack = gmm.ScorePackDF(mu=mu, iv=iv, norm=dfm.from_f64(rng.uniform(10.0, 40.0, J), device),
                           logw=dfm.from_f64(np.log(rng.uniform(0.05, 1.0, J)), device),
                           active=torch.ones((S, D), dtype=torch.bool, device=device),
                           num_mixtures=S, density_cap=D, dim=dim, max_approx=True)
    return pack, torch.as_tensor(x, device=device)
