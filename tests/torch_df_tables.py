"""Inputs shared by the port's CPU tests, its card tests and chip_smoke.py:
double-float scorer tables, and the cases of the alignment backtrack
(kernel G).

A plain module (no pytest, no jax), so chip_smoke.py loads it by path and
the CPU and card tests import it from tests/.
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


#: kernel G's cases (Tp, A, jumps, tie_pruned, T): Tp 1, 300 and 2,000
#: frames (none a multiple of the kernel's tile); A 1, 70 and 1,025
#: positions (70 and 1,025 not multiples of 4 or 16); "dp" and "random"
#: jumps (see backtrack_inputs); the pruned final position and the forced
#: one; T = 0, Tp - 7 or Tp frames emitted
BACKTRACK_CASES = [
    (1, 1, "dp", True, "Tp"), (1, 70, "random", False, "0"),
    (300, 1, "random", True, "Tp-7"), (300, 70, "dp", True, "Tp"),
    (300, 70, "random", False, "Tp-7"), (300, 1025, "dp", False, "Tp"),
    (300, 1025, "random", True, "0"), (2000, 1, "dp", True, "0"),
    (2000, 70, "random", True, "Tp"), (2000, 70, "dp", False, "Tp-7"),
    (2000, 1025, "random", False, "Tp-7"), (2000, 1025, "dp", True, "Tp"),
]


def backtrack_frames(Tp, which):
    """The frames T a case emits: "0", "Tp-7" or "Tp"."""
    return {"0": 0, "Tp-7": max(Tp - 7, 0), "Tp": Tp}[which]


def backtrack_inputs(Tp, A, jumps, seed, B=5):
    """Seeded inputs of align_backtrack, not produced by a DP, as numpy:
    final_hi float32 [B, A], aut_len int32 [B], jumps int8 [Tp, B, A],
    feat_len int32 [B], states_tbl int32 [B, A].

    Utterance 0 is Tp frames long, 1 is 0, 2 is 1, 3 a random length and
    the rest Tp; final rows mix finite costs with BIG (1e30), and row 1 is
    all BIG (no finite final position: the pruned rule gives 0); aut_len
    lies in [1, A], A for utterance 0. ``jumps="dp"`` draws 0, 1 or 2 and
    caps each at its position, as a DP's jumps are, so a walk stays in the
    row; ``"random"`` draws 0, 1 or 2 anywhere, so a walk runs below
    position 0 (the forced final position of an unreachable path) and, over
    enough frames, below -A, where the position wraps once and then clamps
    to the row."""
    rng = np.random.default_rng(seed)
    final_hi = np.where(rng.random((B, A)) < 0.6, rng.uniform(0.0, 300.0, (B, A)),
                        1e30).astype(np.float32)
    final_hi[1] = 1e30
    aut_len = rng.integers(1, A + 1, size=B).astype(np.int32)
    aut_len[0] = A
    draw = rng.integers(0, 3, size=(Tp, B, A))
    if jumps == "dp":
        draw = np.minimum(draw, np.arange(A)[None, None, :])
    lens = np.full(B, Tp, np.int32)
    lens[1:4] = (0, min(1, Tp), rng.integers(min(2, Tp), Tp + 1))
    states_tbl = rng.integers(0, 3000, size=(B, A)).astype(np.int32)
    return final_hi, aut_len, draw.astype(np.int8), lens[:B], states_tbl
