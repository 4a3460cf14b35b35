"""Seeded inputs of the forward-backward scan (kernel L and its plain
version), shared by tests/test_torch_baumwelch.py, tests/test_torch_cuda.py
and chip_smoke.py (which loads this file by path). Imports numpy only."""

import numpy as np

#: kernel L's instance for A positions (sr_forward_backward_instance):
#: positions a lane of the two chains (one warp a chain up to A = 96, 2-8
#: warps past it: sr_forward_backward_warps), -1 for the block instance with
#: its rows in device scratch; each side of every edge, the Sprint path's
#: A 303 and each of the wide chains' 2, 3 and 4 positions a lane
L_INSTANCES = {1: 1, 2: 1, 3: 1, 32: 1, 33: 2, 64: 2, 65: 3, 70: 3, 96: 3, 97: 2, 160: 2,
               303: 2, 512: 2, 700: 3, 1024: 4, 1025: -1}


def fb_inputs(B, T, A, seed):
    """float64 (lams [B, T, A], ltdp [B, A, 3], pos_valid bool [B, A],
    feat_len int32 [B], aut_len int32 [B]): emissions −U(0, 20), transitions
    −U(0, 5), ragged feat_len in [1, T] and aut_len in [1, A], utterance 0
    at full length; utterance 1 has an unreachable final position (two
    frames for an automaton of A >= 4 positions) where the shape allows
    one."""
    rng = np.random.default_rng(seed)
    lams = -rng.uniform(0.0, 20.0, (B, T, A))
    ltdp = -rng.uniform(0.0, 5.0, (B, A, 3))
    feat_len = rng.integers(1, T + 1, B).astype(np.int32)
    feat_len[0] = T
    aut_len = rng.integers(1, A + 1, B).astype(np.int32)
    aut_len[0] = A
    if A >= 4 and T >= 2 and B >= 2:
        feat_len[1], aut_len[1] = 2, A
    pos_valid = np.arange(A)[None, :] < aut_len[:, None]
    return lams, ltdp, pos_valid, feat_len, aut_len
