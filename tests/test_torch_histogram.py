"""The port's histogram pruning (speechrecognition_torch/search/histogram.py)
against the JAX package's on the same scores: the quantile and the pruning
bit for bit, over seeds, bin counts, limits and invalid entries; each row of
the port's batched version equals the reference's function on that row."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechrecognition_tpu.search import histogram as jh
from speechrecognition_torch.search import histogram as th

torch.set_num_threads(1)


def scores_and_valid(seed, rows, n, dtype):
    rng = np.random.RandomState(seed)
    scores = rng.uniform(0.0, 50.0, size=(rows, n)).astype(dtype)
    valid = rng.uniform(size=(rows, n)) < 0.8
    return scores, valid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("bins", [16, 101])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_quantile_bit_equal(seed, bins, dtype):
    scores, valid = scores_and_valid(seed, 3, 500, dtype)
    for limit in (1, 10, 100, 399, 500, 600):
        got = th.histogram_quantile(torch.as_tensor(scores), torch.as_tensor(valid), 0.0,
                                    50.0, limit, bins)
        for r in range(3):
            want = np.asarray(jh.histogram_quantile(jnp.asarray(scores[r]),
                                                    jnp.asarray(valid[r]),
                                                    jnp.asarray(0.0, dtype),
                                                    jnp.asarray(50.0, dtype), limit, bins))
            assert got.dtype == torch.from_numpy(scores).dtype
            assert got[r].numpy().tobytes() == want.tobytes(), (limit, r)


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("bins", [17, 101])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_prune_bit_equal(seed, bins, dtype):
    scores, valid = scores_and_valid(seed, 4, 1000, dtype)
    upper = dtype(20.0)
    for limit in (50, 100, 790, 2000):
        keep, thr = th.histogram_prune(torch.as_tensor(scores), torch.as_tensor(valid), limit,
                                       0.0, upper, bins)
        for r in range(4):
            jk, jt = jh.histogram_prune(jnp.asarray(scores[r]), jnp.asarray(valid[r]), limit,
                                        jnp.asarray(0.0, dtype), jnp.asarray(upper), bins)
            np.testing.assert_array_equal(keep[r].numpy(), np.asarray(jk))
            assert thr[r].numpy().tobytes() == np.asarray(jt).tobytes()


def test_prune_counts_and_degenerate_beam():
    """Nothing is pruned under the limit, and the quantile's lower bin edge
    keeps the count within a bin's population of the limit; a beam of zero
    width (lower == upper) keeps the beam."""
    rng = np.random.RandomState(5)
    scores = torch.as_tensor(rng.uniform(0.0, 20.0, size=(1, 1000)))
    valid = torch.ones_like(scores, dtype=torch.bool)
    keep, thr = th.histogram_prune(scores, valid, 2000, 0.0, 20.0)
    assert bool(keep.all()) and float(thr[0]) == 20.0
    keep, thr = th.histogram_prune(scores, valid, 100, 0.0, 20.0)
    assert 80 <= int(keep.sum()) <= 120
    assert bool((scores[keep] <= thr[0]).all())
    keep, thr = th.histogram_prune(scores.clamp(max=5.0), valid, 10, 5.0, 5.0)
    assert float(thr[0]) == 5.0
