"""tree_scan (kernel I's wrapper; on CPU tensors its plain version) against
the JAX package's ``_tree_scan`` at the edges of kernel I's owner instance
and just past them: N in {2, 31, 32, 33, 212, 224, 225, 1,024, 1,025} nodes
(a warp's edges; SieTill's 212; 7 warps full and one node past them; the
owner instance's limit and one node past it, where the block instance
takes over), float32 and float64, pruned and not. The trees are built
directly as arrays from a seed (tests/torch_search_tables.py::random_tree):
chains and branches, word ends at leaves and inside the tree, and
homophones (sibling copies that end two words and always tie, so the first
node must win). Utterances of T, 1, 0 and T - 3 frames, so that frozen
frames are written too. The tie cases run integer scores with zero TDPs
and exit penalties of 0 or 1, so skip, forward and loop tie (the larger
jump wins) and end nodes tie (the first wins). Every output is bit-equal.
tests/test_torch_cuda.py holds the kernel's two instances against the plain
version at the same edges.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.search.tree_decoder as jtree

import speechrecognition_torch.search.tree_decoder as ttree
from torch_search_tables import random_tree, tree_scores

torch.set_num_threads(1)

B, T = 4, 12
LENS = np.array([T, 1, 0, T - 3], np.int32)
#: node counts at and just past the owner instance's edges
SIZES = [2, 31, 32, 33, 212, 224, 225, 1024, 1025]
JDT = {"float32": jnp.float32, "float64": jnp.float64}
FIELDS = ("state", "parent", "grand", "depth", "tdp", "loop_allowed", "end_word",
          "exit_penalty")


def case_inputs(N, ties):
    """The tree, its scores [B, T, S] (float64) and the threshold."""
    tree = random_tree(N, seed=N + 1000 * ties, ties=ties)
    return tree, tree_scores(B, T, seed=N + 7, ties=ties), 4.0 if ties else 45.0


CASES = ([(N, dt, prune, False) for N in SIZES for dt in ("float32", "float64")
          for prune in (True, False)]
         + [(N, dt, True, True) for N in (33, 212, 225, 1025) for dt in ("float32", "float64")])


@pytest.mark.parametrize("N,dtype,prune,ties", CASES)
def test_tree_scan_equals_jax_at_the_owner_edges(N, dtype, prune, ties):
    tree, am, thr = case_inputs(N, ties)
    td = getattr(torch, dtype)
    am = am.to(td)
    got = ttree.tree_scan(am, torch.from_numpy(LENS), *tree.device_args("cpu", td, am.shape[2]),
                          thr, prune=prune)
    jd = JDT[dtype]
    want = jtree._tree_scan(jnp.asarray(am.numpy()), jnp.asarray(LENS),
                            *(jnp.asarray(getattr(tree, f)) for f in FIELDS),
                            jnp.asarray(thr, jd), prune=prune)
    assert len(got) == len(want) == 3
    for name, g, w in zip(("score", "word", "bkp"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape == (T, B), name
        assert g.tobytes() == w.tobytes(), name
    score, word = got[0].numpy(), got[1].numpy()
    assert score.dtype == np.dtype(dtype)
    # a live word end on the longest utterance, and frames written past the
    # empty one's end
    assert (score[:, 0] < 1e29).any() and (word[:, 0] >= 0).any()
    if ties:
        # homophones tie at every frame: the first of each pair wins, the
        # second never ends a frame
        copies = [n for n in range(5, N) if n % 9 == 5]
        assert not np.isin(word, tree.end_word[copies]).any()
        assert np.isin(word, tree.end_word[[n - 1 for n in copies]]).any()
