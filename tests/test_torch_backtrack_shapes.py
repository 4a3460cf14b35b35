"""align_backtrack (kernel G's wrapper; on CPU tensors its plain version)
against the JAX package's ``_final_pos_dev`` + ``_align_bwd_chunk`` +
``_states_from_positions``, on seeded inputs that no DP produced, at the
shapes kernel G must take: Tp 1, 300 and 2,000 frames, A 1, 70 and 1,025
positions, feat_len 0, 1 and Tp, T 0, Tp - 7 and Tp, both final-position
rules, all-BIG final rows, and walks that run below position -A
(tests/torch_df_tables.py builds the cases; tests/test_torch_cuda.py holds
the kernel against the plain version on the same cases).

Where a walk's position is still outside the row after one wrap (below -A),
JAX's gathers fill (the jump with INT_MIN, so its position overflows), and
the port clamps the index to the row, as align_backtrack's contract says.
There the port is held against JAX on every frame walked before the first
such index, and everywhere against a numpy loop of the contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import speechrecognition_tpu.align.viterbi as jvit

import speechrecognition_torch.align.viterbi as tvit
from torch_df_tables import BACKTRACK_CASES, backtrack_frames, backtrack_inputs

torch.set_num_threads(1)


def contract_walk(final_hi, aut_len, jumps, feat_len, states_tbl, T, tie_pruned):
    """align_backtrack's contract as a plain loop: (states [B, T], final
    positions [B], and per utterance the highest frame whose index was
    clamped, or -1)."""
    Tp, B, A = jumps.shape
    if tie_pruned:
        finite = final_hi < np.float32(5e29)
        fp = np.array([np.flatnonzero(r).max() if r.any() else 0 for r in finite])
    else:
        fp = aut_len.astype(np.int64) - 1
    states = np.zeros((B, T), np.int32)
    clamped = np.full(B, -1)
    for b in range(B):
        cur = int(fp[b])
        for t in range(Tp - 1, -1, -1):
            idx = cur + A if cur < 0 else cur
            if not 0 <= idx < A:
                clamped[b] = max(clamped[b], t)
                idx = min(max(idx, 0), A - 1)
            if t < T:
                states[b, t] = states_tbl[b, idx]
            if t == 0:
                break
            cur = cur - int(jumps[t, b, idx]) if t <= feat_len[b] - 1 else int(fp[b])
    return states, fp.astype(np.int32), clamped


@pytest.mark.parametrize("Tp,A,jumps,tie_pruned,T", BACKTRACK_CASES)
def test_backtrack_equals_jax(Tp, A, jumps, tie_pruned, T):
    final_hi, aut_len, jmp, lens, tbl = backtrack_inputs(Tp, A, jumps, seed=Tp + A)
    T = backtrack_frames(Tp, T)
    states, fp = tvit.align_backtrack(torch.as_tensor(final_hi), torch.as_tensor(aut_len),
                                      torch.as_tensor(jmp), torch.as_tensor(lens),
                                      torch.as_tensor(tbl), T, tie_pruned=tie_pruned)
    assert states.dtype == fp.dtype == torch.int32 and tuple(states.shape) == (len(lens), T)
    want, want_fp, clamped = contract_walk(final_hi, aut_len, jmp, lens, tbl, T, tie_pruned)
    np.testing.assert_array_equal(fp.numpy(), want_fp)
    np.testing.assert_array_equal(states.numpy(), want)

    jfp = jvit._final_pos_dev(jnp.asarray(final_hi), jnp.asarray(aut_len),
                              tie_pruned=tie_pruned)
    _cur, pos = jvit._align_bwd_chunk(jfp, jnp.asarray(jmp), jnp.asarray(lens), jfp,
                                      jnp.asarray(0, jnp.int32))
    jstates = np.asarray(jvit._states_from_positions(pos[:T], jnp.asarray(tbl)))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
    for b in range(len(lens)):
        agree = slice(clamped[b] + 1, T)
        np.testing.assert_array_equal(states.numpy()[b, agree],
                                      jstates[b, agree].astype(np.int32), err_msg=f"b={b}")
    if jumps == "dp":
        assert (clamped == -1).all()


def test_random_cases_leave_the_row():
    """Some "random" cases reach the clamp (a walk below -A), under both
    final-position rules, and no "dp" case does; the pruned rule meets an
    all-BIG row (final position 0)."""
    reached = set()
    for Tp, A, jumps, tie, T in BACKTRACK_CASES:
        final_hi, aut_len, jmp, lens, tbl = backtrack_inputs(Tp, A, jumps, seed=Tp + A)
        _s, fp, clamped = contract_walk(final_hi, aut_len, jmp, lens, tbl, 0, tie)
        if (clamped >= 0).any():
            reached.add((jumps, tie))
        assert not (final_hi[1] < 5e29).any() and (not tie or fp[1] == 0)
    assert reached == {("random", True), ("random", False)}
