"""The port's df32 EM trainer end to end on the CPU (plain versions of
kernels C, F, G and H), against the C++ trainer's outputs and the JAX
package's df32 Trainer on the same corpus: the ten AM-score lines within
1e-4, the alignment dumps bit-equal to tests/fixtures/demo_alignments/,
iter-lin.mix exact in counts, iter-2.mix within rtol 1e-9 / atol 1e-7, and
the JAX trainer's stats lines (as strings) and alignment."""

import numpy as np
import pytest

from test_torch_train import (FIX, ORACLE_AM_SCORES, assert_alignments, assert_mix,
                              assert_trajectory, train)


@pytest.fixture(scope="module")
def df32_runs(tmp_path_factory):
    out, jout = tmp_path_factory.mktemp("torch_df32"), tmp_path_factory.mktemp("jax_df32")
    trainer, alignment = train("torch", out, "df32")
    jtrainer, jalignment = train("jax", jout, "df32")
    return trainer, alignment, out, jtrainer, jalignment


def test_df32_trajectory_matches_oracle(df32_runs):
    assert_trajectory(df32_runs[0].stats_lines, ORACLE_AM_SCORES)


def test_df32_alignments_match_oracle(df32_runs):
    assert_alignments(df32_runs[2], FIX / "demo_alignments",
                      [f"alignment-{i}-0.dump" for i in range(3)])


def test_df32_mixtures_match_oracle(df32_runs):
    out = df32_runs[2]
    assert_mix(out, FIX / "iter-lin.mix", "iter-lin.mix", True, rtol=1e-12, atol=1e-9)
    assert_mix(out, FIX / "iter-2.mix", "iter-2.mix", True, rtol=1e-9, atol=1e-7)


def test_df32_equals_jax_trainer(df32_runs):
    trainer, alignment, _out, jtrainer, jalignment = df32_runs
    assert trainer.stats_lines == jtrainer.stats_lines
    np.testing.assert_array_equal(alignment, jalignment)
