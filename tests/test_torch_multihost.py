"""The port's multi-host runner (speechrecognition_torch/parallel/multihost.py)
against the JAX package's: the striping, the row combination and the
scaling rows equal JAX's; ``allgather_rows`` at world sizes 1 and 2; two
worker processes over localhost (gloo, on the CPU) score the golden
hypotheses and decode the demo corpus, and the gathered WER equals the
single-process golden numbers.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from speechrecognition_tpu.parallel import multihost as jmh

import torch_parallel_ranks as tpr
from speechrecognition_torch.parallel import multihost as mh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 35, 13117])
def test_host_shard_equals_jax(n, hosts):
    got = [mh.host_shard(n, hosts=hosts, host=h) for h in range(hosts)]
    for h, g in enumerate(got):
        want = jmh.host_shard(n, hosts=hosts, host=h)
        assert g.dtype == want.dtype and np.array_equal(g, want)
    assert np.concatenate(got).tolist() == list(range(n))


def test_combine_and_scaling_rows_equal_jax():
    rows = np.asarray([[3, 50, 2, 10, 30.0, 2.0], [1, 47, 1, 9, 28.0, 2.5]])
    assert mh.combine_rows(rows) == jmh.combine_rows(rows)
    for fn in (mh.combine_rows, jmh.combine_rows):
        assert fn(rows)["decode_seconds"] == 2.5

    def decode(n):
        return {"audio_s_per_s": 10.0 * n, "wer": 1.0}

    assert mh.scaling_rows(decode, [1, 2, 4]) == jmh.scaling_rows(decode, [1, 2, 4])


def test_single_process_defaults():
    assert mh.initialize() is False
    assert mh.num_hosts() == 1 and mh.host_id() == 0
    row = np.asarray([1.0, 2.0, 3.0])
    got = mh.allgather_rows(row)
    assert got.shape == (1, 3) and np.array_equal(got, jmh.allgather_rows(row))


def _run_two_workers(tmp_path, fixtures_dir, extra_args, timeout):
    port = tpr.free_port()
    out = str(tmp_path / "multihost.json")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update({"SPEECH_TPU_COORDINATOR": f"localhost:{port}",
                    "SPEECH_TPU_NUM_PROCS": "2", "SPEECH_TPU_PROC_ID": str(pid),
                    "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "speechrecognition_torch.parallel.multihost",
             "--out", out, "--fixtures", str(fixtures_dir), "--device", "cpu"] + extra_args,
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    with open(out) as f:
        return json.load(f)


def test_two_process_collectives_match_golden(tmp_path, fixtures_dir, demo_recognition):
    """Two real processes over localhost start a gloo group, stripe the
    golden hypotheses, all-gather their rows, and the corpus WER equals the
    golden numbers, as the JAX workers' do."""
    res = _run_two_workers(tmp_path, fixtures_dir,
                           ["--golden-hyps", str(fixtures_dir / "demo_recognition.json")],
                           timeout=120)
    assert res["distributed"] is True
    assert res["num_hosts"] == 2
    assert res["devices"] == 2 and res["local_devices"] == 1
    ref = demo_recognition["corpus"]
    assert abs(res["wer"] - ref["wer"]) < 1e-6
    assert abs(res["ser"] - ref["ser"]) < 1e-6
    # one process's row over the whole corpus, as JAX's
    golden = str(fixtures_dir / "demo_recognition.json")
    assert mh._score_golden_stripe(golden) == jmh._score_golden_stripe(golden)


def test_two_process_decode_matches_golden(tmp_path, fixtures_dir, demo_recognition):
    """Two workers decode their stripes of the demo corpus (f64, on the
    CPU) and the gathered WER equals the golden run's."""
    res = _run_two_workers(tmp_path, fixtures_dir, [], timeout=240)
    assert res["distributed"] is True and res["num_hosts"] == 2
    ref = demo_recognition["corpus"]
    assert abs(res["wer"] - ref["wer"]) < 1e-3
    assert abs(res["ser"] - ref["ser"]) < 1e-3
    assert res["substitutions"] >= 0
