"""What the harness and the references load: never JAX or the JAX package
(compared by whole top-level names); the references nothing of the
program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "speechrecognition_tpu")

RUN_TINY = """
import sys, time, torch
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.harness import core
cell = core.find_cell(core.BENCH.parent, "an4-decode-linear-q8")
cell.mix.update(utterances=3, length_max=120, length_mean=100, jobs=2, checked_jobs=1, min_steps=2)
res = run.run_cell(cell, 7, 0.0, False, torch.device("cpu"), core.SetupClock(time.perf_counter()))
assert res is not None and res["correct"], res
for p in sorted((core.BENCH / "drivers").glob("*.py")):
    core.load_module(p)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

RUN_REFERENCES = """
import sys, json
import numpy as np
sys.path.insert(0, {root!r})
from benchmark.harness import core, traffic, mixfile
for name, mixname in (("sietill-gmm", "sietill-train-corpus"), ("an4-lvcsr", "an4-decode-jobs")):
    cdir = core.BENCH / "configs" / name
    cfg = json.loads((cdir / "config.json").read_text())
    mix = json.loads((core.BENCH / "traffic" / (mixname + ".json")).read_text())
    mix.update(utterances=2, length_max=100, length_mean=90)
    model = mixfile.read_model(str(cdir / cfg["model_file"]), cfg["dim"], cfg["pooling"])
    lex = traffic.lexicon_from_config(cfg["lexicon"], model)
    c = traffic.draw_corpus(3, mix, lex, model, "cpu")
    ref = core.load_module(cdir / "reference.py")
    if hasattr(ref, "decode"):
        ref.decode(cfg, str(cdir / cfg["model_file"]), c.features, c.offsets, "cpu")
    else:
        ref.train(cfg, str(cdir / cfg["model_file"]), c.features, c.offsets, c.words, "cpu", 1)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level_modules(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level_modules(RUN_TINY)
    assert "speechrecognition_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_references_load_nothing_of_the_program():
    mods = _top_level_modules(RUN_REFERENCES)
    assert not mods & set(FORBIDDEN + ("speechrecognition_torch",))
