"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernel library, the model,
the seeded traffic, the warm-up) runs first and counts as ``setup_s``; then
the cell's driver runs whole steps until ``--seconds`` have passed; then the
program's outputs of the window are checked against the configuration's plain
reference. The last line of standard output is the result, as JSON; the
numbers compared, each beside its limit, are the last lines of standard
error. With ``--trace 1`` the window runs under ``torch.profiler`` and the
result carries the per-layer metrics in place of the end-to-end ones.

Exits non-zero, printing no result, without enough CUDA devices, or when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

from benchmark.harness import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = core.find_cell(ROOT, args.workload)

    clock = core.SetupClock(T_START)
    with clock.part("import"):
        import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        core.log(f"run: {cell.name} needs {cell.chips} CUDA device(s); "
                 f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, clock)
    if result is None:
        return 4
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device, clock, **variant):
    """Set up, measure, check: the result's dict, or None where a forbidden
    module is loaded once all of that is done. ``variant`` goes to the
    driver's set-up (the controls of ``benchmark/controls.py``)."""
    import torch
    driver = cell.driver()
    state = driver.setup(cell, seed, device, clock, **variant)
    setup_s = time.perf_counter() - clock.t_start
    # seconds the kernel library took to build in this run (0.0 when it was
    # loaded from the checkout's cache); part of ``setup_s`` as well
    build_s = getattr(sys.modules.get("speechrecognition_torch.ops._native"), "build_seconds", 0.0)
    core.log(f"set-up {setup_s:.3f} s (of it the kernel build {build_s:.3f} s): "
             + ", ".join(f"{k} {v:.3f}" for k, v in clock.parts.items()))

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    with torch.profiler.record_function(core.WINDOW_SPAN):
        records, window_s = core.window(driver.step, state, seconds,
                                        cell.mix.get("min_steps", 1))
    if on_card:
        torch.cuda.synchronize(device)
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
        from benchmark.harness.trace import reduce_profile
        tr = reduce_profile(prof)
        prof = None
    mem_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    run = core.Run(cell=cell, setup_s=setup_s, steps=records, window_s=window_s,
                   work=driver.work(state, records), trace=tr,
                   rooflines=core.rooflines())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = core.load_module(core.BENCH / "metrics" / f"{m['name']}.py").read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    checks, attempted, failed = driver.check(state, records)
    correct, compared = core.compare(checks, cell.limits["limits"])
    core.log(f"correct: {correct}")
    for name, c in compared.items():
        core.log(f"check {name}: {c['value']} (limit {c['limit']})")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev, "setup_parts": clock.parts,
              "setup_build_s": build_s}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = compared
    found = core.forbidden_modules()
    if found:
        core.log(f"run: modules loaded that the port may not load: {', '.join(found)}")
        return None
    return result


if __name__ == "__main__":
    sys.exit(main())
