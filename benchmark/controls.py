"""The controls of the cells' checks, run on the card at each cell's own
size: whether the cell's check finds the program wrong when the precision
below the configuration's takes the program's place.

    python3 benchmark/controls.py --workload <name> --seeds <n> [<n> ...] [--seconds <s>] [--fault <name>]

Each seed is one whole run of the cell (set-up, a short window, the check
with the cell's limits), with the driver's ``variant="control"``:
``em_train`` cells train with the program's float32 path in place of df32;
``lvcsr_jobs`` cells put the plain reference's int4 scores where the
program's int8 scores go. With ``--fault <name>`` (``em_train``:
``half_batch``, ``altered_state``) the program runs with that fault planted
under its timed path instead. Prints a JSON line a seed: ``correct`` as the
cell's check decides it, and the numbers it compared. The benchmark's own
runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.harness import core  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("controls: no CUDA device")
    device = torch.device("cuda", 0)
    cell = core.find_cell(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        kw = ({"fault": cell.driver().FAULTS[args.fault]} if args.fault
              else {"variant": "control"})
        res = run.run_cell(cell, seed, args.seconds, False, device,
                           core.SetupClock(time.perf_counter()), **kw)
        print(json.dumps({"workload": cell.name, "fault": args.fault, "seed": seed,
                          "correct": res["correct"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
