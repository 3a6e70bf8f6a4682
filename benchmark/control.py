"""Run a cell's control: the plain reference with one guarantee the
configuration states broken (the torus: cells past the edges read dead),
put in the program's place, through the cell's own comparison.  Its
numbers set the upper reading of each limit (PERF.md); the benchmark's
runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

Prints one JSON line per seed: each number compared, its limit, and
whether ``correct`` came out (it has to come out false).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.core import spec  # noqa: E402
from benchmark.core.harness import Run  # noqa: E402


def control(cell, seed: int, device: str, run_seconds: float):
    run = Run(cell, seed, run_seconds, False, device, time.perf_counter())
    driver = cell.driver()
    if cell.mix["driver"] == "serve_clients":
        return driver.control(run, run_seconds)
    return driver.control(run)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    cell = spec.load_cell(args.workload)
    run_seconds = json.loads((spec.ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        checks = control(cell, seed, args.device, run_seconds)
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds": time.perf_counter() - t,
                          "correct": all(c.ok for c in checks),
                          "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
