"""Run one cell in sets of runs and report each metric's spread: the tool
behind the bounds in ``BENCHMARK.json``.

    python3 benchmark/spread.py --workload <cell> --seeds 11,12,13,14,15,16 \\
        [--sets 2] [--seconds 30] [--trace 0] [--out DIR]

Every set runs the same seeds in the same order, each run a process of its
own (``benchmark/run.py``), one after another.  For each metric it prints
each set's median and quartile spread ((Q3 - Q1) / median, Python's
``statistics.quantiles(n=4)``), the wider spread and five times it.  Each
run's standard output and error go to ``DIR``; the card's name and power
limit head the report.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark.core.window import quartile_spread  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    except OSError as e:
        return f"nvidia-smi: {e}"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=30)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="spread-runs")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(f"card: {card()}", flush=True)
    sets = []
    for k in range(args.sets):
        lines = []
        for seed in seeds:
            stem = out / f"{args.workload}.set{k}.{seed}.t{args.trace}"
            t = time.perf_counter()
            with open(f"{stem}.out", "w") as o, open(f"{stem}.err", "w") as e:
                rc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", args.workload,
                                     "--seed", str(seed), "--seconds", str(args.seconds),
                                     "--trace", str(args.trace)], stdout=o, stderr=e).returncode
            wall = time.perf_counter() - t
            text = Path(f"{stem}.out").read_text().strip().splitlines()
            line = json.loads(text[-1]) if rc == 0 and text else None
            lines.append(line)
            values = {} if line is None else {m: v["value"] for m, v in line["metrics"].items()}
            print(json.dumps({"set": k, "seed": seed, "rc": rc, "wall_s": round(wall, 1),
                              "correct": None if line is None else line["correct"],
                              "attempted": None if line is None else line["attempted"],
                              "failed": None if line is None else line["failed"],
                              "metrics": values,
                              "device": None if line is None else line["device"],
                              "breakdown": None if line is None else line.get("breakdown")}), flush=True)
        sets.append(lines)
    names = sorted({m for lines in sets for line in lines if line for m in line["metrics"]})
    for m in names:
        per_set = []
        for lines in sets:
            vals = [line["metrics"][m]["value"] for line in lines if line and m in line["metrics"]]
            if len(vals) >= 2:
                per_set.append((statistics.median(vals), quartile_spread(vals), len(vals)))
        if not per_set:
            continue
        widest = max(s for _, s, _ in per_set)
        print(json.dumps({"metric": m, "sets": [{"median": med, "spread": s, "n": n} for med, s, n in per_set],
                          "widest_spread": widest, "five_times": 5 * widest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
