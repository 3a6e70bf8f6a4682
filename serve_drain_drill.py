#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s ``serve_cluster`` phase on one GPU, and split
each run's SIGTERM drain.

    python3 serve_drain_drill.py [--tree NAME=PATH ...] [--order NAME,NAME,...]

Each run is one process that imports ``chip_smoke`` from the tree that
``--order`` names (``--tree`` maps a name to the root of a checkout; the
default tree ``this`` is the checkout holding this script) and calls its
``serve_cluster_phase``: a ``serve --serve-cluster on`` frontend and three
``backend --device cuda`` workers on card 0, 1024 sessions and a 4096²
mega-board, a SIGKILL in round 2 and a SIGTERM drain in round 3.  Round
1's reference digests come from the batched step on the card
(``_sessions_reference``), not from a ``serve`` phase.  The frontend's
event log goes to ``chiprun_out/drain/<run>-<tree>/`` with every process's
log.  Each run prints one JSON line: its tree, whether the phase passed
(else its error), the drained worker's exit code and its last drain line,
and the drain read from the event log by this tree's
``chip_smoke.drain_split`` (seconds from DRAIN_REQUEST to DRAIN_COMPLETE,
the shard and chunk moves, where their time went).  The last line sums the
drains per tree.  Compare two trees within one call, in an order such as
``a,b,b,a``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "drain"
DRAIN_BOUND_S = 15.0  # half of the worker's 30 s drain bound


def one(tree: Path, logs: Path) -> int:
    """The run itself, in its own process: the named tree's phase, with its
    logs and the frontend's event log under ``logs``."""
    import tempfile

    sys.path.insert(0, str(tree))
    import chip_smoke as smoke

    from akka_game_of_life_tpu_torch import bench

    smoke.OUT = logs
    if not hasattr(smoke, "drain_split"):
        # A tree whose phase logs no events: give its frontend the log.
        smoke.SC_TOML += f'log_events = "{logs}/serve_cluster.events.jsonl"\n'
    card = bench.card()
    single = smoke._sessions_reference(smoke.serve_specs(), smoke.SC_ROUND_EPOCHS)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            smoke.serve_cluster_phase(Path(tmp), card, single)
        except AssertionError as e:
            print(json.dumps({"failed": str(e)[:400]}), flush=True)
            return 1
    return 0


def run(name: str, tree: Path, i: int) -> dict:
    from chip_smoke import drain_split

    logs = OUT / f"{i:02d}-{name}"
    logs.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--one", str(tree), str(logs)],
        cwd=tree, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    (logs / "phase.log").write_text(proc.stdout)
    res: dict = {"run": i, "tree": name, "ok": proc.returncode == 0}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            doc = json.loads(line)
            if doc.get("phase") == "serve_cluster":
                res["rc"] = doc["drain"]["rc"]
                res["round3_s"] = doc["drain"]["round_s"]
                res["card"] = doc["card"]
            elif "failed" in doc:
                res["error"] = doc["failed"]
                m = re.search(r"the drained worker exited (-?\d+)", doc["failed"])
                if m:
                    res["rc"] = int(m.group(1))
    if not res["ok"] and "error" not in res:
        res["error"] = proc.stdout.splitlines()[-1:] or ["no output"]
    worker = logs / "serve_cluster_sw1.log"
    if worker.exists():
        said = [ln for ln in worker.read_text(errors="replace").splitlines()
                if "drain" in ln or "leaving" in ln]
        res["worker_said"] = said[-1:]
    events = logs / "serve_cluster.events.jsonl"
    if events.exists():
        res["drain"] = drain_split(events, "sw1")
        s = res["drain"]["seconds"]
        res["within_bound"] = s is not None and s <= DRAIN_BOUND_S
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--order", default="this")
    ap.add_argument("--one", nargs=2, metavar=("TREE", "LOGS"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(Path(args.one[0]), Path(args.one[1]))
    trees = {"this": ROOT}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    sys.path.insert(0, str(ROOT))
    summary: dict = {}
    for i, name in enumerate(args.order.split(",")):
        res = run(name, trees[name], i)
        print(json.dumps(res), flush=True)
        s = summary.setdefault(name, {"runs": 0, "passed": 0, "rcs": [], "drain_s": []})
        s["runs"] += 1
        s["passed"] += res["ok"]
        s["rcs"].append(res.get("rc"))
        s["drain_s"].append((res.get("drain") or {}).get("seconds"))
    print(json.dumps({"summary": summary}), flush=True)
    return 0 if all(s["passed"] == s["runs"] for s in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
