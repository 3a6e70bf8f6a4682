#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s node-loss drill on one GPU, and time each run.

    python3 node_loss_drill.py [--tree NAME=PATH ...] [--order NAME,NAME,...]
                               [--delay S] [--limit S]

Each run starts the port's ``frontend`` and two ``backend --device cuda``
processes from the tree that ``--order`` names (``--tree`` maps a name to
the root of a checkout; the default tree ``this`` is the checkout holding
this script), on ``chip_smoke.py``'s 16384² cluster config at its 200 ms
tick, and sends SIGKILL to one backend ``--delay`` seconds after the
epoch-30 checkpoint is final.  A frontend that has not exited ``--limit``
seconds after the kill counts as hung: every child gets SIGABRT first, so
its thread stacks land in its log under ``chiprun_out/drill/``.  Each run
prints one JSON line: its tree, the frontend's exit code (or ``"hang"``),
seconds from the frontend's start to its listen line, the workers' joins,
each digest line, the final epoch-30 checkpoint, the kill and the exit,
and the digests it printed.  Compare two trees within one call, in an
order such as ``a,b,b,a``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from chip_smoke import CLUSTER_TICK, CLUSTER_TOML  # noqa: E402

OUT = ROOT / "chiprun_out" / "drill"
_DIGEST = re.compile(r"epoch (\d+): digest=([0-9a-f]{16})")


def drill(name: str, tree: Path, i: int, tmp: Path, delay: float, limit: float) -> dict:
    logs = OUT / f"{i:02d}-{name}"
    logs.mkdir(parents=True, exist_ok=True)
    toml = tmp / "cluster-16384.toml"
    toml.write_text(CLUSTER_TOML)
    ckpt = tmp / f"ckpt-{i}"
    env = {**os.environ, "PYTHONPATH": str(tree), "PYTHONFAULTHANDLER": "1"}
    t0 = time.monotonic()
    res: dict = {"run": i, "tree": name, "digests": {}}
    listening = threading.Event()

    def since() -> float:
        return round(time.monotonic() - t0, 2)

    def read(proc, log_name: str) -> None:
        with open(logs / f"{log_name}.log", "w") as log:
            for line in proc.stdout:
                log.write(line)
                m = _DIGEST.match(line)
                if m:
                    res["digests"][int(m.group(1))] = m.group(2)
                    res[f"digest{m.group(1)}_s"] = since()
                elif "frontend listening on" in line:
                    res["port"] = re.search(r":(\d+)", line).group(1)
                    res["listen_s"] = since()
                    listening.set()
                elif log_name == "frontend" and " joined " in line:
                    res.setdefault("joins_s", []).append(since())

    def spawn(args, log_name: str):
        proc = subprocess.Popen(
            [sys.executable, "-m", "akka_game_of_life_tpu_torch", *args],
            cwd=tree, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        threading.Thread(target=read, args=(proc, log_name), daemon=True).start()
        return proc

    procs = []
    try:
        fe = spawn(["frontend", "--config", str(toml), "--port", "0", "--min-backends", "2",
                    "--wait-for-backends", "240s", "--tick", CLUSTER_TICK,
                    "--checkpoint-dir", str(ckpt), "--flight-dir", str(logs / "flight")],
                   "frontend")
        procs.append(fe)
        if not listening.wait(120):
            raise TimeoutError("the frontend did not listen")
        for b in range(2):
            procs.append(spawn(["backend", "--port", res["port"], "--name", f"gpu{b}",
                                "--device", "cuda", "--flight-dir", str(logs / "flight")],
                               f"backend{b}"))
        marker = ckpt / f"ckpt_{30:012d}.d" / "COMPLETE.json"
        while not marker.exists():
            if time.monotonic() - t0 > 240 or fe.poll() is not None:
                raise TimeoutError("no epoch-30 checkpoint")
            time.sleep(0.05)
        res["checkpoint30_s"] = since()
        time.sleep(delay)
        procs[1].send_signal(signal.SIGKILL)
        res["kill_s"] = since()
        try:
            res["rc"] = fe.wait(timeout=limit)
            res["exit_s"] = since()
        except subprocess.TimeoutExpired:
            res["rc"] = "hang"
    except Exception as e:  # noqa: BLE001 — reported in the run's line
        res["error"] = repr(e)
    finally:
        stuck = [p for p in procs if p.poll() is None]
        for p in stuck:
            p.send_signal(signal.SIGABRT)
        for p in procs:
            try:
                p.wait(timeout=5 if p in stuck else 30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--order", default="this")
    ap.add_argument("--delay", type=float, default=0.0)
    ap.add_argument("--limit", type=float, default=120.0)
    args = ap.parse_args()
    trees = {"this": ROOT}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        trees[name] = Path(path).resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    hung = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(args.order.split(",")):
            res = drill(name, trees[name], i, Path(tmp), args.delay, args.limit)
            hung += res.get("rc") != 0
            print(json.dumps(res), flush=True)
    return 1 if hung else 0


if __name__ == "__main__":
    sys.exit(main())
