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
the shard and chunk moves, where their time went), with the chunk rounds
and the longest hold of the mega-board's steplock (a log without
``hold_s`` gives its longest round's export + certify + adopt).  The
mega-board's step requests are timed from the client by this script for
either tree (it wraps the phase's ``_http``): round 1 its rounds alone, 2
the kill, 3 the drain; each run gives round 1's and round 3's longest, and
where round 3's longest lay against the drain (seconds after its
DRAIN_REQUEST, seconds of chunk-round holds inside it, whether a shard move
committed after it began).  The last line sums the drains per tree.  Compare two trees within one call, in
an order such as ``a,b,b,a``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "drain"
DRAIN_BOUND_S = 15.0  # half of the worker's 30 s drain bound


def time_mega(smoke) -> dict:
    """Time each step request of the phase's mega-board from the client,
    by traffic round, whatever the tree: wraps the module's ``_http`` (the
    phase's requests) and ``_traffic_round`` (rounds 2 and 3 start there).
    Returns the lists it fills, by round: [start, seconds] a request, the
    start on the monotonic clock the frontend's event log reads."""
    seen = {"round": 1, "sid": None}
    out = {"round1": [], "round2": [], "round3": []}
    http, traffic_round = smoke._http, smoke._traffic_round

    def timed_http(base, method, path, doc=None, *args, **kwargs):
        t_mono, t0 = time.monotonic(), time.perf_counter()
        status, got = http(base, method, path, doc, *args, **kwargs)
        if method == "POST" and path == "/boards" and (doc or {}).get("height") == smoke.SC_MEGA_SIDE:
            seen["sid"] = got.get("id")
        elif method == "POST" and seen["sid"] and path == f"/boards/{seen['sid']}/step":
            out[f"round{seen['round']}"].append([t_mono, time.perf_counter() - t0])
        return status, got

    def counted_round(*args, **kwargs):
        seen["round"] += 1
        return traffic_round(*args, **kwargs)

    smoke._http, smoke._traffic_round = timed_http, counted_round
    return out


def one(tree: Path, logs: Path) -> int:
    """The run itself, in its own process: the named tree's phase, with its
    logs and the frontend's event log under ``logs``."""
    import tempfile

    sys.path.insert(0, str(tree))
    import chip_smoke as smoke

    from akka_game_of_life_tpu_torch import bench

    smoke.OUT = logs
    mega_s = time_mega(smoke)
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
        finally:
            print(json.dumps({"mega_s": mega_s}), flush=True)
    return 0


def longest_hold(chunk: dict):
    """The longest hold of the steplock by a chunk round, and whence."""
    if "hold_s" in chunk.get("max_s", {}):
        return chunk["max_s"]["hold_s"], "hold_s"
    longest = chunk.get("longest")
    if not longest:
        return None, None
    return sum(longest.get(k, 0.0) for k in ("export_s", "certify_s", "adopt_s")), "phases"


def slowest_in_drain(events: Path, member: str, requests) -> dict:
    """Where the slowest of ``requests`` ([start, seconds]) lay against the
    drain of ``member`` in the event log: its start after DRAIN_REQUEST,
    the seconds of chunk-round holds inside it (a round's event is logged
    as its hold ends), and whether a shard move committed after it began."""
    rows = [json.loads(line) for line in events.read_text().splitlines() if line.strip()]
    t0 = next((r["t_mono"] for r in rows if r["event"] == "drain_requested"
               and r.get("member") == member), None)
    if t0 is None or not requests:
        return {}
    start, seconds = max(requests, key=lambda r: r[1])
    ends = {}  # a round's chunks share its split: its first event ends its hold
    for r in rows:
        if (r["event"] == "serve_tiled_chunk_migrated" and r.get("source") == member
                and "hold_s" in r and r["t_mono"] >= t0):
            key = tuple(r.get(k) for k in ("hold_s", "lock_wait_s", "export_s", "certify_s",
                                            "adopt_s", "seconds"))
            ends[key] = min(ends.get(key, r["t_mono"]), r["t_mono"])
    held = sum(max(0.0, min(end, start + seconds) - max(end - key[0], start))
               for key, end in ends.items())
    shards_end = max((r["t_mono"] for r in rows if r["event"] == "serve_shard_migrated"
                      and r.get("source") == member and r["t_mono"] >= t0), default=t0)
    return {"at_s": start - t0, "s": seconds, "held_s": held,
            "shard_moves_open": start < shards_end}


def run(name: str, tree: Path, i: int) -> dict:
    from chip_smoke import drain_split, spread

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
            elif "mega_s" in doc:
                mega_s = doc["mega_s"]
                res["mega_requests"] = {r: spread([s for _, s in xs]) for r, xs in mega_s.items()}
                for r in ("round1", "round3"):
                    res[f"mega_{r}_max_s"] = res["mega_requests"][r]["max_s"]
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
        chunk = res["drain"]["chunk"]
        res["chunk_rounds"] = chunk["rounds"]
        res["hold_max_s"], res["hold_from"] = longest_hold(chunk)
        if "mega_requests" in res:
            res["mega_round3_slowest"] = slowest_in_drain(events, "sw1", mega_s["round3"])
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
        s = summary.setdefault(name, {"runs": 0, "passed": 0, "rcs": [], "drain_s": [],
                                      "chunk_rounds": [], "hold_max_s": [],
                                      "mega_round1_max_s": [], "mega_round3_max_s": []})
        s["runs"] += 1
        s["passed"] += res["ok"]
        s["rcs"].append(res.get("rc"))
        s["drain_s"].append((res.get("drain") or {}).get("seconds"))
        for k in ("chunk_rounds", "hold_max_s", "mega_round1_max_s", "mega_round3_max_s"):
            s[k].append(res.get(k))
    print(json.dumps({"summary": summary}), flush=True)
    return 0 if all(s["passed"] == s["runs"] for s in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
