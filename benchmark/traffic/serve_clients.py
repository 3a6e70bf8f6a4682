"""Driver of the serve plane: ``run_serve`` (what ``python -m
akka_game_of_life_tpu_torch serve`` runs) in this process, its clients in
another (``serve_load.py``), over HTTP on localhost.

Set-up: the server starts; the mix's sessions are created through ``POST
/boards`` (each board made by the server from its seed); every session is
stepped ``warm_rounds`` times, which runs the batched step at the mix's
class and length.  The window: each session's steps of ``steps``
generations fall due on a fixed open-loop schedule, ``rate_per_s`` in
all, from the window's start to its end; replies are awaited up to
``drain_seconds`` past it.  The server runs in the main thread (it stops
on SIGINT and drains, as the CLI's does); this driver's own thread drives
the rest.

End to end: ``serve_cell_updates_per_s``, h * w * steps of every step due
in the window and answered 200, over the seconds from the window's start
until the last of them was answered (so no step is cut in two at the
close).  The latencies' median, 95th and 99th percentiles, from each
step's due time, go to standard error.

What ``correct`` compares, once the server is closed: for a sample of
``reference_sessions`` sessions drawn from ``--seed``, every answered
step's epoch and digest, and each board read back with ``GET`` after the
window, against the plain reference stepping the same seeded boards.
Steps that never got an answer are counted too.
"""

from __future__ import annotations

import base64
import concurrent.futures
import contextlib
import http.client
import json
import math
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.core import window
from benchmark.core.harness import Check, Outcome, Readings, Run
from benchmark.core.trace import Tracer

LOAD = Path(__file__).with_name("serve_load.py")
READY_SECONDS = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(port: int, method: str, path: str, doc=None, timeout: float = 120.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = None if doc is None else json.dumps(doc)
        conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def sessions(run: Run) -> list:
    """(index, rule, seed, tenant) of each session of the mix."""
    mix = run.cell.mix
    n = mix["sessions"]
    return [(i, mix["rules"][i % len(mix["rules"])], run.seed * n + i, f"t{i % mix['tenants']}")
            for i in range(n)]


def _sample(run: Run) -> list:
    """The sessions the reference follows, drawn from the seed."""
    n = run.cell.mix["sessions"]
    k = min(run.cell.mix["reference_sessions"], n)
    return sorted(np.random.default_rng(run.seed).choice(n, size=k, replace=False).tolist())


def _snapshot(registry) -> tuple:
    from akka_game_of_life_tpu_torch.obs.programs import get_programs

    programs = {(p["family"], p["key"]): {"calls": p["calls"], "seconds": p["seconds"]}
                for p in get_programs().snapshot()["programs"]}
    return registry.snapshot(nonzero_only=False), programs


class _Orchestra:
    """The driver's thread: everything but the server."""

    def __init__(self, run: Run, port: int, registry) -> None:
        self.run, self.port, self.registry = run, port, registry
        self.over = threading.Event()
        self.lock = threading.Lock()
        self.error = None
        self.out: dict = {}

    def stop_server(self) -> None:
        with self.lock:
            if not self.over.is_set():
                signal.pthread_kill(threading.main_thread().ident, signal.SIGINT)

    def main(self) -> None:
        try:
            self._drive()
        except BaseException as e:  # noqa: BLE001 -- re-raised in the main thread
            self.error = e
        finally:
            self.stop_server()

    def _wait_ready(self) -> None:
        deadline = time.monotonic() + READY_SECONDS
        while not self.over.is_set() and time.monotonic() < deadline:
            with contextlib.suppress(OSError):
                if _http(self.port, "GET", "/healthz", timeout=5)[0] == 200:
                    return
            time.sleep(0.05)
        raise RuntimeError("the server did not come up")

    def _drive(self) -> None:
        run, mix = self.run, self.run.cell.mix
        load = subprocess.Popen([sys.executable, str(LOAD)], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True)
        try:
            self._wait_ready()
            specs = sessions(run)
            with concurrent.futures.ThreadPoolExecutor(16) as pool:
                created = list(pool.map(lambda s: _http(self.port, "POST", "/boards", {
                    "tenant": s[3], "rule": s[1], "height": mix["height"], "width": mix["width"],
                    "seed": s[2], "density": mix["density"]}), specs))
            for status, doc in created:
                if status != 201:
                    raise RuntimeError(f"create: {status} {doc}")
            sids = [doc["id"] for _, doc in created]
            load.stdin.write(json.dumps({
                "port": self.port, "sids": sids, "steps": mix["steps"],
                "warm_rounds": mix["warm_rounds"], "timeout": mix["request_timeout_seconds"],
                "rate_per_s": mix["rate_per_s"],
            }) + "\n")
            load.stdin.flush()
            if load.stdout.readline().strip() != "warm":
                raise RuntimeError("the clients did not warm up")
            if torch.device(run.device).type == "cuda":
                torch.cuda.synchronize()
            tracer = Tracer() if run.trace else None
            before = _snapshot(self.registry)
            t0 = time.monotonic() + 0.02
            t1 = t0 + run.seconds
            load.stdin.write(json.dumps({"start": t0, "end": t1,
                                         "deadline": t1 + mix["drain_seconds"]}) + "\n")
            load.stdin.flush()
            self.out["setup_s"] = time.perf_counter() + (t0 - time.monotonic()) - run.started
            # A traced run traces the window's last trace_seconds, for as
            # long from the profiler's start; the counters are read over
            # the part before, which the profiler does not slow.
            t_counted = t1 - (min(mix["trace_seconds"], run.seconds / 2) if tracer else 0.0)
            time.sleep(max(0.0, t_counted - time.monotonic()))
            after = _snapshot(self.registry)
            if tracer:
                tracer.start()
                time.sleep(t1 - t_counted)
                tracer.stop()
            self.out["memory_peak_bytes"] = (
                torch.cuda.max_memory_allocated() if torch.device(run.device).type == "cuda" else 0)
            stdout, _ = load.communicate(timeout=mix["drain_seconds"] + mix["request_timeout_seconds"])
            records = json.loads(stdout.strip().splitlines()[-1])
            sample = _sample(run)
            with concurrent.futures.ThreadPoolExecutor(16) as pool:
                gets = dict(zip(sample, pool.map(
                    lambda i: _http(self.port, "GET", f"/boards/{sids[i]}"), sample)))
            self.out.update(t0=t0, t1=t1, t_counted=t_counted, tracer=tracer, before=before, after=after,
                            records=records, sample=sample, gets=gets, specs=specs)
        finally:
            if load.poll() is None:
                load.kill()
            load.wait()


def run(run: Run) -> Outcome:
    from akka_game_of_life_tpu_torch.obs import get_registry
    from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
    from akka_game_of_life_tpu_torch.serve.api import run_serve

    port = _free_port()
    cfg = SimulationConfig(**run.cell.config["run"], metrics_port=port)
    registry = get_registry()
    orchestra = _Orchestra(run, port, registry)
    driver = threading.Thread(target=orchestra.main, name="bench-driver", daemon=True)
    driver.start()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            run_serve(cfg, registry=registry, device=run.device)
    except KeyboardInterrupt:
        pass  # the SIGINT that stops the server outside its own handler
    finally:
        with orchestra.lock:
            orchestra.over.set()
    driver.join()
    if orchestra.error is not None:
        raise orchestra.error
    out = orchestra.out
    out["trace"] = out["tracer"].summary() if out["tracer"] else None
    return _outcome(run, out)


def _outcome(run: Run, out: dict) -> Outcome:
    mix = run.cell.mix
    t0, t1 = out["t0"], out["t1"]
    due = [r for r in out["records"] if not r[6] and t0 <= r[1] < t1]
    ok = [r for r in due if r[3] == 200]
    # The window's work is every step due in it; its time runs until the
    # last of them was answered, so no step is cut in two at the close.
    end = max([t1] + [r[2] for r in ok])
    latencies = [1e3 * (r[2] - r[1]) if r[3] == 200 else math.inf for r in due]
    readings = Readings(
        config=run.cell.config, mix=mix, window=(t0, out["t_counted"]), trace=out["trace"],
        registry=(out["before"][0], out["after"][0]),
        programs=(out["before"][1], out["after"][1]), spans=run.spans,
    )
    t = time.perf_counter()
    checks = compare(run, out)
    reference_s = time.perf_counter() - t
    return Outcome(
        setup_s=out["setup_s"],
        values={
            "serve_cell_updates_per_s": window.rate(mix["height"] * mix["width"] * mix["steps"] * len(ok), end - t0),
        },
        readings=readings,
        attempted=len(due),
        failed=len(due) - len(ok),
        checks=checks,
        memory_peak_bytes=out["memory_peak_bytes"],
        notes={
            "serve_step requests due in the window": len(due),
            "serve_step answered 200": len(ok),
            "serve_step seconds until the last of them was answered": end - t0,
            **{f"serve_step p{q} ms (a failed step slowest)": window.percentile(latencies, q)
               for q in (50, 95, 99) if latencies},
            "generator's latest send after due, ms": 1e3 * max((r[7] - r[1] for r in due), default=0.0),
            "reference seconds": reference_s,
        },
    )


def control(run: Run, run_seconds: float) -> list:
    """The comparison with the control in the server's place: the
    reference with the torus broken (cells past the edges dead) answers
    each sampled session's steps, as many as a run of ``run_seconds``
    answers, and its boards stand for those read back."""
    ref = run.cell.reference()
    mix = run.cell.mix
    specs, sample = sessions(run), _sample(run)
    answers = mix["warm_rounds"] + round(mix["rate_per_s"] * run_seconds / mix["sessions"])
    boards = torch.from_numpy(np.stack([
        ref.random_grid(mix["height"], mix["width"], mix["density"], specs[i][2]) for i in sample
    ])).to(torch.device(run.device))
    rules = [specs[i][1] for i in sample]
    records = []
    for k in range(1, answers + 1):
        boards = ref.run(boards, mix["steps"], rules, torus=False)
        for i, d in zip(sample, ref.digest(boards)):
            records.append([i, 0.0, 0.0, 200, k * mix["steps"], f"{int(d):016x}", False, 0.0])
    cells = boards.cpu().numpy()
    gets = {i: (200, {"epoch": answers * mix["steps"], "height": mix["height"], "width": mix["width"],
                      "board_b64": base64.b64encode(cells[j].tobytes()).decode("ascii")})
            for j, i in enumerate(sample)}
    return compare(run, {"records": records, "gets": gets, "sample": sample, "specs": specs})


def compare(run: Run, out: dict) -> list:
    """Every answer of the sampled sessions and their boards read back,
    against the reference; limits 0."""
    ref = run.cell.reference()
    mix = run.cell.mix
    steps = mix["steps"]
    sample, specs = out["sample"], out["specs"]
    pos = {i: j for j, i in enumerate(sample)}
    answers = [r for r in out["records"] if r[0] in pos]
    unanswered = sum(1 for r in answers if r[3] is None)
    # Each session's answered epochs are steps, 2 steps, ...: one step
    # request each, none lost and none applied twice.
    epochs = {i: sorted(r[4] for r in answers if r[0] == i and r[3] == 200) for i in sample}
    epoch_gaps = sum(
        sum(1 for k, e in enumerate(es) if e != steps * (k + 1)) for es in epochs.values())
    got_boards = {}
    for i, (status, doc) in out["gets"].items():
        if status == 200:
            raw = base64.b64decode(doc["board_b64"])
            got_boards[i] = (doc["epoch"], np.frombuffer(raw, np.uint8).reshape(doc["height"], doc["width"]))
    due = [(r[0], r[4], r[5]) for r in answers if r[3] == 200]
    want_epochs = {e for _, e, _ in due} | {e for e, _ in got_boards.values()}
    dev = torch.device(run.device)
    boards = torch.from_numpy(np.stack([
        ref.random_grid(mix["height"], mix["width"], mix["density"], specs[i][2]) for i in sample
    ])).to(dev)
    rules = [specs[i][1] for i in sample]
    digests, cells, epoch = {}, {}, 0
    wanted_cells = {e for e, _ in got_boards.values()}
    for target in sorted(e for e in want_epochs if e is not None and e > 0 and e % steps == 0):
        boards = ref.run(boards, target - epoch, rules)
        epoch = target
        for j, d in enumerate(ref.digest(boards)):
            digests[(sample[j], epoch)] = f"{int(d):016x}"
        if epoch in wanted_cells:
            cells[epoch] = boards.cpu().numpy()
    digest_misses = sum(1 for i, e, d in due if digests.get((i, e)) != d)
    board_misses = 0
    for i, (e, board) in got_boards.items():
        want = cells.get(e)
        board_misses += board.size if want is None else int((want[pos[i]] != board).sum())
    board_misses += sum(mix["height"] * mix["width"] for i in sample if i not in got_boards)
    return [
        Check("unanswered_steps", unanswered, 0),
        Check("epoch_gaps", epoch_gaps, 0),
        Check("digest_mismatches", digest_misses, 0),
        Check("board_mismatch_cells", board_misses, 0),
    ]
