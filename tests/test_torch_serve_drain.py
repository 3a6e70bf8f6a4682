"""The SIGTERM drain of a port serve worker loses no frame.

A worker's SIGTERM becomes a KeyboardInterrupt in its main thread, which
runs the dispatch loop of the control channel.  Raised there, it tore the
loop out between taking a frame from the inbox and dispatching it (or in
the middle of the dispatch): the frame's ops were never run, never
answered, the frontend kept them pending toward the draining worker, so
``member_clear`` never held, DRAIN_COMPLETE never came and the worker left
after its 30 s drain bound with exit code 130.  The loop now takes the
interrupt as a marker queued behind the frames already in, so every frame
it took is dispatched whole.  Each case counts frames or answers; none
bounds a wall clock.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from _torch_serve_cluster import oracle, oracle_digest, serve_cluster, wait_until

ROOT = Path(__file__).resolve().parent.parent
FRAMES = 12
SIGNAL_AT = 5  # the frame whose dispatch the SIGTERM lands in


# The worker's dispatch loop in its own process, under the CLI's SIGTERM
# mapping: twelve frames queued, a SIGTERM sent to the process from inside
# the dispatch of the sixth.  Prints the frames dispatched whole and where
# the interrupt surfaced.
_LOOP = f"""
import os, signal, sys, threading
from akka_game_of_life_tpu_torch import cli
from akka_game_of_life_tpu_torch.runtime.backend import BackendWorker

w = BackendWorker("127.0.0.1", 1, name="w", engine="numpy")
w.channel = object()
w._reader = threading.current_thread()
whole = []

def dispatch(msg):
    if msg["n"] == {SIGNAL_AT}:
        os.kill(os.getpid(), signal.SIGTERM)
    whole.append(msg["n"])

w._dispatch = dispatch
for n in range({FRAMES}):
    w._inbox.put({{"type": "noop", "n": n}})
with cli._sigterm_as_interrupt():
    try:
        w.run()
        print("returned", len(whole))
    except KeyboardInterrupt:
        print("interrupted", len(whole))
"""


def test_sigterm_inside_a_dispatch_lands_after_every_frame_taken():
    """The count the repair restores: of twelve frames in the inbox, all
    twelve are dispatched whole and then the interrupt surfaces; before it,
    the interrupt cut the sixth frame's dispatch and dropped the rest (5)."""
    out = subprocess.run(
        [sys.executable, "-c", _LOOP], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["interrupted", str(FRAMES)], out.stdout


# A port ``backend`` process whose first serve frame after the trigger
# file appears gets the process's SIGTERM inside its dispatch: the race an
# orchestrator's SIGTERM wins whenever it lands while the main thread holds
# a frame (on a busy worker, most of the time).
_WORKER = """
import os, signal, sys
from akka_game_of_life_tpu_torch import cli
from akka_game_of_life_tpu_torch.runtime import protocol as P
from akka_game_of_life_tpu_torch.runtime.backend import BackendWorker

trigger, port = sys.argv[1], sys.argv[2]
plain = BackendWorker._dispatch
fired = []

def dispatch(self, msg):
    if not fired and msg.get("type") == P.SERVE_OPS and os.path.exists(trigger):
        fired.append(1)
        print("sigterm inside a serve frame of", len(msg["ops"]), "op(s)", flush=True)
        os.kill(os.getpid(), signal.SIGTERM)
    return plain(self, msg)

BackendWorker._dispatch = dispatch
sys.exit(cli.main(["backend", "--port", port, "--name", "wd", "--device", "cpu"]))
"""


def _traffic(plane, sids, stop, issued, errors, lock, k):
    i = 0
    while not stop.is_set():
        sid = sids[(k + i) % len(sids)]
        try:
            plane.step(sid, 1)
            with lock:
                issued[sid] += 1
        except Exception as e:  # noqa: BLE001 — asserted by the caller
            with lock:
                errors.append((sid, repr(e)))
        i += 1


def _mega(plane, sid, k, stop, epochs, errors):
    while not stop.is_set():
        try:
            epochs.append(plane.step(sid, k)[0])
        except Exception as e:  # noqa: BLE001 — asserted by the caller
            errors.append(("mega", repr(e)))


def test_sigterm_drain_of_a_loaded_worker_answers_every_op(tmp_path):
    """A three-worker serve cluster (one worker a real ``backend`` process)
    under step traffic on 128 sessions and a resident 128² mega-board; the
    process worker, holding at least 16 loaded shards and resident chunks,
    takes its SIGTERM inside a serve frame.  Every step the clients sent is
    answered (the count of answers equals the count of requests, no error,
    no 404), the worker drains and exits 0, and every board ends on the
    oracle's digest.  Before the repair its frame's ops were never answered
    and it left after the 30 s drain bound with 130.

    The drain's protocol rounds are counted too: the planner starts every
    loaded shard's move in one pass (in flight together: as many as the
    worker's loaded shards; one at a time before), and the chunks leave in
    one export round per destination (one round per chunk before)."""
    cfg = dict(serve_shards=64, serve_size_classes="16,32", serve_replicate_interval_s=0.05,
               serve_tiled_resident_snapshot=2)
    with serve_cluster(2, **cfg) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        trigger = tmp_path / "sigterm-now"
        proc = subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(trigger), str(fe.port)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
        try:
            wait_until(lambda: len(fe.membership.alive_members()) == 3, 120, "wd to join")
            wait_until(lambda: fe._health()["serve"]["shards_by_worker"].get("wd", 0) >= 18,
                       30, "wd's shards")
            sids = [plane.create(height=16, width=16, seed=i, with_board=False)["id"]
                    for i in range(128)]
            mega = plane.create(rule="conway", height=128, width=128, seed=5,
                                with_board=False)["id"]
            t = plane.tiled[mega]
            with plane._lock:
                loaded = {e.shard for e in plane.sessions.values()
                          if e.shard is not None and plane.shard_owner[e.shard] == "wd"}
                chunks = sum(1 for o in t.owner.values() if o == "wd")
            assert len(loaded) >= 16 and chunks >= 3, (len(loaded), chunks)

            # Count the drain's rounds: shard moves in flight at once, and
            # the chunk export rounds sent to wd.
            in_flight, exports = [0], []
            begin, submit = plane.rebalancer.begin, plane._submit

            def counted_begin(*args, **kwargs):
                mig = begin(*args, **kwargs)
                in_flight[0] = max(in_flight[0], len(plane.rebalancer.inflight))
                return mig

            def counted_submit(op, **kwargs):
                if op.get("op") == "tiled_export" and kwargs.get("member") == "wd":
                    exports.append(len(op["chunks"]))
                return submit(op, **kwargs)

            plane.rebalancer.begin, plane._submit = counted_begin, counted_submit

            issued = {sid: 0 for sid in sids}
            errors, lock, stop, epochs = [], threading.Lock(), threading.Event(), [0]
            pool = [threading.Thread(target=_traffic,
                                     args=(plane, sids, stop, issued, errors, lock, k),
                                     daemon=True)
                    for k in range(4)]
            pool.append(threading.Thread(target=_mega, args=(plane, mega, t.k, stop, epochs,
                                                             errors), daemon=True))
            for th in pool:
                th.start()
            wait_until(lambda: sum(issued.values()) >= 100 and len(epochs) >= 3, 60,
                       "traffic before the drain")
            trigger.touch()
            try:
                rc = proc.wait(timeout=90)
            finally:
                stop.set()
                for th in pool:
                    th.join(60)
            said = proc.stdout.read()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        assert "sigterm inside a serve frame" in said, said[-2000:]
        assert rc == 0 and "backend wd drained; leaving" in said, (rc, said[-2000:])
        assert not errors, errors[:3]
        health = fe._health()["serve"]
        assert "wd" not in health["sessions_by_worker"], health["sessions_by_worker"]
        assert "wd" not in health["tiled_resident"]["chunks_by_worker"], health
        for i, sid in enumerate(sids):
            got = plane.get(sid)
            assert got["epoch"] == issued[sid], (sid, got["epoch"], issued[sid])
            assert got["digest"] == oracle_digest("conway", (16, 16), i, issued[sid])
        assert in_flight[0] == len(loaded), (in_flight[0], len(loaded))
        assert sum(exports) == chunks and len(exports) <= 2, (exports, chunks)
        doc = plane.get(mega)
        assert doc["epoch"] == epochs[-1]
        assert np.array_equal(doc["board"], oracle("conway", (128, 128), 5, doc["epoch"]))
        snap = registry.snapshot()
        assert (snap.get("gol_digest_mismatches_total") or 0) == 0
        assert (snap.get("gol_serve_sessions_lost_total") or 0) == 0


def test_drain_plans_every_movable_shard_and_chunk_in_one_pass():
    """The planner's count of drain moves in one pass at the default
    in-flight budget of 1: every loaded shard and every resident chunk of
    the draining worker (20 and 40).  The JAX planner, and the port's
    before, planned one of each per pass."""
    from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
    from akka_game_of_life_tpu_torch.runtime.rebalance import Rebalancer

    class M:
        def __init__(self, name, draining=False):
            self.name, self.alive, self.draining, self.tiles = name, True, draining, []

    members = [M("a", draining=True), M("b"), M("c")]
    owners = {s: "abc"[s % 3] for s in range(60)}
    weights = {s: 2 for s in owners}
    planner = Rebalancer(SimulationConfig(rebalance_max_inflight=1))
    shards = planner.plan_shards(owners, weights, members, now=1e9)
    assert len(shards) == 20 and {src for _, src, _ in shards} == {"a"}
    assert {dst for _, _, dst in shards} == {"b", "c"}
    chunks = {("s", (i // 8, i % 8)): "abc"[i % 3] for i in range(120)}
    moves = planner.plan_resident(chunks, members, now=1e9)
    assert len(moves) == 40 and {src for _, src, _ in moves} == {"a"}
