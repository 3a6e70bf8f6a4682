"""The SIGTERM drain of a port serve worker loses no frame, and a drain
moves a resident mega-board's chunks in rounds that let its steps in.

A worker's SIGTERM becomes a KeyboardInterrupt in its main thread, which
runs the dispatch loop of the control channel.  Raised there, it tore the
loop out between taking a frame from the inbox and dispatching it (or in
the middle of the dispatch): the frame's ops were never run, never
answered, the frontend kept them pending toward the draining worker, so
``member_clear`` never held, DRAIN_COMPLETE never came and the worker left
after its 30 s drain bound with exit code 130.  The loop now takes the
interrupt as a marker queued behind the frames already in, so every frame
it took is dispatched whole.  The chunk rounds are counted by the export
ops sent and by the session epoch read at each round's export and commit.
Each case counts frames, answers or rounds; only the hand-off's own bound
is read on a clock.
"""

from __future__ import annotations

import concurrent.futures
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

from _torch_serve_cluster import oracle, oracle_digest, serve_cluster, wait_until
from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.runtime.wire import pack_tile
from akka_game_of_life_tpu_torch.serve import cluster

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


# -- a drain's resident chunks move in rounds ----------------------------------

_ROUNDS_CFG = dict(serve_shards=8, serve_size_classes="16,32",
                   serve_replicate_interval_s=0.05, serve_tiled_resident_snapshot=2)


def _ceil(a, b):
    return -(-a // b)


def _held_by(plane, t, name):
    with plane._lock:
        return sorted(c for c, o in t.owner.items() if o == name)


def test_drain_moves_chunks_in_rounds_with_steps_between(monkeypatch):
    """Rounds of at most TILED_MOVE_ROUND_CHUNKS (patched to 2): the drainer
    of a 128² mega-board (16 chunks of 32², 8 on each of two workers), the
    board stepped all along, gets ceil(8 / 2) export ops of at most 2
    chunks; the session epoch moved between the first round and the last
    (the lock went to a step between rounds) but never inside a round (the
    epoch read at a round's export equals the one at each of its chunk
    commits); every chunk ends on the survivor and the board on the
    oracle, with no digest mismatch and no lost session."""
    monkeypatch.setattr(cluster, "TILED_MOVE_ROUND_CHUNKS", 2)
    with serve_cluster(2, **_ROUNDS_CFG) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        mega = plane.create(rule="conway", height=128, width=128, seed=5,
                            with_board=False)["id"]
        t = plane.tiled[mega]
        held = _held_by(plane, t, "w0")
        assert len(held) >= 6, held
        # Both read under the round's steplock, where only a step moves it.
        rounds = []
        submit, complete = plane._submit, plane.tiled_rebalancer.complete

        def counted_submit(op, **kwargs):
            if op.get("op") == "tiled_export" and kwargs.get("member") == "w0":
                rounds.append({"chunks": [tuple(c) for c in op["chunks"]],
                               "export": t.epoch, "commits": []})
            return submit(op, **kwargs)

        def counted_complete(key):
            if key[0] == mega:
                rounds[-1]["commits"].append(t.epoch)
            return complete(key)

        plane._submit = counted_submit
        plane.tiled_rebalancer.complete = counted_complete
        stop, errors, epochs = threading.Event(), [], [0]
        th = threading.Thread(target=_mega, args=(plane, mega, t.k, stop, epochs, errors),
                              daemon=True)
        th.start()
        try:
            wait_until(lambda: len(epochs) >= 3 or errors, 60, "steps before the drain")
            assert workers[0].request_drain()
            wait_until(lambda: not _held_by(plane, t, "w0")
                       and len(fe.membership.alive_members()) == 1, 60, "the drain")
            seen = len(epochs)
            wait_until(lambda: len(epochs) >= seen + 2 or errors, 60, "steps after the drain")
        finally:
            stop.set()
            th.join(60)
        assert not th.is_alive() and not errors, errors[:3]
        assert len(rounds) == _ceil(len(held), 2), rounds
        assert all(len(r["chunks"]) <= 2 for r in rounds), rounds
        assert sorted(c for r in rounds for c in r["chunks"]) == held
        assert rounds[-1]["export"] > rounds[0]["export"], rounds
        for r in rounds:
            assert r["commits"] == [r["export"]] * len(r["chunks"]), r
        assert set(t.owner.values()) == {"w1"}
        assert not plane.tiled_rebalancer.inflight
        doc = plane.get(mega)
        assert np.array_equal(doc["board"], oracle("conway", (128, 128), 5, doc["epoch"]))
        snap = registry.snapshot()
        assert (snap.get("gol_digest_mismatches_total") or 0) == 0
        assert (snap.get("gol_serve_sessions_lost_total") or 0) == 0


def test_a_round_that_aborts_leaves_the_later_ones_to_the_next_pass(monkeypatch):
    """A drain of 8 chunks in 3 rounds whose second round exports one
    corrupted chunk: round 1 commits, round 2 aborts on the digest
    mismatch and round 3 is not tried; right after that mover ends, round
    1's chunks are on the destination, rounds 2-3's on the source, and no
    chunk of the session is left in flight.  The next planner pass moves
    them and the drain ends with the board on the oracle."""
    with serve_cluster(2, **_ROUNDS_CFG) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        mega = plane.create(rule="conway", height=128, width=128, seed=9,
                            with_board=False)["id"]
        t = plane.tiled[mega]
        held = _held_by(plane, t, "w0")
        per = _ceil(len(held), 3)
        assert _ceil(len(held), per) == 3, held
        monkeypatch.setattr(cluster, "TILED_MOVE_ROUND_CHUNKS", per)
        exports, after_first = [], []
        await_, move = plane._await, plane._migrate_tiled_chunks

        def corrupting_await(p, **kwargs):
            res = await_(p, **kwargs)
            if p.op.get("op") == "tiled_export" and p.member == "w0":
                exports.append([tuple(c) for c in p.op["chunks"]])
                if len(exports) == 2:
                    state = res["chunks"][0]["state"]
                    data = np.array(state["data"], copy=True)
                    data[0] ^= 0x80  # the chunk's first cell
                    state["data"] = data
            return res

        def watched_move(sid, chunks, source, dest):
            move(sid, chunks, source, dest)
            with plane._lock:
                if not after_first:
                    after_first.append((dict(t.owner), set(plane.tiled_rebalancer.inflight)))

        plane._await, plane._migrate_tiled_chunks = corrupting_await, watched_move
        stop, errors, epochs = threading.Event(), [], [0]
        th = threading.Thread(target=_mega, args=(plane, mega, t.k, stop, epochs, errors),
                              daemon=True)
        th.start()
        try:
            wait_until(lambda: len(epochs) >= 3 or errors, 60, "steps before the drain")
            assert workers[0].request_drain()
            wait_until(lambda: after_first, 60, "the first mover")
            wait_until(lambda: not _held_by(plane, t, "w0")
                       and len(fe.membership.alive_members()) == 1, 60, "the drain")
        finally:
            stop.set()
            th.join(60)
        assert not th.is_alive() and not errors, errors[:3]
        owners, inflight = after_first[0]
        first = set(exports[0])
        assert len(exports[0]) == per and {owners[c] for c in first} == {"w1"}, exports
        assert {owners[c] for c in held if c not in first} == {"w0"}, owners
        assert not {k for k in inflight if k[0] == mega}, inflight
        assert len(exports) >= 4, exports  # the next pass re-exported the rest
        assert set(t.owner.values()) == {"w1"} and not plane.tiled_rebalancer.inflight
        doc = plane.get(mega)
        assert np.array_equal(doc["board"], oracle("conway", (128, 128), 9, doc["epoch"]))
        snap = registry.snapshot()
        assert snap.get("gol_digest_mismatches_total") == 1
        assert (snap.get("gol_serve_sessions_lost_total") or 0) == 0


class _Count:
    def __init__(self):
        self.n = 0

    def inc(self, v=1):
        self.n += v


class _Events:
    def __init__(self):
        self.rows = []

    def emit(self, event, **fields):
        self.rows.append((event, fields))


def _round_payloads(n, width=512, side=64):
    """``n`` exported chunks of a ``width``-wide board, as a source sends
    them: the packed state, its global origin and its digest lanes."""
    rng = np.random.default_rng(7)
    per_row = width // side
    pays = []
    for i in range(n):
        tile = (rng.random((side, side)) < 0.5).astype(np.uint8)
        origin = (side * (i // per_row), side * (i % per_row))
        lanes = odigest.digest_dense_np(tile, origin, width)
        pays.append({"state": pack_tile(tile), "origin": list(origin), "width": width,
                     "digest": [int(lanes[0]), int(lanes[1])]})
    return pays


def _serial_verdict(chunks, pays):
    """The serial certification loop the round ran before: chunks checked
    in order, the first mismatch ends it.  Returns (checks, first bad)."""
    checks = 0
    for c, pay in zip(chunks, pays):
        lanes = odigest.digest_payload_np(pay["state"], tuple(pay["origin"]), pay["width"])
        checks += 1
        if [int(lanes[0]), int(lanes[1])] != pay["digest"]:
            return checks, c
    return checks, None


@pytest.mark.parametrize("bad", [(), (0,), (1,), (7,), (15,), (3, 9)])
def test_parallel_certification_gives_the_serial_verdict(bad):
    """A full round's chunks certified on the plane's thread pool, with a
    corrupted chunk at each position (none; first; inside; last; two, of
    which the first names the event): the verdict, the checks and
    mismatches counted and the mismatch event are the serial loop's."""
    n = cluster.TILED_MOVE_ROUND_CHUNKS
    chunks = [(i // 4, i % 4) for i in range(n)]
    pays = _round_payloads(n)
    for i in bad:
        pays[i]["digest"][0] ^= 1 << (i % 32)
    checks, first_bad = _serial_verdict(chunks, pays)
    with concurrent.futures.ThreadPoolExecutor(cluster.TILED_CERTIFY_THREADS) as pool:
        plane = types.SimpleNamespace(_certify_pool=pool, _m_digest_checks=_Count(),
                                      _m_digest_mismatches=_Count(), events=_Events())
        ok = cluster.ClusterServePlane._certify_tiled_round(plane, "s1", chunks, pays, "w0")
    assert ok == (first_bad is None)
    assert plane._m_digest_checks.n == checks == (bad[0] + 1 if bad else n)
    assert plane._m_digest_mismatches.n == (1 if bad else 0)
    want = [] if first_bad is None else [(
        "serve_tiled_digest_mismatch", {"sid": "s1", "chunk": list(first_bad), "source": "w0"})]
    assert plane.events.rows == want


@pytest.mark.parametrize("bad", [(), (0,), (7,), (15,), (3, 9)])
@pytest.mark.parametrize("off_table", [(), (5,)])
def test_keyed_certification_gives_the_serial_verdict(bad, off_table, monkeypatch):
    """With the round's key tables made before the hold, certification
    gives the serial loop's verdict, counts and event, for a corrupted
    chunk anywhere; only a payload whose origin is not its table's is
    mixed in full, from the origin it names."""
    n = cluster.TILED_MOVE_ROUND_CHUNKS
    width, side = 512, 64
    chunks = [(i // 8, i % 8) for i in range(n)]
    pays = _round_payloads(n, width, side)
    keys = {c: ((side * c[0], side * c[1]), width, (side, side),
                odigest.key_lanes_np((side, side), (side * c[0], side * c[1]), width))
            for c in chunks}
    for i in off_table:
        keys[chunks[i]] = ((0, 0),) + keys[chunks[i]][1:]
    for i in bad:
        pays[i]["digest"][1] ^= 1 << (i % 32)
    checks, first_bad = _serial_verdict(chunks, pays)
    mixed = []
    full = odigest.digest_payload_np
    monkeypatch.setattr(odigest, "digest_payload_np",
                        lambda state, origin, w: mixed.append(origin) or full(state, origin, w))
    with concurrent.futures.ThreadPoolExecutor(cluster.TILED_CERTIFY_THREADS) as pool:
        plane = types.SimpleNamespace(_certify_pool=pool, _m_digest_checks=_Count(),
                                      _m_digest_mismatches=_Count(), events=_Events())
        ok = cluster.ClusterServePlane._certify_tiled_round(plane, "s1", chunks, pays, "w0",
                                                            keys)
    assert mixed == [tuple(pays[i]["origin"]) for i in off_table]
    assert ok == (first_bad is None)
    assert plane._m_digest_checks.n == checks == (bad[0] + 1 if bad else n)
    assert plane._m_digest_mismatches.n == (1 if bad else 0)
    want = [] if first_bad is None else [(
        "serve_tiled_digest_mismatch", {"sid": "s1", "chunk": list(first_bad), "source": "w0"})]
    assert plane.events.rows == want


def _resident(side=64):
    return cluster._ResidentTiled("s1", "conway", np.zeros((side, side), np.uint8), 32, 8)


def test_hand_off_lets_a_queued_step_take_the_lock_first():
    """Between rounds the mover waits until the step queued on the
    steplock has taken it, so the step runs before the mover's next hold;
    with none queued it does not wait, and a step that cannot get the lock
    holds the mover back only for the hand-off's bound."""
    t = _resident()
    order = []

    def step():
        with t.step_turn():
            order.append("step")
            time.sleep(0.05)

    t.steplock.acquire()  # a round's hold
    th = threading.Thread(target=step, daemon=True)
    th.start()
    wait_until(lambda: t.waiting == 1, 10, "the step to queue")
    t.steplock.release()
    t.hand_off(10.0)
    with t.steplock:
        order.append("mover")
    th.join(10)
    assert not th.is_alive() and order == ["step", "mover"] and t.waiting == 0

    t0 = time.monotonic()
    t.hand_off(10.0)
    assert time.monotonic() - t0 < 5.0  # nothing queued: no wait

    t.steplock.acquire()  # a third party keeps the lock
    th = threading.Thread(target=step, daemon=True)
    th.start()
    wait_until(lambda: t.waiting == 1, 10, "the step to queue")
    t0 = time.monotonic()
    t.hand_off(0.2)
    assert 0.2 <= time.monotonic() - t0 < 5.0 and t.waiting == 1
    t.steplock.release()
    th.join(10)
    assert not th.is_alive() and t.waiting == 0


def test_step_turns_under_contention_count_and_exclude():
    """Sixteen threads of step turns and a mover's rounds with hand-offs
    on one session, the switch interval shortened: never two holders at
    once, and the count of waiting requests returns to 0."""
    t = _resident()
    inside, worst, errors = [0], [0], []
    guard = threading.Lock()

    def hold():
        with guard:
            inside[0] += 1
            worst[0] = max(worst[0], inside[0])
        with guard:
            inside[0] -= 1

    def stepper():
        try:
            for _ in range(200):
                with t.step_turn():
                    hold()
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(repr(e))

    def mover():
        for _ in range(100):
            with t.steplock:
                hold()
            t.hand_off(0.01)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=stepper, daemon=True) for _ in range(16)]
        pool.append(threading.Thread(target=mover, daemon=True))
        for th in pool:
            th.start()
        for th in pool:
            th.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in pool) and not errors, errors[:3]
    assert worst[0] == 1 and t.waiting == 0
