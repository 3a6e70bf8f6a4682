"""The frontend federation of the port (``serve/federation.py``) against the
JAX package's.

The drills run REAL frontends in process, each with its own cluster
listener, federation plane and one ``BackendWorker`` thread speaking the
wire protocol (the port's on the torch engine with ``device="cpu"``),
federated over localhost TCP.  A frontend "crash" closes its listener and
every channel abruptly, with no SHUTDOWN and no goodbye: what the
survivors of a kill -9 observe.  ``federation(..., pkgs=["jax", "torch"])``
mixes the two packages' frontends.  The parity tests feed the same inputs
to both packages' functions and compare the results and the frames' bytes.
The process drill runs ``serve --serve-cluster on`` processes of the port
with ``--device cpu`` and a real SIGKILL.  Every wait has its own deadline.
"""

from __future__ import annotations

import contextlib
import json
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import akka_game_of_life_tpu.runtime.config as j_config
import akka_game_of_life_tpu.runtime.membership as j_membership
import akka_game_of_life_tpu.serve.cluster as j_cluster
import akka_game_of_life_tpu.serve.federation as j_fed
import akka_game_of_life_tpu_torch.runtime.config as t_config
import akka_game_of_life_tpu_torch.runtime.membership as t_membership
import akka_game_of_life_tpu_torch.serve.cluster as t_cluster
import akka_game_of_life_tpu_torch.serve.federation as t_fed
from _torch_serve_cluster import PKGS, oracle_digest
from akka_game_of_life_tpu.runtime import wire as j_wire
from akka_game_of_life_tpu_torch.runtime import protocol as P
from akka_game_of_life_tpu_torch.runtime import wire as t_wire
from akka_game_of_life_tpu_torch.serve.federation import FederationRedirect
from akka_game_of_life_tpu_torch.serve.sessions import AdmissionError, shard_of

N_SHARDS = 64  # the serve default
RETRYABLE = ("failover", "partitioned", "queue_full", "draining")
FED = {"jax": j_fed, "torch": t_fed}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _boot_fe(port: int, seeds: str, tag: str, pkg: str = "torch",
             shards: int = N_SHARDS):
    """One real federated frontend of ``pkg`` plus one worker thread of the
    same package."""
    p = PKGS[pkg]
    cfg = p.Config(
        role="serve", serve_cluster=True, host="127.0.0.1", port=port,
        max_epochs=None, flight_dir="", serve_shards=shards,
        rebalance_interval_s=0.05,
        # Lenient worker failure detection: several frontends and gossip
        # loops share one host, and a starved heartbeat would auto-down a
        # healthy worker mid-drill.
        heartbeat_s=0.5, failure_timeout_s=5.0,
        frontend_seeds=seeds,
        frontend_gossip_interval_s=0.1, frontend_gossip_timeout_s=1.0,
        frontend_replicate_interval_s=0.1,
    )
    registry = p.registry()
    fe = p.Frontend(cfg, min_backends=1, registry=registry,
                    tracer=p.Tracer(node=f"fed-{tag}"))
    fe.start()
    w = p.BackendWorker("127.0.0.1", port, name=f"w-{tag}",
                        registry=registry, tracer=fe.tracer, **p.worker_kw)
    w.crash_hook = w.stop
    w.connect()
    threading.Thread(target=w.run, daemon=True, name=f"w-{tag}").start()
    assert fe.wait_for_backends(timeout=10)
    return fe, w


def _crash(fe) -> None:
    """Die the way kill -9 looks from outside: listener gone (redials
    refused), every channel dropped mid-stream, no SHUTDOWN, no goodbye.
    The frontend's own worker sees EOF and re-homes through its FED_PEERS
    fallbacks; the surviving peer sees EOF, redials into a refusal, and
    confirms the death."""
    fe._stop.set()
    fe.federation._stop.set()
    with contextlib.suppress(OSError):
        # shutdown() too: the accept-loop thread blocked in accept() holds
        # a kernel reference, and close() alone leaves the port accepting.
        fe._listener.shutdown(socket.SHUT_RDWR)
    with contextlib.suppress(OSError):
        fe._listener.close()
    for p in list(fe.federation.peers.values()):
        with contextlib.suppress(OSError):
            p.channel.close()
    for m in fe.membership.alive_members():
        with contextlib.suppress(OSError):
            m.channel.close()


def _wait(predicate, what, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _step_until_owned(router, sid, timeout=20.0) -> int:
    """One step, retrying through the retryable-429 window a failover
    opens.  Every refusal must be retryable: another reason, or a
    404-shaped KeyError, fails the drill."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            epoch, _digest = router.step(sid, 1)
            return epoch
        except AdmissionError as e:
            assert e.reason in RETRYABLE, e.reason
            assert time.monotonic() < deadline, "failover never healed"
            time.sleep(0.05)


def _wait_converged(fes, timeout=15.0, every_one_owns=True) -> None:
    names = {fe.federation.name for fe in fes}

    def ok():
        for fe in fes:
            h = fe.federation.health()
            if len(h["peers"]) != len(fes) - 1:
                return False
            if h["slices"]["unowned"]:
                return False
            if every_one_owns and not h["slices"]["owned"]:
                return False
            if set(h["slices"]["by_frontend"]) - names:
                return False
        maps = [
            {s: o for s, (o, _) in fe.federation.slices.items()}
            for fe in fes
        ]
        return all(m == maps[0] for m in maps)

    try:
        _wait(ok, "federation convergence", timeout)
    except AssertionError:
        views = [(fe.federation.name, fe.federation.health()) for fe in fes]
        raise AssertionError(f"no convergence: {views}") from None


def _sid_owned_by(fed, owner_name: str, tag: str) -> str:
    owned = {s for s, (o, _) in fed.slices.items() if o == owner_name}
    return next(
        f"{tag}{i:04d}" for i in range(100_000)
        if shard_of(f"{tag}{i:04d}", N_SHARDS) in owned
    )


@contextlib.contextmanager
def federation(n: int, ports=None, pkgs=None, shards=N_SHARDS):
    """An in-process federation: n frontends (of ``pkgs``, default all the
    port's), one worker each, pinned ports (so a flapped frontend can
    rebind), every frontend a seed."""
    ports = ports or [_free_port() for _ in range(n)]
    pkgs = pkgs or ["torch"] * n
    seeds = ",".join(f"127.0.0.1:{p}" for p in ports)
    fes, workers = [], []
    try:
        for i, port in enumerate(ports):
            fe, w = _boot_fe(port, seeds, f"fe{i}", pkgs[i], shards)
            fes.append(fe)
            workers.append(w)
        _wait_converged(fes, every_one_owns=shards == N_SHARDS)
        yield fes, workers, ports, seeds
    finally:
        for fe in fes:
            with contextlib.suppress(Exception):
                fe.stop()
        for w in workers:
            with contextlib.suppress(Exception):
                w.stop()


# -- the public surface ---------------------------------------------------------


def _public(cls):
    return sorted(n for n in vars(cls) if not n.startswith("_"))


@pytest.mark.parametrize("name", ["FederationPlane", "FederatedRouter"])
def test_federation_surface_matches_reference(name):
    """The port's classes have the JAX package's public methods, and the
    module its constants, by name and value."""
    assert _public(getattr(t_fed, name)) == _public(getattr(j_fed, name))
    for const in ("FWD_TIMEOUT_S", "PROBE_TIMEOUT_S", "REHOME_GRACE_TIMEOUTS",
                  "SID_MINE_ATTEMPTS"):
        assert getattr(t_fed, const) == getattr(j_fed, const), const


# -- gossip convergence ---------------------------------------------------------


def test_gossip_join_converges():
    """Two seeds converge one slice map; a third frontend joining later
    (finding the fleet through the seeds) pulls the map to a three-way
    split with no unowned slice and no disagreement."""
    with federation(2) as (fes, workers, ports, seeds):
        a, b = fes
        assert sum(
            fe.federation.health()["slices"]["owned"] for fe in fes
        ) == N_SHARDS

        fe_c, w_c = _boot_fe(_free_port(), seeds, "fe2")
        try:
            _wait_converged([a, b, fe_c])
            assert fe_c.federation.health()["slices"]["owned"] > 0
        finally:
            fe_c.stop()
            w_c.stop()


def test_forwarded_ops_fifo_under_slice_churn():
    """Concurrent steps of one session through BOTH frontends (half
    forwarded over the peer plane, half local) land exactly once each,
    while a third frontend joins mid-run and the slice table churns under
    the traffic.  The final epoch equal to the issued count is the
    FIFO/no-loss proof; the digest is the oracle's, and the live session's
    slice never moved."""
    with federation(2) as (fes, workers, ports, seeds):
        a, b = fes
        sid = _sid_owned_by(a.federation, b.federation.name, "fifo")
        doc = a.federation.router.create(
            sid=sid, height=24, width=24, seed=5
        )  # a forwarded create: A does not own the slice
        assert doc["id"] == sid

        per_thread, errors = 25, []

        def stepper(router):
            try:
                for _ in range(per_thread):
                    _step_until_owned(router, sid, timeout=30)
            except Exception as e:  # noqa: BLE001 — recorded, asserted
                errors.append(repr(e))

        pool = [
            threading.Thread(target=stepper, args=(fe.federation.router,))
            for fe in (a, b, a, b)
        ]
        for t in pool:
            t.start()
        # A join mid-traffic: empty-slice releases rewrite the slice map
        # under the forwarded stream.
        fe_c, w_c = _boot_fe(_free_port(), seeds, "fe2")
        try:
            for t in pool:
                t.join(45)
            assert not any(t.is_alive() for t in pool), "a stepper hung"
            assert errors == [], errors
            total = len(pool) * per_thread
            got = b.federation.router.get(sid)
            assert got["epoch"] == total, (got["epoch"], total)
            assert got["digest"] == oracle_digest("conway", (24, 24), 5, total)
            assert a.federation.slices[shard_of(sid, N_SHARDS)][0] == (
                b.federation.name
            )
        finally:
            fe_c.stop()
            w_c.stop()


def _slice_less_ports(n_shards=16, tries=2000):
    """Free ports for three frontends whose names the slice placement
    (``rendezvous_pick`` over ``slice:{shard}``) leaves one with no slice
    of ``n_shards``; returns (ports, that frontend's index)."""
    from akka_game_of_life_tpu_torch.serve.sessions import rendezvous_pick

    for _ in range(tries):
        ports = [_free_port() for _ in range(3)]
        names = sorted(f"127.0.0.1:{p}" for p in ports)
        won = {rendezvous_pick(f"slice:{s}", names) for s in range(n_shards)}
        lost = [i for i, p in enumerate(ports) if f"127.0.0.1:{p}" not in won]
        if lost and len(set(ports)) == 3:
            return ports, lost[0]
    raise AssertionError("no slice-less placement found")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_slice_less_frontend_forwards_its_creates(pkg):
    """The slice placement's crc32 scores are XOR-linear in the key, so
    with few slices a frontend may own none (about one three-frontend
    fleet in ten at 16 slices).  The JAX module refuses its auto-id
    creates for good (429, "owns no slices yet"); the port mines the id
    into the slices of the peer owning most and forwards the create."""
    ports, idle = _slice_less_ports()
    with federation(3, ports=ports, pkgs=[pkg] * 3, shards=16) as (
        fes, workers, _, seeds
    ):
        fe = fes[idle]
        assert fe.federation.health()["slices"]["owned"] == 0
        if pkg == "jax":
            for _ in range(5):
                with pytest.raises(j_fed.AdmissionError) as exc:
                    fe.federation.router.create(height=16, width=16, seed=8)
                assert exc.value.reason == "failover"
                time.sleep(0.1)
            return
        doc = fe.federation.router.create(height=16, width=16, seed=8)
        sid = doc["id"]
        owner = fe.federation.slices[shard_of(sid, 16)][0]
        assert owner != fe.federation.name
        epoch, digest = fe.federation.router.step(sid, 2)  # forwarded too
        assert epoch == 2
        host = next(f for f in fes if f.federation.name == owner)
        assert host.federation.router.get(sid)["digest"] == oracle_digest(
            "conway", (16, 16), 8, 2)


# -- failover -------------------------------------------------------------------


def _kill_drill(a, b, sid_tag="kill"):
    """B crashes with one replicated session; A adopts it, B's worker
    re-homes to A, and the session steps on at a continuous epoch."""
    sid = _sid_owned_by(b.federation, b.federation.name, sid_tag)
    b.federation.router.create(sid=sid, height=24, width=24, seed=9)
    b.federation.router.step(sid, 3)
    _wait(
        lambda: sum(
            a.federation.health()["replicated_rows_held"].values()
        ) >= 1,
        "control rows replicated to the standby",
    )
    _crash(b)
    _wait(
        lambda: b.federation.name in a.federation.health()["dead"],
        "A to confirm B dead",
    )
    epoch = _step_until_owned(a.federation.router, sid)
    assert epoch == 4  # 3 before the crash + 1: the state survived
    return sid


def test_crash_promotes_worker_rehomes_zero_loss():
    """The kill drill: B crashes without a goodbye.  A confirms the death
    on the refused redial, adopts B's slices from the replicated control
    rows (the window answers the retryable 429 ``failover``, never a
    404-shaped KeyError), B's orphaned worker re-homes to A and its
    SHARD_HOME closes the window, and the session steps on with its epoch
    continuous and its digest the oracle's.  No admitted session is lost,
    even once the promotion grace expires."""
    with federation(2) as (fes, workers, ports, seeds):
        a, b = fes
        sid = _kill_drill(a, b)
        h = a.federation.health()
        assert h["slices"]["owned"] == N_SHARDS
        assert h["promotions_inflight"] >= 1  # the grace is still open
        # Past the deadline: SHARD_HOME already closed the windows, so the
        # expiry is a no-op, not the honest-loss path.
        a.federation._expire_promotions(time.monotonic() + 3600.0)
        assert a.federation.health()["promotions_inflight"] == 0
        got = a.federation.router.get(sid)
        assert got["epoch"] == 4
        assert got["digest"] == oracle_digest("conway", (24, 24), 9, 4)
        snap = a.metrics.snapshot()
        assert (snap.get("gol_serve_sessions_lost_total") or 0) == 0
        assert (snap.get("gol_frontend_slice_promotions_total") or 0) >= 1
        # The dead peer's gossip-age series is reclaimed.
        assert not any(
            key.startswith("gol_frontend_gossip_age_seconds")
            and b.federation.name in key
            for key in snap
        ), "dead peer still exports a gossip-age series"
        # The re-homed worker is a member of A now, hosting the session.
        assert workers[1].channel is not None
        assert workers[1].name in {
            m.name for m in a.membership.alive_members()
        }


def test_rehome_announces_the_ops_its_dead_frontend_sent():
    """A step the dead frontend sent that is still queued on its worker
    lands before the worker announces SHARD_HOME: the adopting frontend's
    index holds the epoch after it, so a client reading back after the
    failover sees the step and does not send it twice."""
    with federation(2) as (fes, workers, ports, seeds):
        a, b = fes
        sid = _sid_owned_by(b.federation, b.federation.name, "late")
        b.federation.router.create(sid=sid, height=24, width=24, seed=2)
        b.federation.router.step(sid, 3)
        _wait(lambda: a.federation.health()["replicated_rows_held"].get(
            b.federation.name, 0) >= 1, "the standby to hold the row")
        plane = workers[1].serve_plane
        real, reached = plane._run_op, threading.Event()

        def slow_run_op(op):
            if op.get("op") == "step":
                reached.set()
                time.sleep(1.0)  # still queued on the worker at the crash
            return real(op)

        plane._run_op = slow_run_op
        threading.Thread(
            target=_ignore, args=(lambda: b.federation.router.step(sid, 5),),
            daemon=True,
        ).start()
        assert reached.wait(10)
        _crash(b)
        _wait(lambda: sid in a.serve_plane.sessions
              and not a.serve_plane._promoting
              and workers[1].name in {m.name for m in a.membership.alive_members()},
              "the worker's SHARD_HOME at A")
        assert a.serve_plane.sessions[sid].epoch == 8  # 3 + the in-flight 5
        got = a.federation.router.get(sid)
        assert got["epoch"] == 8
        assert got["digest"] == oracle_digest("conway", (24, 24), 2, 8)


def _ignore(fn):
    try:
        fn()
    except Exception:  # noqa: BLE001 — the answer is lost with its frontend
        pass


def test_flap_dead_frontend_rejoins_and_rebalances():
    """A flapped frontend (a crash, then a fresh one on the same port: the
    same ``host:port`` identity) registers cleanly: the survivor drops the
    stale replicated rows, gossip converges again, and the rejoiner wins
    back its share of the empty keyspace, while the slice holding a live
    adopted session stays with the survivor."""
    ports = [_free_port(), _free_port()]
    with federation(2, ports=ports) as (fes, workers, _, seeds):
        a, b = fes
        sid = _sid_owned_by(b.federation, b.federation.name, "flap")
        b.federation.router.create(sid=sid, height=16, width=16, seed=3)
        _wait(
            lambda: sum(
                a.federation.health()["replicated_rows_held"].values()
            ) >= 1,
            "replication to the standby",
        )
        _crash(b)
        _wait(
            lambda: a.federation.health()["slices"]["owned"] == N_SHARDS,
            "A to adopt every slice",
        )
        assert _step_until_owned(a.federation.router, sid) == 1
        a.federation._expire_promotions(time.monotonic() + 3600.0)

        fe_b2, w_b2 = _boot_fe(ports[1], seeds, "fe1b")
        try:
            _wait_converged([a, fe_b2])
            assert fe_b2.federation.health()["slices"]["owned"] > 0
            assert a.federation.slices[shard_of(sid, N_SHARDS)][0] == (
                a.federation.name
            )
            assert a.federation.router.get(sid)["epoch"] == 1
            held = a.federation.health()["replicated_rows_held"]
            assert held.get(fe_b2.federation.name, 0) == 0
        finally:
            fe_b2.stop()
            w_b2.stop()


def test_split_brain_suspect_parks_writes():
    """A suspect peer (gossip stale past the timeout, link still open: a
    wedged process, not a dead one) is NOT promoted: writes on its slices
    park with the retryable 429 ``partitioned``, ownership never flips,
    and the parked op flows again once gossip resumes."""
    with federation(2) as (fes, workers, ports, seeds):
        a, b = fes
        sid = _sid_owned_by(b.federation, b.federation.name, "park")
        b.federation.router.create(sid=sid, height=16, width=16, seed=7)
        shard = shard_of(sid, N_SHARDS)

        # Wedge B: its gossip loop spins but sends nothing, while its
        # listener and peer link stay open.
        b.federation._gossip_tick = lambda: None
        _wait(
            lambda: b.federation.name in a.federation.health()["suspect"],
            "A to suspect the wedged peer",
        )
        with pytest.raises(AdmissionError) as exc:
            a.federation.router.step(sid, 1)
        assert exc.value.reason == "partitioned"
        assert a.federation.slices[shard][0] == b.federation.name
        assert b.federation.slices[shard][0] == b.federation.name
        snap = a.metrics.snapshot()
        assert (snap.get("gol_frontend_parked_ops_total") or 0) >= 1

        del b.federation._gossip_tick  # unwedge: the class method resumes
        deadline = time.monotonic() + 10
        while True:
            try:
                epoch, _ = a.federation.router.step(sid, 1)
                break
            except AdmissionError as e:
                assert e.reason == "partitioned", e.reason
                assert time.monotonic() < deadline, "suspicion never cleared"
                time.sleep(0.05)
        assert epoch == 1


def test_foreign_get_redirects_local_get_serves():
    """GET is the fat op: a foreign board answers 307 to its owner's HTTP
    port instead of passing O(h·w) cells through a middleman frontend."""
    with federation(2) as (fes, workers, ports, seeds):
        a, b = fes
        sid = _sid_owned_by(b.federation, b.federation.name, "redir")
        a.federation.router.create(sid=sid, height=16, width=16, seed=1)
        with pytest.raises(FederationRedirect) as exc:
            a.federation.router.get(sid)
        assert exc.value.url == (
            f"http://127.0.0.1:{b._metrics_server.port}/boards/{sid}"
        )
        assert b.federation.router.get(sid)["id"] == sid
        # Through the HTTP surface: the 307's Location, followed, is the board.
        status, doc, headers = _http_raw(
            a._metrics_server.port, "GET", f"/boards/{sid}"
        )
        assert status == 307 and headers["Location"] == exc.value.url
        status, doc = _http(b._metrics_server.port, "GET", f"/boards/{sid}")
        assert status == 200 and doc["id"] == sid


# -- the re-home's send path ------------------------------------------------------


def test_control_send_racing_the_rehome_is_dropped_not_raised():
    """A serve frame that meets the dead channel of a federated worker was
    its dead frontend's: it is dropped at once, not raised (the worker's
    reply and replication threads outlive the swap), not held until the
    swap (the re-home's settle waits for the thread that sends it) and not
    resent (a result would answer whatever op of the new frontend bears
    its rid)."""
    with federation(2) as (fes, workers, ports, seeds):
        w = workers[1]
        live = w.channel

        class _Dead:
            def send(self, msg):
                raise BrokenPipeError("the frontend died")

        class _New:
            def __init__(self):
                self.sent = []

            def send(self, msg):
                self.sent.append(msg)

        try:
            w.channel = _Dead()
            t0 = time.monotonic()
            assert w._control_send({"type": "serve_result"}) is None
            assert time.monotonic() - t0 < 1.0
            new = _New()
            w.channel = new
            time.sleep(0.3)
            assert [m for m in new.sent if m["type"] == "serve_result"] == []
        finally:
            w.channel = live


def test_frontend_killed_during_a_shard_prepare_rehomes_zero_loss():
    """B dies while its worker runs a SHARD_PREPARE.  The prepare's reply
    meets the dead channel and is dropped without waiting for the re-home,
    so the re-home's settle, queued behind it, passes; the worker thaws the
    shard B can no longer commit or abort, re-homes to A, and its
    SHARD_HOME closes the window: the session steps on at a continuous
    epoch with the oracle's digest, and none is lost."""
    with federation(2) as (fes, workers, ports, seeds):
        a, b = fes
        w = workers[1]
        sid = _sid_owned_by(b.federation, b.federation.name, "prep")
        b.federation.router.create(sid=sid, height=24, width=24, seed=5)
        b.federation.router.step(sid, 3)
        _wait(lambda: a.federation.health()["replicated_rows_held"].get(
            b.federation.name, 0) >= 1, "the standby to hold the row")
        plane = w.serve_plane
        real, reached, crashed = (
            plane._on_prepare, threading.Event(), threading.Event(),
        )

        def held_prepare(msg):
            reached.set()
            assert crashed.wait(10)
            # Past two heartbeats: the dead channel has drawn its reset, so
            # the reply's send fails rather than filling a socket buffer.
            time.sleep(1.2)
            return real(msg)

        plane._on_prepare = held_prepare
        with b.serve_plane._lock:
            b.serve_plane._enqueue_ctrl_locked(w.name, {
                "type": P.SHARD_PREPARE, "shard": shard_of(sid, N_SHARDS),
                "seq": 1,
            })
        assert reached.wait(10)
        _crash(b)
        crashed.set()
        _wait(
            lambda: w.name in {m.name for m in a.membership.alive_members()}
            and not a.serve_plane._promoting,
            "the worker's SHARD_HOME at A", timeout=30.0,
        )
        assert _step_until_owned(a.federation.router, sid) == 4
        got = a.federation.router.get(sid)
        assert got["digest"] == oracle_digest("conway", (24, 24), 5, 4)
        snap = a.metrics.snapshot()
        assert (snap.get("gol_serve_sessions_lost_total") or 0) == 0


# -- parity with the JAX package on the same inputs --------------------------------


SEED_SPECS = [
    "", "127.0.0.1:9000", " h:1 , 10.0.0.2:2551,", "[::1]:7000,a.b:1",
    "localhost:0",
]


@pytest.mark.parametrize("spec", SEED_SPECS)
def test_parse_seeds_matches_reference(spec):
    assert t_fed.parse_seeds(spec) == j_fed.parse_seeds(spec)


FRONTEND_VALUES = [
    ("frontend_seeds", "a:1,b:2"), ("frontend_seeds", "a:1,b"),
    ("frontend_seeds", ":1"), ("frontend_seeds", "a:x"),
    ("frontend_advertise", "h:2551"), ("frontend_advertise", "a:1,b:2"),
    ("frontend_advertise", "nohost"), ("frontend_gossip_interval_s", "200ms"),
    ("frontend_gossip_interval_s", 0), ("frontend_gossip_timeout_s", "5s"),
    ("frontend_gossip_timeout_s", 0.5), ("frontend_gossip_timeout_s", "0.2s"),
    ("frontend_replicate_every", 4), ("frontend_replicate_every", 0),
    ("frontend_replicate_interval_s", "100ms"),
    ("frontend_replicate_interval_s", 0),
]


@pytest.mark.parametrize("key,value", FRONTEND_VALUES)
def test_frontend_keys_load_and_refuse_like_reference(key, value):
    """Every ``frontend_*`` key loads to the JAX package's value, and an
    invalid one raises the JAX package's text."""
    outcome = {}
    for name, mod in (("jax", j_config), ("torch", t_config)):
        try:
            outcome[name] = ("ok", getattr(mod.load_config(None, {key: value}), key))
        except ValueError as e:
            outcome[name] = ("error", str(e))
    assert outcome["torch"] == outcome["jax"]


def _plane_and_fed(pkg: str, name: str = "127.0.0.1:7000", **cfg_kw):
    """A federation plane on a real cluster plane with no workers (frames
    go nowhere until a test gives it a peer)."""
    p = PKGS[pkg]
    mem = (j_membership if pkg == "jax" else t_membership).Membership(5.0)
    cfg = p.Config(role="serve", serve_cluster=True, flight_dir="",
                   serve_shards=N_SHARDS, frontend_seeds="127.0.0.1:7000",
                   **cfg_kw)
    cluster = j_cluster if pkg == "jax" else t_cluster
    plane = cluster.ClusterServePlane(
        cfg, mem, lambda member, msg: None,
        registry=p.registry(), tracer=p.Tracer(node="parity"),
    )
    fed = FED[pkg].FederationPlane(cfg, plane, name=name,
                                   cluster_addr=("127.0.0.1", 7000))
    return plane, fed


@contextlib.contextmanager
def _pair(**cfg_kw):
    made = {pkg: _plane_and_fed(pkg, **cfg_kw) for pkg in ("jax", "torch")}
    try:
        yield {pkg: fed for pkg, (_plane, fed) in made.items()}
    finally:
        for plane, fed in made.values():
            fed.close()
            plane.close()


SLICE_TABLES = [
    {s: ("127.0.0.1:7000", 1) for s in range(N_SHARDS)},
    {s: ("127.0.0.1:7000" if s % 3 == 0 else "127.0.0.1:7001", 2)
     for s in range(N_SHARDS)},
    {5: ("127.0.0.1:7000", 9), 11: ("127.0.0.1:7001", 1)},
]


@pytest.mark.parametrize("table", range(len(SLICE_TABLES)))
def test_mine_local_sid_matches_reference(table):
    """The same prefix and slice table mine the same sids, in order."""
    with _pair() as feds:
        got = {}
        for pkg, fed in feds.items():
            fed.slices = dict(SLICE_TABLES[table])
            fed._sid_prefix = "s1a2b-"
            got[pkg] = [fed.mine_local_sid() for _ in range(12)]
        assert got["torch"] == got["jax"]
        mine = {s for s, (o, _v) in SLICE_TABLES[table].items()
                if o == "127.0.0.1:7000"}
        assert all(shard_of(sid, N_SHARDS) in mine for sid in got["torch"])


GOSSIP_DOCS = [
    ("127.0.0.1:7001", {
        "type": "p_gossip", "from": "127.0.0.1:7001",
        "members": {"127.0.0.1:7001": {"advertise": ["127.0.0.1", 7001],
                                       "cluster": ["127.0.0.1", 7001],
                                       "http": 8001},
                    "127.0.0.1:7002": {"advertise": ["127.0.0.1", 7002],
                                       "http": 8002}},
        "slices": {str(s): ["127.0.0.1:7001", 1] for s in range(0, N_SHARDS, 2)},
        "budget": {"sessions": 3, "cells": 300}, "owned": 8,
    }),
    ("127.0.0.1:7002", {
        "type": "p_gossip", "from": "127.0.0.1:7002",
        "slices": {**{str(s): ["127.0.0.1:7002", 2] for s in range(0, 6)},
                   "7": ["127.0.0.1:7002", 1], "99": ["x", 5], "bad": [1],
                   "3": ["127.0.0.1:7000", 1]},
        "budget": {"sessions": 1, "cells": 64}, "owned": 7,
    }),
    ("127.0.0.1:7001", {
        "type": "p_gossip", "from": "127.0.0.1:7001",
        "slices": {"1": ["127.0.0.1:7001", 1], "2": ["127.0.0.1:7001", 2],
                   "4": ["127.0.0.1:7003", 2], "9": ["127.0.0.1:7000", 4],
                   "12": ["127.0.0.1:7001", 7]},
    }),
]


def test_merge_gossip_matches_reference():
    """The same gossip documents merged in the same order into both
    packages' planes (this frontend owning some slices, one of them
    holding a session) leave the same slice table, member table and
    budget shares."""
    with _pair() as feds:
        for fed in feds.values():
            fed.slices = {s: ("127.0.0.1:7000", 1) for s in (1, 3, 4, 9)}
            # A live session on slice 4: a conflicting claim re-asserts.
            sid = next(f"m{i}" for i in range(10_000)
                       if shard_of(f"m{i}", N_SHARDS) == 4)
            fed.plane.sessions[sid] = object()
        for origin, doc in GOSSIP_DOCS:
            for fed in feds.values():
                fed._merge_gossip(origin, json.loads(json.dumps(doc)))
        j, t = feds["jax"], feds["torch"]
        assert t.slices == j.slices
        assert t._known == j._known
        assert t._budget == j._budget
        assert t._gossip_heard == j._gossip_heard
        assert t.slices[4] == ("127.0.0.1:7000", 3)  # the re-assert


class _Recorder:
    """A peer channel that keeps the frames it is given."""

    def __init__(self):
        self.frames = []

    def send(self, msg):
        self.frames.append(msg)

    def close(self):
        pass


def _frame_bytes(wire, msg) -> bytes:
    a, b = socket.socketpair()
    try:
        wire.Channel(a).send(msg)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        a.close()
        b.close()


def _frames_of(fed, peer_name="127.0.0.1:7001"):
    """Give ``fed`` one live peer whose channel records its frames."""
    rec = _Recorder()
    mod = t_fed if isinstance(fed, t_fed.FederationPlane) else j_fed
    host, _, port = peer_name.rpartition(":")
    with fed._lock:
        fed.peers[peer_name] = mod._Peer(
            peer_name, rec, advertise=(host, int(port)),
            cluster=(host, int(port)), http_port=8001, dialer=fed.name,
        )
    fed.membership.register(rec, peer_name, peer_host=host,
                            peer_port=int(port))
    return rec


ROWS = [
    {"sid": f"r{i}", "tenant": "t", "kind": "batch", "rule": "B3/S23",
     "height": 16 + i, "width": 32, "seed": i, "density": 0.5,
     "shard": i % N_SHARDS, "epoch": 3 * i, "digest": f"{i:016x}",
     "slice": i % N_SHARDS}
    for i in range(7)
]


def test_gossip_forward_and_replicate_frames_match_reference():
    """P_GOSSIP, P_FWD_OPS and P_REPLICATE for the same state are the same
    bytes on the wire from either package."""
    with _pair(frontend_replicate_every=3) as feds:
        frames = {}
        for pkg, fed in feds.items():
            wire = j_wire if pkg == "jax" else t_wire
            rec = _frames_of(fed)
            fed.set_http_port(8000)
            with fed._lock:
                fed.slices = {s: ("127.0.0.1:7000" if s < 10 else
                                  "127.0.0.1:7001", 2) for s in range(N_SHARDS)}
                fed._known["127.0.0.1:7001"] = {
                    "advertise": ("127.0.0.1", 7001),
                    "cluster": ("127.0.0.1", 7001), "http": 8001}
                alive = {m.name: m for m in fed.membership.alive_members()}
                gossip = fed._gossip_doc_locked(alive, 0.0)
            # A forwarded op: answered at once by a fake owner.
            threading.Timer(0.05, lambda f=fed: f._on_peer_msg(
                "127.0.0.1:7001",
                {"type": "p_fwd_result", "rid": 1, "ok": True,
                 "value": [4, 17]})).start()
            assert fed.forward("127.0.0.1:7001", "step",
                               {"sid": "x1", "steps": 4}) == [4, 17]
            fwd = rec.frames[-1]
            fed.plane.control_rows = lambda: [dict(r) for r in ROWS]
            fed._replicate_tick()
            repl = rec.frames[-3:]
            frames[pkg] = [_frame_bytes(wire, m) for m in [gossip, fwd, *repl]]
            assert [m["type"] for m in repl] == ["p_replicate"] * 3
            assert len(repl[0]["rows"]) == 3 and repl[0]["reset"]
        assert frames["torch"] == frames["jax"]


# -- a repair over the JAX module --------------------------------------------------


class _GrowingIndex(dict):
    """A session index that gains a session while its pairs are iterated:
    what a create racing the gossip tick does to the live dict."""

    def items(self):
        for i, kv in enumerate(dict.items(self)):
            if i == 0:
                self[f"late{len(self)}"] = object()
            yield kv


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_gossip_tick_survives_a_create_racing_the_index_scan(pkg):
    """A create that lands while the gossip tick scans the session index
    costs the JAX module the tick (its gossip is not sent); the port
    scans a snapshot of the keys, so the tick goes on."""
    plane, fed = _plane_and_fed(pkg)
    try:
        rec = _frames_of(fed)
        with fed._lock:
            fed.slices = {s: (fed.name, 1) for s in range(N_SHARDS)}
        index = _GrowingIndex(plane.sessions)
        index["s0"] = object()
        plane.sessions = index
        plane.stats = lambda: {"sessions": 0, "cells": 0}
        if pkg == "jax":
            with pytest.raises(RuntimeError, match="changed size"):
                fed._gossip_tick()
            assert rec.frames == []
        else:
            fed._gossip_tick()
            assert [f["type"] for f in rec.frames] == ["p_gossip"]
    finally:
        fed.close()
        plane.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_op_between_adoption_and_install_answers_failover(pkg):
    """An op that lands while the standby adopts a dead peer's slices must
    find the adopted session's window (a retryable 429), not a 404.  The
    JAX module moves the slices before it installs the replicated rows,
    outside the lock: a step in between raises KeyError.  The port does
    both under one lock hold."""
    plane, fed = _plane_and_fed(pkg)
    dead = "127.0.0.1:7001"
    try:
        _frames_of(fed, dead)
        sid = next(f"d{i}" for i in range(10_000)
                   if shard_of(f"d{i}", N_SHARDS) == 3)
        with fed._lock:
            fed.slices = {s: (dead if s == 3 else fed.name, 1)
                          for s in range(N_SHARDS)}
            fed._store[dead] = {sid: {
                "sid": sid, "tenant": "t", "kind": "batch", "rule": "B3/S23",
                "height": 16, "width": 16, "seed": 1, "density": 0.5,
                "shard": 3, "epoch": 5, "digest": "0" * 16, "slice": 3,
            }}
        seen, clients = [], []
        real = plane.begin_federation_promotion

        def racing_install(rows, *, origin):
            # A client's step on another thread, given 0.5 s to land
            # before the rows are installed.
            def client():
                try:
                    fed.router.step(sid, 1)
                except Exception as e:  # noqa: BLE001 — the outcome
                    seen.append(e)

            t = threading.Thread(target=client, daemon=True)
            t.start()
            clients.append(t)
            t.join(0.5)
            real(rows, origin=origin)

        plane.begin_federation_promotion = racing_install
        fed._confirm_dead(dead)
        clients[0].join(10)
        assert len(seen) == 1
        if pkg == "jax":
            assert isinstance(seen[0], KeyError)
        else:
            assert isinstance(seen[0], AdmissionError), seen
            assert seen[0].reason == "failover"
        assert sid in plane.sessions
    finally:
        fed.close()
        plane.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rehome_fallbacks_list_the_standby_first(pkg):
    """A frontend's workers re-home to the first fallback that answers, and
    only its standby adopts its slices.  The port lists the standby first;
    the JAX module lists the peers by name, which names another peer first
    here."""
    from akka_game_of_life_tpu_torch.serve.sessions import rendezvous_pick

    plane, fed = _plane_and_fed(pkg)
    try:
        peers = next(
            names for names in (
                [f"127.0.0.1:{7001 + i}", f"127.0.0.1:{7101 + i}"]
                for i in range(1000)
            )
            if rendezvous_pick(f"fe-standby:{fed.name}", names) != min(names)
        )
        for name in peers:
            _frames_of(fed, name)
        standby = rendezvous_pick(f"fe-standby:{fed.name}", peers)
        first = "%s:%d" % tuple(fed.worker_fallbacks()[0])
        assert sorted(
            "%s:%d" % tuple(a) for a in fed.worker_fallbacks()
        ) == sorted(peers)
        assert first == (min(peers) if pkg == "jax" else standby)
    finally:
        fed.close()
        plane.close()


def test_three_frontends_crash_rehomes_to_the_standby():
    """Three frontends: one dies with a replicated session.  Its worker
    re-homes to the dead frontend's standby, which adopts the slices, so a
    step through the third frontend is forwarded there and lands at a
    continuous epoch; after the grace no session is lost on any survivor.
    The victim is one whose peers' names sort the other way round from
    its standby where the fleet has one."""
    from akka_game_of_life_tpu_torch.serve.sessions import rendezvous_pick

    with federation(3) as (fes, workers, ports, seeds):
        def standby_of(fe):
            rest = [f.federation.name for f in fes if f is not fe]
            return rendezvous_pick(f"fe-standby:{fe.federation.name}", rest)

        d = next((fe for fe in fes if standby_of(fe) != min(
            f.federation.name for f in fes if f is not fe)), fes[0])
        s = next(fe for fe in fes if fe.federation.name == standby_of(d))
        t = next(fe for fe in fes if fe is not d and fe is not s)
        sid = _sid_owned_by(d.federation, d.federation.name, "tri")
        t.federation.router.create(sid=sid, height=24, width=24, seed=6)
        t.federation.router.step(sid, 3)
        _wait(lambda: s.federation.health()["replicated_rows_held"].get(
            d.federation.name, 0) >= 1, "the standby to hold the row")
        _crash(d)
        _wait(lambda: d.federation.name in s.federation.health()["dead"]
              and d.federation.name in t.federation.health()["dead"],
              "both survivors to confirm the death")
        assert _step_until_owned(t.federation.router, sid) == 4
        for fe in (s, t):
            fe.federation._expire_promotions(time.monotonic() + 3600.0)
        got = s.federation.router.get(sid)
        assert got["epoch"] == 4
        assert got["digest"] == oracle_digest("conway", (24, 24), 6, 4)
        assert workers[fes.index(d)].name in {
            m.name for m in s.membership.alive_members()
        }
        for fe in (s, t):
            snap = fe.metrics.snapshot()
            assert (snap.get("gol_serve_sessions_lost_total") or 0) == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_forwarded_ops_on_other_sessions_pass_a_slow_one(pkg):
    """The owner runs one origin's forwarded ops in order per session, and
    ops on different sessions side by side: a step on ``b`` is answered
    while a step on ``a`` from the same origin still waits for its worker.
    The JAX module runs them one at a time, so ``b`` waits behind ``a``
    (after a frontend's death, a survivor forwards a third of the keyspace
    at once and such queues outlast the forward timeout).  Two steps on
    ``a`` still land in their order."""
    plane, fed = _plane_and_fed(pkg)
    origin = "127.0.0.1:7001"
    try:
        rec = _frames_of(fed, origin)
        with fed._lock:
            fed.slices = {s: (fed.name, 1) for s in range(N_SHARDS)}
        release, order = threading.Event(), []

        def step(sid, steps=1):
            order.append((sid, steps))
            if sid == "a" and steps == 1:
                release.wait(10)
            return len(order), 0

        plane.step = step
        for rid, (sid, steps) in enumerate([("a", 1), ("a", 2), ("b", 1)], 1):
            fed._on_peer_msg(origin, {"type": "p_fwd_ops", "rid": rid, "call": "step",
                                      "kwargs": {"sid": sid, "steps": steps},
                                      "origin": origin})
        time.sleep(0.5)
        answered = sorted(f["rid"] for f in rec.frames if f.get("type") == "p_fwd_result")
        assert answered == ([] if pkg == "jax" else [3])
        release.set()
        _wait(lambda: len([f for f in rec.frames
                           if f.get("type") == "p_fwd_result"]) == 3, "every answer")
        assert [o for o in order if o[0] == "a"] == [("a", 1), ("a", 2)]
    finally:
        fed.close()
        plane.close()


# -- a mixed fleet ---------------------------------------------------------------


@pytest.mark.parametrize("dead", ["torch", "jax"])
def test_mixed_fleet_forwards_redirects_and_fails_over(dead):
    """One JAX frontend and one port frontend, each with a worker of its
    package: they converge, forward creates and steps both ways, redirect
    GETs both ways, and every digest is the oracle's.  Then the ``dead``
    package's frontend crashes: the other adopts its session with no 404,
    its worker re-homes across packages, and the epochs run on."""
    with federation(2, pkgs=["jax", "torch"]) as (fes, workers, ports, seeds):
        by = {"jax": fes[0], "torch": fes[1]}
        sids = {}
        for owner, via in (("jax", "torch"), ("torch", "jax")):
            o, v = by[owner], by[via]
            sid = _sid_owned_by(v.federation, o.federation.name, f"x{owner}")
            v.federation.router.create(sid=sid, height=24, width=24, seed=4)
            for _ in range(3):
                v.federation.router.step(sid, 2)  # forwarded to the owner
            with pytest.raises((FederationRedirect, j_fed.FederationRedirect)) as exc:
                v.federation.router.get(sid)
            assert exc.value.url == (
                f"http://127.0.0.1:{o._metrics_server.port}/boards/{sid}"
            )
            got = o.federation.router.get(sid)
            assert got["epoch"] == 6
            assert got["digest"] == oracle_digest("conway", (24, 24), 4, 6)
            sids[owner] = sid
        for fe in fes:
            assert fe.metrics.snapshot().get(
                "gol_frontend_forwarded_ops_total", 0) >= 4

        live = "jax" if dead == "torch" else "torch"
        a, b = by[live], by[dead]
        _wait(
            lambda: sum(
                a.federation.health()["replicated_rows_held"].values()
            ) >= 1,
            "control rows replicated to the standby",
        )
        _crash(b)
        _wait(lambda: b.federation.name in a.federation.health()["dead"],
              "the survivor to confirm the death")
        for owner, sid in sids.items():
            epoch = _step_until_owned(a.federation.router, sid)
            assert epoch == 7, (owner, epoch)
            got = a.federation.router.get(sid)
            assert got["digest"] == oracle_digest("conway", (24, 24), 4, 7)
        snap = a.metrics.snapshot()
        assert (snap.get("gol_serve_sessions_lost_total") or 0) == 0


# -- real processes ----------------------------------------------------------------


def _http_raw(port: int, method: str, path: str, doc=None, timeout=30):
    """One request, redirects not followed: (status, body, headers)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = json.dumps(doc).encode("utf-8") if doc is not None else None
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, json.loads(raw) if raw else {}, dict(resp.getheaders())
    finally:
        conn.close()


def _http(port: int, method: str, path: str, doc=None, timeout=30):
    status, body, _headers = _http_raw(port, method, path, doc, timeout)
    return status, body


def _child_env() -> dict:
    import os

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn_fe(i, cports, hports, seeds, env, logs):
    # The workers start once both frontends listen, and a loaded host can
    # take more than the default 5 s join window to import torch in them;
    # ``serve`` takes the window from its config file.
    toml = logs / "fe.toml"
    toml.write_text('wait_for_backends_s = "60s"\n')
    return subprocess.Popen(
        [sys.executable, "-m", "akka_game_of_life_tpu_torch", "serve",
         "--config", str(toml), "--serve-cluster", "on", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(cports[i]),
         "--metrics-port", str(hports[i]), "--min-backends", "1",
         "--serve-shards", str(N_SHARDS),
         "--frontend-seeds", seeds,
         "--frontend-gossip-interval-s", "0.2",
         "--frontend-gossip-timeout-s", "1.5",
         "--frontend-replicate-interval-s", "0.1"],
        stdout=open(logs / f"fe{i}.log", "w"),
        stderr=subprocess.STDOUT, env=env,
    )


def _spawn_worker(i, cports, env, logs):
    return subprocess.Popen(
        [sys.executable, "-m", "akka_game_of_life_tpu_torch", "backend",
         "--host", "127.0.0.1", "--port", str(cports[i]),
         "--name", f"pw{i}", "--device", "cpu"],
        stdout=open(logs / f"w{i}.log", "w"),
        stderr=subprocess.STDOUT, env=env,
    )


def _wait_cluster_port(port: int, proc, timeout=40):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            assert proc.poll() is None, "frontend process died while booting"
            time.sleep(0.1)
    raise AssertionError(f"cluster port {port} never listened")


def _wait_fed_ready(hport: int, n_peers: int, timeout=40):
    def ok():
        try:
            status, doc = _http(hport, "GET", "/healthz", timeout=5)
        except Exception:  # noqa: BLE001 — still booting
            return False
        fed = doc.get("federation") or {}
        return (
            status == 200
            and len(doc.get("serve", {}).get("shards_by_worker") or {}) >= 1
            and len(fed.get("peers") or {}) == n_peers
            and (fed.get("slices") or {}).get("unowned") == 0
        )

    _wait(ok, f"federated frontend :{hport} ready", timeout)


def test_kill9_frontend_zero_admitted_loss(tmp_path):
    """kill -9 one of two real frontend processes of the port under
    admitted load: every session answers 200 or a retryable 429
    (``failover`` / ``partitioned``), never 404 or 5xx; afterwards every
    session serves from the survivor with its epoch intact and its digest
    the oracle's, and the orphaned worker says it re-homed."""
    env = _child_env()
    cports = [_free_port() for _ in range(2)]
    hports = [_free_port() for _ in range(2)]
    seeds = ",".join(f"127.0.0.1:{p}" for p in cports)
    procs = []
    try:
        fes = [_spawn_fe(i, cports, hports, seeds, env, tmp_path)
               for i in range(2)]
        procs += fes
        for i in range(2):
            _wait_cluster_port(cports[i], fes[i])
        procs += [_spawn_worker(i, cports, env, tmp_path) for i in range(2)]
        for i in range(2):
            _wait_fed_ready(hports[i], 1)

        specs = []
        for i, hport in enumerate(hports):
            for j in range(3):
                seed = 10 * i + j
                status, doc = _http(
                    hport, "POST", "/boards",
                    {"rule": "conway", "height": 24, "width": 24, "seed": seed},
                )
                assert status in (200, 201), (status, doc)
                specs.append((doc["id"], seed, i))
        issued = {}
        for sid, _, i in specs:
            status, doc = _http(
                hports[i], "POST", f"/boards/{sid}/step", {"steps": 2}
            )
            assert status == 200, (status, doc)
            issued[sid] = doc["epoch"]

        survivor = hports[1]
        _wait(lambda: sum(
            (_http(survivor, "GET", "/healthz")[1]["federation"]
             ["replicated_rows_held"]).values()) >= 3,
            "the survivor to hold the victim's rows", 10)
        fes[0].send_signal(signal.SIGKILL)
        fes[0].wait(timeout=10)

        deadline = time.monotonic() + 30
        for sid, _, _ in specs:
            while True:
                status, doc = _http(
                    survivor, "POST", f"/boards/{sid}/step", {"steps": 1}
                )
                if status == 200:
                    issued[sid] = doc["epoch"]
                    break
                assert status == 429, (
                    f"{sid}: {status} {doc}: the never-404 contract broke"
                )
                assert doc.get("reason") in RETRYABLE, doc
                assert time.monotonic() < deadline, "failover never healed"
                time.sleep(0.1)

        for sid, seed, _ in specs:
            status, doc = _http(survivor, "GET", f"/boards/{sid}")
            assert status == 200, (sid, status, doc)
            assert doc["epoch"] == issued[sid] == 3, (sid, doc["epoch"])
            assert doc["digest"] == oracle_digest(
                "conway", (24, 24), seed, issued[sid]
            ), sid
        status, health = _http(survivor, "GET", "/healthz")
        fed = health["federation"]
        assert fed["slices"]["unowned"] == 0
        assert fed["slices"]["owned"] == fed["slices"]["total"]
        assert "re-homed control channel" in (tmp_path / "w0.log").read_text()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait(timeout=15)
