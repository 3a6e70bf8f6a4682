"""The port's session replication and crash failover: a killed worker loses
zero boards.

Counterpart of ``tests/test_serve_replication.py``: a real in-process
serve-only frontend plus ``BackendWorker`` threads (the port's on
``device="cpu"``), promoted sessions certified against the numpy oracle by
digest.  The deterministic windows (a promotion held open, a migration
frozen mid-protocol) come from holding a worker plane's lock so its
executor cannot run: the worker stays alive, heartbeats beating, while its
serve frames queue.  Every wait has its own timeout.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_serve_cluster import (
    PKGS,
    board_digest,
    oracle,
    oracle_digest,
    serve_cluster,
    wait_spread,
    wait_until,
)
from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
from akka_game_of_life_tpu.runtime.rebalance import Rebalancer as JRebalancer
from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.runtime.config import (
    NetworkChaosConfig,
    SimulationConfig,
)
from akka_game_of_life_tpu_torch.runtime.rebalance import Rebalancer
from akka_game_of_life_tpu_torch.serve.sessions import AdmissionError


def repl_cluster(n_workers, **cfg_kw):
    """A serve-only cluster with a fast replication cadence (the tests wait
    on real acks)."""
    cfg_kw.setdefault("serve_shards", 8)
    cfg_kw.setdefault("serve_replicate_interval_s", 0.05)
    cfg_kw.setdefault("serve_replicate_every", 1)
    return serve_cluster(n_workers, spread=False, **cfg_kw)


def _worker(workers, name):
    return next(w for w in workers if w.name == name)


def _wait_replicated(fe, timeout=20.0):
    """Until every indexed batch session's updates are acked by its shard's
    replica (the frontend's watermark is clean)."""

    def clean():
        plane = fe.serve_plane
        with plane._lock:
            return all(
                e.repl_dirty_since is None
                for e in plane.sessions.values()
                if e.shard is not None
            ) and any(r is not None for r in plane.shard_replica.values())

    wait_until(clean, timeout, "replication to converge")


def _promoted(fe, alive):
    """The loss has landed and every promotion it started has finished:
    ``alive`` members, none in flight, and no shard still owned by a dead
    member (the frontend marks a member dead before the plane's hook
    runs, so the first two alone can hold before any promotion began)."""
    plane = fe.serve_plane
    live = {m.name for m in fe.membership.alive_members()}
    with plane._lock:
        settled = all(o is None or o in live for o in plane.shard_owner.values())
    return (
        settled
        and fe._health()["serve"]["replication"]["promotions_inflight"] == 0
        and len(live) == alive
    )


# -- the surface -------------------------------------------------------------------


def _plane_metrics(pkg):
    """The metric families a registry holds once a ClusterServePlane is
    built on it (the catalog's and the plane's own)."""
    import importlib

    p = PKGS[pkg]
    root = "akka_game_of_life_tpu_torch" if pkg == "torch" else "akka_game_of_life_tpu"
    cluster = importlib.import_module(f"{root}.serve.cluster")
    membership = importlib.import_module(f"{root}.runtime.membership")
    registry = p.registry()
    plane = cluster.ClusterServePlane(
        p.Config(role="serve", serve_cluster=True, flight_dir=""),
        membership.Membership(5.0), lambda member, msg: None,
        registry=registry, tracer=p.Tracer(node="surface"),
    )
    try:
        plane.poll(0.0)
        return sorted(n for n in registry.names() if n.startswith("gol_serve_"))
    finally:
        plane.close()


def test_serve_replicate_surface_matches_reference():
    """The plane registers the JAX package's replication metrics (and every
    other family), by name, so one dashboard reads either frontend."""
    got = _plane_metrics("torch")
    assert got == _plane_metrics("jax")
    for name in ("gol_serve_promotions_total", "gol_serve_single_copy_shards",
                 "gol_serve_sessions_lost_total", "gol_serve_replica_bytes_total"):
        assert name in got, name


def test_replicate_config_validation():
    for key in ("serve_replicate_every", "serve_replicate_interval_s",
                "serve_replicate_max_lag_s"):
        with pytest.raises(ValueError) as got:
            SimulationConfig(**{key: 0})
        with pytest.raises(ValueError) as want:
            JConfig(**{key: 0})
        assert str(got.value) == str(want.value)


# -- planner unit: the placement constraint ----------------------------------------


class _M:
    def __init__(self, name, draining=False):
        self.name = name
        self.alive = True
        self.draining = draining
        self.tiles = []


def test_plan_shards_avoids_replica_dest_but_never_wedges_a_drain():
    def plan(owners, weights, members, replicas):
        got = Rebalancer(SimulationConfig(rebalance_max_inflight=8)).plan_shards(
            owners, weights, members(), now=1e9, replicas=replicas,
        )
        want = JRebalancer(JConfig(rebalance_max_inflight=8)).plan_shards(
            owners, weights, members(), now=1e9, replicas=replicas,
        )
        assert got == want
        return got

    # Spread: shard 0's replica is the least-loaded member, yet another
    # destination exists, so nothing co-locates with its replica.
    moves = plan({s: "a" for s in range(6)}, {},
                 lambda: [_M("a"), _M("b"), _M("c")], {s: "b" for s in range(6)})
    assert moves and all(dest == "c" for _, _, dest in moves)
    # Drain on two workers: the replica IS the only destination and the
    # move still happens (the plane re-homes the replica at commit).
    assert plan({0: "a"}, {0: 2}, lambda: [_M("a", draining=True), _M("b")],
                {0: "b"}) == [(0, "a", "b")]


def test_late_joiners_spread_past_the_sticky_replicas():
    """Two workers join a one-worker cluster before the planner's next
    pass: the first joiner becomes the replica of every (still empty)
    shard, and the planner avoids a shard's replica as its destination.
    Empty shards take their rendezvous replica afresh, so the table still
    spreads over all three workers instead of stalling at 32/32/0."""
    with repl_cluster(1, serve_shards=64) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        wait_until(
            lambda: fe._health()["serve"]["shards_by_worker"] == {"w0": 64},
            15, "w0 to own the table",
        )
        with plane._lock:
            plane.rebalancer._next_shard_plan_at = float("inf")
        for name, alive in (("w1", 2), ("w2", 3)):
            fe.add_serve_worker(name)
            wait_until(
                lambda alive=alive: len(fe.membership.alive_members()) == alive,
                15, f"{name} to join",
            )
        with plane._lock:
            plane.rebalancer._next_shard_plan_at = 0.0
        wait_spread(fe, 3)


# -- the stream: watermarks, standby, lag ------------------------------------------


def test_replication_streams_standby_and_watermarks():
    with repl_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        specs = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(8)
        ]
        for sid in specs:
            plane.step(sid, 3)
        _wait_replicated(fe)
        # Standby payloads live worker-side, outside the router tables.
        standby = {
            sid: pay
            for w in workers
            for store in w.serve_plane._standby.values()
            for sid, pay in store.items()
        }
        assert set(standby) == set(specs)
        for i, sid in enumerate(specs):
            assert int(standby[sid]["epoch"]) == 3
            lanes = odigest.digest_payload_np(standby[sid]["state"], (0, 0), 16)
            assert odigest.format_digest(odigest.value(lanes)) == (
                oracle_digest("conway", (16, 16), i, 3)
            )
        assert (registry.snapshot().get("gol_serve_replica_bytes_total") or 0) > 0
        doc = fe._health()["serve"]["replication"]
        assert doc["enabled"] is True
        assert doc["single_copy_shards"] == 0
        assert doc["promotions_inflight"] == 0
        assert sum(doc["replicas_by_worker"].values()) == sum(
            1 for o in plane.shard_owner.values() if o is not None
        )
        with plane._lock:
            for shard, repl in plane.shard_replica.items():
                if repl is not None:
                    assert repl != plane.shard_owner.get(shard)


def test_failover_promotes_with_zero_board_loss():
    """Kill a worker: every session survives at its replicated epoch,
    digest-certified against the oracle, and keeps serving."""
    with repl_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        specs = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(10)
        ]
        for sid in specs:
            plane.step(sid, 4)
        _wait_replicated(fe)
        victim = workers[0]
        assert any(e["worker"] == victim.name for e in plane.list())
        victim.channel.close()  # abrupt death: no drain, no goodbye
        wait_until(lambda: _promoted(fe, 1), 20, "the promotion")
        assert {e["id"] for e in plane.list()} == set(specs)
        for i, sid in enumerate(specs):
            doc = plane.get(sid)
            assert doc["epoch"] == 4
            assert doc["digest"] == oracle_digest("conway", (16, 16), i, 4)
            epoch, digest = plane.step(sid, 1)
            assert epoch == 5
            assert odigest.format_digest(digest) == oracle_digest("conway", (16, 16), i, 5)
        snap = registry.snapshot()
        assert (snap.get("gol_serve_promotions_total") or 0) >= 1
        assert (snap.get("gol_serve_sessions_lost_total") or 0) == 0


def test_promotion_window_answers_429_failover_not_404():
    """Ops on a shard whose promotion is in flight answer the retryable 429
    ``failover`` (GET, DELETE and the step that was in flight on the dead
    worker), never 404; the window is held open by blocking the replica's
    executor."""
    with repl_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sids = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(8)
        ]
        for sid in sids:
            plane.step(sid, 2)
        _wait_replicated(fe)
        with plane._lock:
            sid, entry = next(
                (s, e) for s, e in plane.sessions.items()
                if plane.shard_replica.get(e.shard) is not None
            )
            shard = entry.shard
            pw = _worker(workers, plane.shard_owner[shard])
            rw = _worker(workers, plane.shard_replica[shard])
        pw.serve_plane._lock.acquire()
        rw.serve_plane._lock.acquire()
        released = False
        try:
            step_err = {}

            def stepper():
                try:
                    plane.step(sid, 1)
                    step_err["e"] = None
                except BaseException as e:  # noqa: BLE001 — asserted below
                    step_err["e"] = e

            t = threading.Thread(target=stepper)
            t.start()

            def step_pending():
                with plane._lock:
                    return any(
                        p.sid == sid and p.kind == "step" for p in plane._pending.values()
                    )

            wait_until(step_pending, 20, "the step to be pending")
            pw.channel.close()  # the primary dies with the step in flight
            wait_until(lambda: shard in plane._promoting, 20, "the promotion to start")
            t.join(20)
            assert not t.is_alive()
            assert isinstance(step_err["e"], AdmissionError)
            assert step_err["e"].reason == "failover"
            for op in (lambda: plane.get(sid), lambda: plane.delete(sid)):
                with pytest.raises(AdmissionError) as exc:
                    op()
                assert exc.value.reason == "failover"
            # Through HTTP: the same contract, with a retry hint.
            port = fe._metrics_server.port
            with pytest.raises(urllib.error.HTTPError) as http:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/boards/{sid}", timeout=10)
            assert http.value.code == 429
            body = json.loads(http.value.read())
            assert body["reason"] == "failover" and "retry_after_s" in body
            rw.serve_plane._lock.release()
            released = True
            wait_until(lambda: shard not in plane._promoting, 20, "the promotion to end")
            doc = plane.get(sid)
            assert doc["epoch"] == 2
            assert doc["digest"] == oracle_digest("conway", (16, 16), sids.index(sid), 2)
        finally:
            if not released:
                rw.serve_plane._lock.release()
            pw.serve_plane._lock.release()


def test_every_promoting_shard_answers_failover():
    """Every shard of a dead primary answers 429 ``failover`` while its
    promotion is in flight, the last one promoted included: the routing
    snapshot must mark a shard as promoting in the same step that hands
    it to the replica, or an op takes the fast path to the replica ahead
    of the promote and answers 404 for a board that survives."""
    with repl_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sids = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(24)
        ]
        for sid in sids:
            plane.step(sid, 2)
        _wait_replicated(fe)
        victim, survivor = workers
        with plane._lock:
            owned = {
                e.shard: sid for sid, e in plane.sessions.items()
                if plane.shard_owner.get(e.shard) == victim.name
            }
        assert len(owned) >= 2
        survivor.serve_plane._lock.acquire()  # the promotes cannot run
        try:
            victim.channel.close()
            wait_until(
                lambda: set(owned) <= set(plane._promoting), 20,
                "every promotion to start",
            )
            assert set(owned) <= plane._routes[1]
            answers = {}

            def reader(shard, sid):
                try:
                    plane.get(sid)
                    answers[shard] = "200"
                except BaseException as e:  # noqa: BLE001 — asserted below
                    answers[shard] = getattr(e, "reason", repr(e))

            readers = [
                threading.Thread(target=reader, args=item, daemon=True)
                for item in owned.items()
            ]
            for t in readers:
                t.start()
            for t in readers:
                t.join(10)
            assert answers == {shard: "failover" for shard in owned}
        finally:
            survivor.serve_plane._lock.release()
        wait_until(lambda: _promoted(fe, 1), 20, "the promotions")
        for i, sid in enumerate(sids):
            doc = plane.get(sid)
            assert doc["epoch"] == 2
            assert doc["digest"] == oracle_digest("conway", (16, 16), i, 2)


def test_op_to_a_dead_primary_answers_failover_before_its_loss_lands():
    """The flusher can find a worker dead before the frontend has run the
    plane's member-loss hook: an op it holds for a shard the replica will
    promote answers the retryable 429 ``failover`` (never a 503), and the
    board resumes at its replicated epoch once the hook runs."""
    with repl_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sids = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(8)
        ]
        for sid in sids:
            plane.step(sid, 2)
        _wait_replicated(fe)
        victim = workers[0]
        with plane._lock:
            i, sid = next(
                (i, s) for i, s in enumerate(sids)
                if plane.shard_owner.get(plane.sessions[s].shard) == victim.name
            )
        assert fe.membership.mark_dead(victim.name) is not None
        with pytest.raises(AdmissionError) as exc:
            plane.step(sid, 1)
        assert exc.value.reason == "failover"
        plane.on_member_lost(victim.name)
        wait_until(
            lambda: fe._health()["serve"]["replication"]["promotions_inflight"] == 0,
            20, "the promotions",
        )
        doc = plane.get(sid)
        assert doc["epoch"] == 2
        assert doc["digest"] == oracle_digest("conway", (16, 16), i, 2)


def test_lossy_replication_stream_retransmits_to_exact_convergence(monkeypatch):
    """Drops on the control plane: replication frames vanish at random,
    watermarks advance only on real acks, and the retransmit pass converges
    the replica exactly once traffic stops; a clean kill then proves the
    converged copy by promoting it."""
    from akka_game_of_life_tpu_torch.serve import cluster as scluster

    monkeypatch.setattr(scluster, "JOB_TIMEOUT_S", 2.0)
    monkeypatch.setattr(scluster, "JOB_GRACE_S", 1.0)
    chaos = NetworkChaosConfig(enabled=True, seed=7, drop_p=0.15, scope="control")
    with repl_cluster(2, net_chaos=chaos) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        specs = []
        for i in range(6):
            doc = None
            for _ in range(40):  # retry like a real client until admitted
                try:
                    doc = plane.create(height=16, width=16, seed=i, with_board=False)
                    break
                except (TimeoutError, AdmissionError):
                    continue
            assert doc is not None, "create never survived the chaos"
            specs.append(doc["id"])
        for sid in specs:
            done = tries = 0
            while done < 3 and tries < 60:
                tries += 1
                try:
                    plane.step(sid, 1)
                    done += 1
                except (TimeoutError, AdmissionError):
                    # A timed-out step may still apply: the checks below
                    # anchor on the served epoch.
                    continue
            assert done == 3
        assert (registry.snapshot().get("gol_net_chaos_dropped_total") or 0) > 0
        _wait_replicated(fe, timeout=60)
        fe.netchaos.config.drop_p = 0.0
        workers[0].channel.close()
        wait_until(lambda: _promoted(fe, 1), 30, "the promotion")
        assert {e["id"] for e in plane.list()} == set(specs)
        for i, sid in enumerate(specs):
            doc = plane.get(sid)
            assert doc["epoch"] >= 3  # every acknowledged step landed
            assert doc["digest"] == oracle_digest("conway", (16, 16), i, doc["epoch"])
        assert (registry.snapshot().get("gol_serve_sessions_lost_total") or 0) == 0


def _get_through_failover(plane, sid, timeout=20.0):
    """GET, retrying the failover window out like a real client."""
    got = {}

    def answered():
        try:
            got["doc"] = plane.get(sid)
            return True
        except AdmissionError as e:
            assert e.reason == "failover"
            return False

    wait_until(answered, timeout, f"{sid} to answer")
    return got["doc"]


def test_promotion_racing_shard_migration_is_safe():
    """A primary dying mid-shard-migration still promotes: its executor is
    blocked so the drain's prepares queue unrun, it dies, the aborts run,
    and the sessions come back from the replica, not a 404."""
    with repl_cluster(3) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        specs = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(12)
        ]
        for sid in specs:
            plane.step(sid, 2)
        _wait_replicated(fe)
        victim = next(w for w in workers if any(e["worker"] == w.name for e in plane.list()))
        victim.serve_plane._lock.acquire()
        try:
            assert victim.request_drain()
            wait_until(
                lambda: any(m.source == victim.name for m in plane.rebalancer.inflight.values()),
                20, "a shard migration to start",
            )
        finally:
            victim.serve_plane._lock.release()
        victim.channel.close()
        wait_until(
            lambda: _promoted(fe, 2) and not plane.rebalancer.inflight,
            30, "migrations and promotions to settle",
        )
        assert {e["id"] for e in plane.list()} == set(specs)
        for i, sid in enumerate(specs):
            doc = _get_through_failover(plane, sid)
            assert doc["epoch"] == 2
            assert doc["digest"] == oracle_digest("conway", (16, 16), i, 2)
        assert (registry.snapshot().get("gol_serve_sessions_lost_total") or 0) == 0


def test_double_failure_loses_honestly_with_counter():
    """Primary and replica both die: the shard's sessions are lost, 404
    with ``gol_serve_sessions_lost_total`` ticking, never a hang."""
    with repl_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sids = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(8)
        ]
        for sid in sids:
            plane.step(sid, 2)
        _wait_replicated(fe)
        w0, w1 = workers
        w1.serve_plane._lock.acquire()
        try:
            w0.channel.close()
            wait_until(lambda: bool(plane._promoting), 20, "the promotion to start")
            w1.channel.close()
            wait_until(
                lambda: not plane._promoting and not fe.membership.alive_members(),
                20, "the double failure to settle",
            )
        finally:
            w1.serve_plane._lock.release()
        assert (registry.snapshot().get("gol_serve_sessions_lost_total") or 0) >= 1
        lost = [s for s in sids if s not in {e["id"] for e in plane.list()}]
        assert lost
        for sid in lost[:3]:
            with pytest.raises(KeyError):
                plane.get(sid)


def test_single_copy_degradation_and_recovery():
    """One worker: the plane reports single-copy shards (gauge and
    /healthz) and the primary parks its stream; a second worker joining
    assigns replicas, resets the park and fills the standby."""
    with repl_cluster(1) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sids = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(6)
        ]
        for sid in sids:
            plane.step(sid, 2)
        owned = sum(1 for o in plane.shard_owner.values() if o is not None)
        wait_until(
            lambda: fe._health()["serve"]["replication"]["single_copy_shards"] == owned,
            20, "single-copy mode",
        )
        assert registry.snapshot().get("gol_serve_single_copy_shards") == float(owned)
        wait_until(lambda: bool(workers[0].serve_plane._repl_parked), 20, "the park")
        fe.add_serve_worker("late")
        wait_until(
            lambda: fe._health()["serve"]["replication"]["single_copy_shards"] == 0,
            20, "replicas after the join",
        )
        _wait_replicated(fe)
        standby = {
            sid
            for w in workers
            for store in w.serve_plane._standby.values()
            for sid in store
        }
        assert standby == set(sids)


def test_deleted_session_never_resurrects_at_promotion():
    """DELETE drops the replica's standby copy; a later promotion must not
    bring the deleted board back."""
    with repl_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sids = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(8)
        ]
        for sid in sids:
            plane.step(sid, 2)
        _wait_replicated(fe)
        doomed = sids[0]
        plane.delete(doomed)
        wait_until(
            lambda: all(
                doomed not in store
                for w in workers
                for store in w.serve_plane._standby.values()
            ),
            20, "the standby copy to retire",
        )
        workers[0].channel.close()
        wait_until(lambda: _promoted(fe, 1), 20, "the promotion")
        live = {e["id"] for e in plane.list()}
        assert doomed not in live
        assert live == set(sids[1:])


def test_tiled_resident_worker_kill_resumes_at_certified_epoch():
    """Kill a worker holding resident mega-board chunks mid-traffic: the
    lost chunks come back from replica snapshots (digest-certified), the
    survivors roll back to the same barrier, the session resumes at its
    certified epoch, and every op in the window answers retryably (zero
    404s)."""
    with repl_cluster(3, serve_size_classes="16,32",
                      serve_tiled_resident_snapshot=1) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sid = plane.create(rule="conway", height=64, width=64, seed=13,
                           with_board=False)["id"]
        t = plane.tiled[sid]
        assert len(set(t.owner.values())) == 3
        epoch, _ = plane.step(sid, 3 * t.k)

        def certified_to(e):
            with plane._lock:
                return t.certified() == e

        wait_until(lambda: certified_to(epoch), 20, "the tiled snapshots' acks")
        stop = threading.Event()
        not_found, retried, served = [], [], []

        def pump():
            while not stop.is_set():
                try:
                    served.append(plane.step(sid, t.k)[0])
                except KeyError as e:
                    not_found.append(repr(e))  # the one forbidden answer
                except AdmissionError as e:
                    retried.append(e.reason)  # retryable: the contract
                except Exception:  # noqa: BLE001 — timeouts are retryable
                    retried.append("timeout")

        pumps = [threading.Thread(target=pump, daemon=True) for _ in range(3)]
        for th in pumps:
            th.start()
        wait_until(lambda: len(served) >= 3, 20, "steps before the kill")
        workers[0].channel.close()  # SIGKILL-shaped: no drain, no goodbye
        wait_until(
            lambda: fe._health()["serve"]["tiled_resident"]["promotions_inflight"] == 0
            and len(fe.membership.alive_members()) == 2 and not t.promoting,
            30, "the tiled promotion",
        )
        seen = len(served)
        wait_until(lambda: len(served) >= seen + 3, 30, "steps after the promotion")
        stop.set()
        for th in pumps:
            th.join(30)
        assert not not_found, not_found[:3]
        assert sid in {e["id"] for e in plane.list()}
        doc = plane.get(sid)
        assert np.array_equal(doc["board"], oracle("conway", (64, 64), 13, doc["epoch"]))
        epoch2, digest2 = plane.step(sid, t.k)
        assert odigest.format_digest(digest2) == board_digest(
            oracle("conway", (64, 64), 13, epoch2)
        )
        snap = registry.snapshot()
        assert (snap.get("gol_serve_promotions_total") or 0) >= 1
        assert (snap.get("gol_serve_sessions_lost_total") or 0) == 0
