"""The port's serving cluster: shard routing, elastic shard migration,
failure paths and tiled mega-board sessions, against the JAX package's.

Counterpart of ``tests/test_serve_cluster.py``.  Every cluster case runs a
real in-process serve-only frontend plus ``BackendWorker`` threads speaking
the wire protocol (``serve --serve-cluster on``'s stack), the port's on
``device="cpu"``.  Deterministic scripts run through both packages'
clusters and their transcripts must be equal; every end state is held
against the numpy oracle by digest (bit-identical).  The mixed cases route
one cluster's sessions across a port worker and a JAX worker.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

from _torch_serve_cluster import (
    board_digest,
    oracle,
    oracle_digest,
    serve_cluster,
    step_to,
    wait_until,
)
from akka_game_of_life_tpu.runtime import protocol as jP
from akka_game_of_life_tpu.runtime.rebalance import Rebalancer as JRebalancer
from akka_game_of_life_tpu.serve import worker as jworker
from akka_game_of_life_tpu.serve.cluster import shard_of as j_shard_of
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.obs.catalog import install
from akka_game_of_life_tpu_torch.obs.metrics import MetricsRegistry
from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.runtime import protocol as P
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.rebalance import Rebalancer
from akka_game_of_life_tpu_torch.serve import worker as tworker
from akka_game_of_life_tpu_torch.serve.cluster import shard_of
from akka_game_of_life_tpu_torch.serve.sessions import AdmissionError, SessionRouter


# -- the wire and config surface -------------------------------------------------


def test_serve_wire_surface_matches_reference():
    """The frames, the WELCOME policy keys and the serve config keys are the
    JAX package's, and every ``--serve-*`` flag of the port's ``serve`` and
    ``frontend`` maps onto a ``serve_*`` key (a cluster may mix packages)."""
    frames = ("SERVE_OPS", "SERVE_RESULT", "SHARD_PREPARE", "SHARD_STATE",
              "SHARD_COMMIT", "SHARD_ABORT", "SHARD_REPLICATE",
              "SHARD_REPLICATE_ACK", "TILED_HALO", "TILED_HALO_ACK", "SHARD_HOME")
    assert {f: getattr(P, f) for f in frames} == {f: getattr(jP, f) for f in frames}
    assert tworker.SERVE_POLICY_KEYS == jworker.SERVE_POLICY_KEYS
    from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig

    t_serve = {f.name: f.default for f in dataclasses.fields(SimulationConfig)
               if f.name.startswith("serve_")}
    j_serve = {f.name: f.default for f in dataclasses.fields(JConfig)
               if f.name.startswith("serve_")}
    assert t_serve == j_serve
    assert tworker.serve_policy(SimulationConfig()) == jworker.serve_policy(JConfig())
    for role in ("serve", "frontend"):
        parser = next(
            a for a in tcli_parser()._actions if a.dest == "command"
        ).choices[role]
        flags = {o[len("--serve-"):].replace("-", "_")
                 for o in parser._option_string_actions if o.startswith("--serve-")}
        assert {"serve_" + f for f in flags} == set(t_serve), role


def tcli_parser():
    import argparse

    captured = {}

    def stop(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = stop
    try:
        with pytest.raises(SystemExit):
            tcli.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["parser"]


def test_shard_hash_stable_and_bounded():
    assert shard_of("s00000001", 64) == shard_of("s00000001", 64)
    seen = {shard_of(f"s{i:08x}", 16) for i in range(256)}
    assert seen <= set(range(16))
    assert len(seen) > 8  # spreads, not clumps
    # The JAX package's hash: a mixed cluster routes every id alike.
    assert all(
        shard_of(f"s{i:08x}", n) == j_shard_of(f"s{i:08x}", n)
        for i in range(256) for n in (16, 64)
    )


# -- planner units ---------------------------------------------------------------


class _M:
    def __init__(self, name, draining=False):
        self.name = name
        self.alive = True
        self.draining = draining
        self.tiles = []


def _plans(owners, weights, members, **kw):
    """The port's plan and the JAX planner's on the same input."""
    from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig

    got = Rebalancer(SimulationConfig(**kw)).plan_shards(
        owners, weights, members(), now=1e9
    )
    want = JRebalancer(JConfig(**kw)).plan_shards(owners, weights, members(), now=1e9)
    assert got == want
    return got


def test_plan_shards_spreads_empties_budget_free():
    moves = _plans({s: "a" for s in range(16)}, {}, lambda: [_M("a"), _M("b")],
                   rebalance_max_inflight=1)
    assert {d for _, _, d in moves} == {"b"} and len(moves) == 8


def test_plan_shards_drain_first_and_loaded_budget_bound():
    moves = _plans(
        {0: "a", 1: "a", 2: "b", 3: "b"}, {0: 3, 1: 0, 2: 1, 3: 1},
        lambda: [_M("a", draining=True), _M("b")], rebalance_max_inflight=1,
    )
    # The empty shard flips free first; the loaded one is charged against
    # the in-flight budget of 1.
    assert [(s, src, d) for s, src, d in moves] == [(1, "a", "b"), (0, "a", "b")]


def test_plan_shards_gap_floor_no_ping_pong():
    assert _plans({0: "a", 1: "a", 2: "b"}, {}, lambda: [_M("a"), _M("b")],
                  rebalance_max_inflight=4) == []


# -- end to end: routing and certification ---------------------------------------

_RULES = ("conway", "highlife", "brians-brain")


def _roundtrip(pkg):
    """Create nine sessions over three rules, step each 4 epochs, read one
    back and delete it: the transcript both packages must produce."""
    out = []
    with serve_cluster(2, pkg=pkg) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        specs = []
        for i in range(9):
            doc = plane.create(
                tenant=f"t{i % 2}", rule=_RULES[i % 3], height=18 + i,
                width=16, seed=i, with_board=False,
            )
            specs.append((doc["id"], _RULES[i % 3], (18 + i, 16), i))
        for sid, rule, shape, seed in specs:
            epoch, digest = plane.step(sid, 4)
            out.append((sid, epoch, odigest.format_digest(digest)))
            assert odigest.format_digest(digest) == oracle_digest(rule, shape, seed, 4)
        doc = plane.get(specs[0][0])
        assert doc["board"].shape == specs[0][2]
        out.append(board_digest(doc["board"]))
        assert {e["worker"] for e in plane.list()} <= {"w0", "w1"}
        plane.delete(specs[0][0])
        with pytest.raises(KeyError):
            plane.get(specs[0][0])
        out.append(sorted(e["id"] for e in plane.list()))
    return out


def test_cluster_roundtrip_vs_oracle():
    assert _roundtrip("torch") == _roundtrip("jax")


def test_cluster_admission_budget_and_healthz():
    with serve_cluster(2, serve_max_sessions=4, serve_max_cells=870) as (
        fe, workers, threads, registry,
    ):
        plane = fe.serve_plane
        for i in range(3):
            plane.create(height=16, width=16, seed=i, with_board=False)
        # The cell budget refuses before the session cap does.
        with pytest.raises(AdmissionError) as e:
            plane.create(height=30, width=30, with_board=False)
        assert e.value.reason == "max_cells"
        plane.create(height=8, width=8, with_board=False)
        with pytest.raises(AdmissionError) as e:
            plane.create(height=8, width=8, with_board=False)
        assert e.value.reason == "max_sessions"
        doc = fe._health()["serve"]
        assert doc["sessions"] == 4
        assert set(doc) >= {
            "shards_by_worker", "sessions_by_worker",
            "queue_depth_by_worker", "shard_migrations_inflight",
        }
        assert sum(doc["shards_by_worker"].values()) == 16


def test_late_join_starts_receiving_shards():
    with serve_cluster(1) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        specs = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(12)
        ]
        # The late joiner gets shards: empties flip at once, loaded shards
        # migrate digest-certified.
        fe.add_serve_worker("late")
        wait_until(
            lambda: fe._health()["serve"]["shards_by_worker"].get("late", 0) >= 6,
            what="shards on the late joiner",
        )
        for i, sid in enumerate(specs):
            epoch, digest = plane.step(sid, 3)
            assert epoch == 3
            assert odigest.format_digest(digest) == oracle_digest("conway", (16, 16), i, 3)


def _load(plane, specs, stop, issued, errors, lock, k):
    i = 0
    while not stop.is_set():
        sid = specs[(k + i) % len(specs)]
        try:
            plane.step(sid, 1)
            with lock:
                issued[sid] += 1
        except Exception as e:  # noqa: BLE001 — asserted by the caller
            with lock:
                errors.append((sid, repr(e)))
        i += 1


def test_drain_zero_admitted_loss_mid_traffic():
    with serve_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        specs = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(16)
        ]
        issued = {sid: 0 for sid in specs}
        errors, lock, stop = [], threading.Lock(), threading.Event()
        pool = [
            threading.Thread(target=_load, args=(plane, specs, stop, issued, errors, lock, k))
            for k in range(3)
        ]
        for t in pool:
            t.start()
        wait_until(lambda: sum(issued.values()) >= 30, what="traffic before the drain")
        assert workers[0].request_drain()
        threads[0].join(30)
        assert not threads[0].is_alive()
        done = sum(issued.values())
        wait_until(lambda: sum(issued.values()) >= done + 30, what="traffic after the drain")
        stop.set()
        for t in pool:
            t.join(30)
        assert workers[0].stopped_reason == "drained"
        assert not errors, errors[:3]
        assert fe._health()["serve"]["sessions_by_worker"] == {"w1": 16}
        for i, sid in enumerate(specs):
            got = plane.get(sid)
            assert got["epoch"] == issued[sid]
            assert got["digest"] == oracle_digest("conway", (16, 16), i, issued[sid])
        assert registry.snapshot().get("gol_serve_shard_migrations_total") >= 1


def test_worker_crash_answers_never_hangs():
    # serve_replicate off: the honest-loss contract of the single-copy
    # plane (the replicated failover is tests/test_torch_serve_replication.py).
    with serve_cluster(2, serve_replicate=False) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        specs = [
            plane.create(height=16, width=16, seed=i, with_board=False)["id"]
            for i in range(12)
        ]
        outcomes, lock, stop = [], threading.Lock(), threading.Event()

        def loader(k):
            i = 0
            while not stop.is_set():
                sid = specs[(k + i) % len(specs)]
                try:
                    plane.step(sid, 1)
                    with lock:
                        outcomes.append("ok")
                except BaseException as e:  # noqa: BLE001
                    with lock:
                        outcomes.append(type(e).__name__)
                i += 1

        pool = [threading.Thread(target=loader, args=(k,)) for k in range(3)]
        for t in pool:
            t.start()
        wait_until(lambda: len(outcomes) >= 30, what="traffic before the crash")
        workers[1].channel.close()  # abrupt death, mid-traffic
        wait_until(lambda: len(fe.membership.alive_members()) == 1, what="the loss")
        seen = len(outcomes)
        wait_until(lambda: len(outcomes) >= seen + 30, what="answers after the crash")
        stop.set()
        for t in pool:
            t.join(20)
        assert not any(t.is_alive() for t in pool), (
            "a step hung across the crash instead of answering"
        )
        live = {e["id"] for e in plane.list()}
        lost = [sid for sid in specs if sid not in live]
        kept = [sid for sid in specs if sid in live]
        assert lost and kept  # both workers held sessions
        for sid in kept[:3]:
            plane.step(sid, 1)
        for sid in lost[:3]:
            with pytest.raises(KeyError):
                plane.step(sid, 1)
        snap = registry.snapshot()
        assert snap.get('gol_serve_shards{member="w1"}') == 0.0
        assert snap.get('gol_serve_shard_sessions{member="w1"}') == 0.0
        assert snap.get('gol_serve_worker_queue_depth{member="w1"}') == 0.0


# -- tiled (mega-board) sessions ------------------------------------------------


def _mega(pkg):
    with serve_cluster(2, pkg=pkg, serve_size_classes="16,32") as (
        fe, workers, threads, registry,
    ):
        plane = fe.serve_plane
        # 72x40 over 32-sided tiles: a 3x2 grid with ragged edges.
        doc = plane.create(rule="conway", height=72, width=40, seed=7, with_board=False)
        sid = doc["id"]
        assert doc["kind"] == "tiled" and doc["tiles"] == 6
        epoch, digest = step_to(plane, sid, 10)
        assert epoch == 10
        want = oracle("conway", (72, 40), 7, 10)
        assert odigest.format_digest(digest) == board_digest(want)
        got = plane.get(sid)
        assert np.array_equal(got["board"], want)
        assert registry.snapshot().get("gol_serve_tiled_sessions") == 1.0
        # The ticker-fairness bound stands (no fast-forward lane for tiled);
        # each package raises its own AdmissionError.
        with pytest.raises(Exception) as e:
            plane.step(sid, 100000)
        assert type(e.value).__name__ == "AdmissionError"
        assert e.value.reason == "max_steps"
        plane.delete(sid)
        with pytest.raises(KeyError):
            plane.get(sid)
        assert registry.snapshot().get("gol_serve_tiled_sessions") == 0.0
        return sid, epoch, odigest.format_digest(digest), got["population"]


def test_mega_board_admitted_as_tiled_session_and_certifies():
    assert _mega("torch") == _mega("jax")


def test_mega_board_survives_worker_crash_mid_step():
    """Ship mode (``serve_tiled_resident`` off): tile chunks are pure, so a
    dead worker's chunk replays elsewhere and the step still certifies."""
    with serve_cluster(2, serve_size_classes="16,32", serve_tile_chunk=2,
                       serve_tiled_resident=False) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sid = plane.create(rule="conway", height=48, width=48, seed=3,
                           with_board=False)["id"]
        done = {}
        t = threading.Thread(target=lambda: done.setdefault("result", plane.step(sid, 12)))
        t.start()
        wait_until(lambda: (registry.snapshot().get("gol_serve_ops_total") or 0) >= 4,
                   what="tile chunks in flight")
        workers[0].channel.close()  # crash one worker mid-step
        t.join(60)
        assert not t.is_alive(), "tiled step hung across worker crash"
        epoch, digest = done["result"]
        assert epoch == 12
        assert odigest.format_digest(digest) == oracle_digest("conway", (48, 48), 3, 12)


def test_cluster_ttl_sweep_retires_budget_everywhere():
    """Idle eviction is the frontend's in cluster mode: workers run with TTL
    0, the plane's sweep deletes idle sessions through real ops, and the
    freed budget admits new creates — tiled sessions included."""
    with serve_cluster(2, serve_ttl_s=0.3, serve_size_classes="16,32") as (
        fe, workers, threads, registry,
    ):
        plane = fe.serve_plane
        sid = plane.create(height=16, width=16, with_board=False)["id"]
        mega = plane.create(height=48, width=48, with_board=False)["id"]
        assert workers[0].serve_plane.router.ttl_s == 0  # the frontend owns it
        wait_until(lambda: plane.stats()["sessions"] == 0, what="the TTL sweep")
        assert plane.stats()["cells"] == 0
        for s in (sid, mega):
            with pytest.raises(KeyError):
                plane.get(s)
        assert sum(w.serve_plane.router.stats()["sessions"] for w in workers) == 0
        assert registry.snapshot().get("gol_serve_session_evictions_total") == 2.0


def test_ff_jump_retry_counter_via_blocked_batch_drill():
    """One optimistic-commit retry on the serve fast path: park the jump
    between compute and commit, land a blocked batch job in the window, and
    the retry counter ticks while the final state is still exact."""
    registry = install(MetricsRegistry())
    cfg = SimulationConfig(role="serve", serve_max_steps=4, flight_dir="")
    router = SessionRouter(cfg, registry=registry, device="cpu")
    try:
        sid = router.create(rule="fredkin", height=16, width=16, seed=1,
                            with_board=False)["id"]
        router.pause()
        batch_done = threading.Event()
        threading.Thread(
            target=lambda: (router.step(sid, 1), batch_done.set()), daemon=True,
        ).start()
        wait_until(lambda: router.stats()["queue_depth"] >= 1, what="the queued batch")
        fired = threading.Event()

        def hook():
            if fired.is_set():
                return  # the retry's second pass commits cleanly
            fired.set()
            router.resume()
            assert batch_done.wait(30)

        router._drill_ff_precommit = hook
        epoch, digest = router.step(sid, 100)  # > max_steps: the ff path
        assert fired.is_set()
        assert epoch == 101  # the blocked batch's epoch was not clobbered
        assert registry.snapshot().get("gol_serve_ff_jump_retries_total") == 1.0
        assert odigest.format_digest(digest) == oracle_digest("fredkin", (16, 16), 1, 101)
    finally:
        router.close()


# -- mixed packages --------------------------------------------------------------


@pytest.mark.parametrize(
    "frontend,workers",
    [("torch", ("torch", "jax")), ("jax", ("jax", "torch"))],
    ids=["port-frontend", "jax-frontend"],
)
def test_mixed_package_cluster_ends_on_the_oracle(frontend, workers):
    """Sessions and a worker-resident tiled session routed across a port
    worker and a JAX worker (halo strips cross between the packages) end on
    the oracle's digests, and a drain of either worker re-homes them."""
    with serve_cluster(pkg=frontend, workers=workers, serve_size_classes="16,32",
                       serve_replicate_interval_s=0.05) as (fe, ws, threads, registry):
        plane = fe.serve_plane
        specs = [
            (plane.create(rule=_RULES[i % 3], height=16, width=12 + i, seed=i,
                          with_board=False)["id"], _RULES[i % 3], (16, 12 + i), i)
            for i in range(8)
        ]
        assert {e["worker"] for e in plane.list()} == {"w0", "w1"}
        mega = plane.create(rule="conway", height=64, width=64, seed=5, with_board=False)
        assert mega["resident"]
        assert set(plane.tiled[mega["id"]].owner.values()) == {"w0", "w1"}
        for sid, rule, shape, seed in specs:
            _, digest = plane.step(sid, 5)
            assert odigest.format_digest(digest) == oracle_digest(rule, shape, seed, 5)
        epoch, digest = step_to(plane, mega["id"], 12)
        assert odigest.format_digest(digest) == oracle_digest("conway", (64, 64), 5, epoch)
        assert ws[1].request_drain()
        threads[1].join(30)
        assert ws[1].stopped_reason == "drained"
        for sid, rule, shape, seed in specs:
            assert plane.get(sid)["digest"] == oracle_digest(rule, shape, seed, 5)
        epoch, digest = step_to(plane, mega["id"], 20)
        assert epoch == 20
        assert odigest.format_digest(digest) == oracle_digest("conway", (64, 64), 5, 20)
        assert set(plane.tiled[mega["id"]].owner.values()) == {"w0"}

