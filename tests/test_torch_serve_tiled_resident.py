"""The port's worker-resident tiled sessions: halo-exchange correctness
against the oracle, O(perimeter) bytes per round, digest-certified chunk
re-homing under drain, and the migration-against-barrier exclusion.

Counterpart of ``tests/test_serve_tiled_resident.py``: a real in-process
serve-only frontend plus ``BackendWorker`` threads (the port's on
``device="cpu"``); halo strips travel over real sockets between the
workers' peer listeners.  The deterministic case runs through both
packages' clusters and their transcripts must be equal.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from _torch_serve_cluster import (
    board_digest,
    oracle,
    serve_cluster,
    wait_until,
)
from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
from akka_game_of_life_tpu.serve import worker as jworker
from akka_game_of_life_tpu_torch.obs.catalog import install
from akka_game_of_life_tpu_torch.obs.metrics import MetricsRegistry
from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.serve import worker as tworker


def tiled_cluster(n_workers, pkg="torch", **cfg_kw):
    cfg_kw.setdefault("serve_shards", 8)
    cfg_kw.setdefault("serve_size_classes", "16,32")
    cfg_kw.setdefault("serve_replicate_interval_s", 0.05)
    cfg_kw.setdefault("serve_replicate_every", 1)
    cfg_kw.setdefault("serve_tiled_resident_snapshot", 2)
    return serve_cluster(n_workers, pkg=pkg, spread=False, **cfg_kw)


# -- the surface -----------------------------------------------------------------


def test_tiled_resident_surface_matches_reference():
    """The worker plane's halo protocol constants and metric families are
    the JAX package's: eight Moore strips per chunk, the same retransmit
    budget and snapshot cap, the same gauges and counters."""
    for name in ("_HALO_DIRS", "_HALO_MAX_TRIES", "_SNAP_CAP", "REPL_ACK_TIMEOUT_FLOOR_S"):
        assert getattr(tworker, name) == getattr(jworker, name), name
    registry = install(MetricsRegistry())
    plane = tworker.ServeWorkerPlane(
        tworker.serve_policy(SimulationConfig()), lambda msg: None, name="w",
        registry=registry, device="cpu",
    )
    try:
        names = set(registry.names())
    finally:
        plane.close()
    assert {"gol_serve_tiled_resident_chunks", "gol_serve_tiled_halo_bytes_total",
            "gol_serve_tiled_halo_retx_total"} <= names


def test_tiled_resident_config_validation():
    for key in ("serve_tiled_resident_snapshot", "serve_tiled_resident_halo_timeout_s"):
        with pytest.raises(ValueError, match=key) as got:
            SimulationConfig(**{key: 0})
        with pytest.raises(ValueError) as want:
            JConfig(**{key: 0})
        assert str(got.value) == str(want.value)


# -- steady-state correctness ------------------------------------------------------


def _resident(pkg):
    """A 9-chunk resident board stepped through full and partial rounds."""
    with tiled_cluster(2, pkg) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        doc = plane.create(rule="conway", height=80, width=80, seed=7, with_board=False)
        sid = doc["id"]
        assert doc["resident"] and doc["tiles"] == 9
        t = plane.tiled[sid]
        transcript = []
        total = 0
        for steps in (t.k, 2 * t.k, 3, 5):  # full rounds and ragged tails
            epoch, digest = plane.step(sid, steps)
            total += steps
            assert epoch == total
            transcript.append((epoch, odigest.format_digest(digest)))
        want = oracle("conway", (80, 80), 7, total)
        assert transcript[-1][1] == board_digest(want)
        got = plane.get(sid)
        assert np.array_equal(got["board"], want)
        assert got["population"] == int((want == 1).sum())
        assert (registry.snapshot().get("gol_serve_tiled_halo_bytes_total") or 0) > 0
        return transcript


def test_resident_session_certifies_vs_oracle():
    assert _resident("torch") == _resident("jax")


def test_resident_bytes_per_round_perimeter_not_area():
    """Resident rounds move O(chunk perimeter) bytes; ship-per-round moves
    O(area) through the frontend: same board, both certified, the per-round
    byte histogram separates them by a wide margin."""
    means = {}
    for resident in (True, False):
        with tiled_cluster(2, serve_tiled_resident=resident) as (
            fe, workers, threads, registry,
        ):
            plane = fe.serve_plane
            sid = plane.create(rule="conway", height=64, width=64, seed=9,
                               with_board=False)["id"]
            k = plane.tiled[sid].k if resident else plane.tile_chunk
            epoch, digest = plane.step(sid, 4 * k)
            assert odigest.format_digest(digest) == board_digest(
                oracle("conway", (64, 64), 9, epoch)
            )
            hist = registry.snapshot().get("gol_serve_tiled_bytes_round") or {}
            assert (hist.get("count") or 0) >= 4
            means[resident] = hist.get("sum", 0.0) / hist["count"]
    assert means[True] < means[False] / 3, means


def test_get_without_board_skips_worker_roundtrip():
    """A listing answers from the frontend's index: only ``with_board``
    pays the O(area) fetch."""
    with tiled_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sid = plane.create(height=64, width=64, seed=1, with_board=False)["id"]
        plane.step(sid, 4)
        before = registry.snapshot().get("gol_serve_ops_total") or 0
        assert any(e["id"] == sid and e["epoch"] == 4 for e in plane.list())
        assert (registry.snapshot().get("gol_serve_ops_total") or 0) == before


# -- rebalancing -----------------------------------------------------------------


def _pump(plane, sid, k, stop, epochs, errors):
    while not stop.is_set():
        try:
            epoch, _ = plane.step(sid, k)
            assert epoch > epochs[-1], "epoch regressed"
            epochs.append(epoch)
        except Exception as e:  # noqa: BLE001 — recorded, asserted
            errors.append(repr(e))


def test_drain_rehomes_resident_chunks_digest_certified():
    """A drain re-homes every resident chunk digest-certified with zero lost
    epochs under live traffic; the drained worker is released only once
    nothing resident points at it."""
    with tiled_cluster(3) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sid = plane.create(rule="conway", height=64, width=64, seed=5,
                           with_board=False)["id"]
        t = plane.tiled[sid]
        assert "w0" in set(t.owner.values())  # round-robin over 3 workers
        stop, errors, epochs = threading.Event(), [], [0]
        th = threading.Thread(target=_pump, args=(plane, sid, t.k, stop, epochs, errors),
                              daemon=True)
        th.start()
        wait_until(lambda: len(epochs) >= 4, 20, "steps before the drain")
        assert workers[0].request_drain()
        wait_until(
            lambda: "w0" not in set(t.owner.values())
            and len(fe.membership.alive_members()) == 2,
            30, "the drain to re-home the resident chunks",
        )
        seen = len(epochs)
        wait_until(lambda: len(epochs) >= seen + 3, 20, "steps after the drain")
        stop.set()
        th.join(30)
        assert not errors, errors[:3]
        doc = plane.get(sid)
        assert np.array_equal(doc["board"], oracle("conway", (64, 64), 5, doc["epoch"])), (
            "torn state after drain re-homing"
        )
        snap = registry.snapshot()
        assert (snap.get("gol_serve_tiled_chunk_migrations_total") or 0) >= 2
        assert (snap.get("gol_digest_mismatches_total") or 0) == 0


def test_chunk_migration_racing_barrier_cannot_tear_halo():
    """A chunk move holds the session's steplock across export, certify and
    adopt, so it never interleaves with a barrier: moves forced during
    sustained stepping commit between rounds, the trajectory bit-exact."""
    with tiled_cluster(2, serve_replicate=False) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sid = plane.create(rule="conway", height=64, width=64, seed=11,
                           with_board=False)["id"]
        t = plane.tiled[sid]
        stop, errors, epochs = threading.Event(), [], [0]
        th = threading.Thread(target=_pump, args=(plane, sid, t.k, stop, epochs, errors),
                              daemon=True)
        th.start()
        moved = 0
        for _ in range(6):
            seen = len(epochs)
            with plane._lock:
                c, source = next(iter(sorted(t.owner.items())))
                dest = next(
                    m.name for m in fe.membership.alive_members() if m.name != source
                )
                plane.tiled_rebalancer.begin((sid, c), source, dest, time.monotonic())
            plane._migrate_tiled_chunks(sid, [c], source, dest)
            with plane._lock:
                if t.owner[c] == dest:
                    moved += 1
            # Let a round land between forced moves.
            wait_until(lambda: len(epochs) > seen or errors, 20, "a round between moves")
        stop.set()
        th.join(30)
        assert not errors, errors[:3]
        assert moved >= 4, f"only {moved} forced moves committed"
        doc = plane.get(sid)
        assert np.array_equal(doc["board"], oracle("conway", (64, 64), 11, doc["epoch"])), (
            "torn halo"
        )
        assert (registry.snapshot().get("gol_digest_mismatches_total") or 0) == 0


def test_resident_off_keeps_ship_mode():
    """``serve_tiled_resident`` off runs the ship-per-round path (the
    board stays on the frontend), still digest-certified."""
    with tiled_cluster(2, serve_tiled_resident=False) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        doc = plane.create(height=48, width=48, seed=2, with_board=False)
        assert doc["resident"] is False
        epoch, digest = plane.step(doc["id"], 6)
        assert odigest.format_digest(digest) == board_digest(oracle("conway", (48, 48), 2, 6))
        assert (registry.snapshot().get("gol_serve_tiled_resident_chunks") or 0) == 0


def test_delete_clears_standby_on_owner_replica_worker():
    """A worker is often both an owner and a replica of one session: the one
    ``tiled_drop`` a delete sends it must retire its standby history too."""
    with tiled_cluster(2) as (fe, workers, threads, registry):
        plane = fe.serve_plane
        sid = plane.create(height=64, width=64, seed=21, with_board=False)["id"]
        t = plane.tiled[sid]
        plane.step(sid, 2 * t.k)
        wait_until(
            lambda: any(sid in w.serve_plane._tiled_standby for w in workers),
            20, "standby history",
        )
        plane.delete(sid)
        wait_until(
            lambda: all(
                sid not in w.serve_plane._tiled_standby
                and not any(k[0] == sid for k in w.serve_plane._resident)
                for w in workers
            ),
            20, "the delete to clear chunks and standby history",
        )


def test_resync_rolls_desynced_session_back_to_certified_epoch():
    """A request that dies without a worker death may leave worker epochs
    ahead of the frontend: the resync rolls the whole session back to its
    certified snapshot and serving resumes oracle-exact."""
    with tiled_cluster(2, serve_tiled_resident_snapshot=1) as (
        fe, workers, threads, registry,
    ):
        plane = fe.serve_plane
        sid = plane.create(rule="conway", height=64, width=64, seed=23,
                           with_board=False)["id"]
        t = plane.tiled[sid]
        epoch, _ = plane.step(sid, 2 * t.k)
        wait_until(lambda: t.certified() == epoch, 20, "the snapshots' acks")
        # Desync on purpose: advance the workers one round the frontend
        # never learns about.
        with plane._lock:
            owners_wire = plane._tiled_owner_wire_locked(t)
            by_member = {}
            for c, o in t.owner.items():
                by_member.setdefault(o, []).append(list(c))
        pends = [
            plane._submit(
                {"op": "tiled_step", "rid": 0, "sid": sid, "epoch": t.epoch,
                 "ks": [t.k], "chunks": chunks, "owners": owners_wire,
                 "digest": True, "snap_epochs": [], "floor": t.certified()},
                sid=sid, kind="tile_ctl", member=m,
            )
            for m, chunks in sorted(by_member.items())
        ]
        for p in pends:
            plane._await(p)
        with t.steplock:
            plane._begin_tiled_resync(sid, t)
        wait_until(lambda: not t.promoting and sid not in plane._tiled_promoting,
                   20, "the resync")
        doc = plane.get(sid)
        assert doc["epoch"] == epoch  # back at the certified barrier
        assert np.array_equal(doc["board"], oracle("conway", (64, 64), 23, epoch))
        e2, digest2 = plane.step(sid, t.k)
        assert odigest.format_digest(digest2) == board_digest(oracle("conway", (64, 64), 23, e2))


# -- the worker's device step --------------------------------------------------------


@pytest.mark.parametrize("rule", ["conway", "brians-brain", "wireworld"])
def test_batched_tile_step_matches_reference(rule):
    """The round's batched step (a ``[B, H, W]`` stack, each board on its
    own torus: only the last two dims roll) equals the JAX package's
    vmapped step board for board, and a ship-mode ``step_raw`` chunk (its
    interior and digest lanes at the tile's global origin) equals the JAX
    worker's answer."""
    import jax.numpy as jnp
    import torch

    from akka_game_of_life_tpu.ops.rules import resolve_rule as j_rule
    from akka_game_of_life_tpu.runtime.wire import pack_tile as j_pack
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
    from akka_game_of_life_tpu_torch.runtime.wire import pack_tile

    rng = np.random.default_rng(5)
    states = 4 if rule == "wireworld" else 3 if rule == "brians-brain" else 2
    stack = rng.integers(0, states, size=(5, 20, 24), dtype=np.uint8)
    got = tworker._batched_step_fn(resolve_rule(rule), 3, torch.device("cpu"))(
        torch.from_numpy(stack)
    ).numpy()
    want = np.asarray(jworker._batched_step_fn(j_rule(rule), 3)(jnp.asarray(stack)))
    np.testing.assert_array_equal(got, want)
    one = tworker._batched_step_fn(resolve_rule(rule), 3, torch.device("cpu"))
    for b in range(len(stack)):
        np.testing.assert_array_equal(one(torch.from_numpy(stack[b : b + 1])).numpy()[0], got[b])
    op = {"op": "step_raw", "rid": 7, "rule": rule, "k": 3, "interior": [3, 17, 3, 21],
          "origin": [40, 8], "width": 96}
    planes = {}
    for name, mod, pack in (("torch", tworker, pack_tile), ("jax", jworker, j_pack)):
        kw = {"device": "cpu"} if name == "torch" else {}
        plane = mod.ServeWorkerPlane(mod.serve_policy(
            SimulationConfig() if name == "torch" else JConfig()), lambda msg: None,
            name="w", **kw)
        try:
            planes[name] = plane._step_raw(7, dict(op, state=pack(stack[0])))
        finally:
            plane.close()
    t, j = planes["torch"], planes["jax"]
    assert t["digest"] == j["digest"] and t["rid"] == j["rid"] == 7
    np.testing.assert_array_equal(
        np.asarray(t["state"]["data"]), np.asarray(j["state"]["data"])
    )
