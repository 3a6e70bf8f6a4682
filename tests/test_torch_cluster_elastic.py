"""The port's elastic and quiescent cluster on the CPU, against the JAX
dense oracle.

Mirrors ``tests/test_rebalance.py`` and the cluster cases of
``tests/test_sparse.py`` with the port's ``torch`` engine on
``device="cpu"``: a late joiner receiving live-migrated tiles, a graceful
drain (with and without network chaos), a drain with nowhere to go, a
corrupted migration rolled back, and the quiescence tier skipping chunks of
still lifes and oscillators without changing the trajectory.  Boards are
16²–64²; every wait has a timeout and every port is ephemeral.
"""

import io
import json
import time

import numpy as np
import pytest

from akka_game_of_life_tpu.ops import digest as jdigest
from akka_game_of_life_tpu_torch.obs.catalog import install
from akka_game_of_life_tpu_torch.obs.metrics import MetricsRegistry
from akka_game_of_life_tpu_torch.runtime.config import (
    NetworkChaosConfig,
    SimulationConfig,
)
from akka_game_of_life_tpu_torch.runtime.harness import cluster
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import initial_board

from tests.test_torch_cluster import DONE_TIMEOUT, dense_oracle


def _registry():
    return install(MetricsRegistry())


def _cluster(cfg, n, registry=None):
    return cluster(
        cfg, n, observer=BoardObserver(out=io.StringIO()), device="cpu",
        registry=registry,
    )


def _wait(pred, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _wait_floor(h, epoch):
    _wait(
        lambda: min(h.frontend.tile_epochs.values(), default=0) >= epoch,
        f"epoch floor >= {epoch}",
    )


def _finish(h):
    assert h.frontend.done.wait(DONE_TIMEOUT), "cluster did not finish"
    assert h.frontend.error is None, h.frontend.error
    return h.frontend.final_board


def test_scale_out_migrates_tiles_to_late_joiner():
    reg = _registry()
    cfg = SimulationConfig(
        height=64, width=64, seed=7, max_epochs=80, tick_s=0.005,
        start_delay_s=0.05, tiles_per_worker=2, obs_digest=True,
        rebalance_enabled=True, rebalance_interval_s=0.05,
    )
    with _cluster(cfg, 2, reg) as h:
        assert h.frontend.wait_for_backends(timeout=5)
        h.frontend.start_simulation()
        _wait_floor(h, 5)
        late = h.add_worker("late")
        _wait(
            lambda: late.name in h.frontend.tile_owner.values(),
            "a tile to migrate onto the late joiner",
        )
        final = _finish(h)
        final_digest = h.frontend.final_digest
    snap = reg.snapshot()
    assert snap.get("gol_migrations_total", 0) >= 1
    assert not snap.get("gol_digest_mismatches_total")
    want = dense_oracle(initial_board(cfg), "conway", 80)
    np.testing.assert_array_equal(final, want)
    assert final_digest == jdigest.value(jdigest.digest_dense_np(want))


@pytest.mark.parametrize("chaos", [False, True], ids=["clean", "netchaos"])
def test_drain_hands_tiles_back_without_redeploys(chaos):
    """A drained worker's tiles live-migrate to the survivor and it leaves
    "drained"; planned departure is not node loss, even on a lossy peer
    plane with a partition mid-run."""
    reg = _registry()
    net = NetworkChaosConfig(
        enabled=True, seed=5, drop_p=0.1, scope="peer", partition_after_s=0.3,
        partition_every_s=60.0, partition_heal_s=0.5, max_partitions=1,
    )
    cfg = SimulationConfig(
        height=48, width=48, seed=23, max_epochs=120 if chaos else 80,
        tick_s=0.005, start_delay_s=0.05, tiles_per_worker=2, flight_dir="",
        **({"net_chaos": net} if chaos else {}),
    )
    with _cluster(cfg, 2, reg) as h:
        assert h.frontend.wait_for_backends(timeout=5)
        h.frontend.start_simulation()
        _wait_floor(h, 20 if chaos else 5)
        assert h.drain_worker(h.workers[0]) == "drained"
        survivor = h.workers[1].name
        assert all(o == survivor for o in h.frontend.tile_owner.values())
        final = _finish(h)
    snap = reg.snapshot()
    assert not snap.get("gol_redeploys_total")
    assert snap.get("gol_drains_total") == 1
    assert snap.get("gol_migrations_total", 0) >= 2
    if chaos:
        assert snap.get("gol_net_chaos_dropped_total", 0) > 0
    np.testing.assert_array_equal(
        final, dense_oracle(initial_board(cfg), "conway", cfg.max_epochs)
    )


def test_drain_refused_without_destination():
    cfg = SimulationConfig(height=16, width=16, seed=3, max_epochs=500, tick_s=0.01)
    with _cluster(cfg, 1) as h:
        assert h.frontend.wait_for_backends(timeout=5)
        h.frontend.start_simulation()
        _wait_floor(h, 2)
        assert h.drain_worker(h.workers[0]) == "drain_refused"


def test_migration_digest_mismatch_rolls_back(tmp_path):
    """A corrupted transfer is caught by the frontend's certification and
    aborted; the source never dropped the tile, so the run still ends on
    the oracle."""
    reg = _registry()
    flight_dir = tmp_path / "flight"
    cfg = SimulationConfig(
        height=32, width=32, seed=9, max_epochs=80, tick_s=0.005,
        start_delay_s=0.05, flight_dir=str(flight_dir),
    )
    with _cluster(cfg, 2, reg) as h:
        assert h.frontend.wait_for_backends(timeout=5)
        h.frontend.start_simulation()
        _wait_floor(h, 5)
        source = h.workers[0]
        orig = source._migrate_payload

        def corrupt(tid, arr, epoch):
            out = orig(tid, arr, epoch)
            out["digest"] = [out["digest"][0] ^ 1, out["digest"][1]]
            return out

        source._migrate_payload = corrupt
        tile = next(t for t, o in h.frontend.tile_owner.items() if o == source.name)
        assert h.frontend.migrate_tile(tile, h.workers[1].name)
        _wait(
            lambda: reg.snapshot().get("gol_migration_aborts_total"),
            "the mismatch rollback",
        )
        assert h.frontend.tile_owner[tile] == source.name
        final = _finish(h)
    snap = reg.snapshot()
    assert snap.get("gol_digest_mismatches_total") == 1
    assert not snap.get("gol_migrations_total")
    dumps = [json.loads(p.read_text()) for p in flight_dir.glob("flightrec-*.json")]
    assert any(d.get("reason") == "migration_abort" for d in dumps)
    np.testing.assert_array_equal(final, dense_oracle(initial_board(cfg), "conway", 80))


@pytest.mark.parametrize(
    "pattern,offset,epochs,period",
    [("block", (3, 3), 48, 1), ("blinker", (8, 8), 40, 2)],
)
def test_quiescent_tiles_skip_chunks(pattern, offset, epochs, period):
    reg = _registry()
    cfg = SimulationConfig(
        height=32, width=32, pattern=pattern, pattern_offset=offset,
        max_epochs=epochs, sparse_cluster=True, flight_dir="", obs_digest=True,
    )
    with _cluster(cfg, 2, reg) as h:
        final = h.run_to_completion()
        quiescent = dict(h.frontend.quiescent)
        final_digest = h.frontend.final_digest
    want = dense_oracle(initial_board(cfg), "conway", epochs)
    np.testing.assert_array_equal(final, want)
    assert final_digest == jdigest.value(jdigest.digest_dense_np(want))
    assert reg.snapshot().get("gol_tiles_skipped_total", 0) > 0
    assert period in quiescent.values(), quiescent


@pytest.mark.parametrize("advanced", [1, 3])
@pytest.mark.parametrize("engine", ["actor", "actor-native"])
def test_quiescent_skip_spares_the_actor_engines(tmp_path, engine, advanced):
    """The actor engines keep per-cell histories, so the quiescence tier
    must drive every chunk of theirs: a period-2 tile that skipped an odd
    number of chunks would wake in the wrong phase.  A blinker plus a
    glider that crosses its tile, pre-advanced an odd number of
    generations, must end on the oracle's board with no chunk skipped."""
    from akka_game_of_life_tpu_torch.utils.patterns import encode_rle

    board = np.zeros((32, 32), np.uint8)
    board[24, 23:26] = 1  # blinker
    board[1, 2] = board[2, 3] = 1  # glider heading south-east
    board[3, 1:4] = 1
    board = dense_oracle(board, "conway", advanced)
    path = tmp_path / "start.rle"
    path.write_text(encode_rle(board))
    reg = _registry()
    # The pure-Python actor engine holds the GIL for whole chunks: a wide
    # heartbeat margin keeps a loaded host from auto-downing both workers.
    cfg = SimulationConfig(
        height=32, width=32, pattern=str(path), pattern_offset=(0, 0),
        max_epochs=90, sparse_cluster=True, flight_dir="", failure_timeout_s=30.0,
    )
    with cluster(
        cfg, 2, observer=BoardObserver(out=io.StringIO()), engine=engine,
        device="cpu", registry=reg,
    ) as h:
        final = h.run_to_completion()
    np.testing.assert_array_equal(final, dense_oracle(board, "conway", 90))
    assert reg.snapshot().get("gol_tiles_skipped_total", 0) == 0


def test_random_board_never_skips():
    reg = _registry()
    cfg = SimulationConfig(
        height=32, width=32, seed=3, density=0.5, max_epochs=30,
        sparse_cluster=True, flight_dir="",
    )
    with _cluster(cfg, 2, reg) as h:
        final = h.run_to_completion()
    np.testing.assert_array_equal(final, dense_oracle(initial_board(cfg), "conway", 30))
    assert reg.snapshot().get("gol_tiles_skipped_total", 0) == 0
