"""The port's in-process cluster on the CPU, against the JAX dense oracle.

Mirrors ``tests/test_cluster.py``: two and four workers, a gun with render
assembly, a multistate rule, node loss with checkpoint replay, tile-crash
injection and digest-plane certification, with the port's ``torch`` engine
on ``device="cpu"`` (the plain version of every kernel) and its ``numpy``
engine.  Boards are 32²–64²; every wait has a timeout and every port is
ephemeral.
"""

import io
import time

import jax.numpy as jnp
import numpy as np
import pytest

from akka_game_of_life_tpu.models import get_model
from akka_game_of_life_tpu.ops import digest as jdigest
from akka_game_of_life_tpu.ops.npkernel import step_np
from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore
from akka_game_of_life_tpu_torch.runtime.config import (
    FaultInjectionConfig,
    SimulationConfig,
)
from akka_game_of_life_tpu_torch.runtime.harness import cluster
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import initial_board

DONE_TIMEOUT = 60


def dense_oracle(board, rule, steps):
    return np.asarray(get_model(rule).run(steps)(jnp.asarray(board)))


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@pytest.mark.parametrize("engine,width", [("torch", 1), ("torch", 4), ("numpy", 4)])
def test_free_run_two_workers_matches_dense(engine, width):
    cfg = SimulationConfig(
        height=32, width=32, seed=11, max_epochs=25 if width == 1 else 24,
        exchange_width=width,
    )
    with cluster(cfg, 2, engine=engine, device="cpu") as h:
        final = h.run_to_completion()
    want = dense_oracle(initial_board(cfg), "conway", cfg.max_epochs)
    np.testing.assert_array_equal(final, want)


def test_four_workers_gun_and_render_assembly():
    sink = io.StringIO()
    cfg = SimulationConfig(
        height=64, width=64, pattern="gosper-glider-gun", pattern_offset=(4, 4),
        max_epochs=30, render_every=30, exchange_width=3,
    )
    obs = BoardObserver(render_every=30, out=sink, render_max_cells=64)
    with cluster(cfg, 4, observer=obs, device="cpu") as h:
        final = h.run_to_completion()
    want = dense_oracle(initial_board(cfg), "conway", 30)
    np.testing.assert_array_equal(final, want)
    gun = np.s_[4:13, 4:40]
    np.testing.assert_array_equal(final[gun], initial_board(cfg)[gun])  # period 30
    assert "epoch 30" in sink.getvalue()


@pytest.mark.parametrize("width", [1, 4])
def test_multistate_rule_cluster(width):
    cfg = SimulationConfig(
        height=32, width=32, rule="brians-brain", density=0.3, seed=8,
        max_epochs=12, exchange_width=width,
    )
    with cluster(cfg, 2, device="cpu") as h:
        final = h.run_to_completion()
    want = initial_board(cfg)
    for _ in range(12):
        want = step_np(want, "brians-brain")
    np.testing.assert_array_equal(final, want)


def test_node_loss_redeploys_and_preserves_trajectory(tmp_path):
    """Kill a worker mid-run: its tiles redeploy to the survivor, replay
    from the checkpoint, and the final board equals the dense run."""
    cfg = SimulationConfig(
        height=48, width=64, pattern="gosper-glider-gun", pattern_offset=(2, 2),
        max_epochs=60, tick_s=0.01, checkpoint_dir=str(tmp_path),
        checkpoint_every=10, exchange_width=5,
    )
    with cluster(cfg, 2, device="cpu") as h:
        assert h.frontend.wait_for_backends(timeout=5)
        h.frontend.start_simulation()
        _wait(lambda: h.frontend._last_ckpt[0] >= 10, 10, "no checkpoint before kill")
        h.workers[0].stop()
        assert h.frontend.done.wait(DONE_TIMEOUT)
        assert h.frontend.error is None
        final = h.frontend.final_board
        assert len(h.frontend.membership.alive_members()) == 1
        assert h.frontend._m_redeploys.value >= 1
    np.testing.assert_array_equal(
        final, dense_oracle(initial_board(cfg), "conway", 60)
    )


def test_tile_crash_injection_with_budget(tmp_path):
    cfg = SimulationConfig(
        height=32, width=32, seed=5, max_epochs=40, tick_s=0.005,
        checkpoint_dir=str(tmp_path), checkpoint_every=10,
        fault_injection=FaultInjectionConfig(
            enabled=True, first_after_s=0.1, every_s=0.2, max_crashes=3, mode="tile"
        ),
    )
    with cluster(cfg, 2, device="cpu") as h:
        final = h.run_to_completion()
    assert 1 <= h.frontend.injector.crashes <= 3
    assert len(h.frontend.crash_events) == h.frontend.injector.crashes
    np.testing.assert_array_equal(
        final, dense_oracle(initial_board(cfg), "conway", 40)
    )


def test_digest_plane_certifies_against_jax_digest(tmp_path):
    """Per-tile digest lanes merged by the frontend equal the JAX package's
    digest of the oracle board, at every cadence epoch, and the durable
    per-tile checkpoint records the same value."""
    sink = io.StringIO()
    cfg = SimulationConfig(
        height=64, width=64, seed=3, max_epochs=20, metrics_every=10,
        checkpoint_dir=str(tmp_path), checkpoint_every=10, obs_digest=True,
        exchange_width=5,
    )
    obs = BoardObserver(metrics_every=10, out=sink)
    with cluster(cfg, 4, observer=obs, device="cpu") as h:
        final = h.run_to_completion()
        digests = dict(h.frontend.epoch_digests)
    board = initial_board(cfg)
    for epoch in (10, 20):
        want = dense_oracle(board, "conway", epoch)
        assert digests[epoch] == jdigest.value(jdigest.digest_dense_np(want))
        assert f"epoch {epoch}: digest={digests[epoch]:016x}" in sink.getvalue()
    np.testing.assert_array_equal(final, dense_oracle(board, "conway", 20))
    store = CheckpointStore(str(tmp_path))
    assert store.latest_epoch() == 20
    assert int(store.tile_meta(20)["digest"], 16) == digests[20]
    assert store.tile_digest(20) == digests[20]


def test_frontend_restart_resumes_from_checkpoint(tmp_path):
    kw = dict(height=32, width=32, seed=12, checkpoint_dir=str(tmp_path), checkpoint_every=10)
    with cluster(SimulationConfig(max_epochs=20, **kw), 2, device="cpu") as h:
        h.run_to_completion()
    cfg2 = SimulationConfig(max_epochs=40, **kw)
    with cluster(cfg2, 2, device="cpu") as h2:
        assert h2.frontend.wait_for_backends(timeout=5)
        h2.frontend.start_simulation()
        assert h2.frontend.start_epoch == 20
        assert h2.frontend.done.wait(DONE_TIMEOUT)
        final = h2.frontend.final_board
    np.testing.assert_array_equal(
        final, dense_oracle(initial_board(cfg2), "conway", 40)
    )


def test_control_channel_drains_while_dispatch_blocks_in_a_send(monkeypatch):
    """A worker busy sending a bulk frame the frontend is not reading yet
    still reads the frontend's own bulk frame (a DEPLOY behind a node loss):
    neither end waits on the other.  Reading on the dispatch thread made the
    two sends block each other for good."""
    import socket
    import threading

    from akka_game_of_life_tpu_torch.runtime.backend import BackendWorker
    from akka_game_of_life_tpu_torch.runtime.wire import Channel

    a, b = socket.socketpair()
    worker = BackendWorker("127.0.0.1", 1, engine="numpy", peer_host="127.0.0.1")
    worker.channel, frontend = Channel(a), Channel(b)
    bulk = np.arange(8 << 20, dtype=np.uint32).astype(np.uint8)  # >> socket buffers

    def dispatch(msg):  # the reply to any frame: a bulk frame, as TILE_STATE is
        if msg["type"] == "ask":
            worker.channel.send({"type": "reply", "blob": bulk})

    monkeypatch.setattr(worker, "_dispatch", dispatch)
    run = threading.Thread(target=worker.run, daemon=True)
    run.start()
    try:
        frontend.send({"type": "ask"})
        send = threading.Thread(
            target=frontend.send, args=({"type": "bulk", "blob": bulk},), daemon=True
        )
        send.start()
        send.join(timeout=20)
        assert not send.is_alive(), "the worker stopped reading its control channel"
        reply = frontend.recv()
        np.testing.assert_array_equal(reply["blob"], bulk)
        frontend.close()
        run.join(timeout=20)
        assert not run.is_alive() and worker.stopped_reason == "disconnected"
    finally:
        frontend.close()
        worker.stop()


def test_cluster_refusals_by_name():
    from akka_game_of_life_tpu_torch.runtime.backend import BackendWorker

    with pytest.raises(ValueError, match="jax"):
        BackendWorker("127.0.0.1", 1, engine="jax")
    for engine in ("swar", "actor", "actor-native"):  # ported: the host engines
        assert BackendWorker("127.0.0.1", 1, engine=engine).engine == engine
    with pytest.raises(ValueError, match="interpret"):
        BackendWorker("127.0.0.1", 1, pallas="interpret", device="cpu")
