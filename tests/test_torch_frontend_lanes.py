"""The port's frontend writes to each member on that member's own lane.

A worker that stops reading its control channel (a JAX worker reads it on
its dispatch thread, which may be deep in a step) must stall only its own
lane: the frontend keeps deciding under its lock and queues there, but never
writes a socket while holding it.  Here one member registers and then never
reads, with socket buffers far smaller than its DEPLOY, so the write to it
blocks for good; the frontend's lock must still be free within a second and
the other member must go on receiving TICKs.
"""

import socket
import threading
import time

from akka_game_of_life_tpu_torch.runtime import protocol as P
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.frontend import Frontend
from akka_game_of_life_tpu_torch.runtime.wire import Channel

SCENARIO_TIMEOUT_S = 60.0
SMALL_BUFFER = 4096


def _join(port: int, name: str, *, small_buffer: bool = False) -> Channel:
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if small_buffer:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, SMALL_BUFFER)
    sock.connect(("127.0.0.1", port))
    channel = Channel(sock)
    channel.send({"type": P.REGISTER, "name": name, "peer_port": 0, "engine": "jax"})
    return channel


def _wait(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _scenario(report: dict) -> None:
    # 2048² split over two members: each DEPLOY carries a 256 KB tile.
    cfg = SimulationConfig(
        height=2048, width=2048, rule="conway", seed=1, max_epochs=100_000,
        tick_s=0.02, start_delay_s=0.0, failure_timeout_s=120.0, port=0,
    )
    fe = Frontend(cfg, min_backends=2)
    fe.start()
    stuck = _join(fe.port, "stuck", small_buffer=True)
    reader = _join(fe.port, "reader")
    got = []

    def read() -> None:
        while True:
            try:
                msg = reader.recv()
            except (OSError, ValueError):
                return
            if msg is None:
                return
            got.append(msg["type"])

    try:
        _wait(lambda: len(fe.membership.alive_members()) == 2, 10, "both members")
        stuck_member = fe.membership.get("stuck")
        stuck_member.channel.sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDBUF, SMALL_BUFFER
        )
        threading.Thread(target=read, daemon=True).start()
        threading.Thread(target=fe.start_simulation, daemon=True).start()
        _wait(lambda: P.DEPLOY in got and got.count(P.TICK) >= 2, 20, "reader's DEPLOY and TICKs")
        lane = fe._sender(stuck_member)
        _wait(lambda: lane._busy, 10, "the stuck member's write to block")
        # The stuck lane is mid-write for good; the lock and the other
        # member's ticks are not held up by it.
        held = []
        for _ in range(3):
            t0 = time.monotonic()
            took = fe._lock.acquire(timeout=1.0)
            held.append(time.monotonic() - t0)
            assert took, "frontend lock not free within 1 s"
            fe._lock.release()
            time.sleep(0.1)
        ticks = got.count(P.TICK)
        _wait(lambda: got.count(P.TICK) >= ticks + 5, 5, "more TICKs at the reader")
        report.update(
            lock_wait_s=max(held), stuck_busy=lane._busy,
            ticks=got.count(P.TICK), stuck_alive=stuck_member.alive,
        )
    finally:
        fe.stop()
        for channel in (stuck, reader):
            channel.close()


def test_a_member_that_does_not_read_holds_neither_the_lock_nor_ticks():
    report, errors = {}, []

    def run() -> None:
        try:
            _scenario(report)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(SCENARIO_TIMEOUT_S)
    assert not worker.is_alive(), f"scenario still running after {SCENARIO_TIMEOUT_S} s"
    if errors:
        raise errors[0]
    assert report["lock_wait_s"] < 1.0
    assert report["stuck_busy"] and report["stuck_alive"]
    assert report["ticks"] >= 7
