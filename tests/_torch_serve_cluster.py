"""Serving clusters of either package, or of both, for the port's tests.

``serve_cluster(n, pkg=...)`` runs a real in-process serve-only frontend
plus ``n`` ``BackendWorker`` threads speaking the wire protocol, the stack
``serve --serve-cluster on`` runs.  ``workers=["torch", "jax"]`` names each
worker's package, so a port frontend can drive JAX workers and the reverse.
The port's workers run the torch engine on ``device="cpu"``; the JAX
package's run on its CPU backend.  Every wait has its own timeout.
"""

from __future__ import annotations

import contextlib
import threading
import time
import types

import numpy as np

import akka_game_of_life_tpu.obs.catalog as j_catalog
import akka_game_of_life_tpu.obs.metrics as j_metrics
import akka_game_of_life_tpu.obs.tracing as j_tracing
import akka_game_of_life_tpu.runtime.backend as j_backend
import akka_game_of_life_tpu.runtime.config as j_config
import akka_game_of_life_tpu.runtime.frontend as j_frontend
import akka_game_of_life_tpu_torch.obs.catalog as t_catalog
import akka_game_of_life_tpu_torch.obs.metrics as t_metrics
import akka_game_of_life_tpu_torch.obs.tracing as t_tracing
import akka_game_of_life_tpu_torch.runtime.backend as t_backend
import akka_game_of_life_tpu_torch.runtime.config as t_config
import akka_game_of_life_tpu_torch.runtime.frontend as t_frontend
from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.ops.npkernel import step_np
from akka_game_of_life_tpu_torch.utils.patterns import random_grid

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax",
        Config=j_config.SimulationConfig,
        Frontend=j_frontend.Frontend,
        BackendWorker=j_backend.BackendWorker,
        worker_kw={"engine": "numpy"},
        registry=lambda: j_catalog.install(j_metrics.MetricsRegistry()),
        Tracer=j_tracing.Tracer,
    ),
    "torch": types.SimpleNamespace(
        name="torch",
        Config=t_config.SimulationConfig,
        Frontend=t_frontend.Frontend,
        BackendWorker=t_backend.BackendWorker,
        worker_kw={"engine": "torch", "device": "cpu"},
        registry=lambda: t_catalog.install(t_metrics.MetricsRegistry()),
        Tracer=t_tracing.Tracer,
    ),
}


def oracle(rule, shape, seed, epochs) -> np.ndarray:
    """The session board ``epochs`` generations on, by the numpy oracle
    (neither package's plane steps with it)."""
    board = random_grid(shape, density=0.5, seed=seed)
    for _ in range(epochs):
        board = step_np(board, rule)
    return board


def board_digest(board) -> str:
    return odigest.format_digest(odigest.value(odigest.digest_dense_np(board)))


def oracle_digest(rule, shape, seed, epochs) -> str:
    return board_digest(oracle(rule, shape, seed, epochs))


def wait_until(pred, timeout=15.0, what="condition"):
    """Poll ``pred`` until true; fail loudly at ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    tick = threading.Event()
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        tick.wait(0.02)


def wait_spread(fe, n: int, timeout: float = 15.0) -> None:
    """Until the shard table spreads over ``n`` workers within 2 shards."""

    def spread():
        alive = len(fe.membership.alive_members())
        by = fe._health()["serve"]["shards_by_worker"]
        return len(by) == min(n, alive) and (
            len(by) < 2 or max(by.values()) - min(by.values()) <= 2
        )

    wait_until(spread, timeout, "the shards to spread")


@contextlib.contextmanager
def serve_cluster(n_workers: int = 0, *, pkg: str = "torch", workers=None,
                  spread: bool = True, **cfg_kw):
    """A serve-only cluster: ``pkg``'s frontend plus one worker thread per
    entry of ``workers`` (package names; default ``[pkg] * n_workers``).
    Yields ``(frontend, workers, threads, registry)``; the registry is the
    frontend's (a worker of the frontend's package shares it).  With
    ``spread`` it first waits for the shard table to spread."""
    workers = list(workers) if workers is not None else [pkg] * n_workers
    cfg_kw.setdefault("serve_shards", 16)
    cfg_kw.setdefault("rebalance_interval_s", 0.05)
    # Worker loss in these drills is EOF-driven (channel.close()); a wide
    # heartbeat margin keeps a loaded host from auto-downing a live worker.
    cfg_kw.setdefault("failure_timeout_s", 5.0)
    fe_pkg = PKGS[pkg]
    cfg = fe_pkg.Config(
        role="serve", serve_cluster=True, port=0, max_epochs=None,
        flight_dir="", **cfg_kw,
    )
    registries = {pkg: fe_pkg.registry()}
    tracers = {pkg: fe_pkg.Tracer(node="test-serve-cluster")}
    fe = fe_pkg.Frontend(cfg, min_backends=len(workers),
                         registry=registries[pkg], tracer=tracers[pkg])
    fe.start()
    live, threads = [], []

    def add_worker(name, wpkg=pkg):
        p = PKGS[wpkg]
        if wpkg not in registries:
            registries[wpkg] = p.registry()
            tracers[wpkg] = p.Tracer(node="test-serve-cluster")
        w = p.BackendWorker(
            "127.0.0.1", fe.port, name=name, registry=registries[wpkg],
            tracer=tracers[wpkg], **p.worker_kw,
        )
        w.crash_hook = w.stop
        w.connect()
        t = threading.Thread(target=w.run, daemon=True, name=name)
        t.start()
        live.append(w)
        threads.append(t)
        return w, t

    fe.add_serve_worker = add_worker  # test hook
    try:
        for i, wpkg in enumerate(workers):
            add_worker(f"w{i}", wpkg)
        assert fe.wait_for_backends(timeout=15)
        if workers and spread:
            wait_spread(fe, len(workers))
        yield fe, live, threads, registries[pkg]
    finally:
        fe.stop()
        for w in live:
            w.stop()


def step_to(plane, sid, target, *, laps=80):
    """The tiled client contract: step toward the ABSOLUTE epoch
    ``target``, retrying on the retryable 429 ``failover`` (the session
    resumed at its certified epoch).  Returns ``(epoch, digest)``."""
    epoch = int(plane.get(sid)["epoch"])
    tick = threading.Event()
    for _ in range(laps):
        try:
            return plane.step(sid, target - epoch)
        except Exception as e:  # noqa: BLE001 — only failover retries
            if getattr(e, "reason", None) != "failover":
                raise
            tick.wait(0.25)
            try:
                epoch = int(plane.get(sid)["epoch"])
            except Exception as e2:  # noqa: BLE001
                if getattr(e2, "reason", None) != "failover":
                    raise
    raise AssertionError(f"{sid} never reached epoch {target}")
