"""In-process cluster harness: frontend + N backend workers as threads.

Counterpart of ``akka_game_of_life_tpu/runtime/harness.py``: one process
standing in for "start N backends on localhost", used by the tests, by
``chip_smoke.py``'s cluster phase and by library users who want a local
cluster without shell plumbing.  The workers share the process's device
(``cuda`` unless ``device="cpu"``) and its default stream; each steps its
tiles under its own lock.  A list of devices (``device=["cuda:0"] * 2``)
reaches every worker whole, so each row-shards its chunks over them
(``backend._meshed_engine``).  Real multi-process clusters use the CLI roles
(``python -m akka_game_of_life_tpu_torch frontend/backend``).
"""

from __future__ import annotations

import contextlib
import threading

from akka_game_of_life_tpu_torch.runtime.backend import BackendWorker
from akka_game_of_life_tpu_torch.runtime.frontend import Frontend

DONE_TIMEOUT = 60


class ClusterHarness:
    def __init__(
        self,
        config,
        n_backends,
        observer=None,
        engine="torch",
        pallas=None,
        device=None,
        registry=None,
        tracer=None,
    ):
        # engine="torch" steps on ``device`` (cuda unless "cpu" is passed;
        # a worker raises without CUDA); "numpy", "swar", "actor" and
        # "actor-native" step on the host.
        # registry/tracer isolate the cluster's metrics and spans; None =
        # the process defaults.  When config.net_chaos is enabled, the
        # frontend's NetworkChaos instance is shared by every worker, so
        # partition sides and the seeded fault stream are cluster-wide.
        self.engine = engine
        self.pallas = pallas
        self.device = device
        self.registry = registry
        self.tracer = tracer
        config.port = 0  # ephemeral: parallel harnesses must not fight over 2551
        self.frontend = Frontend(
            config,
            min_backends=n_backends,
            observer=observer,
            registry=registry,
            tracer=tracer,
        )
        self.frontend.start()
        self.netchaos = self.frontend.netchaos
        self.workers = []
        self.threads = []
        try:
            for i in range(n_backends):
                self.add_worker(f"w{i}")
        except BaseException:
            self.shutdown()
            raise

    def add_worker(self, name):
        # No retry/breaker knobs here: WELCOME ships the frontend's
        # SimulationConfig policy, so tests and CLI share one source of truth.
        w = BackendWorker(
            "127.0.0.1",
            self.frontend.port,
            name=name,
            engine=self.engine,
            pallas=self.pallas,
            device=self.device,
            registry=self.registry,
            tracer=self.tracer,
            netchaos=self.frontend.netchaos,
        )
        w.crash_hook = w.stop  # in-thread "process death": drop the connection
        w.connect()
        t = threading.Thread(target=w.run, daemon=True, name=f"worker-{name}")
        t.start()
        self.workers.append(w)
        self.threads.append(t)
        return w

    def drain_worker(self, w, timeout: float = 30.0) -> str:
        """Gracefully drain one in-process worker; returns its
        stopped_reason — "drained" on success."""
        assert w.request_drain(), "drain request not sendable"
        t = self.threads[self.workers.index(w)]
        t.join(timeout)
        return w.stopped_reason

    def run_to_completion(self, timeout: float = DONE_TIMEOUT):
        assert self.frontend.wait_for_backends(timeout=5)
        self.frontend.start_simulation()
        assert self.frontend.done.wait(timeout), "cluster did not finish"
        assert self.frontend.error is None, self.frontend.error
        return self.frontend.final_board

    def shutdown(self):
        self.frontend.stop()
        for w in self.workers:
            w.stop()


@contextlib.contextmanager
def cluster(
    config,
    n_backends,
    observer=None,
    engine="torch",
    pallas=None,
    device=None,
    registry=None,
    tracer=None,
):
    h = ClusterHarness(
        config,
        n_backends,
        observer=observer,
        engine=engine,
        pallas=pallas,
        device=device,
        registry=registry,
        tracer=tracer,
    )
    try:
        yield h
    finally:
        h.shutdown()
