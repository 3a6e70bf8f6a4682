"""Multi-tenant serving plane: batched boards + session router + HTTP API.

Counterpart of ``akka_game_of_life_tpu/serve/``:
thousands of small per-user boards advancing together on one device
(:mod:`.batch`, per-board rule masks as data), a session table + job queue
feeding the engine in ticks with admission control (:mod:`.sessions`), the
cross-tenant memo plane (:mod:`.memo`), the canary prober (:mod:`.canary`)
and ``/boards`` HTTP routes mounted on the obs endpoint (:mod:`.api`).  The
serving cluster shards sessions over backend workers: the frontend's
``ClusterServePlane`` / ``run_serve_cluster`` (:mod:`.cluster`) and each
worker's ``ServeWorkerPlane`` (:mod:`.worker`); several such frontends
federate over one keyspace (:mod:`.federation`).
"""

from akka_game_of_life_tpu_torch.serve.api import board_routes, run_serve
from akka_game_of_life_tpu_torch.serve.batch import (
    DEFAULT_SIZE_CLASSES,
    batch_step_fn,
    size_class,
)
from akka_game_of_life_tpu_torch.serve.sessions import (
    AdmissionError,
    Session,
    SessionRouter,
)

__all__ = [
    "AdmissionError",
    "ClusterServePlane",
    "DEFAULT_SIZE_CLASSES",
    "ServeWorkerPlane",
    "Session",
    "SessionRouter",
    "batch_step_fn",
    "board_routes",
    "run_serve",
    "run_serve_cluster",
    "size_class",
]

def __getattr__(name):
    # The cluster-sharded plane imports runtime.frontend machinery; lazy
    # so `import akka_game_of_life_tpu_torch.serve` stays light for the
    # single-process role.
    if name in ("ClusterServePlane", "run_serve_cluster"):
        from akka_game_of_life_tpu_torch.serve import cluster as _c

        return getattr(_c, name)
    if name == "ServeWorkerPlane":
        from akka_game_of_life_tpu_torch.serve.worker import ServeWorkerPlane

        return ServeWorkerPlane
    raise AttributeError(name)
