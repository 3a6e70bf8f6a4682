"""Multi-tenant serving plane: batched boards + session router + HTTP API.

Counterpart of ``akka_game_of_life_tpu/serve/``'s single-process plane:
thousands of small per-user boards advancing together on one device
(:mod:`.batch`, per-board rule masks as data), a session table + job queue
feeding the engine in ticks with admission control (:mod:`.sessions`), the
cross-tenant memo plane (:mod:`.memo`), the canary prober (:mod:`.canary`)
and ``/boards`` HTTP routes mounted on the obs endpoint (:mod:`.api`).  The
serving cluster (``ClusterServePlane``, ``run_serve_cluster``,
``ServeWorkerPlane``) is a later slice of the port and raises by name.
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
    "DEFAULT_SIZE_CLASSES",
    "Session",
    "SessionRouter",
    "batch_step_fn",
    "board_routes",
    "run_serve",
    "size_class",
]

_CLUSTER_NAMES = ("ClusterServePlane", "run_serve_cluster", "ServeWorkerPlane")


def __getattr__(name):
    if name in _CLUSTER_NAMES:
        raise NotImplementedError(
            f"{name} belongs to the serving cluster, which the PyTorch port "
            f"does not support yet (a later slice of the port); the "
            f"single-process plane is SessionRouter / run_serve"
        )
    raise AttributeError(name)
