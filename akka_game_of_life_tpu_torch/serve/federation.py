"""Frontend federation: only :class:`FederationRedirect` so far.

Counterpart of ``akka_game_of_life_tpu/serve/federation.py:FederationRedirect``.
The ``/boards`` route (``serve/api.py``) catches it to answer 307 with the
owning frontend's URL.  The rest of the federation plane (gossiped slice
maps, forwarded ops, peer-replicated control state) comes with the serving
cluster, a later slice of the port; until then the ``frontend_*`` config
keys are refused by name.
"""

from __future__ import annotations

__all__ = ["FederationRedirect"]


class FederationRedirect(Exception):
    """A request whose payload is too fat to proxy (GET ``/boards/<id>``
    carries the board): answer 307 with the owning frontend's URL.  The
    HTTP layer (``BoardsRoute._respond``) maps this to a ``Location``
    header; every other surface treats it as an error."""

    def __init__(self, url: str) -> None:
        super().__init__(url)
        self.url = url
