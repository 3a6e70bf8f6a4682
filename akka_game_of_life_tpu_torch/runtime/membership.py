"""Cluster membership — the Akka Cluster gossip/DeathWatch capability.

The reference gets membership from Akka Cluster: gossip with a seed node,
``MemberUp``/``MemberRemoved`` events, aggressive 1-second auto-down
(``application.conf:19-23``), plus per-actor DeathWatch
(``BoardCreator.scala:83,120-121``).  Here the frontend *is* the seed node;
workers register over TCP and heartbeat; a member is evicted when its
connection drops (DeathWatch) or its heartbeat goes stale past
``failure_timeout_s`` (auto-down).  Same two failure detectors, one registry.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from akka_game_of_life_tpu_torch.runtime.tiles import TileId


@dataclasses.dataclass
class Member:
    name: str
    channel: object  # wire.Channel
    last_seen: float
    tiles: List[TileId] = dataclasses.field(default_factory=list)
    alive: bool = True
    # Peer-to-peer data-plane address (host as seen by the frontend, the
    # worker's advertised peer listener port) — brokered to other workers
    # via OWNERS; the frontend itself never carries ring bytes.
    peer_host: str = ""
    peer_port: int = 0
    # Graceful scale-in: a draining member still serves everything it owns
    # but receives no NEW tiles (placement, recovery, or migration) while
    # the elastic plane moves its tiles off; drain_acked marks the one
    # DRAIN_COMPLETE release already sent.
    draining: bool = False
    drain_acked: bool = False


class Membership:
    """Thread-safe member registry with heartbeat-based failure detection."""

    def __init__(self, failure_timeout_s: float) -> None:
        self.failure_timeout_s = failure_timeout_s
        self._members: Dict[str, Member] = {}
        self._lock = threading.RLock()
        self._seq = 0

    def register(
        self,
        channel,
        name: Optional[str] = None,
        peer_host: str = "",
        peer_port: int = 0,
    ) -> Member:
        with self._lock:
            self._seq += 1
            if not name:
                name = f"backend-{self._seq}"
            if name in self._members and self._members[name].alive:
                name = f"{name}-{self._seq}"
            m = Member(
                name=name,
                channel=channel,
                last_seen=time.monotonic(),
                peer_host=peer_host,
                peer_port=peer_port,
            )
            self._members[name] = m
            return m

    def beat(self, name: str) -> None:
        with self._lock:
            m = self._members.get(name)
            if m is not None:
                m.last_seen = time.monotonic()

    def get(self, name: str) -> Optional[Member]:
        with self._lock:
            return self._members.get(name)

    def alive_members(self) -> List[Member]:
        with self._lock:
            return [m for m in self._members.values() if m.alive]

    def placeable_members(self) -> List[Member]:
        """Members that may RECEIVE tiles: alive and not draining.  Every
        placement decision (initial deal, node-loss reassignment, migration
        destination) filters through this — a worker mid-drain must never
        be handed new work it would immediately have to hand back."""
        with self._lock:
            return [
                m for m in self._members.values() if m.alive and not m.draining
            ]

    def mark_dead(self, name: str) -> Optional[Member]:
        """DeathWatch fired (EOF) or auto-down (stale heartbeat)."""
        with self._lock:
            m = self._members.get(name)
            if m is None or not m.alive:
                return None
            m.alive = False
            return m

    def stale_members(self, now: Optional[float] = None) -> List[Member]:
        now = now if now is not None else time.monotonic()
        with self._lock:
            return [
                m
                for m in self._members.values()
                if m.alive and (now - m.last_seen) > self.failure_timeout_s
            ]
