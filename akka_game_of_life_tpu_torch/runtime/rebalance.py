"""Elastic rebalancing: the frontend's live tile-migration planner.

The reference cluster only *reacts* to failure (node-loss redeploy,
supervision replay); production elasticity needs the proactive motions —
scale-out (a late joiner receives load mid-run) and scale-in (a draining
worker hands its tiles back before leaving).  Both ride ONE mechanism, the
three-phase live migration the :class:`Rebalancer` plans and the frontend
executes:

  PREPARE   frontend → source: ``MIGRATE_PREPARE`` freezes the tile at its
            next chunk boundary (the worker refuses to start new chunks;
            in-flight compute completes normally under the worker lock).
  TRANSFER  source → frontend: ``MIGRATE_STATE`` ships the tile bit-packed
            (the ``pack_tile`` codec, 8 cells/byte) at its live epoch,
            plus the source-computed 64-bit digest lanes.  The frontend
            re-derives the lanes from the payload (``digest_payload_np``)
            and refuses a mismatch LOUDLY — a corrupted transfer must roll
            back, never fork the trajectory.
  COMMIT    frontend: atomically rewire ownership (one OWNERS broadcast),
            then DEPLOY the certified payload to the destination at the
            frozen epoch.  The source drops the tile on the OWNERS receipt
            — until that moment it still owns the canonical state, so a
            destination death, a digest mismatch, or a deadline all roll
            back by simply unfreezing the source (``MIGRATE_ABORT``); no
            epoch is ever lost.

This module holds only the *policy* and the in-flight bookkeeping — pure
data structures the frontend mutates under its own lock.  All wire traffic,
membership, and metrics stay in :mod:`runtime.frontend`.

The planner knows THREE resource types: big-board *tiles* (:meth:`plan`),
the serving plane's *session shards* (:meth:`plan_shards` — groups of
tenant sessions hashed to a shard id, moved between workers by the same
freeze → transfer → certify → commit protocol at session granularity; see
:mod:`akka_game_of_life_tpu_torch.serve.cluster`), and *resident tiled chunks*
(:meth:`plan_resident` — a worker-resident mega-board session's chunks,
re-homed digest-certified under the session's step barrier lock so a move
can never interleave with an epoch round).  The in-flight bookkeeping is
shared code: shard moves ride :class:`Migration` records keyed by the
integer shard id, chunk moves by the (sid, (cy, cx)) tuple, each in its
own serve-plane-owned Rebalancer instance.

Failure handling follows the peer plane's retry discipline: an aborted migration puts its
tile on a decorrelated-jitter cooldown (``delay = min(retry_max_s,
uniform(retry_s, 3·last))``, reset on success) so a flapping destination
sees a handful of desynchronized attempts per window, not a retry storm;
peer-plane traffic the migration induces (the destination's ring-history
pull from the source) rides the existing per-peer circuit breakers.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

from akka_game_of_life_tpu_torch.runtime.tiles import TileId


def rendezvous_pick(key: str, names):
    """Highest-random-weight pick: the name maximizing crc32(f"{key}:{n}")
    (name as the deterministic tiebreak); None on an empty pool.  A copy of
    the JAX package's ``serve/sessions.py`` function, whose module the port
    does not carry."""
    import zlib

    pool = list(names)
    if not pool:
        return None
    return max(
        pool, key=lambda n: (zlib.crc32(f"{key}:{n}".encode("utf-8")), n)
    )


@dataclasses.dataclass
class Migration:
    """One in-flight tile move, PREPARE through COMMIT/abort."""

    tile: TileId
    source: str
    dest: str
    seq: int
    started: float  # monotonic, for gol_migration_seconds
    deadline: float  # monotonic; overdue → abort + cooldown
    span: object = None  # the frontend's migrate.tile span


class Rebalancer:
    """Plans tile moves and tracks the in-flight set.

    NOT thread-safe on its own: the frontend mutates it strictly under the
    frontend lock (the same discipline as ``tile_owner``/``tile_epochs``).
    ``rebalance_enabled`` gates only the automatic imbalance planning;
    drain-driven moves (a member marked draining) are always planned —
    graceful scale-in must work on any cluster.
    """

    def __init__(self, config) -> None:
        self.enabled = config.rebalance_enabled
        self.interval_s = config.rebalance_interval_s
        self.min_gap = config.rebalance_min_gap
        self.max_inflight = config.rebalance_max_inflight
        self.deadline_s = config.rebalance_deadline_s
        # The peer plane's backoff policy, applied to migration retries.
        self._retry_s = config.retry_s
        self._retry_max_s = config.retry_max_s
        self._rng = random.Random(f"rebalance:{config.seed}")
        self.inflight: Dict[TileId, Migration] = {}
        self._seq = 0
        self._next_plan_at = 0.0
        self._next_shard_plan_at = 0.0
        self._next_resident_plan_at = 0.0
        self._cooldown: Dict[TileId, float] = {}  # tile → not-before
        self._delay: Dict[TileId, float] = {}  # tile → last chosen backoff

    # -- in-flight bookkeeping ------------------------------------------------

    def begin(
        self, tile: TileId, source: str, dest: str, now: float
    ) -> Migration:
        self._seq += 1
        mig = Migration(
            tile=tile,
            source=source,
            dest=dest,
            seq=self._seq,
            started=now,
            deadline=now + self.deadline_s,
        )
        self.inflight[tile] = mig
        return mig

    def get(self, tile, seq: int) -> Optional[Migration]:
        """The in-flight migration a MIGRATE_STATE / SHARD_STATE answers,
        or None for a stale/unknown (key, seq) — a state frame from an
        already-aborted attempt must be ignored, never committed.  Keys
        are TileId tuples for tile moves, plain ints for shard moves."""
        key = tuple(tile) if isinstance(tile, (list, tuple)) else tile
        mig = self.inflight.get(key)
        return mig if mig is not None and mig.seq == seq else None

    def complete(self, tile: TileId) -> Optional[Migration]:
        """Commit: drop the in-flight record and reset the tile's backoff."""
        self._cooldown.pop(tile, None)
        self._delay.pop(tile, None)
        return self.inflight.pop(tile, None)

    def abort(self, tile: TileId, now: float) -> Optional[Migration]:
        """Rollback: drop the record and put the tile on a decorrelated-
        jitter cooldown before the planner may try it again."""
        last = self._delay.get(tile, self._retry_s)
        delay = min(self._retry_max_s, self._rng.uniform(self._retry_s, 3 * last))
        self._delay[tile] = delay
        self._cooldown[tile] = now + delay
        return self.inflight.pop(tile, None)

    def expired(self, now: float) -> List[Migration]:
        return [m for m in self.inflight.values() if now >= m.deadline]

    def drop_member(self, name: str) -> List[Migration]:
        """Migrations that must abort because ``name`` left the cluster
        (either end of an in-flight move)."""
        return [
            m for m in self.inflight.values() if name in (m.source, m.dest)
        ]

    # -- planning -------------------------------------------------------------

    def plan(
        self,
        members,
        tile_epochs: Dict[TileId, int],
        final_epoch: int,
        now: float,
        drain_only: bool = False,
    ) -> List[Tuple[TileId, str, str]]:
        """(tile, source, dest) moves to start this pass.

        Drain-driven moves come first and are planned every pass; automatic
        imbalance moves run only when enabled, at ``interval_s`` cadence,
        and never when ``drain_only`` (a paused cluster still honors
        drains — a paused tile is not stepping, so moving it is safe — but
        must not reshape for load).
        Loads are projected through the in-flight set so a slow migration
        is not double-planned, and every destination filters to placeable
        (alive, not draining) members.
        """
        moves: List[Tuple[TileId, str, str]] = []
        budget = self.max_inflight - len(self.inflight)
        if budget <= 0:
            return moves
        placeable = [m for m in members if m.alive and not m.draining]
        if not placeable:
            return moves
        loads = {m.name: len(m.tiles) for m in placeable}
        for mig in self.inflight.values():
            if mig.dest in loads:
                loads[mig.dest] += 1
            if mig.source in loads:
                loads[mig.source] = max(0, loads[mig.source] - 1)
        planned = set()

        def movable(m, require_unfinished: bool = False):
            out = [
                t
                for t in m.tiles
                if t not in self.inflight
                and t not in planned
                and self._cooldown.get(t, 0.0) <= now
            ]
            if require_unfinished and final_epoch:
                # Load balancing skips tiles already at the final epoch
                # (nothing left to speed up); drains still move them —
                # the member cannot leave while it owns anything.
                out = [t for t in out if tile_epochs.get(t, 0) < final_epoch]
            # Most caught-up first: freezing the tile closest to the
            # target blocks the fewest neighbor halo assemblies.
            out.sort(key=lambda t: tile_epochs.get(t, 0), reverse=True)
            return out

        # 1. Drain-driven: empty draining members as fast as the in-flight
        # budget allows.  A draining member is its own source only.
        for m in members:
            if not (m.alive and m.draining):
                continue
            for tile in movable(m):
                if budget <= 0 or not loads:
                    break
                dest = min(loads, key=lambda n: loads[n])
                moves.append((tile, m.name, dest))
                planned.add(tile)
                loads[dest] += 1
                budget -= 1

        # 2. Load-driven: most- → least-loaded while the gap holds.  The
        # effective gap floor is 2 whatever min_gap says: moving a tile
        # across a gap of 1 swaps which member is fuller without lowering
        # the peak load — a planner honoring gap 1 ping-pongs the same
        # tile forever once loads are as even as the tile count allows.
        if self.enabled and not drain_only and budget > 0 and now >= self._next_plan_at:
            self._next_plan_at = now + self.interval_s
            gap = max(2, self.min_gap)
            while budget > 0 and len(loads) >= 2:
                src = max(placeable, key=lambda m: loads[m.name])
                dest = min(loads, key=lambda n: loads[n])
                if dest == src.name or loads[src.name] - loads[dest] < gap:
                    break
                cands = movable(src, require_unfinished=True)
                if not cands:
                    break
                tile = cands[0]
                moves.append((tile, src.name, dest))
                planned.add(tile)
                loads[src.name] -= 1
                loads[dest] += 1
                budget -= 1
        return moves

    def plan_shards(
        self,
        owners: Dict[int, str],
        weights: Dict[int, int],
        members,
        now: float,
        drain_only: bool = False,
        replicas: Optional[Dict[int, Optional[str]]] = None,
    ) -> List[Tuple[int, str, str]]:
        """(shard, source, dest) **session-shard** moves — the planner's
        second resource type (the cluster-sharded serving plane; the serve
        plane owns its own Rebalancer instance, so the in-flight budget
        and cooldowns never contend with tile moves).

        Same policy shape as :meth:`plan` with one deliberate difference:
        load-driven spreading ignores ``rebalance_enabled``.  For tiles,
        rebalancing is an optimization of a run that works anyway; for
        serving, a worker with zero shards serves zero traffic — spreading
        shards onto a late joiner IS how ``--grow-to`` buys boards/sec, so
        it is product behavior, not tuning.  It stays cadenced by
        ``interval_s`` and floored at a gap of 2 (a gap-1 shard move
        ping-pongs exactly like a gap-1 tile move).  Drain-driven moves
        come first and empty the drainer lightest-shards-first
        (``weights`` = sessions per shard), so a draining worker is
        released in the fewest protocol rounds blocked behind big
        exports.  In the port they are planned past the in-flight
        budget, every movable shard of the drainer in one pass (the
        loaded ones still spend it, so load-driven moves wait): the
        budget bounds load-driven reshaping, while a drain is bounded by
        what the drainer holds and must end within the worker's drain
        bound (the JAX planner stops at the budget, so a drain there
        moves one loaded shard at a time).

        ``replicas`` (shard → replica worker, from the serve plane's
        replication table) is a PLACEMENT CONSTRAINT: a shard and its
        replica should not co-reside, so a shard's replica is avoided as
        its migration destination whenever any other placeable member
        exists.  When the replica is the ONLY destination (a 2-worker
        drain), the move still happens — wedging a drain forever would be
        worse than a transient co-residence, and the serve plane's
        post-commit replica refresh re-homes the replica in the same lock
        hold that commits the move."""
        moves: List[Tuple[int, str, str]] = []
        # The in-flight budget bounds only LOADED shards (each move
        # freezes sessions and runs the transfer protocol).  An EMPTY
        # shard (weight 0) flips ownership with no wire traffic at all,
        # so empties move budget-free — this is what lets a late joiner
        # absorb half an idle cluster's shard table in one pass.
        budget = self.max_inflight - len(self.inflight)
        free_budget = len(owners)  # hard per-pass bound, not a resource
        placeable = [m for m in members if m.alive and not m.draining]
        if not placeable:
            return moves
        loads = {m.name: 0 for m in placeable}
        for owner in owners.values():
            if owner in loads:
                loads[owner] += 1
        for mig in self.inflight.values():
            if mig.dest in loads:
                loads[mig.dest] += 1
            if mig.source in loads:
                loads[mig.source] = max(0, loads[mig.source] - 1)
        planned: set = set()

        def movable(name: str) -> List[int]:
            out = [
                s
                for s, o in owners.items()
                if o == name
                and s not in self.inflight
                and s not in planned
                and self._cooldown.get(s, 0.0) <= now
            ]
            out.sort(key=lambda s: (weights.get(s, 0), s))
            return out

        def charge(shard: int) -> bool:
            nonlocal budget, free_budget
            if weights.get(shard, 0) == 0:
                if free_budget <= 0:
                    return False
                free_budget -= 1
                return True
            if budget <= 0:
                return False
            budget -= 1
            return True

        def pick_dest(shard: int, exclude=()) -> Optional[str]:
            """Least-loaded placeable destination, avoiding the shard's
            replica (the no-co-residence constraint) unless the replica
            is the only destination left."""
            pool = [n for n in loads if n not in exclude]
            if not pool:
                return None
            banned = (replicas or {}).get(shard)
            cands = [n for n in pool if n != banned] or pool
            return min(cands, key=lambda n: (loads[n], n))

        # 1. Drain-driven: always planned, every pass, past the budget
        # (lightest shards first).  Loaded ones still spend it, so no
        # load-driven move starts while a drain's are in flight.
        for m in members:
            if not (m.alive and m.draining):
                continue
            for shard in movable(m.name):
                if not loads:
                    break
                dest = pick_dest(shard)
                if dest is None:
                    continue
                moves.append((shard, m.name, dest))
                planned.add(shard)
                loads[dest] += 1
                if weights.get(shard, 0):
                    budget -= 1

        # 2. Load-driven spreading (shard-count gap ≥ 2), cadenced.  The
        # (shard, dest) pair is chosen together: each candidate shard's
        # replica bans ITS least-loaded destination individually, so one
        # shard's constraint never blocks the whole pass.
        if not drain_only and now >= self._next_shard_plan_at:
            self._next_shard_plan_at = now + self.interval_s
            gap = max(2, self.min_gap)
            while len(loads) >= 2:
                src = max(placeable, key=lambda m: loads.get(m.name, 0))
                choice = None
                for s in movable(src.name):
                    d = pick_dest(s, exclude=(src.name,))
                    if d is None or loads[src.name] - loads[d] < gap:
                        continue
                    choice = (s, d)
                    break
                if choice is None or not charge(choice[0]):
                    break
                shard, dest = choice
                moves.append((shard, src.name, dest))
                planned.add(shard)
                loads[src.name] -= 1
                loads[dest] += 1
        return moves

    def plan_slices(
        self,
        owners: Dict[int, str],
        weights: Dict[int, int],
        frontends,
        me: str,
    ) -> List[Tuple[int, str, str]]:
        """(slice, source, dest) **frontend-slice** releases — the
        planner's fourth resource type (the federation's serve-keyspace
        slices; ``serve/federation.py``).

        Deliberately the narrowest policy of the four: only EMPTY
        self-owned slices move, and only to their rendezvous-desired
        owner.  A non-empty slice never migrates between frontends —
        sessions are process-resident, so moving a loaded slice would
        mean moving boards across frontends for a placement preference;
        ownership of loaded slices changes only through confirmed-death
        promotion.  Empty releases are budget-free (ownership flips in
        one gossip round, like ``plan_shards``'s weight-0 empties), and
        the rendezvous target is deterministic over the live set, so a
        release can never ping-pong.

        ``owners`` is this frontend's view restricted to slices it owns;
        ``frontends`` is the sorted live frontend-name list (self
        included); ``me`` is this frontend's name."""
        moves: List[Tuple[int, str, str]] = []
        live = sorted(frontends)
        if len(live) < 2:
            return moves
        for shard, owner in sorted(owners.items()):
            if owner != me or weights.get(shard, 0):
                continue
            desired = rendezvous_pick(f"slice:{shard}", live)
            if desired is not None and desired != me:
                moves.append((shard, me, desired))
        return moves

    def plan_resident(
        self,
        owners: Dict[tuple, str],
        members,
        now: float,
        drain_only: bool = False,
        replicas: Optional[Dict[tuple, Optional[str]]] = None,
    ) -> List[Tuple[tuple, str, str]]:
        """(chunk key, source, dest) **resident tiled chunk** moves — the
        planner's third resource type.  Keys are (sid, (cy, cx)) tuples;
        every move is a real state transfer (export → certify → adopt
        under the session's step barrier), so every load-driven move
        charges the in-flight budget.  Same drain-always / load-cadenced
        policy shape as :meth:`plan_shards`, with the chunk's replica
        avoided as a destination (the no-co-residence constraint, falling
        back when it is the last placeable member — a 2-worker drain must
        not wedge).  As there, the port plans drain moves past the
        budget, every movable chunk of the drainer in one pass (the serve
        plane moves a session's chunks for one destination in one
        protocol round); the JAX planner moves them one at a time."""
        moves: List[Tuple[tuple, str, str]] = []
        budget = self.max_inflight - len(self.inflight)
        placeable = [m for m in members if m.alive and not m.draining]
        if not placeable:
            return moves
        loads = {m.name: 0 for m in placeable}
        for owner in owners.values():
            if owner in loads:
                loads[owner] += 1
        for mig in self.inflight.values():
            if mig.dest in loads:
                loads[mig.dest] += 1
            if mig.source in loads:
                loads[mig.source] = max(0, loads[mig.source] - 1)
        planned: set = set()

        def movable(name: str) -> List[tuple]:
            return sorted(
                k
                for k, o in owners.items()
                if o == name
                and k not in self.inflight
                and k not in planned
                and self._cooldown.get(k, 0.0) <= now
            )

        def pick_dest(key: tuple, exclude=()) -> Optional[str]:
            pool = [n for n in loads if n not in exclude]
            if not pool:
                return None
            banned = (replicas or {}).get(key)
            cands = [n for n in pool if n != banned] or pool
            return min(cands, key=lambda n: (loads[n], n))

        # 1. Drain-driven: always planned, every pass, past the budget
        # (which they still spend: no load-driven move starts meanwhile).
        for m in members:
            if not (m.alive and m.draining):
                continue
            for key in movable(m.name):
                if not loads:
                    break
                dest = pick_dest(key)
                if dest is None:
                    continue
                moves.append((key, m.name, dest))
                planned.add(key)
                loads[dest] += 1
                budget -= 1

        # 2. Load-driven spreading (chunk-count gap ≥ 2), cadenced.
        if not drain_only and budget > 0 and now >= self._next_resident_plan_at:
            self._next_resident_plan_at = now + self.interval_s
            gap = max(2, self.min_gap)
            while budget > 0 and len(loads) >= 2:
                src = max(placeable, key=lambda m: loads.get(m.name, 0))
                choice = None
                for k in movable(src.name):
                    d = pick_dest(k, exclude=(src.name,))
                    if d is None or loads[src.name] - loads[d] < gap:
                        continue
                    choice = (k, d)
                    break
                if choice is None:
                    break
                key, dest = choice
                moves.append((key, src.name, dest))
                planned.add(key)
                loads[src.name] -= 1
                loads[dest] += 1
                budget -= 1
        return moves
