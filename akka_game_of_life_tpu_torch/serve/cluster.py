"""Cluster-sharded serving: the session router as the frontend's surface.

The single-process serving plane batches small boards on ONE process; the
elastic cluster runs ONE big board across workers.  This module fuses them: the
:class:`ClusterServePlane` is the cluster frontend's tenant-facing router —
it owns cluster-wide admission and the session *index*, while the boards
themselves live sharded across workers, each worker running its own
batch engine (:mod:`serve.worker` wraps the ``SessionRouter``
unchanged as the per-worker core).  Serve capacity then scales with
``--grow-to``: boards/sec multiplies by worker count because every worker
ticks its own device program concurrently.

**Shard routing.**  Session ids hash onto ``serve_shards`` virtual shards
(crc32, stable across processes); each shard is owned by one worker.  A
session's whole life stays on its shard's owner — the board is resident
worker-side between ticks (the Casper access-pattern lesson: move the
session once, not its cells every tick), and ops for one worker coalesce
into single ``SERVE_OPS`` frames (the halo plane's coalescing discipline on the
control plane).

**Shard migration.**  The elastic Rebalancer learns session shards as a
second resource type (:meth:`runtime.rebalance.Rebalancer.plan_shards`):
load-driven spreading (a late joiner starts receiving shards) and
drain-driven evacuation ride the same freeze → transfer → certify →
commit protocol as tile migration, at session granularity — every
exported board is certified via ``digest_payload_np`` before commit, ops
arriving mid-move are *held* and replayed at the new owner, and a
mid-traffic SIGTERM drain loses zero admitted jobs.  A shard with no
sessions flips ownership without any wire protocol.

**Session replication & crash failover.**  Each owned shard gets a
*replica* worker (sticky once assigned — churn discards acked standby
state; rendezvous-hashed by (shard, worker) on fresh assignment so a
membership change re-homes only the shards that must move; never the
primary): the primary streams dirty session snapshots —
bit-packed boards plus digest lanes — to the frontend
(``SHARD_REPLICATE``), which relays them to the replica as ``replicate``
ops on the replica's op FIFO and acks the primary with the per-session
epoch watermark (``SHARD_REPLICATE_ACK``, on the primary's op FIFO — so
replication can never reorder against shard control).  On worker loss
the frontend *promotes* replicas instead of 404ing: the replica
certifies every standby payload against its streamed lanes and installs
it, promoted sessions resume from their last acked replicated epoch, and
ops caught in the window answer the retryable 429 ``failover`` (the
board is provably at its replicated epoch) rather than 404.  When no
second placeable worker exists the plane degrades honestly to
single-copy mode (``gol_serve_single_copy_shards`` + the /healthz flag;
primaries park their streams), and replication lag past
``serve_replicate_max_lag_s`` is surfaced loudly, never silently
unbounded.  A shard and its replica do not co-reside — the rebalancer
avoids a shard's replica as a migration destination (falling back only
when it is the last placeable member, with the replica re-homed in the
same lock hold that commits the move), and drains re-home replicas (a
draining worker is released only once nothing replicates to it).

**Tiled (mega-board) sessions.**  A board above the largest size class is
no longer rejected: it is admitted as a first-class *tiled* session.
With ``serve_tiled_resident`` on (the default) the session is
WORKER-RESIDENT: chunks install once on their assigned workers and stay
device-side across steps; per step request the frontend sends ONE op per
worker naming the barrier epoch, the per-round step counts, and the
chunk→owner aiming map — the workers then chain the rounds themselves,
exchanging O(perimeter) halo strips worker-to-worker (``TILED_HALO``
over the peer plane, batched and bit-packed per destination) and
batching each round's ready chunks into one batched device call.  The
frontend re-enters only at the request barrier (merged digest lanes, 16
bytes a chunk) and on renders (``GET ?with_board=1`` pays the one
remaining O(area) fetch).  Chunks snapshot at a barrier cadence and
stream to per-chunk replicas through the session replication watermarks; a
worker loss PROMOTES at the session's certified epoch (lost chunks from
replica standby, survivors rolled back to their local snapshot — the
whole session resumes consistent, windowed ops answer 429 ``failover``),
and the Rebalancer re-homes resident chunks digest-certified under the
session's steplock (a move can never interleave with an epoch barrier).
With the gate off, the ship-per-round path runs: the frontend
keeps the board and each step fans ``step_raw`` chunks with full state
across ALL workers (pure operands; a crash mid-chunk replays
elsewhere).  Either way per-tile digest lanes computed at global offsets
merge into the session digest — the same certification plane as the
big-board cluster.

Counterpart of ``akka_game_of_life_tpu/serve/cluster.py``, frame for frame,
so its workers may be the port's or the JAX package's.  The frontend half
holds no device state (index, routing, digests on the host); the cells
step on the workers' devices (``serve/worker.py``).  With the frontend
federation on (``serve/federation.py``) the plane also streams its control
rows to a standby peer frontend (:meth:`ClusterServePlane.control_rows`),
adopts a dead peer's rows (:meth:`begin_federation_promotion`, closed by
the re-homed workers' ``SHARD_HOME`` or by
:meth:`expire_federation_promotion`).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from akka_game_of_life_tpu_torch.obs import get_registry
from akka_game_of_life_tpu_torch.obs import slo as _slo
from akka_game_of_life_tpu_torch.obs.tracing import TRACE_KEY, current, get_tracer
from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.runtime import protocol as P
from akka_game_of_life_tpu_torch.runtime.rebalance import Rebalancer
from akka_game_of_life_tpu_torch.runtime.wire import pack_tile, unpack_tile
from akka_game_of_life_tpu_torch.serve import batch as sbatch
from akka_game_of_life_tpu_torch.serve.sessions import (
    JOB_GRACE_S,
    JOB_TIMEOUT_S,
    AdmissionError,
    rendezvous_pick,
    shard_of,
    validate_create,
)
from akka_game_of_life_tpu_torch.utils.patterns import random_grid

# Bounded re-routes for one op (shard moved under it, worker lost before
# the frame went out, worker answered "migrating"): each retry lands on a
# live owner or fails loudly — never a silent drop, never a spin.
OP_MAX_RETRIES = 4
# Tile-chunk ops of a mega-board step are pure functions of their
# operands: a worker loss mid-chunk replays the SAME chunk elsewhere.
TILE_OP_RETRIES = 3
# The port's worker times its half of a shard move in SHARD_STATE (seconds
# waiting for the frozen sessions' jobs, seconds exporting them).
_WORKER_SPLIT = ("freeze_wait_s", "export_s")
# A resident-chunk move runs in rounds of at most this many chunks, each
# its own hold of the session's steplock (export, certify, adopt), so a
# step request waits out at most one round, never a whole drain.
TILED_MOVE_ROUND_CHUNKS = 16
# Between two rounds the mover lets the steps queued on the lock go first,
# waiting at most this long for them to take it.
TILED_HANDOFF_S = 0.25
# Threads certifying a round's exported chunks (digest_payload_np's numpy
# passes release the GIL on a 256² chunk).
TILED_CERTIFY_THREADS = 4
# A round's digest key tables are made before its hold, up to this many
# cells a round (8 bytes a cell); past it the hold mixes the keys itself.
TILED_CERTIFY_KEY_CELLS = 1 << 22


class _Entry:
    """Cluster-side session index row: where a session lives and the last
    observed (epoch, digest) — the authoritative board stays worker-side
    (or plane-side for tiled sessions)."""

    __slots__ = (
        "sid", "tenant", "kind", "rule_s", "height", "width",
        "seed", "density", "shard", "epoch", "digest", "last_used",
        "evicting", "repl_epoch", "repl_dirty_since",
    )

    def __init__(self, sid, tenant, kind, rule_s, height, width, seed,
                 density, shard):
        self.sid = sid
        self.tenant = tenant
        self.kind = kind  # "batch" | "tiled"
        self.rule_s = rule_s
        self.height = height
        self.width = width
        self.seed = seed
        self.density = density
        self.shard = shard  # None for tiled sessions (plane-resident)
        self.epoch = 0
        self.digest: Optional[str] = None
        # TTL bookkeeping: the FRONTEND owns idle eviction in cluster mode
        # (workers get serve_ttl_s=0 — a local eviction would silently
        # leak the cluster admission budget this index charges).
        self.last_used = time.monotonic()
        self.evicting = False
        # Replication watermark: the highest epoch the shard's replica has
        # ACKED for this session (-1 = nothing replicated — a promotion
        # cannot save it), and when the session first advanced past it
        # (None = clean; the lag gauge reads this).
        self.repl_epoch = -1
        self.repl_dirty_since: Optional[float] = time.monotonic()

    def mark_dirty(self, now: float) -> None:
        """Epoch moved past the acked watermark: start the lag clock
        (idempotent — the clock keeps its ORIGINAL dirty time until the
        replica catches all the way up)."""
        if (
            self.shard is not None
            and self.epoch > self.repl_epoch
            and self.repl_dirty_since is None
        ):
            self.repl_dirty_since = now

    def summary(self, owner: Optional[str]) -> dict:
        return {
            "id": self.sid,
            "tenant": self.tenant,
            "rule": self.rule_s,
            "kind": self.kind,
            "height": self.height,
            "width": self.width,
            "seed": self.seed,
            "epoch": self.epoch,
            "digest": self.digest,
            "shard": self.shard,
            "worker": owner,
        }


class _TiledSession:
    """A frontend-resident mega-board and its tile grid (the
    ship-per-round mode: ``serve_tiled_resident`` off)."""

    mode = "ship"

    __slots__ = ("board", "lanes", "epoch", "tiles", "steplock")

    def __init__(self, board: np.ndarray, tile_side: int) -> None:
        self.board = board
        self.lanes = odigest.digest_dense_np(board)
        self.epoch = 0
        h, w = board.shape
        self.tiles: List[Tuple[int, int, int, int]] = [
            (gy, gx, min(tile_side, h - gy), min(tile_side, w - gx))
            for gy in range(0, h, tile_side)
            for gx in range(0, w, tile_side)
        ]
        # Serializes concurrent steps of ONE mega session (each step is a
        # multi-chunk read-modify-write of the resident board); different
        # sessions step fully in parallel.
        self.steplock = threading.Lock()


class _ResidentTiled:
    """A worker-resident mega-board session: the frontend holds only the
    chunk grid, placement maps, and digest/watermark bookkeeping — the
    cells live on the workers and per-round traffic is O(perimeter) peer
    halo strips, never board state through here."""

    mode = "resident"

    __slots__ = (
        "sid", "rule_s", "H", "W", "k", "ny", "nx", "tiles",
        "owner", "replica", "acked", "epoch", "lanes", "population",
        "steplock", "promoting", "round_idx", "parked", "waiting",
        "turns",
    )

    def __init__(self, sid: str, rule_s: str, board: np.ndarray,
                 tile_side: int, tile_chunk: int) -> None:
        self.sid = sid
        self.rule_s = rule_s
        self.H, self.W = board.shape
        grid_y = range(0, self.H, tile_side)
        grid_x = range(0, self.W, tile_side)
        self.ny = len(grid_y)
        self.nx = len(grid_x)
        # (cy, cx) -> (gy, gx, th, tw)
        self.tiles: Dict[Tuple[int, int], Tuple[int, int, int, int]] = {
            (cy, cx): (gy, gx,
                       min(tile_side, self.H - gy),
                       min(tile_side, self.W - gx))
            for cy, gy in enumerate(grid_y)
            for cx, gx in enumerate(grid_x)
        }
        # The halo width must fit inside every neighbor chunk (a strip is
        # cut from ONE chunk's interior), so ragged edge tiles clamp the
        # per-round epoch count.
        self.k = max(1, min(
            tile_chunk,
            min(t[2] for t in self.tiles.values()),
            min(t[3] for t in self.tiles.values()),
        ))
        self.owner: Dict[Tuple[int, int], str] = {}
        self.replica: Dict[Tuple[int, int], Optional[str]] = {
            c: None for c in self.tiles
        }
        # Per-chunk replication watermark: newest snapshot epoch the
        # chunk's replica has acked (-1 = nothing; the session's
        # certified resume point is the min over chunks).
        self.acked: Dict[Tuple[int, int], int] = {
            c: -1 for c in self.tiles
        }
        self.epoch = 0
        self.lanes = odigest.digest_dense_np(board)
        self.population = int((board == 1).sum())
        self.steplock = threading.Lock()
        # Step requests blocked on the steplock, and the condition a chunk
        # mover waits on to hand them the lock.
        self.waiting = 0
        self.turns = threading.Condition(threading.Lock())
        self.promoting = False
        self.round_idx = 0
        self.parked = False

    @contextlib.contextmanager
    def step_turn(self):
        """Hold the steplock for one step request, counted in ``waiting``
        until it is taken."""
        with self.turns:
            self.waiting += 1
        try:
            self.steplock.acquire()
        finally:
            with self.turns:
                self.waiting -= 1
                self.turns.notify_all()
        try:
            yield
        finally:
            self.steplock.release()

    def hand_off(self, timeout: float) -> None:
        """A chunk mover between two rounds (lock released): wait until
        the step requests queued on the steplock have taken it or the
        epoch has moved, at most ``timeout`` s.  ``threading.Lock`` is not
        FIFO, so a mover re-acquiring at once could starve them."""
        epoch = self.epoch
        with self.turns:
            self.turns.wait_for(
                lambda: self.waiting == 0 or self.epoch != epoch, timeout
            )

    def certified(self, chunks=None) -> int:
        """The epoch the session can provably resume at after losing
        ``chunks`` (default: any chunk): every lost chunk's replica must
        hold an acked snapshot there, and survivors' local history is
        floor-pruned no deeper (so they hold it too)."""
        keys = self.tiles if chunks is None else chunks
        return min((self.acked[c] for c in keys), default=-1)

    def meta(self) -> dict:
        return {
            "rule": self.rule_s, "H": self.H, "W": self.W,
            "grid": [self.ny, self.nx], "k": self.k,
        }


class _Pending:
    """One forwarded op awaiting its SERVE_RESULT (or internal callback)."""

    __slots__ = (
        "rid", "op", "sid", "shard", "kind", "member", "sent",
        "retries", "event", "result", "error", "on_done",
    )

    def __init__(self, rid, op, *, sid=None, shard=None, kind="",
                 member=None, on_done=None):
        self.rid = rid
        self.op = op
        self.sid = sid
        self.shard = shard
        self.kind = kind
        self.member = member  # None until routed; direct ops pre-target
        self.sent = False
        self.retries = 0
        self.event = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.on_done = on_done


class ClusterServePlane:
    """The frontend's tenant-facing serve surface (SessionRouter-shaped:
    ``BoardsRoute`` mounts it unchanged).  Thread layout: HTTP/caller
    threads block on per-op events; one flusher thread coalesces queued
    ops into per-worker SERVE_OPS frames; the frontend's reader threads
    deliver results via :meth:`on_result`/:meth:`on_shard_state`; the
    maintenance loop drives :meth:`poll`.

    Lock discipline: ``self._lock`` (RLock) orders the shard table, the
    session index, and the op queues.  NOTHING is sent on the wire while
    it is held — sends go through the frontend's ``_safe_send``, whose
    failure path takes the frontend lock (frontend lock → plane lock is
    the only permitted nesting order)."""

    def __init__(
        self,
        config,
        membership,
        send,
        *,
        registry=None,
        tracer=None,
        events=None,
    ) -> None:
        self.config = config
        self.membership = membership
        self._send_to = send  # callable(Member, dict); never under _lock
        self.n_shards = int(config.serve_shards)
        self.max_sessions = config.serve_max_sessions
        self.max_cells = config.serve_max_cells
        self.max_steps = config.serve_max_steps
        self.size_classes = sbatch.parse_size_classes(
            config.serve_size_classes
        )
        self.tile_side = self.size_classes[-1]
        self.tile_chunk = max(1, int(config.serve_tile_chunk))
        self.metrics = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.events = events
        self._m_rejects = self.metrics.counter(
            "gol_serve_rejects_total", labelnames=("reason",)
        )
        self._m_shards = self.metrics.gauge(
            "gol_serve_shards",
            "Session shards owned, per serve worker",
            ("member",),
        )
        self._m_shard_sessions = self.metrics.gauge(
            "gol_serve_shard_sessions",
            "Sessions resident, per serve worker",
            ("member",),
        )
        self._m_wqueue = self.metrics.gauge(
            "gol_serve_worker_queue_depth",
            "Serve ops queued toward each worker (unsent + unanswered)",
            ("member",),
        )
        self._m_ops = self.metrics.counter("gol_serve_ops_total")
        self._m_frames = self.metrics.counter("gol_serve_op_frames_total")
        self._m_migrations = self.metrics.counter(
            "gol_serve_shard_migrations_total"
        )
        self._m_migration_aborts = self.metrics.counter(
            "gol_serve_shard_migration_aborts_total"
        )
        self._m_tiled = self.metrics.gauge("gol_serve_tiled_sessions")
        self._m_tiled_bytes = self.metrics.histogram(
            "gol_serve_tiled_bytes_round",
            "Cell-state bytes moved per tiled step round",
            buckets=(2**10, 2**12, 2**14, 2**16, 2**18, 2**20, 2**22, 2**24),
        )
        self._m_chunk_migrations = self.metrics.counter(
            "gol_serve_tiled_chunk_migrations_total"
        )
        self._m_evictions = self.metrics.counter(
            "gol_serve_session_evictions_total"
        )
        self.ttl_s = config.serve_ttl_s
        self._m_digest_checks = self.metrics.counter("gol_digest_checks_total")
        self._m_digest_mismatches = self.metrics.counter(
            "gol_digest_mismatches_total"
        )
        # Session replication & failover (docs/OPERATIONS.md "Session
        # replication & failover").
        self._replicate = bool(config.serve_replicate)
        self.repl_max_lag_s = float(config.serve_replicate_max_lag_s)
        self._m_repl_lag = self.metrics.gauge(
            "gol_serve_replication_lag_seconds",
            "Age of the oldest un-acked session update, per shard",
            ("shard",),
        )
        self._m_repl_bytes = self.metrics.counter(
            "gol_serve_replica_bytes_total"
        )
        self._m_promotions = self.metrics.counter(
            "gol_serve_promotions_total"
        )
        self._m_single_copy = self.metrics.gauge(
            "gol_serve_single_copy_shards"
        )
        self._m_sessions_lost = self.metrics.counter(
            "gol_serve_sessions_lost_total"
        )

        # The elastic planner's second resource type rides a plane-owned
        # Rebalancer: same policy/backoff machinery, zero contention with
        # tile moves (budget and cooldowns are per-instance).
        self.rebalancer = Rebalancer(config)
        # ...and the THIRD resource type (resident tiled chunks) gets its
        # own instance too — chunk moves must not contend with shard
        # moves for the in-flight budget.
        self.tiled_rebalancer = Rebalancer(config)
        self._certify_pool = concurrent.futures.ThreadPoolExecutor(
            TILED_CERTIFY_THREADS, thread_name_prefix="tiled-certify"
        )
        self.tiled_resident = bool(config.serve_tiled_resident)
        self.tiled_snap_rounds = int(config.serve_tiled_resident_snapshot)
        # Request-trace propagation gate (one bool read on the hot path;
        # the attach itself is a thread-local peek + dict store).
        self._trace = bool(getattr(config, "serve_trace", True))

        self._lock = threading.RLock()
        # Flusher wake signal: an Event, not the Condition — the routing
        # fast path sets it WITHOUT holding the plane lock.
        self._wake = threading.Event()
        self._ids = itertools.count(1)
        self._rids = itertools.count(1)
        self._rr = itertools.count()  # tiled-chunk round-robin cursor
        self.shard_owner: Dict[int, Optional[str]] = {  # graftlint: guarded-by _lock
            s: None for s in range(self.n_shards)
        }
        self.sessions: Dict[str, _Entry] = {}  # graftlint: guarded-by _lock
        self.tiled: Dict[str, _TiledSession] = {}  # graftlint: guarded-by _lock
        self._cells = 0  # graftlint: guarded-by _lock
        self._pending: Dict[int, _Pending] = {}  # graftlint: guarded-by _lock
        self._outq: Dict[str, deque] = {}  # graftlint: guarded-by _lock
        self._held: Dict[int, List[_Pending]] = {}  # graftlint: guarded-by _lock
        self.shard_replica: Dict[int, Optional[str]] = {}  # graftlint: guarded-by _lock
        self._promoting: Dict[int, dict] = {}  # graftlint: guarded-by _lock
        self._tiled_promoting: Dict[str, dict] = {}  # graftlint: guarded-by _lock
        # The routing fast path's versioned immutable lookup snapshot:
        # (owner dict, blocked frozenset), REPLACED (never mutated) under
        # the lock whenever the shard table, in-flight move set, or
        # promotion set changes — readers take the reference lock-free and
        # revalidate identity under one short lock hold before enqueueing.
        self._routes: Tuple[Dict[int, str], frozenset] = ({}, frozenset())
        self._lag_alert: set = set()  # graftlint: guarded-by _lock
        self._lag_minted: set = set()  # graftlint: guarded-by _lock
        self._lag_snapshot: Dict[int, float] = {}  # graftlint: guarded-by _lock
        self._draining = False  # graftlint: guarded-by _lock
        self._stopped = False  # graftlint: guarded-by _lock
        self._health_snapshot: Dict[str, dict] = {
            "shards": {}, "sessions": {}, "queue_depths": {},
        }
        self._flusher = threading.Thread(
            target=self._flush_loop, daemon=True, name="serve-flusher"
        )
        self._flusher.start()

    # -- admission ------------------------------------------------------------

    def _reject(self, reason: str, detail: str, link=None) -> None:
        """Refuse one op.  ``link`` (a span or its ctx dict) ties the
        refusal to the event that CAUSED it — a failover 429 carries the
        ``serve.promote`` span's trace so the tenant's trace clicks
        through to the promotion that bounced it."""
        self._m_rejects.labels(reason=reason).inc()
        if link is not None and hasattr(link, "ctx"):
            link = link.ctx
        raise AdmissionError(reason, detail, trace_link=link)

    def _tiled_link_locked(self, sid: str):
        """The in-flight tiled promotion/resync span ctx for ``sid`` (or
        None) — the link a tiled failover 429 carries (caller holds the
        lock)."""
        info = self._tiled_promoting.get(sid)
        span = info.get("span") if info is not None else None
        return span.ctx if span is not None else None

    def _admit_locked(self, height: int, width: int) -> None:
        """Cluster-wide admission — the budget the frontend owns (worker
        caps are only the backstop behind it)."""
        if self._stopped:
            raise RuntimeError("router is closed")
        if self._draining:
            self._reject("draining", "cluster serve plane is draining")
        if not self.membership.alive_members():
            self._reject(
                "no_workers",
                "no serve workers joined yet; retry once the cluster has "
                "capacity",
            )
        if len(self.sessions) >= self.max_sessions:
            self._reject(
                "max_sessions",
                f"cluster session cap {self.max_sessions} reached",
            )
        if self._cells + height * width > self.max_cells:
            self._reject(
                "max_cells",
                f"cluster cell budget {self.max_cells} would be exceeded "
                f"({self._cells} in use, {height * width} asked)",
            )

    # -- session lifecycle (the SessionRouter-shaped surface) -----------------

    def create(
        self,
        tenant: str = "default",
        rule="conway",
        height: int = 64,
        width: int = 64,
        seed: int = 0,
        density: float = 0.5,
        with_board: bool = True,
        sid: Optional[str] = None,
    ) -> dict:
        tenant = str(tenant)
        rule_r = validate_create(tenant, rule, height, width, density)
        if sid is not None:
            # Caller-chosen id (the canary prober aims crc32 at a specific
            # shard with it): same contract as the worker router — refuse
            # collisions, never silently replace a tenant's board.
            sid = str(sid)
            if not sid or len(sid) > 128:
                raise ValueError(f"session id {sid!r} must be 1-128 chars")
        tiled = sbatch.size_class(height, width, self.size_classes) is None
        with self._lock:
            self._admit_locked(height, width)
            if sid is None:
                sid = f"s{next(self._ids):08x}"
            elif sid in self.sessions:
                raise ValueError(f"session id {sid!r} already exists")
            entry = _Entry(
                sid, tenant, "tiled" if tiled else "batch",
                rule_r.rulestring(), height, width, seed, density,
                None if tiled else shard_of(sid, self.n_shards),
            )
            # Charged against the budget NOW — a racing create must not
            # slip past the cap while this one's worker round-trip runs.
            self.sessions[sid] = entry
            self._cells += height * width
        if tiled:
            board = random_grid((height, width), density=density, seed=seed)
            if self.tiled_resident:
                try:
                    t = self._install_tiled(sid, entry, board)
                except BaseException:
                    with self._lock:
                        if self.sessions.get(sid) is entry:
                            del self.sessions[sid]
                            self._cells -= height * width
                    raise
            else:
                t = _TiledSession(board, self.tile_side)
            with self._lock:
                self.tiled[sid] = t
                entry.digest = odigest.format_digest(odigest.value(t.lanes))
                self._m_tiled.set(len(self.tiled))
            doc = self._tiled_doc(
                sid, entry, t, with_board=with_board, board=board
            )
            return doc
        op = {
            "op": "create", "rid": 0, "sid": sid, "tenant": tenant,
            "rule": rule_r.rulestring(), "height": height, "width": width,
            "seed": seed, "density": density,
        }
        p = None
        try:
            # Inside the try: a routing refusal (no_workers between the
            # admission check and here) must refund the entry/budget just
            # charged, not leak a ghost index row.
            p = self._submit(op, sid=sid, shard=entry.shard, kind="create")
            self._await(p)
        except BaseException as e:
            # A SENT create that timed out has an UNKNOWN outcome: the
            # worker may still apply it after we refund the budget here.
            # A compensating delete rides the same FIFO lane — it runs
            # after the create if that applied (404s harmlessly if not),
            # so the worker-local backstop can never leak orphan boards.
            cleanup = p is not None and p.sent and isinstance(e, TimeoutError)
            with self._lock:
                if self.sessions.get(sid) is entry:
                    del self.sessions[sid]
                    self._cells -= height * width
            if cleanup:
                try:
                    self._submit(
                        {"op": "delete", "rid": 0, "sid": sid},
                        sid=sid, shard=entry.shard, kind="evict",
                        on_done=lambda _p: None,
                    )
                except Exception:  # noqa: BLE001 — best-effort compensation
                    pass
            raise
        doc = dict(p.result["doc"])
        with self._lock:
            entry.epoch = int(doc.get("epoch", 0))
            entry.digest = doc.get("digest")
            entry.mark_dirty(time.monotonic())
        return doc

    def _tiled_doc(self, sid, entry, t, *, with_board: bool,
                   board=None) -> dict:
        doc = {
            "id": sid,
            "tenant": entry.tenant,
            "rule": entry.rule_s,
            "kind": "tiled",
            "height": entry.height,
            "width": entry.width,
            "seed": entry.seed,
            "epoch": t.epoch,
            "population": (
                t.population if t.mode == "resident"
                else int((t.board == 1).sum())
            ),
            "digest": odigest.format_digest(odigest.value(t.lanes)),
            "tiles": len(t.tiles),
            "resident": t.mode == "resident",
        }
        if with_board:
            if board is not None:
                doc["board"] = board.copy()
            elif t.mode == "resident":
                doc["board"] = self._fetch_tiled_board(sid, t)
            else:
                doc["board"] = t.board.copy()
        return doc

    def get(self, sid: str) -> dict:
        with self._lock:
            entry = self.sessions.get(sid)
            if entry is None:
                raise KeyError(sid)
            entry.last_used = time.monotonic()
            t = self.tiled.get(sid)
        if t is not None:
            if t.mode == "resident":
                with self._lock:
                    if t.promoting:
                        self._reject(
                            "failover",
                            f"tiled session {sid} is mid-promotion after "
                            f"a worker loss; retry",
                            link=self._tiled_link_locked(sid),
                        )
            with t.steplock:
                return self._tiled_doc(sid, entry, t, with_board=True)
        p = self._submit(
            {"op": "get", "rid": 0, "sid": sid}, sid=sid,
            shard=entry.shard, kind="get",
        )
        self._await(p)
        doc = dict(p.result["doc"])
        with self._lock:
            entry.epoch = int(doc.get("epoch", entry.epoch))
            entry.digest = doc.get("digest", entry.digest)
            entry.mark_dirty(time.monotonic())
        return doc

    def list(self) -> List[dict]:
        with self._lock:
            return [
                e.summary(
                    None if e.shard is None else self.shard_owner.get(e.shard)
                )
                for e in self.sessions.values()
            ]

    def tenant_of(self, sid: str) -> Optional[str]:
        """Tenant attribution for the SLO access log (None = unknown sid;
        the edge falls back to the default tenant)."""
        with self._lock:
            e = self.sessions.get(sid)
            return e.tenant if e is not None else None

    def canary_targets(self) -> Dict[str, int]:
        """worker name -> one shard it owns, covering every placeable
        member — the canary prober pins one known-orbit session per worker
        by mining a sid whose crc32 hash lands on that shard.  Members
        owning nothing yet get a shard assigned (round-robin through the
        unowned pool), so a fresh cluster is probe-covered immediately."""
        with self._lock:
            targets: Dict[str, int] = {}
            for shard, owner in self.shard_owner.items():
                if owner is not None and owner not in targets:
                    targets[owner] = shard
            members = [
                m.name for m in self.membership.placeable_members()
                if m.name not in targets
            ]
            free = [s for s, o in self.shard_owner.items() if o is None]
            assigned = False
            for name, shard in zip(sorted(members), free):
                self.shard_owner[shard] = name
                targets[name] = shard
                assigned = True
            if assigned:
                self._rebuild_routes_locked()
            return targets

    def delete(self, sid: str) -> None:
        with self._lock:
            entry = self.sessions.get(sid)
            if entry is None:
                raise KeyError(sid)
            if entry.kind == "tiled":
                t = self.tiled.pop(sid, None)
                del self.sessions[sid]
                self._cells -= entry.height * entry.width
                self._m_tiled.set(len(self.tiled))
                if t is not None and t.mode == "resident":
                    self._drop_tiled_locked(sid, t)
                return
        p = self._submit(
            {"op": "delete", "rid": 0, "sid": sid}, sid=sid,
            shard=entry.shard, kind="delete",
        )
        self._await(p)
        with self._lock:
            if self.sessions.get(sid) is entry:
                del self.sessions[sid]
                self._cells -= entry.height * entry.width
                # The replica's standby copy must go too, or a later
                # promotion would resurrect a deleted board.
                self._replicate_forget_locked(entry.shard, sid)

    def step(self, sid: str, steps: int = 1) -> Tuple[int, int]:
        # The steady-state hot path: session lookup and the draining gate
        # read GIL-atomic state without the plane lock — the only lock
        # holds left on a routed step are the (short) enqueue in _submit
        # and the epoch write-back below.
        if steps < 1:
            raise ValueError(f"steps {steps} must be >= 1")
        entry = self.sessions.get(sid)  # graftlint: waive GL-LOCK01 -- hot-path read: a single dict.get is GIL-atomic, and every later mutation re-validates under the lock
        if entry is None:
            raise KeyError(sid)
        if self._draining:  # graftlint: waive GL-LOCK01 -- monotonic one-way bool; the worst stale read admits one op that drains with the rest
            self._reject("draining", "cluster serve plane is draining")
        entry.last_used = time.monotonic()
        if entry.kind == "tiled":
            return self._step_tiled(sid, entry, steps)
        p = self._submit(
            {"op": "step", "rid": 0, "sid": sid, "steps": int(steps)},
            sid=sid, shard=entry.shard, kind="step",
        )
        self._await(p, grace=True)
        qw = p.result.get("qw")
        if qw is not None:
            # Relay the worker-side queue wait to the HTTP edge (the SLO
            # access log separates queueing from compute on this thread).
            _slo.note_queue_wait(float(qw))
        epoch, digest = int(p.result["epoch"]), int(p.result["digest"])
        with self._lock:
            if self.sessions.get(sid) is entry and epoch >= entry.epoch:
                entry.epoch = epoch
                entry.digest = odigest.format_digest(digest)
                entry.mark_dirty(time.monotonic())
        return epoch, digest

    # -- op plumbing ----------------------------------------------------------

    def _rebuild_routes_locked(self) -> None:
        """Publish a fresh immutable routing snapshot (caller holds the
        lock).  Called from every site that changes shard ownership, the
        in-flight move set, or the promotion set — the fast path routes
        entirely from this object and revalidates its identity under one
        short lock hold, so a stale read can never enqueue onto a frozen
        or promoted shard."""
        self._routes = (
            {s: o for s, o in self.shard_owner.items() if o is not None},
            frozenset(self._promoting) | frozenset(
                k for k in self.rebalancer.inflight if isinstance(k, int)
            ),
        )

    def _submit(self, op: dict, *, sid=None, shard=None, kind="",
                member=None, on_done=None) -> _Pending:
        rid = next(self._rids)  # itertools.count is GIL-atomic
        op["rid"] = rid
        if self._trace:
            # Stamp the caller's active span (the HTTP thread's
            # serve.request) onto the op: the worker opens its serve.batch
            # span as a CHILD of this ctx, so one trace spans processes.
            # Cost with no active span: one thread-local read.
            sp = current()
            if sp is not None:
                op[TRACE_KEY] = sp.ctx
        p = _Pending(rid, op, sid=sid, shard=shard, kind=kind,
                     member=member, on_done=on_done)
        if member is None and shard is not None:
            # Fast path: resolve the owner from the immutable snapshot
            # outside the lock; one short hold enqueues, with an identity
            # re-check so a concurrent table change falls back to the
            # full router (which sees the new world).
            routes = self._routes
            owner = routes[0].get(shard)
            if owner is not None and shard not in routes[1]:
                p.member = owner
                with self._lock:
                    if self._routes is routes:
                        self._pending[rid] = p
                        self._outq.setdefault(owner, deque()).append(p)
                        self._wake.set()
                        return p
                p.member = None  # table moved under us: route slowly
        with self._lock:
            self._route_locked(p)
            self._wake.set()
        return p

    def _route_locked(self, p: _Pending) -> None:
        """Aim one op: direct-target ops go straight to their member's
        queue; shard ops go to the shard's owner — or into the held list
        while the shard is mid-migration (replayed at the new owner on
        commit, at the old one on abort: zero admitted ops lost)."""
        self._pending[p.rid] = p
        if p.member is not None:
            self._outq.setdefault(p.member, deque()).append(p)
            return
        if p.shard in self._promoting:
            # The shard's primary just died and its replica is being
            # promoted: EVERY op (step/get/delete/create) answers the
            # retryable 429 ``failover`` — the 404-vs-retryable
            # distinction is the client contract (the board provably
            # resumes at its replicated epoch; a retry lands post-commit).
            del self._pending[p.rid]
            self._reject(
                "failover",
                f"shard {p.shard} is mid-promotion after a worker loss; "
                f"the board resumes at its last replicated epoch — retry",
                link=self._promoting[p.shard].get("span"),
            )
        if p.shard in self.rebalancer.inflight:
            self._held.setdefault(p.shard, []).append(p)
            return
        owner = self.shard_owner.get(p.shard)
        if owner is None:
            owner = self._assign_shard_locked(p.shard)
            if owner is None:
                del self._pending[p.rid]
                self._reject(
                    "no_workers",
                    "no serve workers available for this shard; retry",
                )
        p.member = owner
        self._outq.setdefault(owner, deque()).append(p)

    def _assign_shard_locked(self, shard: int) -> Optional[str]:
        """First placement of an unowned (or orphaned-empty) shard: the
        least-shard-loaded placeable member."""
        members = self.membership.placeable_members() or (
            self.membership.alive_members()
        )
        if not members:
            return None
        loads = {m.name: 0 for m in members}
        for owner in self.shard_owner.values():
            if owner in loads:
                loads[owner] += 1
        name = min(loads, key=lambda n: (loads[n], n))
        self.shard_owner[shard] = name
        self._rebuild_routes_locked()
        return name

    def _await(self, p: _Pending, *, grace: bool = False):
        """Block the caller on its op with the router's timeout contract: an
        op cancelled UNSENT provably never ran (safe retry); a sent op
        gets bounded grace, then reports with outcome unknown."""
        if not p.event.wait(JOB_TIMEOUT_S):
            with self._lock:
                cancelled = False
                if not p.sent and self._pending.pop(p.rid, None) is not None:
                    q = self._outq.get(p.member)
                    if q is not None and p in q:
                        q.remove(p)
                    held = self._held.get(p.shard)
                    if held is not None and p in held:
                        held.remove(p)
                    cancelled = True
            if cancelled:
                raise TimeoutError(
                    f"serve op for {p.sid} timed out unsent (cancelled; "
                    f"not applied)"
                )
            if not p.event.wait(JOB_GRACE_S if grace else 1.0):
                raise TimeoutError(
                    f"serve op for {p.sid} timed out in flight on "
                    f"{p.member}"
                )
        if p.error is not None:
            raise p.error
        return p.result

    def _resolve(self, p: _Pending, *, result=None, error=None) -> None:
        """Complete one op — caller must NOT hold the plane lock (the
        callback path can send frames)."""
        p.result = result
        p.error = error
        p.event.set()
        if p.on_done is not None:
            try:
                p.on_done(p)
            except Exception:  # noqa: BLE001 — internal-callback bug must not kill a reader thread
                pass

    @staticmethod
    def _entry_error(entry: dict) -> BaseException:
        kind = entry.get("err")
        detail = str(entry.get("detail", ""))
        if kind == "admission":
            return AdmissionError(str(entry.get("reason", "unknown")), detail)
        return {
            "key": KeyError,
            "value": ValueError,
            "timeout": TimeoutError,
        }.get(kind, RuntimeError)(detail)

    # -- wire-in (frontend reader threads) ------------------------------------

    def on_result(self, member_name: str, msg: dict) -> None:
        for entry in msg.get("results", []):
            try:
                rid = int(entry["rid"])
            except (KeyError, TypeError, ValueError):
                continue
            with self._lock:
                p = self._pending.pop(rid, None)
            if p is None:
                continue  # cancelled / already failed by member loss
            if entry.get("ok"):
                self._resolve(p, result=entry)
                continue
            err = self._entry_error(entry)
            if (
                isinstance(err, AdmissionError)
                and err.reason == "migrating"
                and p.retries < OP_MAX_RETRIES
            ):
                # The worker froze this shard before our frame arrived:
                # re-route — the held list (or the post-commit owner)
                # replays it, the tenant never sees the reason.  A
                # re-route can itself refuse (last worker just died):
                # that failure must resolve the op, never escape into
                # the frontend's reader thread.
                try:
                    with self._lock:
                        p.retries += 1
                        p.sent = False
                        p.member = None
                        self._route_locked(p)
                        self._wake.set()
                    continue
                except AdmissionError as e:
                    err = e
            self._resolve(p, error=err)

    # -- the flusher (halo-plane coalescing, op-plane edition) ----------------

    def _enqueue_ctrl_locked(self, member: str, msg: dict) -> _Pending:
        """Queue a raw control frame (SHARD_PREPARE/COMMIT/ABORT) through
        the member's op lane — caller holds the lock.  EVERY shard-control
        frame rides this one FIFO, which is the protocol's whole ordering
        story: a create queued toward the old owner before a migration
        began reaches it before the freeze; an abort can never overtake
        its own prepare and leave sessions frozen forever; a ghost-cleanup
        drop can never overtake the adopt it compensates."""
        if self._trace and TRACE_KEY not in msg:
            # shard_*/replicate control frames join the active trace (a
            # promotion's acks, a migration's prepare/commit) when one is
            # open on this thread — ambient plumbing stays unlinked.
            sp = current()
            if sp is not None:
                msg[TRACE_KEY] = sp.ctx
        p = _Pending(0, msg, kind="ctrl", member=member)
        self._outq.setdefault(member, deque()).append(p)
        self._wake.set()
        return p

    def _flush_loop(self) -> None:
        while True:
            self._wake.wait(timeout=0.25)
            self._wake.clear()
            with self._lock:
                if self._stopped:
                    return
                batches: List[Tuple[str, List[_Pending]]] = []
                for name, q in self._outq.items():
                    if q:
                        ops = list(q)
                        q.clear()
                        for p in ops:
                            p.sent = True
                        batches.append((name, ops))
            for name, entries in batches:
                m = self.membership.get(name)
                if m is None or not m.alive:
                    self._fail_worker_ops(
                        name, [p for p in entries if p.kind != "ctrl"]
                    )
                    continue
                # Coalesce runs of ops into SERVE_OPS frames, emitting
                # interleaved ctrl frames in place so queue order IS wire
                # order (the shard-prepare ordering guarantee).
                run: List[_Pending] = []

                def flush_run(member=m):
                    if run:
                        self._m_frames.inc()
                        self._m_ops.inc(len(run))
                        frame = {
                            "type": P.SERVE_OPS,
                            "ops": [p.op for p in run],
                        }
                        # The tracing wire discipline, serve edition: the
                        # frame itself carries the FIRST traced op's ctx
                        # (each op still carries its own — a coalesced
                        # frame spans many requests).
                        for p in run:
                            ctx = p.op.get(TRACE_KEY)
                            if ctx is not None:
                                frame[TRACE_KEY] = dict(ctx)
                                break
                        self._send_to(member, frame)
                        run.clear()

                for p in entries:
                    if p.kind == "ctrl":
                        flush_run()
                        self._send_to(m, p.op)
                    else:
                        run.append(p)
                flush_run()

    def _reroute_unsent_locked(
        self, p: _Pending, name: str
    ) -> Optional[BaseException]:
        """One UNSENT op aimed at dead ``name`` (caller holds the lock
        and has popped it from ``_pending``): re-route what provably
        never ran — creates re-hash to the shard's new owner, pure tile
        chunks re-pick any worker — and return the error everything else
        must resolve with (None = re-routed).  The ONE implementation of
        this contract: the flusher's dead-member path and the membership
        hook must not drift."""
        if p.kind in ("create", "tile") and p.retries < OP_MAX_RETRIES:
            p.retries += 1
            p.sent = False
            if p.kind == "tile":
                p.member = self._pick_worker_locked()
                if p.member is None:
                    return AdmissionError(
                        "no_workers", "no serve workers left"
                    )
            else:
                p.member = None
            try:
                self._route_locked(p)
                return None
            except AdmissionError as e:
                return e
        return TimeoutError(
            f"serve worker {name} lost before this op ran; retry"
        )

    def _fail_worker_ops(self, name: str, ops: List[_Pending]) -> None:
        """Ops aimed at a member that died before the frame went out:
        unsent work provably never ran — re-route what can move (creates,
        tile chunks), fail the rest retryably.  An op the member-loss
        path already answered keeps that answer.  An op on a shard whose
        replica is (or is about to be) promoted answers the retryable 429
        ``failover``, as :meth:`on_member_lost` answers it: the flusher
        can see the member dead before that hook has run."""
        dead: List[Tuple[_Pending, BaseException]] = []
        with self._lock:
            for p in ops:
                if self._pending.pop(p.rid, None) is None:
                    continue  # answered by the member-loss path
                if p.kind != "create" and self._promotable_locked(p.shard, name):
                    dead.append((p, AdmissionError(
                        "failover",
                        f"serve worker {name} lost before this op ran; the "
                        f"shard's replica is being promoted — retry",
                    )))
                    continue
                err = self._reroute_unsent_locked(p, name)
                if err is not None:
                    dead.append((p, err))
            self._wake.set()
        for p, err in dead:
            self._resolve(p, error=err)

    def _promotable_locked(self, shard, name: str) -> bool:
        """Is ``shard`` mid-promotion, or owned by the dead ``name`` with
        a live replica that :meth:`_begin_promotion_locked` will promote?"""
        if shard is None:
            return False
        if shard in self._promoting:
            return True
        if not self._replicate or self.shard_owner.get(shard) != name:
            return False
        repl = self.shard_replica.get(shard)
        m = self.membership.get(repl) if repl is not None else None
        return m is not None and m.alive

    # -- membership hooks (called by the frontend) ----------------------------

    def on_member_joined(self, name: str) -> None:
        """A worker joined: claim any unowned shards for it (first worker
        takes the whole table; later joiners receive shards through the
        rebalancer — empty ones flip instantly, loaded ones migrate)."""
        with self._lock:
            if self._stopped:
                return
            unowned = [s for s, o in self.shard_owner.items() if o is None]
            for shard in unowned:
                self._assign_shard_locked(shard)
            # The joiner may be the FIRST second worker: single-copy
            # shards get their replica (and the primaries a stream reset)
            # right away, not at the next maintenance pass.
            self._refresh_replicas_locked()
        self._refresh_gauges()

    def on_member_lost(self, name: str) -> None:
        """A worker died.  Shards with a live replica PROMOTE — their
        sessions survive, resuming from the last acked replicated epoch,
        and ops caught in the window answer the retryable 429
        ``failover``.  Shards without one lose their sessions honestly
        (404 + ``gol_serve_sessions_lost_total``).  Every in-flight op
        gets an ANSWER (the never-silently-lost contract): sent ops on
        promoting shards answer ``failover``, other sent ops report
        unknown-outcome, unsent creates/tile-chunks replay elsewhere,
        ops for dead sessions 404.  Migrations involving the member roll
        back or — when the certified state already left the source —
        complete anyway."""
        resolutions: List[Tuple[_Pending, Optional[dict], Optional[BaseException]]] = []
        aborts: List = []
        promotions: List[Tuple[int, dict]] = []
        tiled_plans: List[tuple] = []
        with self._lock:
            if self._stopped:
                return  # teardown: member losses are expected, plane is done
            tiled_plans = self._begin_tiled_promotions_locked(name)
            doomed = self.rebalancer.drop_member(name)
            for mig in doomed:
                phase = getattr(mig, "phase", "prepare")
                if mig.source == name and phase == "adopt":
                    # The certified payload already left the dead source:
                    # the in-flight adopt at the (live) dest completes the
                    # move and the sessions SURVIVE their worker's death.
                    continue
                aborts.append((mig, "member_lost",
                               mig.source != name, mig.source == name))
            lost_shards = [
                s for s, o in self.shard_owner.items()
                if o == name and s not in self.rebalancer.inflight
            ]
            lost_sids: set = set()
            for shard in lost_shards:
                info = self._begin_promotion_locked(shard)
                if info is not None:
                    promotions.append((shard, info))
                    lost_sids |= info["dropped"]
                    continue
                # No live replica (replication off, single-copy shard, or
                # a double failure): honest loss.
                for sid in [
                    s for s, e in self.sessions.items() if e.shard == shard
                ]:
                    e = self.sessions.pop(sid)
                    self._cells -= e.height * e.width
                    self._m_sessions_lost.inc()
                    lost_sids.add(sid)
                self.shard_owner[shard] = None
                self._assign_shard_locked(shard)
            promoting = set(self._promoting)
            for p in list(self._pending.values()):
                if p.member != name:
                    continue
                self._pending.pop(p.rid, None)
                if p.shard in promoting:
                    # The board provably resumes at its replicated epoch:
                    # retryable, never an unknown-outcome shrug.  The 429
                    # links to the promotion span that caused it.
                    info = self._promoting.get(p.shard)
                    span = info.get("span") if info is not None else None
                    resolutions.append((p, None, AdmissionError(
                        "failover",
                        f"serve worker {name} lost mid-op; the shard's "
                        f"replica is being promoted — retry",
                        trace_link=span.ctx if span is not None else None,
                    )))
                elif p.sent:
                    resolutions.append((p, None, TimeoutError(
                        f"serve worker {name} lost; op outcome unknown"
                        + (" (session lost with it)" if p.sid in lost_sids
                           else "")
                    )))
                elif p.sid in lost_sids:
                    resolutions.append((p, None, KeyError(p.sid)))
                else:
                    q = self._outq.get(name)
                    if q is not None and p in q:
                        q.remove(p)
                    err = self._reroute_unsent_locked(p, name)
                    if err is not None:
                        resolutions.append((p, None, err))
            self._outq.pop(name, None)
            # A dead member may also have been a REPLICA: re-home every
            # replica assignment that pointed at it (the primaries get a
            # reset, so their streams start from scratch toward the new
            # replica).
            self._refresh_replicas_locked()
            self._wake.set()
        for mig, reason, notify, lost in aborts:
            self._abort_shard(mig, reason, source_alive=notify,
                              sessions_lost=lost)
        for shard, info in promotions:
            self._launch_promotion(shard, info, lost_member=name)
        for plan in tiled_plans:
            self._launch_tiled_promotion(plan, lost_member=name)
        for p, result, error in resolutions:
            self._resolve(p, result=result, error=error)
        # Gauge reclaim, the heartbeat-age discipline: a dead member's
        # series must read zero, not its last live value.
        self._m_shards.labels(member=name).set(0)
        self._m_shard_sessions.labels(member=name).set(0)
        self._m_wqueue.labels(member=name).set(0)

    def member_clear(self, name: str) -> bool:
        """May a draining member be released?  Only once it owns no
        shards, no migration involves it, and nothing is queued toward
        it — the serve analog of 'owns no tiles'."""
        with self._lock:
            if any(o == name for o in self.shard_owner.values()):
                return False
            if any(r == name for r in self.shard_replica.values()):
                # Still a replica somewhere: releasing it now would
                # silently drop standby state the re-homing pass (drains
                # re-home replicas every poll) hasn't moved yet.
                return False
            if any(
                info["dest"] == name for info in self._promoting.values()
            ):
                return False
            if any(
                name in (m.source, m.dest)
                for m in self.rebalancer.inflight.values()
            ):
                return False
            for t in self.tiled.values():
                if t.mode != "resident":
                    continue
                if any(o == name for o in t.owner.values()):
                    return False  # still hosts resident chunks
                if any(r == name for r in t.replica.values()):
                    return False  # still a chunk replica
            if any(
                name in (m.source, m.dest)
                for m in self.tiled_rebalancer.inflight.values()
            ):
                return False
            q = self._outq.get(name)
            if q:
                return False
            return not any(
                p.member == name for p in self._pending.values()
            )

    # -- shard migration (frontend side) --------------------------------------

    def poll(self, now: float, drain_only: bool = False) -> None:
        """One maintenance pass: expire overdue moves, plan new ones
        (drain evacuation always; load spreading cadenced), sweep the
        idle-session TTL, refresh the per-worker gauges."""
        with self._lock:
            if self._stopped:
                return
            overdue = self.rebalancer.expired(now)
        for mig in overdue:
            self._abort_shard(mig, "deadline")
        self._sweep_ttl(now)
        lag_events: Dict[int, float] = {}
        with self._lock:
            if self._stopped or self._draining:
                self._refresh_gauges_locked()
                return
            # Replica upkeep before planning: drains re-home replicas
            # (a draining worker is not placeable), losses already
            # re-homed in on_member_lost, and the single-copy gauge
            # tracks the honest degradation level.
            self._refresh_replicas_locked()
            for t in self.tiled.values():
                if t.mode == "resident" and not t.promoting:
                    self._assign_tiled_replicas_locked(t)
            # One mover per (session, source, destination).
            tiled_moves: Dict[tuple, list] = {}
            for (sid, c), source, dest in self._plan_tiled_moves_locked(
                now, drain_only
            ):
                self.tiled_rebalancer.begin((sid, c), source, dest, now)
                tiled_moves.setdefault((sid, source, dest), []).append(c)
            lag_events = {
                s: self._lag_snapshot.get(s, 0.0)
                for s in self._update_lag_locked(now)
            }
            members = self.membership.alive_members()
            weights: Dict[int, int] = {}
            for e in self.sessions.values():
                if e.shard is not None:
                    weights[e.shard] = weights.get(e.shard, 0) + 1
            plans = self.rebalancer.plan_shards(
                {
                    s: o for s, o in self.shard_owner.items()
                    if o is not None and s not in self._promoting
                },
                weights, members, now, drain_only=drain_only,
                replicas=self.shard_replica,
            )
            for shard, source, dest in plans:
                sids = [
                    sid for sid, e in self.sessions.items()
                    if e.shard == shard
                ]
                busy = any(
                    p.shard == shard for p in self._pending.values()
                )
                if not sids and not busy:
                    # Empty shard: ownership flips without any protocol —
                    # this is how a late joiner starts receiving shards
                    # the moment the planner notices it.
                    self.shard_owner[shard] = dest
                    self._rebuild_routes_locked()
                    continue
                mig = self.rebalancer.begin(shard, source, dest, now)
                self._rebuild_routes_locked()
                mig.phase = "prepare"
                mig.sids = sids  # plan-time estimate; the WORKER's export
                # is authoritative (it recomputes membership by hash when
                # the prepare executes, after every earlier op frame)
                mig.span = self.tracer.start(
                    "serve.shard_migrate", node="frontend",
                    shard=shard, source=source, dest=dest,
                    sessions=len(sids),
                )
                # Queued through the source's op lane (NOT sent directly):
                # wire order against already-routed ops is the correctness
                # of the freeze — see _enqueue_ctrl_locked.
                mig.prepare_pending = self._enqueue_ctrl_locked(source, {
                    "type": P.SHARD_PREPARE, "shard": shard,
                    "seq": mig.seq,
                })
            self._refresh_gauges_locked()
        for (sid, source, dest), chunks in tiled_moves.items():
            # Each resident-chunk mover runs on its own thread: its rounds
            # hold the session's steplock across export → certify →
            # adopt, so the maintenance loop must not block behind them.
            threading.Thread(
                target=self._migrate_tiled_chunks,
                args=(sid, chunks, source, dest),
                daemon=True, name=f"tiled-move-{sid}",
            ).start()
        if self.events is not None:
            for shard, lag in sorted(lag_events.items()):
                # Loud, transition-edged (only shards NEWLY over the
                # bound): replication lag is never silently unbounded.
                self.events.emit(
                    "serve_replication_lag_exceeded", shard=shard,
                    lag_s=round(lag, 3), bound_s=self.repl_max_lag_s,
                )

    def _sweep_ttl(self, now: float) -> None:
        """The cluster-wide idle-session TTL (workers run with ttl 0 —
        eviction must retire the budget charged HERE, or idle sessions
        would leak serve_max_cells forever).  Tiled sessions drop in
        place; batch sessions retire through a real delete op so the
        worker table and this index let go together."""
        if self.ttl_s <= 0:
            return
        evict_ops: List[Tuple[str, int]] = []
        with self._lock:
            for sid, e in list(self.sessions.items()):
                if (
                    e.evicting
                    or now - e.last_used <= self.ttl_s
                    or (e.shard is not None
                        and e.shard in self.rebalancer.inflight)
                ):
                    continue
                if e.kind == "tiled":
                    t = self.tiled.pop(sid, None)
                    if t is not None and t.mode == "resident":
                        if t.promoting:
                            self.tiled[sid] = t
                            continue  # settle the promotion first
                        self._drop_tiled_locked(sid, t)
                    del self.sessions[sid]
                    self._cells -= e.height * e.width
                    self._m_tiled.set(len(self.tiled))
                    self._m_evictions.inc()
                else:
                    e.evicting = True
                    evict_ops.append((sid, e.shard))
        for sid, shard in evict_ops:
            try:
                self._submit(
                    {"op": "delete", "rid": 0, "sid": sid},
                    sid=sid, shard=shard, kind="evict",
                    on_done=lambda p, sid=sid: self._on_evicted(sid, p),
                )
            except (AdmissionError, KeyError, RuntimeError):
                # No worker / plane closing: clear the mark so the next
                # sweep retries instead of pinning the entry forever.
                with self._lock:
                    e = self.sessions.get(sid)
                    if e is not None:
                        e.evicting = False

    def _on_evicted(self, sid: str, p: _Pending) -> None:
        """An eviction delete answered.  Deleted (or already gone
        worker-side) → release the index entry and its budget; any other
        failure → unmark, the next sweep retries."""
        with self._lock:
            e = self.sessions.get(sid)
            if e is None:
                return
            if p.error is None or isinstance(p.error, KeyError):
                del self.sessions[sid]
                self._cells -= e.height * e.width
                self._m_evictions.inc()
                self._replicate_forget_locked(e.shard, sid)
            else:
                e.evicting = False

    def on_shard_state(self, member_name: str, msg: dict) -> None:
        """TRANSFER → CERTIFY → adopt-at-dest → COMMIT.  Exactly the tile
        protocol's shape: every session payload re-derives its digest
        lanes (``digest_payload_np``) before any ownership change; a
        mismatch rolls back loudly and the source (which never dropped the
        sessions) unfreezes."""
        shard = int(msg["shard"])
        seq = int(msg["seq"])
        t_state = time.monotonic()
        with self._lock:
            mig = self.rebalancer.get(shard, seq)
            if mig is None or mig.source != member_name:
                return  # stale frame from an aborted attempt
            # The move's split (port-only; a JAX worker sends no times).
            mig.split = {"prepare_s": t_state - mig.started}
            mig.split.update({k: float(msg[k]) for k in _WORKER_SPLIT if k in msg})
        if msg.get("error"):
            self._abort_shard(mig, f"source: {msg['error']}")
            return
        payloads = msg.get("sessions", [])
        # Certification OUTSIDE the lock: O(session bytes) per board.
        for pay in payloads:
            lanes = odigest.digest_payload_np(
                pay["state"], (0, 0), int(pay["width"])
            )
            self._m_digest_checks.inc()
            if [int(lanes[0]), int(lanes[1])] != [
                int(v) for v in pay["digest"]
            ]:
                self._m_digest_mismatches.inc()
                if self.events is not None:
                    self.events.emit(
                        "serve_shard_digest_mismatch",
                        shard=shard, sid=pay.get("sid"), source=member_name,
                    )
                self._abort_shard(mig, "digest_mismatch")
                return
        with self._lock:
            if self.rebalancer.get(shard, seq) is not mig:
                return  # aborted while certifying
            dest = self.membership.get(mig.dest)
            if dest is None or not dest.alive:
                dest = None
            else:
                mig.phase = "adopt"
                mig.payload_sids = [p["sid"] for p in payloads]
                mig.t_adopt = time.monotonic()
                mig.split["certify_s"] = mig.t_adopt - t_state
                # Submitted under the SAME lock acquisition that set the
                # phase (RLock; _submit only enqueues): an abort racing
                # this window must always see adopt_pending, or it could
                # neither recall the adopt nor clean up after it.
                mig.adopt_pending = self._submit(
                    {"op": "adopt", "rid": 0, "sessions": payloads},
                    kind="adopt", member=dest.name,
                    on_done=lambda p, mig=mig: self._on_adopted(mig, p),
                )
        if dest is None:
            self._abort_shard(mig, "dest_lost")
            return

    def _on_adopted(self, mig, p: _Pending) -> None:
        if p.error is not None:
            self._abort_shard(mig, f"adopt failed: {p.error!r}")
            return
        flush: List[_Pending] = []
        now = time.monotonic()
        with self._lock:
            if self.rebalancer.get(mig.tile, mig.seq) is not mig:
                return
            split = dict(mig.split, adopt_s=now - mig.t_adopt,
                         seconds=now - mig.started)
            self.rebalancer.complete(mig.tile)
            self.shard_owner[mig.tile] = mig.dest
            self._rebuild_routes_locked()
            self._m_migrations.inc()
            if mig.span is not None:
                mig.span.set(outcome="commit").finish()
                mig.span = None
            src = self.membership.get(mig.source)
            if src is not None and src.alive:
                # Through the source's op lane, like the prepare: every
                # shard-control frame for one worker rides ONE FIFO, so
                # no control message can ever overtake another.
                self._enqueue_ctrl_locked(mig.source, {
                    "type": P.SHARD_COMMIT, "shard": mig.tile,
                    "sids": getattr(mig, "payload_sids", mig.sids),
                })
            for held in self._held.pop(mig.tile, []):
                held.member = mig.dest
                held.sent = False
                self._outq.setdefault(mig.dest, deque()).append(held)
                flush.append(held)
            # Ownership moved: the replica may now co-reside with the new
            # owner (it was the migration dest's sibling constraint, but
            # membership may have shifted) — reconcile immediately, so the
            # co-residence window is one lock hold, not one poll tick.
            self._refresh_replicas_locked()
            self._wake.set()
        if self.events is not None:
            self.events.emit(
                "serve_shard_migrated", shard=mig.tile,
                source=mig.source, dest=mig.dest,
                sessions=len(getattr(mig, "payload_sids", [])),
                replayed_ops=len(flush),
                **{k: round(v, 6) for k, v in split.items()},
            )

    def _abort_shard(
        self, mig, reason: str, *, source_alive: bool = True,
        sessions_lost: bool = False,
    ) -> None:
        """Roll a shard move back.  ``sessions_lost`` (dead source before
        transfer): the shard's sessions died with their worker — index
        entries release, held writes 404, held creates re-route."""
        resolutions: List[Tuple[_Pending, BaseException]] = []
        with self._lock:
            if self.rebalancer.get(mig.tile, mig.seq) is not mig:
                return
            self.rebalancer.abort(mig.tile, time.monotonic())
            self._rebuild_routes_locked()
            self._m_migration_aborts.inc()
            # An abort racing the adopt phase (deadline mid-install, dest
            # flapping) must not strand GHOST session copies at the
            # destination while the unfrozen source keeps serving: an
            # adopt still in the queue is recalled; otherwise a drop of
            # the same sids rides the dest's SAME op lane — the one FIFO
            # guarantees it lands after the adopt whatever the flusher
            # was doing when the abort fired (p.sent alone cannot tell:
            # the flusher marks it before the frame is actually written).
            ap = getattr(mig, "adopt_pending", None)
            if ap is not None:
                self._pending.pop(ap.rid, None)
                q = self._outq.get(ap.member)
                if q is not None and ap in q:
                    q.remove(ap)
                else:
                    dst = self.membership.get(mig.dest)
                    if dst is not None and dst.alive:
                        self._enqueue_ctrl_locked(mig.dest, {
                            "type": P.SHARD_COMMIT, "shard": mig.tile,
                            "sids": getattr(mig, "payload_sids", mig.sids),
                        })
            if mig.span is not None:
                mig.span.set(outcome="abort", reason=reason).finish()
                mig.span = None
            # A source that died mid-protocol means the shard's sessions
            # died with it even when the CALLER didn't know that (e.g. the
            # member-loss path let an in-flight adopt run on, and the
            # adopt then failed): without this, shard_owner would point at
            # the dead member forever — membership already evicted it, so
            # nothing else would ever reassign the shard — wedging every
            # future op for 1/serve_shards of the keyspace.
            src_m = self.membership.get(mig.source)
            lost = sessions_lost or src_m is None or not src_m.alive
            promotion = None
            if lost:
                # A source that died mid-migration is just a worker loss
                # wearing a migration: a live replica PROMOTES — the op
                # FIFO makes the race safe (the promote lands at the
                # replica after every replicate install already queued,
                # and the recalled adopt/cleanup rides the dest's own
                # lane) — and only a replica-less shard loses sessions.
                promotion = self._begin_promotion_locked(mig.tile)
                if promotion is None:
                    # Recomputed LIVE from the index (not the plan-time
                    # snapshot): a create that landed on the shard after
                    # the migration was planned died with the source too.
                    for sid in [
                        s for s, e in self.sessions.items()
                        if e.shard == mig.tile
                    ]:
                        e = self.sessions.pop(sid)
                        self._cells -= e.height * e.width
                        self._m_sessions_lost.inc()
                    self.shard_owner[mig.tile] = None
                    self._assign_shard_locked(mig.tile)
            held = self._held.pop(mig.tile, [])
            for p in held:
                self._pending.pop(p.rid, None)
                if lost and promotion is not None:
                    # Mid-promotion: the retryable contract, never a 404
                    # for a board that provably survives.
                    pspan = promotion.get("span")
                    resolutions.append((p, AdmissionError(
                        "failover",
                        f"shard {mig.tile} is being promoted after its "
                        f"worker died mid-migration; retry",
                        trace_link=pspan.ctx if pspan is not None else None,
                    )))
                elif lost and p.kind != "create":
                    resolutions.append((p, KeyError(p.sid)))
                else:
                    # Replay at whoever owns the shard now (the unfrozen
                    # source on a plain abort; a survivor on source loss).
                    p.sent = False
                    p.member = None
                    try:
                        self._route_locked(p)
                    except AdmissionError as e:
                        resolutions.append((p, e))
            if source_alive and not lost:
                # A prepare still sitting in the queue is simply recalled
                # (no freeze will ever happen); otherwise the abort rides
                # the SAME lane, so it always lands after the freeze it
                # undoes and the worker unfreezes the set IT froze.
                pp = getattr(mig, "prepare_pending", None)
                q = self._outq.get(mig.source)
                if pp is not None and q is not None and pp in q:
                    q.remove(pp)
                else:
                    self._enqueue_ctrl_locked(mig.source, {
                        "type": P.SHARD_ABORT, "shard": mig.tile,
                    })
            self._wake.set()
        if self.events is not None:
            self.events.emit(
                "serve_shard_migration_aborted", shard=mig.tile,
                source=mig.source, dest=mig.dest, reason=reason,
            )
        for p, err in resolutions:
            self._resolve(p, error=err)
        if promotion is not None:
            self._launch_promotion(
                mig.tile, promotion, lost_member=mig.source
            )

    # -- session replication & failover ---------------------------------------

    def _replica_for_locked(
        self, shard: int, owner: Optional[str], names: List[str],
        current: Optional[str] = None, sticky: bool = True,
    ) -> Optional[str]:
        """The shard's replica — STICKY first, rendezvous-hashed second,
        never the primary.  A still-valid current replica is kept: every
        reassignment discards acked standby state and resets the stream,
        so churn IS a board-loss window (a primary dying before the new
        replica's from-scratch stream acks loses what the old replica
        still held).  Fresh assignments use rendezvous hashing
        (highest-random-weight by (shard, worker)), so a membership
        change re-homes only the shards that must move, not ~all of them
        the way a modulo ring would.

        An EMPTY shard (``sticky`` False) holds no standby state, so it
        always takes its rendezvous replica.  Kept sticky, every shard
        of a first worker would keep the second joiner as its replica,
        and the planner (which avoids a shard's replica as destination)
        could never place a shard on that joiner once a third had
        taken half the table."""
        if not self._replicate or owner is None:
            return None
        if (sticky and current is not None and current != owner
                and current in names):
            return current
        return rendezvous_pick(str(shard), (n for n in names if n != owner))

    def _refresh_replicas_locked(self) -> None:
        """Reconcile replica assignments with the current membership and
        shard table (caller holds the lock).  A change resets the
        frontend watermarks for the shard, tells the primary to restart
        its stream from scratch (the new replica holds nothing), and
        tells a surviving old replica to drop its standby copies.  Also
        refreshes the single-copy gauge — the honest-degradation signal."""
        now = time.monotonic()
        names = sorted(
            m.name for m in self.membership.placeable_members()
        )
        single = 0
        loaded = {e.shard for e in self.sessions.values()}
        for shard, owner in self.shard_owner.items():
            if shard in self._promoting:
                continue  # ownership settles at the promote result first
            desired = self._replica_for_locked(
                shard, owner, names, current=self.shard_replica.get(shard),
                sticky=shard in loaded,
            )
            if owner is not None and desired is None and self._replicate:
                single += 1
            cur = self.shard_replica.get(shard)
            if desired == cur:
                continue
            self.shard_replica[shard] = desired
            if cur is not None:
                old = self.membership.get(cur)
                if old is not None and old.alive:
                    self._submit(
                        {"op": "replica_drop", "rid": 0, "shard": shard},
                        kind="replicate", member=cur,
                        on_done=lambda _p: None,
                    )
            # The new replica starts empty: frontend watermarks reset and
            # the primary streams the shard from scratch.
            for e in self.sessions.values():
                if e.shard == shard:
                    e.repl_epoch = -1
                    if e.repl_dirty_since is None:
                        e.repl_dirty_since = now
            if owner is not None:
                pm = self.membership.get(owner)
                if pm is not None and pm.alive:
                    self._enqueue_ctrl_locked(owner, {
                        "type": P.SHARD_REPLICATE_ACK, "shard": shard,
                        "reset": True,
                    })
        self._m_single_copy.set(single if self._replicate else 0)

    def _replicate_forget_locked(self, shard, sid: str) -> None:
        """A session left the index (delete/evict): its replica standby
        copy must go too, or a later promotion would resurrect it."""
        if not self._replicate or shard is None:
            return
        repl = self.shard_replica.get(shard)
        m = self.membership.get(repl) if repl is not None else None
        if m is None or not m.alive:
            return
        self._submit(
            {"op": "replicate", "rid": 0, "shard": int(shard),
             "sessions": [], "deleted": [sid]},
            kind="replicate", member=repl, on_done=lambda _p: None,
        )

    def on_shard_replicate(self, member_name: str, msg: dict) -> None:
        """A primary's replication stream frame: relay the payloads to
        the shard's replica through the replica's op FIFO (so an install
        can never reorder against a promote/adopt there), or park the
        stream when no replica is placeable."""
        if not self._replicate:
            return
        if "tiled" in msg:
            # Resident tiled-chunk snapshots share the frame kind but are
            # keyed by (sid, chunk), not shard.
            self.on_tiled_replicate(member_name, msg["tiled"])
            return
        shard = int(msg["shard"])
        payloads = msg.get("sessions", [])
        with self._lock:
            if self._stopped:
                return
            if (
                self.shard_owner.get(shard) != member_name
                or shard in self._promoting
            ):
                return  # stale stream from a former owner; ignore
            repl = self.shard_replica.get(shard)
            m = self.membership.get(repl) if repl is not None else None
            if m is None or not m.alive:
                # Single-copy mode: park the primary's stream instead of
                # letting it re-ship every board every pass to nobody.
                self._enqueue_ctrl_locked(member_name, {
                    "type": P.SHARD_REPLICATE_ACK, "shard": shard,
                    "parked": True,
                })
                return
            # A session deleted mid-stream must not resurrect standby-side.
            keep = [
                pay for pay in payloads
                if (e := self.sessions.get(str(pay.get("sid")))) is not None
                and e.shard == shard
            ]
            if not keep:
                return
            nbytes = 0
            for pay in keep:
                data = pay.get("state", {}).get("data")
                nbytes += getattr(data, "nbytes", 0)
            self._m_repl_bytes.inc(nbytes)
            self._submit(
                {"op": "replicate", "rid": 0, "shard": shard,
                 "sessions": keep},
                kind="replicate", member=repl,
                on_done=lambda p, shard=shard, primary=member_name: (
                    self._on_replicated(shard, primary, p)
                ),
            )

    def _on_replicated(self, shard: int, primary: str, p: _Pending) -> None:
        """A replica acked an install: advance the frontend watermarks
        and relay the ack to the primary (its op FIFO) so its stream
        moves on.  A failed install is simply NOT acked — the primary's
        next pass retransmits (the watermark-retransmit contract)."""
        if p.error is not None or not p.result:
            return
        acked = {
            str(sid): int(epoch)
            for sid, epoch in dict(p.result.get("acked", {})).items()
        }
        if not acked:
            return
        with self._lock:
            if self.shard_replica.get(shard) != p.member:
                return  # replica reassigned since: a stale ack must not
                # advance watermarks the NEW replica never earned
            now = time.monotonic()
            for sid, epoch in acked.items():
                e = self.sessions.get(sid)
                if e is None or e.shard != shard:
                    continue
                if epoch > e.repl_epoch:
                    e.repl_epoch = epoch
                    # Re-base the lag clock on every watermark advance:
                    # the oldest un-acked update is now at most this old.
                    # Without this, a continuously-stepped session's lag
                    # would read time-since-FIRST-dirty and fire a false
                    # over-bound alert under perfectly healthy sustained
                    # traffic.
                    e.repl_dirty_since = (
                        None if e.repl_epoch >= e.epoch else now
                    )
                elif e.repl_epoch >= e.epoch:
                    e.repl_dirty_since = None
            pm = self.membership.get(primary)
            if pm is not None and pm.alive:
                self._enqueue_ctrl_locked(primary, {
                    "type": P.SHARD_REPLICATE_ACK, "shard": shard,
                    "acked": acked,
                })

    def _begin_promotion_locked(self, shard: int) -> Optional[dict]:
        """Mark one dead-owner shard for promotion (caller holds the
        lock): flip ownership to the live replica, drop the sessions the
        replica never acked (nothing can save them — counted lost), and
        open the ``serve.promote`` span.  Returns the promotion record,
        or None when no live replica exists (the caller takes the honest-
        loss path)."""
        repl = self.shard_replica.get(shard) if self._replicate else None
        m = self.membership.get(repl) if repl is not None else None
        if m is None or not m.alive or shard in self._promoting:
            return None
        dropped: set = set()
        kept = 0
        for sid in [
            s for s, e in self.sessions.items() if e.shard == shard
        ]:
            e = self.sessions[sid]
            if e.repl_epoch < 0:
                del self.sessions[sid]
                self._cells -= e.height * e.width
                self._m_sessions_lost.inc()
                dropped.add(sid)
            else:
                kept += 1
        self.shard_owner[shard] = repl
        self.shard_replica[shard] = None
        info = {
            "dest": repl,
            "t0": time.monotonic(),
            "sessions": kept,
            "dropped": dropped,
            "span": self.tracer.start(
                "serve.promote", node="frontend", shard=shard,
                dest=repl, sessions=kept,
            ),
        }
        self._promoting[shard] = info
        # The snapshot must see the shard as promoting in the same step
        # that hands it to the replica: built before, it would route the
        # shard's ops to the replica ahead of the promote (a 404 for a
        # board that survives) until some later rebuild.
        self._rebuild_routes_locked()
        return info

    def _launch_promotion(
        self, shard: int, info: dict, *, lost_member: str = ""
    ) -> None:
        """Fire one promotion (caller must NOT hold the lock): flight
        dump — a promotion is exactly the moment a post-mortem wants
        context for — then the ``promote`` op through the replica's op
        FIFO, ordered after every replicate install already queued
        there."""
        flight = getattr(self.tracer, "flight", None)
        if flight is not None:
            flight.dump("serve_promote", node="frontend")
        if self.events is not None:
            self.events.emit(
                "serve_promotion_started", shard=shard,
                dest=info["dest"], lost=lost_member,
                sessions=info["sessions"],
                unreplicated_lost=len(info["dropped"]),
            )
        try:
            self._submit(
                {"op": "promote", "rid": 0, "shard": shard},
                kind="promote", member=info["dest"],
                on_done=lambda p, shard=shard: self._on_promoted(shard, p),
            )
        except Exception as e:  # noqa: BLE001 — a submit failure must
            # resolve the promotion (double failure), never strand the
            # shard mid-promotion forever
            fake = _Pending(0, {}, kind="promote", member=info["dest"])
            fake.error = e
            self._on_promoted(shard, fake)

    def _on_promoted(self, shard: int, p: _Pending) -> None:
        """The replica answered the promote.  Success: promoted sessions
        resume at their certified replicated epoch (index epochs roll
        BACK to it — that is the honest state), a new replica is
        appointed, and the new primary streams from scratch.  Failure
        (the replica died too — double failure): the shard's remaining
        sessions are lost honestly."""
        lost: List[str] = []
        failed: List[str] = []
        promoted = 0
        with self._lock:
            info = self._promoting.get(shard)
            if info is None or info["dest"] != p.member:
                return
            del self._promoting[shard]
            self._rebuild_routes_locked()
            span = info["span"]
            now = time.monotonic()
            if p.error is not None or not p.result:
                for sid in [
                    s for s, e in self.sessions.items() if e.shard == shard
                ]:
                    e = self.sessions.pop(sid)
                    self._cells -= e.height * e.width
                    self._m_sessions_lost.inc()
                    lost.append(sid)
                if self.shard_owner.get(shard) == p.member:
                    self.shard_owner[shard] = None
                    self._assign_shard_locked(shard)
                if span is not None:
                    span.set(outcome="lost", error=repr(p.error)).finish()
            else:
                installed = {
                    str(row["sid"]): row
                    for row in p.result.get("installed", [])
                }
                failed = [str(s) for s in p.result.get("failed", [])]
                for sid in [
                    s for s, e in self.sessions.items() if e.shard == shard
                ]:
                    e = self.sessions[sid]
                    row = installed.get(sid)
                    if row is None:
                        # Standby missing or digest-refused: lost, loudly.
                        del self.sessions[sid]
                        self._cells -= e.height * e.width
                        self._m_sessions_lost.inc()
                        if sid in failed:
                            self._m_digest_mismatches.inc()
                        lost.append(sid)
                        continue
                    # Certified resume point: the index rolls back to the
                    # replicated epoch — that IS the board's state now.
                    e.epoch = int(row["epoch"])
                    e.digest = odigest.format_digest(odigest.value(
                        np.asarray(row["digest"], dtype=np.uint32)
                    ))
                    e.repl_epoch = -1
                    e.repl_dirty_since = now
                    promoted += 1
                self._m_promotions.inc()
                if span is not None:
                    span.set(
                        outcome="promoted", sessions=promoted,
                        latency_s=round(now - info["t0"], 6),
                    ).finish()
                # Appoint the next replica; the new primary streams the
                # shard from scratch (it has no watermark state).
                self._refresh_replicas_locked()
            self._wake.set()
        if self.events is not None:
            self.events.emit(
                "serve_promotion_finished", shard=shard, dest=p.member,
                promoted=promoted, lost=len(lost),
                digest_refused=len(failed),
                outcome="lost" if p.error is not None else "promoted",
            )

    # -- frontend federation hooks (serve/federation.py) ----------------------

    def control_rows(self) -> List[dict]:
        """This frontend's slice of control state, one row per session —
        what the federation streams to its standby peer frontend.  Batch
        rows promote into placeholder index entries on a confirmed
        frontend death; tiled rows (``shard`` None — the cells live on
        workers) ride as certified-floor observability only."""
        with self._lock:
            return [
                {
                    "sid": sid, "tenant": e.tenant, "kind": e.kind,
                    "rule": e.rule_s, "height": e.height, "width": e.width,
                    "seed": e.seed, "density": e.density, "shard": e.shard,
                    "epoch": e.epoch, "digest": e.digest,
                    "slice": shard_of(sid, self.n_shards),
                }
                for sid, e in self.sessions.items()
            ]

    def begin_federation_promotion(self, rows: List[dict], *,
                                   origin: str) -> None:
        """A peer frontend died and THIS frontend (its rendezvous
        standby) adopted its slices: install the replicated batch rows as
        placeholder index entries and open a federation failover window
        per shard — windowed ops answer retryable 429 ``failover`` (never
        404) until the dead frontend's workers re-home their control
        channel here and announce session truth with ``SHARD_HOME``
        (:meth:`on_shard_home`), or the re-home grace expires
        (:meth:`expire_federation_promotion`)."""
        now = time.monotonic()
        shards: set = set()
        installed = 0
        with self._lock:
            for row in rows:
                if not isinstance(row, dict) or row.get("kind") != "batch":
                    continue  # tiled cells live on workers; nothing to park
                sid = str(row.get("sid", ""))
                if not sid or sid in self.sessions:
                    continue
                shard = shard_of(sid, self.n_shards)
                e = _Entry(
                    sid, str(row.get("tenant", "default")), "batch",
                    str(row.get("rule", "B3/S23")),
                    int(row.get("height", 0)), int(row.get("width", 0)),
                    int(row.get("seed", 0)),
                    float(row.get("density", 0.5)), shard,
                )
                e.epoch = int(row.get("epoch", 0))
                e.digest = row.get("digest")
                e.repl_dirty_since = now
                self.sessions[sid] = e
                self._cells += e.height * e.width
                shards.add(shard)
                installed += 1
            for shard in shards:
                if shard in self._promoting:
                    continue
                self._promoting[shard] = {
                    # dest=None can never collide with a worker name, so
                    # the replica-promotion reply path (_on_promoted's
                    # dest guard) ignores these windows.
                    "fed": True, "dest": None, "origin": origin,
                    "t0": now, "sessions": installed, "dropped": set(),
                    "span": self.tracer.start(
                        "serve.fed_promote", node="frontend", shard=shard,
                        origin=origin,
                    ),
                }
            self._rebuild_routes_locked()
            self._wake.set()
        if self.events is not None:
            self.events.emit(
                "serve_federation_promotion", origin=origin,
                sessions=installed, shards=len(shards),
            )

    def expire_federation_promotion(self, shard: int) -> None:
        """No ``SHARD_HOME`` arrived within the re-home grace — the dead
        frontend's workers died with it.  Close the window honestly: the
        placeholder sessions are lost (counted, evented), and the shard
        reopens for fresh creates on a local worker."""
        lost = 0
        with self._lock:
            info = self._promoting.get(shard)
            if info is None or not info.get("fed"):
                return
            del self._promoting[shard]
            for sid in [
                s for s, e in self.sessions.items() if e.shard == shard
            ]:
                e = self.sessions.pop(sid)
                self._cells -= e.height * e.width
                self._m_sessions_lost.inc()
                lost += 1
            if info.get("span") is not None:
                info["span"].set(outcome="lost", sessions=lost).finish()
            self._rebuild_routes_locked()
            self._wake.set()
        if self.events is not None:
            self.events.emit(
                "serve_federation_promotion_expired", shard=shard, lost=lost,
            )

    # -- worker re-home (SHARD_HOME) -------------------------------------------

    def on_shard_home(self, member_name: str, msg: dict) -> None:
        """A worker re-homed its control channel here after its frontend
        died (``SHARD_HOME``): its session list IS the truth.  Install or
        refresh index rows from it, point their shards at the worker,
        close the federation failover windows they held (digest-certified
        resume: the worker's epoch/digest replace the placeholder's
        replicated floor), and let replication appoint fresh replicas."""
        rows = [
            r for r in (msg.get("sessions") or [])
            if isinstance(r, dict) and r.get("id")
        ]
        now = time.monotonic()
        touched: set = set()
        closed = 0
        with self._lock:
            for row in rows:
                sid = str(row["id"])
                shard = shard_of(sid, self.n_shards)
                e = self.sessions.get(sid)
                if e is None:
                    e = _Entry(
                        sid, str(row.get("tenant", "default")), "batch",
                        str(row.get("rule", "B3/S23")),
                        int(row.get("height", 0)), int(row.get("width", 0)),
                        int(row.get("seed", 0)),
                        float(row.get("density", 0.5)), shard,
                    )
                    self.sessions[sid] = e
                    self._cells += e.height * e.width
                e.epoch = int(row.get("epoch", e.epoch))
                if row.get("digest") is not None:
                    e.digest = row["digest"]
                e.repl_epoch = -1
                e.repl_dirty_since = now
                e.last_used = now
                self.shard_owner[shard] = member_name
                touched.add(shard)
            for shard in touched:
                info = self._promoting.get(shard)
                if info is not None and info.get("fed"):
                    del self._promoting[shard]
                    if info.get("span") is not None:
                        info["span"].set(outcome="rehomed").finish()
                    closed += 1
            self._rebuild_routes_locked()
            if self._replicate:
                self._refresh_replicas_locked()
            self._wake.set()
        if self.events is not None:
            self.events.emit(
                "serve_shard_home", worker=member_name, sessions=len(rows),
                shards=len(touched), windows_closed=closed,
            )

    def _update_lag_locked(self, now: float) -> set:
        """Per-shard replication lag gauges (age of the oldest un-acked
        update; defined only while a replica exists — single-copy shards
        surface through the single-copy gauge instead) and the over-bound
        alert set.  Returns shards NEWLY over the bound so the caller can
        emit events outside the lock."""
        lag: Dict[int, float] = {}
        if self._replicate:
            for e in self.sessions.values():
                if (
                    e.shard is None
                    or e.repl_dirty_since is None
                    or self.shard_replica.get(e.shard) is None
                ):
                    continue
                lag[e.shard] = max(
                    lag.get(e.shard, 0.0), now - e.repl_dirty_since
                )
        for shard in self._lag_minted - set(lag):
            # Reclaim, the breaker-reset hygiene discipline: a caught-up
            # (or emptied, or lost) shard's series reads 0, not its last
            # stale lag.
            self._m_repl_lag.labels(shard=str(shard)).set(0.0)
        for shard, val in lag.items():
            self._m_repl_lag.labels(shard=str(shard)).set(val)
        self._lag_minted |= set(lag)
        alert = {s for s, v in lag.items() if v > self.repl_max_lag_s}
        fresh = alert - self._lag_alert
        self._lag_alert = alert
        self._lag_snapshot = lag
        return fresh

    # -- tiled (mega-board) sessions ------------------------------------------

    def _pick_worker_locked(self) -> Optional[str]:
        members = self.membership.placeable_members() or (
            self.membership.alive_members()
        )
        if not members:
            return None
        names = sorted(m.name for m in members)
        return names[next(self._rr) % len(names)]

    def _step_tiled(self, sid: str, entry: _Entry, steps: int) -> Tuple[int, int]:
        if steps > self.max_steps:
            # No fast-forward lane for tiled sessions (their rules are the
            # general totalistic family); the fairness bound stands.
            self._reject(
                "max_steps",
                f"steps {steps} over serve_max_steps={self.max_steps} "
                f"for a tiled session; chunk the request",
            )
        with self._lock:
            t = self.tiled.get(sid)
        if t is None:
            raise KeyError(sid)
        if t.mode == "resident":
            return self._step_tiled_resident(sid, entry, t, steps)
        with t.steplock:
            board = t.board
            H, W = board.shape
            remaining = steps
            lanes_parts: List = []
            while remaining > 0:
                k = min(remaining, self.tile_chunk)
                pends: List[_Pending] = []
                round_bytes = 0
                for gy, gx, th, tw in t.tiles:
                    rows = np.arange(gy - k, gy + th + k) % H
                    cols = np.arange(gx - k, gx + tw + k) % W
                    padded = np.ascontiguousarray(board[np.ix_(rows, cols)])
                    with self._lock:
                        member = self._pick_worker_locked()
                    if member is None:
                        self._reject(
                            "no_workers",
                            "no serve workers available for tile chunks",
                        )
                    state = pack_tile(padded)
                    round_bytes += int(getattr(state["data"], "nbytes", 0))
                    pends.append(self._submit(
                        {
                            "op": "step_raw", "rid": 0, "rule": entry.rule_s,
                            "k": int(k), "state": state,
                            "origin": [int(gy), int(gx)], "width": int(W),
                            "interior": [int(k), int(k + th), int(k),
                                         int(k + tw)],
                        },
                        sid=sid, kind="tile", member=member,
                    ))
                # ALL chunk results land before ANY tile scatters: a
                # failure mid-chunk (worker losses exhausting the retry
                # budget) must leave the board wholly at its pre-chunk
                # epoch — a half-scattered board would mix epochs and
                # serve silently corrupt state with a fresh digest.
                results = [self._await_tile(p) for p in pends]
                lanes_parts = []
                for result, (gy, gx, th, tw) in zip(results, t.tiles):
                    board[gy:gy + th, gx:gx + tw] = unpack_tile(
                        result["state"]
                    )
                    round_bytes += int(getattr(
                        result["state"]["data"], "nbytes", 0
                    ))
                    lanes_parts.append(
                        [int(result["digest"][0]), int(result["digest"][1])]
                    )
                self._m_tiled_bytes.observe(round_bytes)
                remaining -= k
                t.epoch += k
                # Per ROUND, not after the loop: a later round's failure
                # leaves the board legitimately advanced to THIS round's
                # epoch, and the stored lanes must describe that state —
                # a stale digest on the certification surface is worse
                # than a partial step.
                t.lanes = odigest.merge_lanes(lanes_parts)
            epoch, digest = t.epoch, odigest.value(t.lanes)
        with self._lock:
            if self.sessions.get(sid) is entry:
                entry.epoch = epoch
                entry.digest = odigest.format_digest(digest)
        return epoch, digest

    def _await_tile(self, p: _Pending) -> dict:
        """Wait one pure tile chunk out; a worker loss just replays it on
        another worker (the op is a function of its operands — nothing to
        lose)."""
        last: Optional[BaseException] = None
        for _ in range(TILE_OP_RETRIES):
            try:
                return self._await(p)
            except (TimeoutError, RuntimeError) as e:
                last = e
                with self._lock:
                    member = self._pick_worker_locked()
                if member is None:
                    break
                op = dict(p.op)
                p = self._submit(op, sid=p.sid, kind="tile", member=member)
        raise last if last is not None else RuntimeError("tile chunk failed")

    # -- worker-resident tiled sessions ---------------------------------------

    @staticmethod
    def _ckey(c: Tuple[int, int]) -> str:
        return f"{c[0]},{c[1]}"

    def _install_tiled(self, sid: str, entry: _Entry,
                       board: np.ndarray) -> _ResidentTiled:
        """Create-time installation: place each chunk on a worker (round-
        robin over the placeable set), appoint replicas, and ship every
        chunk ONCE — the last time its full state crosses the frontend
        until a render asks for it."""
        t = _ResidentTiled(
            sid, entry.rule_s, board, self.tile_side, self.tile_chunk
        )
        with self._lock:
            members = self.membership.placeable_members() or (
                self.membership.alive_members()
            )
            if not members:
                self._reject(
                    "no_workers", "no serve workers for a tiled session"
                )
            names = sorted(m.name for m in members)
            for i, c in enumerate(sorted(t.tiles)):
                t.owner[c] = names[i % len(names)]
            self._assign_tiled_replicas_locked(t)
        pends = []
        for c, (gy, gx, th, tw) in sorted(t.tiles.items()):
            pends.append(self._submit(
                {
                    "op": "tiled_install", "rid": 0, "sid": sid,
                    "rule": t.rule_s, "H": t.H, "W": t.W,
                    "grid": [t.ny, t.nx], "chunk": list(c),
                    "origin": [gy, gx], "shape": [th, tw], "k": t.k,
                    "state": pack_tile(board[gy:gy + th, gx:gx + tw]),
                    "epoch": 0,
                    "replicate": self._replicate,
                },
                sid=sid, kind="tile_ctl", member=t.owner[c],
            ))
        try:
            for p in pends:
                self._await(p)
        except BaseException:
            with self._lock:
                self._drop_tiled_locked(sid, t)
            raise
        return t

    def _tiled_owner_wire_locked(self, t: _ResidentTiled) -> Dict[str, list]:
        """chunk key -> [owner name, peer host, peer port] for one round's
        halo aiming (caller holds the lock)."""
        out: Dict[str, list] = {}
        for c, owner in t.owner.items():
            m = self.membership.get(owner)
            if m is None or not m.alive:
                raise AdmissionError(
                    "no_workers", f"tiled chunk owner {owner} is gone"
                )
            out[self._ckey(c)] = [owner, m.peer_host, int(m.peer_port)]
        return out

    def _step_tiled_resident(
        self, sid: str, entry: _Entry, t: _ResidentTiled, steps: int
    ) -> Tuple[int, int]:
        """The steady-state tentpole: per round, ONE light op per worker
        (epoch barrier + halo aiming map), O(perimeter) peer strips on the
        workers' own wire, digest lanes only at barrier/final rounds —
        the frontend never touches cell state."""
        with t.step_turn():
            with self._lock:
                if t.promoting:
                    self._reject(
                        "failover",
                        f"tiled session {sid} is mid-promotion; retry",
                        link=self._tiled_link_locked(sid),
                    )
                owners_wire = self._tiled_owner_wire_locked(t)
                floor = t.certified()
                by_member: Dict[str, List[list]] = {}
                for c, owner in t.owner.items():
                    by_member.setdefault(owner, []).append(list(c))
            # ONE op per worker for the WHOLE request: the per-round step
            # counts and the absolute snapshot epochs ride along, and the
            # workers chain the intermediate rounds peer-to-peer — the
            # frontend re-enters only at the request barrier.
            ks: List[int] = []
            snap_epochs: List[int] = []
            e = t.epoch
            remaining = steps
            while remaining > 0:
                k = min(remaining, t.k)
                ks.append(int(k))
                e += k
                remaining -= k
                t.round_idx += 1
                if (
                    self._replicate
                    and t.round_idx % self.tiled_snap_rounds == 0
                ):
                    snap_epochs.append(int(e))
            pends = [
                self._submit(
                    {
                        "op": "tiled_step", "rid": 0, "sid": sid,
                        "epoch": t.epoch, "ks": ks, "chunks": chunks,
                        "owners": owners_wire, "digest": True,
                        "snap_epochs": snap_epochs, "floor": floor,
                    },
                    sid=sid, kind="tile_ctl", member=member,
                )
                for member, chunks in sorted(by_member.items())
            ]
            try:
                results = [self._await(p, grace=True) for p in pends]
            except BaseException as e:
                with self._lock:
                    promoting = t.promoting
                    link = self._tiled_link_locked(sid)
                if promoting:
                    self._reject(
                        "failover",
                        f"tiled session {sid} lost a worker mid-step; "
                        f"it resumes at its last certified epoch — retry",
                        link=link,
                    )
                # A request that failed WITHOUT a worker loss (one op
                # timing out on a slow worker, a halo batch exhausting
                # its retries) may have advanced SOME workers' chunks:
                # the frontend epoch and the worker epochs must never
                # drift apart silently, or every later request errors
                # forever.  Resync the whole session to its certified
                # snapshot — the same consistent-rollback machinery a
                # promotion uses, with no chunks to promote.
                self._begin_tiled_resync(sid, t)
                with self._lock:
                    link = self._tiled_link_locked(sid)
                self._reject(
                    "failover",
                    f"tiled session {sid} step failed mid-request "
                    f"({e!r}); the session resyncs to its last "
                    f"certified epoch — retry",
                    link=link,
                )
            request_bytes = sum(
                int(r.get("halo_bytes", 0)) for r in results
            )
            for _ in ks:
                self._m_tiled_bytes.observe(request_bytes / len(ks))
            t.epoch += steps
            lanes_parts: List[list] = []
            pop = 0
            for r in results:
                lanes_parts.extend(r.get("lanes", {}).values())
                pop += sum(int(v) for v in r.get("pop", {}).values())
            t.lanes = odigest.merge_lanes(lanes_parts)
            t.population = pop
            epoch, digest = t.epoch, odigest.value(t.lanes)
        with self._lock:
            if self.sessions.get(sid) is entry:
                entry.epoch = epoch
                entry.digest = odigest.format_digest(digest)
        return epoch, digest

    def _fetch_tiled_board(self, sid: str, t: _ResidentTiled) -> np.ndarray:
        """Render pull (GET ?with_board=1 only): gather the resident
        chunks and assemble the full board — the one remaining O(area)
        path, paid exactly when a tenant asks to SEE the board."""
        with self._lock:
            by_member: Dict[str, List[list]] = {}
            for c, owner in t.owner.items():
                by_member.setdefault(owner, []).append(list(c))
        pends = [
            self._submit(
                {"op": "tiled_fetch", "rid": 0, "sid": sid, "chunks": chunks},
                sid=sid, kind="tile_ctl", member=member,
            )
            for member, chunks in sorted(by_member.items())
        ]
        board = np.zeros((t.H, t.W), dtype=np.uint8)
        try:
            for p in pends:
                res = self._await(p)
                for row in res["states"]:
                    if int(row["epoch"]) != t.epoch:
                        # Never serve a torn board: a chunk off the
                        # session epoch means a failed request left the
                        # workers desynchronized (the resync path owns
                        # recovery; this render answers retryably).
                        raise RuntimeError(
                            f"tiled chunk {row['chunk']} at epoch "
                            f"{row['epoch']}, session at {t.epoch}"
                        )
                    gy, gx = (int(v) for v in row["origin"])
                    th, tw = (int(v) for v in row["shape"])
                    board[gy:gy + th, gx:gx + tw] = unpack_tile(row["state"])
        except BaseException:
            with self._lock:
                promoting = t.promoting
                link = self._tiled_link_locked(sid)
            if promoting:
                self._reject(
                    "failover",
                    f"tiled session {sid} is mid-promotion; retry",
                    link=link,
                )
            raise
        return board

    def _drop_tiled_locked(self, sid: str, t: _ResidentTiled) -> None:
        """Release a resident session's worker-side state (delete, evict,
        honest loss, failed install) — best-effort ops to every live
        owner and replica (caller holds the lock)."""
        for name in {
            n for n in list(t.owner.values()) + list(t.replica.values())
            if n is not None
        }:
            m = self.membership.get(name)
            if m is None or not m.alive:
                continue
            op = (
                {"op": "tiled_drop", "rid": 0, "sid": sid}
                if name in t.owner.values()
                else {"op": "tiled_replica_drop", "rid": 0, "sid": sid}
            )
            try:
                self._submit(op, sid=sid, kind="tile_ctl", member=name,
                             on_done=lambda _p: None)
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass

    # -- resident tiled: replication relay ------------------------------------

    def _tiled_replica_for_locked(
        self, sid: str, c: Tuple[int, int], owner: Optional[str],
        names: List[str], current: Optional[str],
    ) -> Optional[str]:
        """Sticky-first, rendezvous-second, never the chunk's owner —
        the shard-replica policy at chunk granularity."""
        if not self._replicate or owner is None:
            return None
        if current is not None and current != owner and current in names:
            return current
        return rendezvous_pick(
            f"{sid}:{c[0]},{c[1]}", (n for n in names if n != owner)
        )

    def _assign_tiled_replicas_locked(self, t: _ResidentTiled) -> None:
        """Reconcile one resident session's replica map with the current
        membership (caller holds the lock): re-homed chunks reset their
        watermark and tell the primary to restart its stream; a session
        with no possible replica parks its primaries' streams."""
        names = sorted(
            m.name for m in self.membership.placeable_members()
        )
        resets: Dict[str, List[str]] = {}
        drops: List[Tuple[str, list]] = []
        for c, owner in t.owner.items():
            desired = self._tiled_replica_for_locked(
                t.sid, c, owner, names, t.replica.get(c)
            )
            cur = t.replica.get(c)
            if desired == cur:
                continue
            t.replica[c] = desired
            t.acked[c] = -1
            if cur is not None:
                m = self.membership.get(cur)
                if m is not None and m.alive:
                    drops.append((cur, list(c)))
            if owner is not None:
                resets.setdefault(owner, []).append(self._ckey(c))
        was_parked = t.parked
        t.parked = self._replicate and all(
            r is None for r in t.replica.values()
        )
        for cur, chunk in drops:
            try:
                self._submit(
                    {"op": "tiled_replica_drop", "rid": 0, "sid": t.sid,
                     "chunks": [chunk]},
                    kind="tile_ctl", member=cur, on_done=lambda _p: None,
                )
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
        if t.parked and not was_parked:
            for owner in set(t.owner.values()):
                m = self.membership.get(owner)
                if m is not None and m.alive:
                    self._enqueue_ctrl_locked(owner, {
                        "type": P.SHARD_REPLICATE_ACK, "shard": -1,
                        "tiled_parked": [t.sid],
                    })
            return
        for owner, keys in resets.items():
            m = self.membership.get(owner)
            if m is not None and m.alive:
                self._enqueue_ctrl_locked(owner, {
                    "type": P.SHARD_REPLICATE_ACK, "shard": -1,
                    "tiled_reset": {t.sid: keys},
                })

    def on_tiled_replicate(self, member_name: str, payloads: list) -> None:
        """A primary's resident-chunk snapshot stream: relay each payload
        to its chunk's replica through the replica's op FIFO; acks flow
        back to the primary with the per-chunk watermark and the
        session's certified floor."""
        by_replica: Dict[Tuple[str, str], List[dict]] = {}
        with self._lock:
            if self._stopped:
                return
            for pay in payloads:
                sid = str(pay.get("sid"))
                t = self.tiled.get(sid)
                if (
                    t is None or t.mode != "resident" or t.promoting
                    or sid in self._tiled_promoting
                ):
                    continue
                c = tuple(int(v) for v in pay["chunk"])
                if t.owner.get(c) != member_name:
                    continue  # stale stream from a former owner
                repl = t.replica.get(c)
                m = self.membership.get(repl) if repl is not None else None
                if m is None or not m.alive:
                    continue  # parked / re-homing; the refresh pass acks
                by_replica.setdefault((sid, repl), []).append(pay)
                self._m_repl_bytes.inc(
                    int(getattr(pay.get("state", {}).get("data"), "nbytes", 0))
                )
            for (sid, repl), chunk_pays in by_replica.items():
                t = self.tiled.get(sid)
                self._submit(
                    {"op": "tiled_replicate", "rid": 0, "sid": sid,
                     "chunks": chunk_pays, "floor": t.certified()},
                    kind="replicate", member=repl,
                    on_done=lambda p, sid=sid, primary=member_name: (
                        self._on_tiled_replicated(sid, primary, p)
                    ),
                )

    def _on_tiled_replicated(self, sid: str, primary: str,
                             p: _Pending) -> None:
        """A replica acked resident-chunk snapshots: advance per-chunk
        watermarks and relay the ack (plus the new certified floor) to
        the primary's op FIFO.  A failed install is simply not acked —
        the primary's next pass retransmits."""
        if p.error is not None or not p.result:
            return
        acked = dict(p.result.get("acked", {}))
        if not acked:
            return
        with self._lock:
            t = self.tiled.get(sid)
            if t is None or t.mode != "resident":
                return
            wire_acked: Dict[str, int] = {}
            for ck, epoch in acked.items():
                c = tuple(int(v) for v in ck.split(","))
                if t.replica.get(c) != p.member:
                    continue  # re-homed since: stale ack
                if int(epoch) > t.acked.get(c, -1):
                    t.acked[c] = int(epoch)
                wire_acked[ck] = t.acked[c]
            if not wire_acked:
                return
            pm = self.membership.get(primary)
            if pm is not None and pm.alive:
                self._enqueue_ctrl_locked(primary, {
                    "type": P.SHARD_REPLICATE_ACK, "shard": -1,
                    "tiled_acked": {sid: wire_acked},
                    "tiled_floor": {sid: t.certified()},
                })

    # -- resident tiled: promotion on worker loss ------------------------------

    def _begin_tiled_resync(self, sid: str, t: _ResidentTiled) -> None:
        """A step request failed without a member loss (timeout on a slow
        worker, halo retry exhaustion): some workers' chunks may have
        advanced past the frontend's epoch.  Roll the WHOLE session back
        to its certified snapshot — promotion with zero lost chunks —
        so frontend and workers agree again; no certified state = honest
        loss (the session could otherwise serve torn state forever).
        Caller holds the steplock (the failed request's own hold)."""
        with self._lock:
            if t.promoting or self.tiled.get(sid) is not t:
                return
            C = t.certified() if self._replicate else -1
            if C < 0:
                e = self.sessions.pop(sid, None)
                self.tiled.pop(sid, None)
                if e is not None:
                    self._cells -= e.height * e.width
                self._m_sessions_lost.inc()
                self._m_tiled.set(len(self.tiled))
                self._drop_tiled_locked(sid, t)
                return
            t.promoting = True
            survivors = sorted(set(t.owner.values()))
            info = {
                "t0": time.monotonic(),
                "span": self.tracer.start(
                    "serve.promote", node="frontend", sid=sid,
                    kind="tiled_resync", epoch=C,
                ),
            }
            self._tiled_promoting[sid] = info
        # A resync means a request failed in a way that may have torn the
        # session's epoch consensus — exactly the moment a post-mortem
        # wants the ring buffers (the promotion path dumps separately;
        # this reason marks the no-member-loss variant).
        flight = getattr(self.tracer, "flight", None)
        if flight is not None:
            flight.dump("serve_resync", node="frontend")
        self._launch_tiled_promotion(
            (sid, t, C, {}, survivors, info), lost_member=""
        )

    def _begin_tiled_promotions_locked(self, name: str) -> List[tuple]:
        """Worker ``name`` died.  For every resident session touched:
        chunks it OWNED promote from their replicas at the session's
        certified epoch (survivor chunks roll back to it — the whole
        session resumes consistent); chunks it replicated re-home.
        Sessions with no certified resume point are lost honestly.
        Returns promotion plans for _launch_tiled_promotion (caller holds
        the lock)."""
        plans: List[tuple] = []
        for sid, t in list(self.tiled.items()):
            if t.mode != "resident":
                continue
            lost = [c for c, o in t.owner.items() if o == name]
            for c, r in list(t.replica.items()):
                if r == name:
                    # The dead member was a REPLICA here: the standby
                    # state died with it; the refresh pass re-homes.
                    t.replica[c] = None
                    t.acked[c] = -1
            if not lost:
                continue
            C = t.certified(lost) if self._replicate else -1
            live_repl = all(
                t.replica.get(c) is not None
                and (m := self.membership.get(t.replica[c])) is not None
                and m.alive
                for c in lost
            )
            if t.promoting or C < 0 or not live_repl:
                # Honest loss: no certified resume point (or a double
                # failure mid-promotion).
                e = self.sessions.pop(sid, None)
                self.tiled.pop(sid, None)
                if e is not None:
                    self._cells -= e.height * e.width
                self._m_sessions_lost.inc()
                self._m_tiled.set(len(self.tiled))
                self._drop_tiled_locked(sid, t)
                continue
            t.promoting = True
            lost_set = set(lost)
            # Every member still owning a SURVIVING chunk rolls it back
            # to C (rollback first on each FIFO, so a member that both
            # survives and promotes orders correctly).
            survivors = sorted({
                o for c, o in t.owner.items()
                if c not in lost_set and o != name
            })
            by_replica: Dict[str, List[list]] = {}
            for c in lost:
                by_replica.setdefault(t.replica[c], []).append(list(c))
                t.owner[c] = t.replica[c]
                t.replica[c] = None
                t.acked[c] = -1
            info = {
                "t0": time.monotonic(),
                "span": self.tracer.start(
                    "serve.promote", node="frontend", sid=sid,
                    kind="tiled", chunks=len(lost), epoch=C,
                ),
            }
            self._tiled_promoting[sid] = info
            plans.append((sid, t, C, by_replica, survivors, info))
        return plans

    def _launch_tiled_promotion(self, plan: tuple, lost_member: str) -> None:
        """Fire one resident-session promotion on its own thread (the
        caller is a frontend reader/maintenance thread and must not block
        on worker round-trips)."""
        threading.Thread(
            target=self._run_tiled_promotion, args=(plan, lost_member),
            daemon=True, name=f"tiled-promote-{plan[0]}",
        ).start()

    def _run_tiled_promotion(self, plan: tuple, lost_member: str) -> None:
        sid, t, C, by_replica, survivors, info = plan
        flight = getattr(self.tracer, "flight", None)
        if flight is not None:
            flight.dump("serve_promote", node="frontend")
        if self.events is not None:
            self.events.emit(
                "serve_promotion_started", sid=sid, kind="tiled",
                lost=lost_member, epoch=C,
                chunks=sum(len(v) for v in by_replica.values()),
            )
        lanes_parts: List[list] = []
        pop = 0
        ok = True
        try:
            # Survivors FIRST: the rollback cancels any round stalled on
            # halos from the dead worker, so an in-flight step fails fast
            # (its caller answers 429 failover) instead of waiting out
            # the barrier timeout.
            pends = [
                self._submit(
                    {"op": "tiled_rollback", "rid": 0, "sid": sid,
                     "epoch": int(C)},
                    sid=sid, kind="tile_ctl", member=m,
                )
                for m in survivors
            ]
            pends += [
                self._submit(
                    {"op": "tiled_promote", "rid": 0, "sid": sid,
                     "epoch": int(C), "chunks": chunks, "meta": t.meta()},
                    sid=sid, kind="tile_ctl", member=m,
                )
                for m, chunks in sorted(by_replica.items())
            ]
            for p in pends:
                res = self._await(p)
                rows = res.get("restored", []) + res.get("installed", [])
                if res.get("missing") or res.get("failed"):
                    ok = False
                for row in rows:
                    lanes_parts.append([int(v) for v in row["digest"]])
                    pop += int(row.get("pop", 0))
            if len(lanes_parts) != len(t.tiles):
                ok = False
        except BaseException:  # noqa: BLE001 — resolved below, honestly
            ok = False
        with self._lock:
            self._tiled_promoting.pop(sid, None)
            entry = self.sessions.get(sid)
            if not ok or entry is None:
                t.promoting = False
                if entry is not None:
                    del self.sessions[sid]
                    self._cells -= entry.height * entry.width
                    self._m_sessions_lost.inc()
                self.tiled.pop(sid, None)
                self._m_tiled.set(len(self.tiled))
                self._drop_tiled_locked(sid, t)
                if info["span"] is not None:
                    info["span"].set(outcome="lost").finish()
            else:
                t.epoch = int(C)
                t.lanes = odigest.merge_lanes(lanes_parts)
                t.population = pop
                t.round_idx = 0
                entry.epoch = int(C)
                entry.digest = odigest.format_digest(
                    odigest.value(t.lanes)
                )
                t.promoting = False
                self._assign_tiled_replicas_locked(t)
                self._m_promotions.inc()
                if info["span"] is not None:
                    info["span"].set(
                        outcome="promoted", epoch=int(C),
                        latency_s=round(
                            time.monotonic() - info["t0"], 6
                        ),
                    ).finish()
        if self.events is not None:
            self.events.emit(
                "serve_promotion_finished", sid=sid, kind="tiled",
                outcome="promoted" if ok else "lost", epoch=int(C),
            )

    # -- resident tiled: chunk migration (drain / load rebalancing) -----------

    def _plan_tiled_moves_locked(self, now: float,
                                 drain_only: bool) -> List[tuple]:
        """Ask the chunk-plane Rebalancer for (key, source, dest) moves
        over every resident, non-promoting session (caller holds the
        lock)."""
        owners: Dict[tuple, str] = {}
        replicas: Dict[tuple, Optional[str]] = {}
        for sid, t in self.tiled.items():
            if t.mode != "resident" or t.promoting:
                continue
            for c, o in t.owner.items():
                owners[(sid, c)] = o
                replicas[(sid, c)] = t.replica.get(c)
        if not owners:
            return []
        return self.tiled_rebalancer.plan_resident(
            owners, self.membership.alive_members(), now,
            drain_only=drain_only, replicas=replicas,
        )

    def _migrate_tiled_chunks(self, sid: str, chunks: list, source: str,
                              dest: str) -> None:
        """Move a session's resident chunks from ``source`` to ``dest``,
        digest-certified, in rounds of at most ``TILED_MOVE_ROUND_CHUNKS``
        (one export, one adopt, one drop each).  A round holds the
        session's steplock across export → certify → adopt, so a move can
        never interleave with an epoch barrier and a torn halo is
        unrepresentable (the next step's op simply aims at the new
        owners).  Before a round takes the lock, the source and the
        destination have caught up with their op lanes
        (:meth:`_lanes_caught_up`), so the hold does not wait out their
        backlogs.  Between rounds the lock goes first
        to the steps queued on it, which step the board with some chunks
        moved and the rest not, as the JAX plane does after each of its
        one-chunk moves.  A round commits its own chunks' in-flight
        records; once a round aborts, the later ones are not tried and
        their records abort with its reason (the next planner pass
        re-plans them)."""
        with self._lock:
            t = self.tiled.get(sid)
            migs = [self.tiled_rebalancer.inflight.get((sid, c)) for c in chunks]
        # A round's ``seconds`` run from the planner's start (the first)
        # or the previous round's end to its own end.
        started = min((m.started for m in migs if m is not None),
                      default=time.monotonic())
        aborted = None if t is not None else "setup"
        for i in range(0, len(chunks), TILED_MOVE_ROUND_CHUNKS):
            batch = chunks[i:i + TILED_MOVE_ROUND_CHUNKS]
            split = {}  # the round's split, port-only event fields
            if aborted is None:
                if i:
                    t.hand_off(TILED_HANDOFF_S)
                aborted = self._lanes_caught_up(sid, (source, dest))
            if aborted is None:
                aborted = self._migrate_tiled_round(t, sid, batch, source,
                                                    dest, split)
            now = time.monotonic()
            if aborted is not None:
                with self._lock:
                    for c in batch:
                        self.tiled_rebalancer.abort((sid, c), now)
            if self.events is not None:
                split["seconds"] = now - started
                for c in batch:
                    if aborted is None:
                        self.events.emit(
                            "serve_tiled_chunk_migrated", sid=sid,
                            chunk=list(c), source=source, dest=dest,
                            batch=len(batch),
                            **{k: round(v, 6) for k, v in split.items()},
                        )
                    else:
                        self.events.emit(
                            "serve_tiled_chunk_migration_aborted", sid=sid,
                            chunk=list(c), source=source, dest=dest,
                            reason=aborted,
                        )
            started = now

    def _lanes_caught_up(self, sid, members) -> Optional[str]:
        """Wait, holding no lock, until each of ``members`` has run every
        op queued to it so far: a ``tiled_fetch`` of no chunk answers only
        then (a member's op lane runs in order; at a drain's start the
        source's holds the shard prepares, the destination's their
        adopts).  The round's export and adopt, sent under the steplock,
        then find no backlog ahead of them.  Returns None, else the abort
        reason."""
        try:
            pends = [
                self._submit(
                    {"op": "tiled_fetch", "rid": 0, "sid": sid, "chunks": []},
                    sid=sid, kind="tile_ctl", member=m,
                )
                for m in members
            ]
            for p in pends:
                self._await(p)
        except BaseException as e:  # noqa: BLE001 — abort, never raise
            return f"catch_up: {e!r}"
        return None

    def _migrate_tiled_round(self, t, sid, chunks, source, dest,
                             split) -> Optional[str]:
        """One round of a move under the session's steplock.  Returns None
        once its chunks are committed, else the abort reason; notes in
        ``split`` the seconds waited for the lock and held it.  The
        chunks' digest key tables, which depend on no cell, are made
        before the hold."""
        geo = [t.tiles.get(c) for c in chunks]  # (gy, gx, th, tw)
        keys = None
        if all(geo) and sum(g[2] * g[3] for g in geo) <= TILED_CERTIFY_KEY_CELLS:
            keys = {
                c: ((gy, gx), t.W, (th, tw),
                    odigest.key_lanes_np((th, tw), (gy, gx), t.W))
                for c, (gy, gx, th, tw) in zip(chunks, geo)
            }
        t_lock = time.monotonic()
        if not t.steplock.acquire(timeout=self.tiled_rebalancer.deadline_s):
            return "setup"
        held = time.monotonic()
        split["lock_wait_s"] = held - t_lock
        try:
            return self._migrate_tiled_chunks_held(
                t, sid, chunks, source, dest, split, keys
            )
        except BaseException as e:  # noqa: BLE001 — the in-flight
            # records MUST resolve (abort), whatever broke
            return repr(e)
        finally:
            t.steplock.release()
            split["hold_s"] = time.monotonic() - held

    def _certify_tiled_round(self, sid, chunks, pays, source,
                             keys=None) -> bool:
        """Certify a round's exported chunks against the lanes their
        source sent, on the plane's certification threads.  A chunk whose
        payload has the origin, width and shape of its table in ``keys``
        (chunk -> (origin, width, shape, table)) takes one product with
        it; any other is mixed in full.  The verdict is the serial loop's:
        chunks count as checked in chunk order up to the first mismatch,
        which alone names the mismatch event."""
        def lanes_of(c, pay):
            origin = tuple(int(v) for v in pay["origin"])
            width = int(pay["width"])
            key = (keys or {}).get(c)
            if key is not None and key[:3] == (
                origin, width, tuple(int(v) for v in pay["state"]["shape"])
            ):
                return odigest.digest_keyed_np(key[3], unpack_tile(pay["state"]))
            return odigest.digest_payload_np(pay["state"], origin, width)

        lanes = self._certify_pool.map(lanes_of, chunks, pays)
        for c, pay, got in zip(chunks, pays, lanes):
            self._m_digest_checks.inc()
            if [int(got[0]), int(got[1])] != [int(v) for v in pay["digest"]]:
                self._m_digest_mismatches.inc()
                if self.events is not None:
                    self.events.emit(
                        "serve_tiled_digest_mismatch", sid=sid,
                        chunk=list(c), source=source,
                    )
                return False
        return True

    def _migrate_tiled_chunks_held(self, t, sid, chunks, source, dest,
                                   split, keys=None) -> Optional[str]:
        """The round's body (steplock held).  Returns None on commit, else
        the abort reason; notes its phases' seconds in ``split``."""
        with self._lock:
            if (
                t.promoting
                or self.tiled.get(sid) is not t
                or any(t.owner.get(c) != source for c in chunks)
            ):
                return "stale"
            dm = self.membership.get(dest)
            if dm is None or not dm.alive:
                return "dest_lost"
        try:
            p = self._submit(
                {"op": "tiled_export", "rid": 0, "sid": sid,
                 "chunks": [list(c) for c in chunks]},
                sid=sid, kind="tile_ctl", member=source,
            )
            t0 = time.monotonic()
            pays = self._await(p)["chunks"]
        except BaseException as e:  # noqa: BLE001 — abort, never raise
            return f"export: {e!r}"
        t1 = time.monotonic()
        split["export_s"] = t1 - t0
        if not self._certify_tiled_round(sid, chunks, pays, source, keys):
            return "digest_mismatch"
        t2 = time.monotonic()
        split["certify_s"] = t2 - t1
        try:
            p = self._submit(
                {"op": "tiled_adopt", "rid": 0, "sid": sid,
                 "meta": t.meta(), "chunks": pays},
                sid=sid, kind="tile_ctl", member=dest,
            )
            self._await(p)
        except BaseException as e:  # noqa: BLE001 — abort, never raise
            return f"adopt: {e!r}"
        split["adopt_s"] = time.monotonic() - t2
        with self._lock:
            if self.tiled.get(sid) is not t or t.promoting:
                return "stale"
            for c in chunks:
                t.owner[c] = dest
                t.acked[c] = -1
                self.tiled_rebalancer.complete((sid, c))
                self._m_chunk_migrations.inc()
            self._assign_tiled_replicas_locked(t)
            sm = self.membership.get(source)
            src_alive = sm is not None and sm.alive
        if src_alive:
            try:
                self._submit(
                    {"op": "tiled_chunk_drop", "rid": 0, "sid": sid,
                     "chunks": [list(c) for c in chunks]},
                    sid=sid, kind="tile_ctl", member=source,
                    on_done=lambda _p: None,
                )
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
        return None

    # -- stats / health / lifecycle -------------------------------------------

    def _refresh_gauges_locked(self) -> None:
        shards: Dict[str, int] = {}
        for owner in self.shard_owner.values():
            if owner is not None:
                shards[owner] = shards.get(owner, 0) + 1
        sess: Dict[str, int] = {}
        for e in self.sessions.values():
            if e.shard is not None:
                owner = self.shard_owner.get(e.shard)
                if owner is not None:
                    sess[owner] = sess.get(owner, 0) + 1
        queues: Dict[str, int] = {}
        for p in self._pending.values():
            if p.member is not None:
                queues[p.member] = queues.get(p.member, 0) + 1
        for m in self.membership.alive_members():
            self._m_shards.labels(member=m.name).set(shards.get(m.name, 0))
            self._m_shard_sessions.labels(member=m.name).set(
                sess.get(m.name, 0)
            )
            self._m_wqueue.labels(member=m.name).set(queues.get(m.name, 0))
        self._health_snapshot = {
            "shards": shards, "sessions": sess, "queue_depths": queues,
        }

    def _refresh_gauges(self) -> None:
        with self._lock:
            self._refresh_gauges_locked()

    def health(self) -> dict:
        """The /healthz contribution: per-worker session-shard counts and
        queue depths (the migrations_inflight shape, serve edition)."""
        with self._lock:
            self._refresh_gauges_locked()
            snap = self._health_snapshot
            replicas: Dict[str, int] = {}
            single = 0
            for shard, owner in self.shard_owner.items():
                if owner is None:
                    continue
                r = self.shard_replica.get(shard)
                if r is not None:
                    replicas[r] = replicas.get(r, 0) + 1
                elif self._replicate and shard not in self._promoting:
                    single += 1
            chunks_by_worker: Dict[str, int] = {}
            for t in self.tiled.values():
                if t.mode == "resident":
                    for o in t.owner.values():
                        chunks_by_worker[o] = chunks_by_worker.get(o, 0) + 1
            return {
                "sessions": len(self.sessions),
                "cells": self._cells,
                "tiled_sessions": len(self.tiled),
                "tiled_resident": {
                    "enabled": self.tiled_resident,
                    "chunks_by_worker": chunks_by_worker,
                    "chunk_migrations_inflight": len(
                        self.tiled_rebalancer.inflight
                    ),
                    "promotions_inflight": len(self._tiled_promoting),
                },
                "shards_total": self.n_shards,
                "shards_by_worker": dict(snap["shards"]),
                "sessions_by_worker": dict(snap["sessions"]),
                "queue_depth_by_worker": dict(snap["queue_depths"]),
                "shard_migrations_inflight": len(self.rebalancer.inflight),
                "held_ops": sum(len(v) for v in self._held.values()),
                "draining": self._draining,
                "replication": {
                    "enabled": self._replicate,
                    "replicas_by_worker": replicas,
                    "single_copy_shards": (
                        single if self._replicate
                        else sum(
                            1 for o in self.shard_owner.values()
                            if o is not None
                        )
                    ),
                    "promotions_inflight": len(self._promoting),
                    "max_lag_s": round(
                        max(self._lag_snapshot.values(), default=0.0), 3
                    ),
                    "lag_alert_shards": sorted(self._lag_alert),
                },
            }

    def stats(self) -> dict:
        with self._lock:
            return {
                "sessions": len(self.sessions),
                "cells": self._cells,
                "queue_depth": len(self._pending),
                "max_sessions": self.max_sessions,
                "max_cells": self.max_cells,
                "size_classes": list(self.size_classes),
                "shards": self.n_shards,
                "workers": len(self.membership.alive_members()),
            }

    def drain(self, timeout: float = 30.0) -> bool:
        """Refuse NEW work, run the in-flight ops dry — the plane half of
        a graceful shutdown (worker drains are the per-member story; this
        is whole-service SIGTERM)."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout  # graftlint: waive GL-HAZ04 -- real-time bound pairs with the real sleep pacing below; shutdown must stay bounded
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending:
                    return True
            time.sleep(0.05)
        return False

    def close(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            doomed = list(self._pending.values())
            self._pending.clear()
            self._outq.clear()
            self._held.clear()
            # Promotion spans must not outlive the run (the elastic-plane
            # discipline): finish open ones with outcome=shutdown.
            for info in self._promoting.values():
                if info.get("span") is not None:
                    info["span"].set(outcome="shutdown").finish()
            self._promoting.clear()
            for info in self._tiled_promoting.values():
                if info.get("span") is not None:
                    info["span"].set(outcome="shutdown").finish()
            self._tiled_promoting.clear()
            self._wake.set()
        for p in doomed:
            self._resolve(p, error=RuntimeError("router is closed"))
        self._certify_pool.shutdown(wait=False, cancel_futures=True)
        self._flusher.join(timeout=5)


def run_serve_cluster(config, *, min_backends: int = 1) -> int:
    """The ``serve --serve-cluster on`` role body: a serve-only cluster
    frontend — workers join like any cluster (``backend`` role), the
    tenant surface rides the obs endpoint, and SIGTERM drains."""
    from akka_game_of_life_tpu_torch.runtime.frontend import Frontend
    from akka_game_of_life_tpu_torch.runtime.signals import mask_interrupts

    fe = Frontend(config, min_backends=min_backends)
    canary = None
    fe.start()
    print(
        f"serve frontend listening on {config.host}:{fe.port} "
        f"({config.serve_shards} shards)",
        flush=True,
    )
    try:
        if not fe.wait_for_backends():
            print(
                f"error: only {len(fe.membership.alive_members())} of "
                f"{min_backends} backends joined within "
                f"{config.wait_for_backends_s}s",
                flush=True,
            )
            fe.stop()
            return 1
        port = fe._metrics_server.port if fe._metrics_server else None
        print(
            f"cluster serving /boards (+/metrics,/healthz,/trace,/slo) on "
            f":{port} — {fe.serve_plane.max_sessions} sessions / "
            f"{fe.serve_plane.max_cells} cells cluster-wide, "
            f"{len(fe.membership.alive_members())} worker(s)",
            flush=True,
        )
        if config.serve_canary and port:
            from akka_game_of_life_tpu_torch.serve.canary import CanaryProber

            # Probes the REAL tenant surface (loopback HTTP), pinned one
            # session per worker via the plane's shard map.
            canary = CanaryProber(
                config, base=f"http://127.0.0.1:{port}",
                registry=fe.metrics, tracer=fe.tracer, events=fe.events,
                plane=fe.serve_plane,
            )
            canary.start()
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("serve: interrupted; draining", flush=True)
        if canary is not None:
            canary.close()
        drained = fe.serve_plane.drain()
        print(
            "serve: drained" if drained
            else "serve: drain timed out; aborting pending ops",
            flush=True,
        )
        with mask_interrupts():
            fe.stop()
        return 130
    fe.stop()
    return 0
