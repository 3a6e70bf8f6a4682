"""The frontend coordinator: the ``frontend`` role of the cluster.

Counterpart of ``akka_game_of_life_tpu/runtime/frontend.py``, speaking the
same wire protocol, so its workers may be the port's or the JAX package's.
One process is the seed node workers join, the membership tracker, the
placement authority, the epoch pacer, the fault injector, the render sink
and the recovery orchestrator.  It builds the start board, cuts it into
packed tiles and DEPLOYs them; merges the workers' per-tile digest lanes
into ``epoch N: digest=`` lines; streams per-tile checkpoints and recovers
from them; evicts dead workers (connection EOF, stale heartbeat) and
redeploys their tiles from the last checkpoint, the survivors replaying
forward by pulling epoch-tagged rings; and injects tile or node crashes on
a wall-clock or epoch-indexed schedule.  Live tile migration and graceful
drain (the elastic plane) are carried over.

With ``serve_cluster`` on, the frontend is also the tenant-facing session
router (``serve/cluster.py:ClusterServePlane``): sessions hash-shard across
the same workers, ``/boards`` and the SLO tracker mount on the obs endpoint,
and a serve-only cluster (no ``max_epochs``) is membership plus the plane.

With ``frontend_seeds`` set as well, several such frontends federate
(``serve/federation.py:FederationPlane``): they gossip over this listener
(a connection whose first frame is ``P_HELLO`` is a peer frontend), own
slices of one keyspace, forward ops to each other and replicate control
rows to a standby peer; ``stop()`` then leaves the workers running, so they
re-home to a peer.  ``POST /profile`` captures a ``torch.profiler`` window
(``runtime/profiling.py``) and fans it out to the workers.
"""

from __future__ import annotations

import dataclasses
import queue
import socket
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from akka_game_of_life_tpu_torch.obs import (
    EventLog,
    MetricsDumper,
    MetricsServer,
    get_registry,
)
from akka_game_of_life_tpu_torch.obs.programs import get_programs
from akka_game_of_life_tpu_torch.obs.programs import http_routes as program_routes
from akka_game_of_life_tpu_torch.obs.tracing import get_tracer
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
from akka_game_of_life_tpu_torch.runtime import protocol as P
from akka_game_of_life_tpu_torch.runtime.checkpoint import make_store
from akka_game_of_life_tpu_torch.runtime.chaos import CrashInjector
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.membership import Member, Membership
from akka_game_of_life_tpu_torch.runtime.netchaos import (
    ChaosChannel,
    NetworkChaos,
    wrap_channel,
)
from akka_game_of_life_tpu_torch.runtime.profiling import ProfilerCapture
from akka_game_of_life_tpu_torch.runtime.rebalance import Migration, Rebalancer
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import initial_board
from akka_game_of_life_tpu_torch.runtime.tiles import TileId, TileLayout, layout_for_workers
from akka_game_of_life_tpu_torch.runtime.wire import (
    MAX_FRAME,
    Channel,
    attach_trace,
    pack_tile,
    unpack_tile,
)

_MAINT_INTERVAL_S = 0.05

# Cadence of the frontend's --metrics-file rewrites.  The standalone runner
# dumps at its epoch-indexed metrics cadence; the coordinator has no
# per-epoch loop of its own, so it refreshes the exposition on wall time —
# a file collector scrapes a live view mid-run, not only the exit snapshot.
_METRICS_DUMP_INTERVAL_S = 5.0

# Cadence of *in-memory* checkpoints when no durable cadence is configured.
# The frontend needs a periodic per-tile snapshot anyway: it is both the
# recovery source for redeploys and the floor below which boundary rings are
# pruned — without it ring history grows forever (the reference's
# unbounded-History bug, SURVEY.md §2 bug 5, at tile granularity).
_MEMORY_CKPT_EVERY = 32

# Assemble a full final board in memory only below this cell count; above it
# (65536²-class boards) the durable per-tile checkpoint IS the final output.
_ASSEMBLE_LIMIT = 1 << 28


class MalformedMessage(Exception):
    """A structurally invalid message from a registered worker — grounds to
    drop the connection (tiles redeploy), never to crash a serve thread."""


# Required fields per message type, checked BEFORE dispatch so a missing
# field can never surface as a KeyError inside cluster bookkeeping.
_MSG_REQUIRED = {
    P.PROGRESS: ("tile", "epoch"),
    P.TILE_STATE: ("tile", "epoch"),
    P.REDEPLOY_REQUEST: ("tile",),
    P.GATHER_FAILED: ("tile", "epoch"),
    P.MIGRATE_STATE: ("tile", "epoch", "state", "digest", "seq"),
    P.DRAIN_REQUEST: (),
    P.SERVE_RESULT: ("results",),
    P.SHARD_STATE: ("shard", "seq"),
    P.SHARD_HOME: ("sessions",),
}
# TILE_STATE carries per-reason payloads; each declared reason needs its key.
_REASON_PAYLOAD = {
    "final": ("state",),
    "checkpoint": ("state",),
    "render": ("scaled_origin", "sample"),
    "metrics": ("population",),
}


def _validate_msg(msg) -> None:
    if not isinstance(msg, dict):
        raise MalformedMessage(f"non-dict payload ({type(msg).__name__})")
    kind = msg.get("type")
    if not isinstance(kind, str):
        raise MalformedMessage(f"message type {kind!r} is not a string")
    required = _MSG_REQUIRED.get(kind, ())
    for field in required:
        if field not in msg:
            raise MalformedMessage(f"{kind} message missing {field!r}")
    if "tile" in required:
        tile = msg["tile"]
        if not (
            isinstance(tile, (list, tuple))
            and len(tile) == 2
            and all(isinstance(v, int) for v in tile)
        ):
            raise MalformedMessage(
                f"{kind} tile {tile!r} is not an integer (row, col) pair"
            )
    if "epoch" in required and not isinstance(msg["epoch"], int):
        raise MalformedMessage(f"{kind} epoch {msg['epoch']!r} is not an int")
    if "seq" in required and not isinstance(msg["seq"], int):
        raise MalformedMessage(f"{kind} seq {msg.get('seq')!r} is not an int")
    if "state" in required and not isinstance(msg["state"], dict):
        raise MalformedMessage(f"{kind} state is not a tile payload dict")
    if "shard" in required and not isinstance(msg["shard"], int):
        raise MalformedMessage(
            f"{kind} shard {msg.get('shard')!r} is not an int"
        )
    if "results" in required and not isinstance(msg["results"], list):
        raise MalformedMessage(f"{kind} results is not a list")
    if kind == P.PROGRESS:
        for field in ("q", "skipped"):
            if field in msg and not isinstance(msg[field], int):
                raise MalformedMessage(
                    f"progress {field} {msg[field]!r} is not an int"
                )
    if kind in (P.PROGRESS, P.MIGRATE_STATE) and "digest" in msg:
        d = msg["digest"]
        if not (
            isinstance(d, (list, tuple))
            and len(d) == 2
            and all(isinstance(v, int) for v in d)
        ):
            raise MalformedMessage(
                f"{kind} digest {d!r} is not an integer (lo, hi) pair"
            )
    if kind == P.TILE_STATE:
        reasons = msg.get("reasons", [])
        if not isinstance(reasons, (list, tuple)) or not all(
            isinstance(r, str) for r in reasons
        ):
            raise MalformedMessage(
                f"tile_state reasons {reasons!r} not a list of strings"
            )
        for reason in reasons:
            for field in _REASON_PAYLOAD.get(reason, ()):
                if field not in msg:
                    raise MalformedMessage(
                        f"tile_state[{reason}] missing {field!r}"
                    )
        if "window" in msg and "window_origin" not in msg:
            raise MalformedMessage("tile_state window missing 'window_origin'")


class _MemberSender:
    """One member's outbound lane: a FIFO drained by a writer thread.

    The frontend decides what to send under its lock (the order of an OWNERS
    broadcast against a late joiner's snapshot, a TICK against a PRUNE), so
    it enqueues there, in that order, and never writes a socket while it
    holds the lock: a member that stops reading (a JAX worker reads its
    control channel on its dispatch thread, which may be deep in a step)
    then stalls only its own lane, not the lock, the other members' TICKs
    or the readers.  A send that fails drops the member, off the lock."""

    def __init__(self, member: Member, on_lost) -> None:
        self._member = member
        self._on_lost = on_lost
        self._cond = threading.Condition()
        self._items: Deque[dict] = deque()
        self._busy = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"member-send-{member.name}"
        )
        self._thread.start()

    def send(self, msg: dict) -> None:
        with self._cond:
            if not self._closed:
                self._items.append(msg)
                self._cond.notify_all()

    def close(self) -> None:
        """Drop what is queued; the writer ends after its current send."""
        with self._cond:
            self._closed = True
            self._items.clear()
            self._cond.notify_all()

    def flush(self, deadline: float) -> bool:
        """Wait until everything queued is written, or ``deadline``
        (monotonic seconds) passes; True if the lane is empty."""
        with self._cond:
            while (self._items or self._busy) and not self._closed:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
            return not self._items

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._items and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                msg = self._items.popleft()
                self._busy = True
            try:
                self._member.channel.send(msg)
            except OSError:
                self.close()
                self._on_lost(self._member.name)
                return
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()


class Frontend:
    """Coordinator state machine.  Thread layout: one acceptor, one reader
    thread per worker connection, one maintenance thread (ticks, heartbeat
    eviction, fault injection)."""

    # Lock discipline (tools/graftlint, pass GL-LOCK01): the coordinator
    # RLock orders every piece of cluster bookkeeping the reader threads
    # and the maintenance thread both touch.  Helpers documented "caller
    # holds the lock" carry the *_locked suffix.  Set-once references
    # (config, rule, store, observer, membership — internally consistent
    # or single-writer) are deliberately undeclared.
    _GRAFTLINT_GUARDED = {
        "tile_owner": "_lock",
        "tile_epochs": "_lock",
        "target_epoch": "_lock",
        "paused": "_lock",
        "layout": "_lock",
        "quiescent": "_lock",
        "_last_ring_time": "_lock",
        "_redeploy_times": "_lock",
        "_last_ckpt": "_lock",
        "_ckpt_pending": "_lock",
        "_final_tiles": "_lock",
        "final_board": "_lock",
        "_digest_partial": "_lock",
        "_digest_floor": "_lock",
        "epoch_digests": "_lock",
        "final_digest": "_lock",
        "error": "_lock",
        "_next_tick": "_lock",
        "_drain_spans": "_lock",
        "_degraded_span": "_lock",
        "degraded": "_lock",
    }

    def __init__(
        self,
        config: SimulationConfig,
        *,
        min_backends: int = 1,
        observer: Optional[BoardObserver] = None,
        registry=None,
        tracer=None,
    ) -> None:
        if config.max_epochs is None and not config.serve_cluster:
            # A serve-only cluster (serve_cluster with no simulation) has
            # no epoch target: the frontend is membership + serve plane.
            raise ValueError("frontend requires max_epochs")
        if config.max_epochs is None:
            config = dataclasses.replace(config, max_epochs=0)
        self.config = config
        self.rule = resolve_rule(config.rule)
        # Coordinator observability: membership churn and recovery actions
        # as counters/gauges, lifecycle as JSONL events, both exposed live
        # at /metrics + /healthz + /trace when metrics_port is set (started
        # in :meth:`start`).  The tracer's epoch span context rides inside
        # TICK/DEPLOY/CRASH envelopes so worker spans join the epoch trace.
        self.metrics = registry if registry is not None else get_registry()
        if tracer is None:
            tracer = get_tracer()
            # Role-label the process tracer so nodeless spans (checkpoint
            # IO on the io thread) attribute to this role, not "proc".
            tracer.node = "frontend"
        self.tracer = tracer
        self.tracer.flight.configure(
            directory=config.flight_dir, node="frontend"
        )
        self.events = EventLog(
            config.log_events, node="frontend", recorder=self.tracer.flight
        )
        # Compile & cost observatory: the frontend is the cluster merge
        # point — its process registry gets the role identity and alert
        # sinks, and every worker COST frame folds in through merge_remote.
        self.programs = get_programs().configure(
            node="frontend",
            events=self.events,
            flight=self.tracer.flight,
            metrics=self.metrics,
            enabled=config.obs_programs,
        )
        # POST /profile: one rate-limited capture at a time, fanned out to
        # the workers (each lands its own beside its crash dumps).
        self._profiler = ProfilerCapture(
            config.flight_dir or "artifacts",
            node="frontend",
            max_seconds=config.obs_profile_max_s,
            min_interval_s=config.obs_profile_min_interval_s,
        )
        # cluster.run is the whole simulation; epoch is one epoch-target
        # announcement (the whole run in free-running mode, one tick in
        # paced mode) — the span every backend step links back to.
        self._run_span = None
        self._epoch_span = None
        self._metrics_dumper = (
            MetricsDumper(
                self.metrics,
                config.metrics_file,
                interval_s=_METRICS_DUMP_INTERVAL_S,
            )
            if config.metrics_file
            else None
        )
        self._m_alive = self.metrics.gauge("gol_members_alive")
        self._m_joined = self.metrics.counter("gol_members_joined_total")
        self._m_lost = self.metrics.counter("gol_members_lost_total")
        self._m_redeploys = self.metrics.counter("gol_redeploys_total")
        self._m_degraded = self.metrics.gauge("gol_degraded_mode")
        self._m_degraded_entries = self.metrics.counter(
            "gol_degraded_entries_total"
        )
        self._m_tiles_skipped = self.metrics.counter(
            "gol_tiles_skipped_total"
        )
        self._m_tiles_quiescent = self.metrics.gauge("gol_tiles_quiescent")
        self._m_digest_checks = self.metrics.counter("gol_digest_checks_total")
        self._m_digest_mismatches = self.metrics.counter(
            "gol_digest_mismatches_total"
        )
        self._m_digest_seconds = self.metrics.histogram("gol_digest_seconds")
        # Elastic plane observability: per-member control-plane staleness
        # (the operator's early-warning gauge before auto-down fires),
        # migration outcomes, and drain progress.
        self._m_hb_age = self.metrics.gauge(
            "gol_member_heartbeat_age_seconds",
            "Seconds since each member's last control-plane traffic",
            ("member",),
        )
        self._m_draining = self.metrics.gauge("gol_members_draining")
        self._m_migrations = self.metrics.counter("gol_migrations_total")
        self._m_migration_aborts = self.metrics.counter(
            "gol_migration_aborts_total"
        )
        self._m_migration_seconds = self.metrics.histogram(
            "gol_migration_seconds"
        )
        self._m_drains = self.metrics.counter("gol_drains_total")
        self._metrics_server: Optional[MetricsServer] = None
        self._serve_slo = None  # SloTracker when serve_cluster is on
        # Wire-fault policy (config/CLI --chaos-net-*): one seeded instance
        # per process; the in-process harness hands this same instance to
        # its workers so partition sides are consistent cluster-wide.
        self.netchaos = (
            NetworkChaos(
                config.net_chaos, registry=self.metrics, tracer=self.tracer
            )
            if config.net_chaos.enabled
            else None
        )
        if self.netchaos is not None:
            self.netchaos.register_node("frontend")
        # Degraded mode: a partition has stranded a quorum of tiles past
        # stuck_timeout_s — the run checkpoints what it has and WAITS for
        # the heal instead of auto-downing live members / thrashing the
        # restart budget on tiles nobody can actually step.
        self.degraded = False
        self._degraded_span = None
        if self.rule.radius != 1:
            raise ValueError(
                "the TCP cluster exchanges radius-1 boundary rings; "
                "radius-R ltl rules run standalone"
            )
        self.min_backends = min_backends
        self.observer = observer or BoardObserver(
            render_every=config.render_every,
            render_max_cells=config.render_max_cells,
            metrics_every=config.metrics_every,
            log_file=config.log_file,
            registry=self.metrics,
        )
        # Fault schedules: the wall-clock killer (BoardCreator.scala:97-102)
        # polls from the maintenance loop; the epoch-indexed schedule is
        # anchored to cluster progress instead — it fires from the PROGRESS
        # handler once the slowest tile reaches first_after_epochs (then
        # every every_epochs).  Epoch anchoring is what makes chaos drills
        # deterministic: a fast run cannot outrace the injector, because the
        # schedule is indexed by the very epochs the run must produce.
        self.membership = Membership(config.failure_timeout_s)
        # The elastic plane (docs/OPERATIONS.md "Elastic rebalancing"):
        # live tile migration, mid-run scale-out, graceful drain.  Always
        # constructed — drains use it on every cluster; rebalance_enabled
        # only gates the automatic load-driven planning.  Mutated strictly
        # under self._lock.
        self.rebalancer = Rebalancer(config)
        self._drain_spans: Dict[str, object] = {}
        # Cluster-sharded serving (docs/OPERATIONS.md "Serving plane"):
        # when serve_cluster is on, this frontend is ALSO the tenant-facing
        # session router — sessions hash-shard across the same workers that
        # host tiles, /boards mounts on the obs endpoint, and the plane's
        # own Rebalancer instance migrates session shards (load + drain).
        self.serve_plane = None
        if config.serve_cluster:
            from akka_game_of_life_tpu_torch.serve.cluster import ClusterServePlane

            self.serve_plane = ClusterServePlane(
                config,
                self.membership,
                self._safe_send,
                registry=self.metrics,
                tracer=self.tracer,
                events=self.events,
            )
        if config.checkpoint_dir and config.checkpoint_format != "npz":
            # The frontend streams per-tile saves (save_tile /
            # finalize_epoch), which only the npz store implements; orbax is
            # the standalone run's per-shard store.
            raise ValueError(
                "cluster frontend requires checkpoint_format='npz' "
                f"(got {config.checkpoint_format!r})"
            )
        self.store = (
            make_store(
                config.checkpoint_dir,
                config.checkpoint_format,
                registry=self.metrics,
                tracer=self.tracer,
            )
            if config.checkpoint_dir
            else None
        )
        # Created in start_simulation so the error.delay schedule counts from
        # simulation start, not from process start (workers may take a long
        # time to join during wait-for-backends).
        self.injector: Optional[CrashInjector] = None

        self.layout: Optional[TileLayout] = None
        self.tile_owner: Dict[TileId, str] = {}
        self.tile_epochs: Dict[TileId, int] = {}
        self.target_epoch = 0
        self.start_epoch = 0
        self.paused = False
        self.crash_events: List[dict] = []
        # Supervision budget (OneForOneStrategy ≤10 restarts/min,
        # BoardCreator.scala:42-45): recent redeploy timestamps per tile.
        self._redeploy_times: Dict[TileId, Deque[float]] = {}
        # Per-tile progress clock (last RING received) — the evidence a
        # GATHER_FAILED escalation is judged against.
        self._last_ring_time: Dict[TileId, float] = {}
        # Quiescence tier (sparse_cluster): tiles currently reporting
        # themselves quiescent (tile -> period).  Exempted — while their
        # pings stay fresh — from the stuck-neighbor redeploy and the
        # degraded-mode stranded count (silence at cadence granularity is
        # the feature, not a fault), and surfaced in /healthz.  Cleared on
        # any ownership change; the new owner re-detects from scratch.
        self.quiescent: Dict[TileId, int] = {}
        # Checkpoint cadence workers report at; falls back to an in-memory
        # cadence so ring pruning and recovery work without a durable store.
        self._ckpt_cadence = config.checkpoint_every or _MEMORY_CKPT_EVERY
        if self._ckpt_cadence % config.exchange_width:
            # Tiles only visit exchange_width-aligned epochs (config
            # validates the explicit cadences; the in-memory fallback must
            # hold the same invariant or recovery epochs would never land).
            self._ckpt_cadence = (
                self._ckpt_cadence
                + config.exchange_width
                - self._ckpt_cadence % config.exchange_width
            )

        # Recovery source: (epoch, {tile: bit-packed payload}).  Kept packed
        # (8 cells/byte) so a 65536² board's recovery state is ~512 MiB, and
        # the full board is never assembled on this process (VERDICT weak #5).
        self._last_ckpt: Optional[Tuple[int, Dict[TileId, dict]]] = None
        self._ckpt_pending: Dict[int, Dict[TileId, dict]] = {}
        self._final_tiles: Dict[TileId, dict] = {}
        self.final_board: Optional[np.ndarray] = None
        # Digest plane (obs_digest): per-tile fingerprint lanes arrive on
        # PROGRESS pings at digest-due epochs and merge here in O(tiles)
        # bytes — the cluster's whole-board state certificate without any
        # board assembly.  epoch_digests holds the last few merged 64-bit
        # values (finalized checkpoints copy theirs into COMPLETE.json);
        # final_digest is the max_epochs certificate bench/tests compare.
        self._digest_partial: Dict[int, Dict[TileId, Tuple[int, int]]] = {}
        self._digest_floor: Optional[int] = None
        self.epoch_digests: Dict[int, int] = {}
        self.final_digest: Optional[int] = None
        self.error: Optional[str] = None

        self._lock = threading.RLock()
        # Each member's writer (:class:`_MemberSender`), by ``id(member)``.
        self._senders: Dict[int, _MemberSender] = {}
        self._senders_lock = threading.Lock()
        self._started = threading.Event()
        self.done = threading.Event()
        self._stop = threading.Event()
        self._next_tick: Optional[float] = None
        # Checkpoint IO rides its own thread: a reader thread that blocks on
        # disk stops draining its worker's socket, which can starve that
        # worker's heartbeats behind bulk sends and auto-down a live member.
        self._io_queue: "queue.Queue[Optional[Tuple[str, tuple]]]" = queue.Queue()

        self._listener = socket.create_server(
            (config.host, config.port), reuse_port=False
        )
        self.port = self._listener.getsockname()[1]
        # The frontend federation: with frontend_seeds set, this frontend
        # gossips membership and slice ownership with its peers, forwards
        # foreign-slice serve ops and replicates its control rows to a
        # standby peer.  Built after the listener, so the advertised
        # identity carries the bound port.
        self.federation = None
        if self.serve_plane is not None and config.frontend_seeds:
            from akka_game_of_life_tpu_torch.serve.federation import FederationPlane

            adv = config.frontend_advertise or f"{config.host}:{self.port}"
            host, _, port_s = adv.rpartition(":")
            if host in ("0.0.0.0", ""):
                host = "127.0.0.1"
            self.federation = FederationPlane(
                config, self.serve_plane,
                name=f"{host}:{int(port_s)}",
                cluster_addr=(host, int(port_s)),
                events=self.events,
            )
            self.federation.on_peers_changed(self._push_fed_peers)
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.config.metrics_port or self.serve_plane is not None:
            # Observatory surface: cluster-merged /programs + /cost, and
            # POST /profile.
            routes = dict(
                program_routes(
                    registry=self.programs, profile=self._cluster_profile
                )
            )
            if self.serve_plane is not None:
                from akka_game_of_life_tpu_torch.obs import slo as slo_mod
                from akka_game_of_life_tpu_torch.serve.api import board_routes

                # The tenant surface rides the obs endpoint, exactly like
                # the single-process serve role (ephemeral port when no
                # metrics_port was configured — printed by the role body).
                # The SLO tracker gets the frontend's event log so burn
                # alerts land in the same stream as promotions.
                self._serve_slo = slo_mod.SloTracker(
                    self.config, registry=self.metrics, tracer=self.tracer,
                    events=self.events, node="frontend",
                )
                routes.update(
                    board_routes(
                        # With federation on, /boards mounts the federated
                        # router: one routing level (the slice's owner)
                        # above the plane's shard table.
                        self.federation.router
                        if self.federation is not None
                        else self.serve_plane,
                        tracer=self.tracer,
                        slo=self._serve_slo,
                    )
                )
            self._metrics_server = MetricsServer(
                self.metrics,
                port=self.config.metrics_port,
                health=self._health,
                tracer=self.tracer,
                routes=routes,
            )
        if self.federation is not None:
            if self._metrics_server is not None:
                # Peers learn this HTTP port by gossip: their 307s for
                # this frontend's boards point there.
                self.federation.set_http_port(self._metrics_server.port)
            self.federation.start()
        for fn in (self._accept_loop, self._maintenance_loop, self._io_loop):
            t = threading.Thread(target=fn, daemon=True, name=fn.__name__)
            t.start()
            self._threads.append(t)

    def _health(self) -> dict:
        """The /healthz document: ok until the run has errored — plus the
        live facts an operator checks first (members, epoch floor, done).
        Per-member heartbeat age surfaces control-plane staleness BEFORE
        auto-down fires (it also lives in the
        gol_member_heartbeat_age_seconds gauge)."""
        now = time.monotonic()
        with self._lock:
            alive = self.membership.alive_members()
            doc = {
                "ok": self.error is None,
                "error": self.error,
                "members_alive": len(alive),
                "heartbeat_age_s": {
                    m.name: round(max(0.0, now - m.last_seen), 3)
                    for m in alive
                },
                "draining": sorted(m.name for m in alive if m.draining),
                "migrations_inflight": len(self.rebalancer.inflight),
                "tiles_quiescent": len(self.quiescent),
                "epoch_floor": min(self.tile_epochs.values(), default=0),
                "target_epoch": self.target_epoch,
                "done": self.done.is_set(),
                "paused": self.paused,
                "degraded": self.degraded,
            }
        # Cost observatory digest (registry takes its own lock): program
        # counts, compile bill, storms, per-member warmth.
        doc["programs"] = self.programs.health_summary()
        if self.serve_plane is not None:
            # Outside the frontend lock (frontend → plane is the one
            # permitted nesting order, and health() takes the plane lock).
            doc["serve"] = self.serve_plane.health()
        if self.federation is not None:
            # Peers and gossip ages, the slice map, forwarded and parked
            # ops, promotions in flight.
            doc["federation"] = self.federation.health()
        return doc

    def _push_fed_peers(self) -> None:
        """The federation's peer set changed: push the control re-home
        fallbacks to every live worker (FED_PEERS), so a worker that joined
        before the federation converged, or outlived a peer, holds the
        current list."""
        fallbacks = self.federation.worker_fallbacks()
        for m in self.membership.alive_members():
            self._safe_send(m, {"type": P.FED_PEERS, "peers": fallbacks})

    def _cluster_profile(self, seconds: Optional[float]) -> dict:
        """POST /profile: capture locally first (the rate limiter lives
        here, one knob for the whole cluster), then fan the same window to
        every live worker, fire and forget: ``queued`` names the members
        whose writer took the request, not ones it has reached."""
        result = self._profiler.capture(seconds)
        if not result.get("ok"):
            return result
        queued = []
        for m in self.membership.alive_members():
            if self._safe_send(m, {"type": P.PROFILE, "seconds": result["seconds"]}):
                queued.append(m.name)
        result["queued"] = sorted(queued)
        return result

    def _io_loop(self) -> None:
        while True:
            item = self._io_queue.get()
            if item is None:
                self._io_queue.task_done()
                return
            kind, args = item
            try:
                if kind == "tile":
                    self.store.save_tile(*args)
                elif kind == "finalize":
                    epoch, rule, grid, shape, meta = args
                    self.store.finalize_epoch(
                        epoch, rule, grid, shape, meta=meta
                    )
            except Exception as e:  # any write failure: fail loudly, never
                # strand stop() on an unjoinable queue
                with self._lock:
                    self.error = f"checkpoint IO failed: {e!r}"
                self.done.set()
            finally:
                self._io_queue.task_done()

    def wait_for_backends(self, timeout: Optional[float] = None) -> bool:
        """Reference semantics: give workers ``wait-for-backends`` to join
        (``Run.scala:50``), but start as soon as the quorum is there."""
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.config.wait_for_backends_s
        )
        while time.monotonic() < deadline:
            if len(self.membership.alive_members()) >= self.min_backends:
                return True
            time.sleep(0.01)
        return len(self.membership.alive_members()) >= self.min_backends

    def start_simulation(self) -> None:
        with self._lock:
            members = self.membership.placeable_members()
            if len(members) < self.min_backends:
                raise RuntimeError(
                    f"only {len(members)} backends joined, need {self.min_backends}"
                )
            # Oversubscription: tiles_per_worker > 1 deals several tiles to
            # each worker (round-robin below), giving the coalescing data
            # plane multiple rings per peer per epoch to batch into one
            # frame and node-loss recovery finer redistribution units.
            self.layout = layout_for_workers(
                self.config.shape,
                len(members) * self.config.tiles_per_worker,
            )
            th, tw = self.layout.tile_shape
            tile_bytes = th * tw // 8 if self.rule.states == 2 else th * tw
            if tile_bytes > MAX_FRAME - (1 << 20):
                raise RuntimeError(
                    f"a {th}x{tw} tile needs ~{tile_bytes} wire bytes, over "
                    f"the {MAX_FRAME}-byte frame cap — run more workers so "
                    "tiles shrink"
                )
            if min(th, tw) < self.config.exchange_width:
                raise RuntimeError(
                    f"exchange_width={self.config.exchange_width} exceeds the "
                    f"{th}x{tw} tile — a ring cannot be wider than its tile"
                )
            epoch0, tiles0 = self._load_recovery_tiles_locked()
            self._last_ckpt = (epoch0, tiles0)
            self.start_epoch = epoch0
            self.observer.set_cluster_layout(
                len(self.layout.tile_ids), self.config.shape
            )
            if self.config.probe_window is not None:
                y0, y1, x0, x1 = self.config.probe_window
                th2, tw2 = self.layout.tile_shape
                n_hit = sum(
                    1
                    for t in self.layout.tile_ids
                    if (oy := t[0] * th2) < y1
                    and oy + th2 > y0
                    and (ox := t[1] * tw2) < x1
                    and ox + tw2 > x0
                )
                self.observer.expect_window(self.config.probe_window, n_hit)

            if self.config.tick_s > 0:
                # Paced mode: announce epochs one tick at a time, like the
                # reference's fixed 3 s clock (BoardCreator.scala:107).
                self.target_epoch = epoch0
                self._next_tick = time.monotonic() + self.config.start_delay_s
            else:
                # Free-running: announce the final target; tiles pipeline
                # toward it asynchronously, epoch-tagged (the reference's
                # lag-and-catch-up behavior, CellActor.scala:41-47).
                self.target_epoch = self.config.max_epochs

            if self.config.fault_injection.enabled:
                self.injector = CrashInjector(
                    self.config.fault_injection,
                    registry=self.metrics,
                    flight=self.tracer.flight,
                )

            # Root the run's trace: every backend step/halo/recovery span
            # links back here through the context TICK/DEPLOY carry.
            self._run_span = self.tracer.start(
                "cluster.run", node="frontend",
                shape=str(self.config.shape), max_epochs=self.config.max_epochs,
                members=len(members),
            )
            self._epoch_span = self.tracer.start(
                "epoch", parent=self._run_span, node="frontend",
                target=self.target_epoch,
            )

            assignments: Dict[str, List[TileId]] = {m.name: [] for m in members}
            for idx, tile in enumerate(self.layout.tile_ids):
                m = members[idx % len(members)]
                assignments[m.name].append(tile)
                self.tile_owner[tile] = m.name
                self.tile_epochs[tile] = epoch0
            # Wiring before data: workers must know every tile's peer
            # address before the first DEPLOY makes them publish rings.
            self._broadcast_owners_locked()
            for m in members:
                m.tiles = assignments[m.name]
            self._started.set()
        # Bulk sends outside the lock (see _send_deploy).
        for m in members:
            if m.tiles:
                self._send_deploy(m, m.tiles)

    def _owners_msg_locked(self) -> dict:
        """The current wiring as one OWNERS message.  Caller holds the lock."""
        rows = []
        for tile, owner in self.tile_owner.items():
            m = self.membership.get(owner)
            if m is None:
                continue
            rows.append([list(tile), owner, m.peer_host, m.peer_port])
        return {
            "type": P.OWNERS,
            "tiles": rows,
            "grid": list(self.layout.grid),
            "shape": list(self.config.shape),
        }

    def _broadcast_owners_locked(self) -> None:
        """NeighboursRefs (re-)wiring (BoardCreator.scala:86-88,149-151):
        every worker learns every tile's owner and peer data-plane address.
        The frontend brokers addresses only — ring bytes never touch it."""
        msg = self._owners_msg_locked()
        for m in self.membership.alive_members():
            self._safe_send(m, msg)

    def _load_recovery_tiles_locked(self) -> Tuple[int, Dict[TileId, dict]]:
        """The (epoch, packed tile dict) the run starts/recovers from.

        A durable per-tile checkpoint whose grid matches the current layout
        is loaded tile-by-tile — the full board never materializes; a
        full-board (or grid-mismatched) checkpoint is split and re-packed;
        otherwise the deterministic initial board is split and packed."""
        layout = self.layout
        if self.store is not None and self.store.latest_epoch() is not None:
            epoch0 = self.store.latest_epoch()
            meta = getattr(self.store, "tile_meta", None)
            if meta is not None:
                try:
                    epoch_meta = self.store.tile_meta(epoch0)
                    if tuple(epoch_meta["grid"]) == layout.grid:
                        # Stored payloads go straight back onto the wire —
                        # no unpack/repack, no full-tile materialization.
                        tiles = {
                            t: self.store.load_tile_payload(epoch0, t)
                            for t in layout.tile_ids
                        }
                        self._certify_recovery_tiles_locked(epoch_meta, tiles)
                        # One restore per recovery-source load: this path
                        # bypasses store.load(), so count it here (the
                        # full-board fallback below counts inside load()).
                        self.store.metrics.restores.inc()
                        return epoch0, tiles
                except FileNotFoundError:
                    pass  # latest is a full-board file; fall through
            ckpt = self.store.load()
            board, epoch0 = ckpt.board, ckpt.epoch
        else:
            epoch0 = 0
            board = initial_board(self.config)
        return epoch0, {
            t: pack_tile(layout.extract(board, t)) for t in layout.tile_ids
        }

    def _certify_recovery_tiles_locked(
        self, epoch_meta: dict, tiles: Dict[TileId, dict]
    ) -> None:
        """Certify a per-tile recovery source against the 64-bit digest its
        finalize recorded (present when the saving run had obs_digest on):
        re-derive per-tile lanes from the payloads — one tile at a time,
        no board assembly — merge, and fail LOUDLY on mismatch.  A corrupt
        checkpoint deployed as a recovery source would otherwise fork the
        whole cluster's trajectory silently."""
        from akka_game_of_life_tpu_torch.ops import digest as odigest

        recorded = epoch_meta.get("digest")
        if not recorded:
            return
        t0 = time.perf_counter()
        computed = odigest.format_digest(
            odigest.value(
                odigest.merge_lanes(
                    odigest.digest_payload_np(
                        payload, self.layout.origin(t), self.config.width
                    )
                    for t, payload in tiles.items()
                )
            )
        )
        self._m_digest_checks.inc()
        self._m_digest_seconds.observe(time.perf_counter() - t0)
        if computed != recorded:
            self._m_digest_mismatches.inc()
            self.events.emit(
                "digest_mismatch",
                epoch=int(epoch_meta.get("epoch", -1)),
                stored=recorded,
                computed=computed,
            )
            raise ValueError(
                f"recovery checkpoint failed digest certification: stored "
                f"{recorded}, computed {computed} — refusing to deploy a "
                f"corrupt recovery source"
            )

    def _send_deploy(
        self,
        member: Member,
        tiles: List[TileId],
        *,
        state_epoch: Optional[int] = None,
        payloads: Optional[Dict[TileId, dict]] = None,
        ring_history: Optional[Dict[TileId, list]] = None,
    ) -> None:
        """Ship tiles to a worker.  Callers must NOT hold the frontend lock:
        a DEPLOY is a multi-megabyte send, and the receiving worker may be
        deep in a multi-second compute step, not reading — a blocking send
        under the global lock would stall every reader thread behind it and
        auto-down live workers (the bulk-send liveness hazard).

        By default the recovery (epoch, payload) pair is read HERE, under
        one lock acquisition: a caller passing an epoch it read earlier
        races with a checkpoint completing in between, shipping a newer
        board labeled with the older epoch — the tile then replays from a
        wrong state and silently corrupts the trajectory (caught by the
        width-k node-loss test, where chunked stepping makes
        kill-during-checkpoint likely).

        A live migration instead passes the certified ``payloads`` at their
        frozen ``state_epoch`` (plus ``ring_history``, the source's retained
        rings for the tile, forwarded in-band so the destination can serve
        lagging neighbors even after the source has left the wiring) — the
        tile resumes exactly where it froze, no checkpoint replay."""
        with self._lock:
            now = time.monotonic()
            if payloads is not None:
                # A migration deploy races member loss: if the destination
                # died (or a tile was re-placed by recovery) between COMMIT
                # and this send, mutating the bookkeeping below would pin
                # the tile's epoch at the frozen value while its real owner
                # replays from a checkpoint — and the wrongly-high prune
                # floor would drop ring history the replay still needs
                # (PROGRESS is monotone-max, so it never self-corrects).
                # The recovery path already owns the tile; drop this deploy.
                if not member.alive or any(
                    self.tile_owner.get(t) != member.name for t in tiles
                ):
                    return
                epoch, recovery = state_epoch, payloads
            else:
                epoch, recovery = self._last_ckpt
            for t in tiles:
                # A freshly deployed tile gets a full stuck_timeout_s of
                # grace before GATHER_FAILED may count it as wedged.
                self._last_ring_time[t] = now
                # Keep the lag/prune bookkeeping consistent with the epoch
                # actually shipped (not one a caller read before the swap).
                self.tile_epochs[t] = epoch
            specs = []
            for t in tiles:
                spec = {
                    "id": list(t),
                    "epoch": epoch,
                    "origin": list(self.layout.origin(t)),
                    "state": recovery[t],  # bit-packed, straight to wire
                }
                if ring_history and ring_history.get(t):
                    spec["rings"] = ring_history[t]
                specs.append(spec)
            msg = {
                "type": P.DEPLOY,
                "tiles": specs,
                "rule": self.rule.rulestring(),
                "target": self.target_epoch,
                "final_epoch": self.config.max_epochs,
                "render_every": self.config.render_every,
                "render_strides": list(self.observer.render_strides),
                "checkpoint_every": self._ckpt_cadence,
                "metrics_every": self.config.metrics_every,
            }
            if self.config.probe_window is not None:
                # Workers attach their tile∩window cells to render-cadence
                # TILE_STATE pushes; the observer stitches the exact window
                # (O(window) on the wire at any board size).
                msg["probe_window"] = list(self.config.probe_window)
            attach_trace(msg, self._epoch_span)
        with self.tracer.span(
            "cluster.deploy", parent=self._epoch_span, node="frontend",
            member=member.name, tiles=len(tiles), epoch=epoch,
        ):
            self._safe_send(member, msg)

    def _sender(self, member: Member) -> Optional[_MemberSender]:
        """The member's writer, made at its first send; None once the
        member is lost.  ``_on_member_lost`` marks the member dead under
        the same lock, so a lost member never gets a new writer."""
        with self._senders_lock:
            sender = self._senders.get(id(member))
            if sender is None and member.alive:
                sender = _MemberSender(member, self._on_member_lost)
                self._senders[id(member)] = sender
            return sender

    def _safe_send(self, member: Member, msg: dict) -> bool:
        """Queue ``msg`` on the member's writer: safe under the lock, in
        the order of the calls; a failed write drops the member.  False if
        the member was already lost."""
        sender = self._sender(member)
        if sender is not None:
            sender.send(msg)
        return sender is not None

    def stop(self) -> None:
        self._stop.set()
        handoff = False
        if self.federation is not None:
            # Before close() clears the peer table: is there a live peer
            # this frontend's workers can re-home to?
            handoff = bool(self.federation.worker_fallbacks())
            # Before the plane closes: the peer links drop (the survivors
            # see EOF and a refused redial, and promote), and no forwarded
            # op lands on a closed plane.
            self.federation.close()
        if self.serve_plane is not None:
            # Before SHUTDOWN frames: pending tenant ops fail fast with
            # "router is closed" instead of timing out against workers
            # that are about to leave.
            self.serve_plane.close()
        members = self.membership.alive_members()
        if handoff:
            # Leave the serve workers RUNNING: a SHUTDOWN would take every
            # session this frontend owns down with it.  Closing the channel
            # instead makes each worker re-home, state intact, to a peer
            # from its FED_PEERS fallbacks and announce SHARD_HOME there:
            # the path a kill -9 takes.
            for m in members:
                sender = self._sender(m)
                if sender is not None:
                    sender.close()
                try:
                    m.channel.close()
                except OSError:
                    pass
            members = []
        for m in members:
            self._safe_send(m, {"type": P.SHUTDOWN})
        # Bounded: a member that does not read costs 2 s, not the shutdown.
        deadline = time.monotonic() + 2.0
        for m in members:
            sender = self._sender(m)
            if sender is not None:
                sender.flush(deadline)
        if self.config.trace_file:
            # Drain the workers' final P.SPANS batches before the export
            # below: each worker flushes its pending spans on SHUTDOWN
            # receipt and then closes, and its reader thread here ingests
            # everything sent before the EOF — so "every member gone" means
            # the tail has landed.  Bounded: a wedged worker costs 2 s, not
            # the shutdown.
            deadline = time.monotonic() + 2.0
            while self.membership.alive_members() and time.monotonic() < deadline:
                time.sleep(0.01)
        try:
            # shutdown() before close(): the accept-loop thread blocked in
            # accept() holds a kernel reference to the listening socket, so
            # close() alone leaves the port accepting (and the redial-refused
            # death confirmation peers rely on never fires).
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # Drain queued checkpoint writes, then stop the IO thread.
        self._io_queue.join()
        self._io_queue.put(None)
        if self.store is not None:
            self.store.close()
        # Observability epilogue: close out the run's spans, final
        # exposition + trace dumps, then tear the live endpoint and the
        # event log down (a scrape after stop() would show a half-dead
        # cluster).  Every step is failure-contained so teardown completes.
        with self._lock:
            # Under the lock: the paced-mode rotation also runs under it
            # (and skips once _stop is set), so the span finished here is
            # always the last one minted.
            if self._degraded_span is not None:
                self._degraded_span.set(healed=False).finish()
                self._degraded_span = None
            # Elastic-plane spans must not outlive the run: migrations and
            # drains still open at stop() finish with outcome=shutdown.
            for mig in list(self.rebalancer.inflight.values()):
                if mig.span is not None:
                    mig.span.set(outcome="shutdown").finish()
                    mig.span = None
            for span in self._drain_spans.values():
                span.set(outcome="shutdown").finish()
            self._drain_spans.clear()
            if self._epoch_span is not None:
                self._epoch_span.set(done=self.done.is_set()).finish()
            if self._run_span is not None:
                self._run_span.set(error=self.error).finish()
        if self._metrics_dumper is not None:
            self._metrics_dumper.final()
        if self.config.trace_file:
            try:
                self.tracer.write(self.config.trace_file)
            except Exception as e:  # noqa: BLE001 — teardown must complete
                print(f"trace-file write failed: {e!r}", flush=True)
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        if self._serve_slo is not None:
            self._serve_slo.close()
            self._serve_slo = None
        with self._lock:
            err = self.error
        self.events.emit(
            "frontend_stopped",
            error=err,
            done=self.done.is_set(),
        )
        self.events.close()

    # -- pause/resume (reachable, unlike BoardCreator.scala:109-112) ---------

    def pause(self) -> None:
        with self._lock:
            self.paused = True
            for m in self.membership.alive_members():
                self._safe_send(m, {"type": P.PAUSE})

    def resume(self) -> None:
        with self._lock:
            self.paused = False
            for m in self.membership.alive_members():
                self._safe_send(m, {"type": P.RESUME})

    # -- accept / per-connection reader --------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            channel = Channel(sock, send_deadline_s=self.config.send_deadline_s)
            if self.netchaos is not None and self.netchaos.config.wraps_control:
                # Control-plane chaos drops silently: a cut control link is
                # judged by heartbeats/eviction, not by send exceptions.
                # dst is labeled once REGISTER names the worker.
                channel = wrap_channel(channel, self.netchaos, src="frontend")
            t = threading.Thread(
                target=self._serve_connection, args=(channel,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _serve_connection(self, channel: Channel) -> None:
        member: Optional[Member] = None
        try:
            hello = channel.recv()
            if (
                isinstance(hello, dict)
                and hello.get("type") == P.P_HELLO
                and self.federation is not None
            ):
                # A peer FRONTEND dialed this listener (the federation's
                # peer plane shares it): serve_peer answers the handshake
                # and reads the connection until EOF.
                self.federation.serve_peer(channel, hello)
                return
            # The listener is an open TCP port: a hello that is not a
            # well-typed REGISTER (port scan, wrong peer, wrong version) is
            # closed without ceremony — and without a thread traceback.
            if (
                not isinstance(hello, dict)
                or hello.get("type") != P.REGISTER
                or not isinstance(hello.get("name"), (str, type(None)))
                or not isinstance(hello.get("peer_port", 0), int)
            ):
                channel.close()
                return
            engine = hello.get("engine", "jax")
            if self.config.exchange_width > 1 and str(engine).startswith("actor"):
                # Actor engines step per-epoch and cannot honor width-k
                # rings; a mixed-width cluster would deadlock on epochs the
                # chunked tiles never compute, so refuse at the door.
                print(
                    f"rejecting worker with engine={engine}: exchange_width="
                    f"{self.config.exchange_width} needs chunk-capable "
                    f"engines (numpy/jax/torch)",
                    flush=True,
                )
                channel.send({"type": P.SHUTDOWN})
                channel.close()
                return
            try:
                peer_host = channel.sock.getpeername()[0]
            except OSError:
                peer_host = "127.0.0.1"
            member = self.membership.register(
                channel,
                hello.get("name"),
                peer_host=peer_host,
                peer_port=int(hello.get("peer_port", 0)),
            )
            if isinstance(channel, ChaosChannel):
                channel.dst = member.name
                self.netchaos.register_node(member.name)
            welcome_serve = {}
            if self.serve_plane is not None:
                from akka_game_of_life_tpu_torch.serve.worker import serve_policy

                # The serve knobs are frontend-owned cluster policy, like
                # the ring/retry bundles: every worker builds its local
                # SessionRouter from the SAME source of truth.
                welcome_serve = {
                    "serve_cluster": True,
                    "serve": serve_policy(self.config),
                }
                if self.federation is not None:
                    # The control channel's re-home fallbacks: the live
                    # peers' listeners (pushed again as FED_PEERS whenever
                    # the peer set changes).
                    welcome_serve["federation"] = (
                        self.federation.worker_fallbacks()
                    )
            self._safe_send(
                member,
                {
                    "type": P.WELCOME,
                    "name": member.name,
                    "heartbeat_s": self.config.heartbeat_s,
                    "max_pull_retries": self.config.max_pull_retries,
                    "exchange_width": self.config.exchange_width,
                    # One retry/breaker/deadline policy source of truth for
                    # every worker of this cluster (SimulationConfig).
                    "retry_s": self.config.retry_s,
                    "retry_max_s": self.config.retry_max_s,
                    "breaker_failures": self.config.breaker_failures,
                    "breaker_cooldown_s": self.config.breaker_cooldown_s,
                    "send_deadline_s": self.config.send_deadline_s,
                    # Halo-plane wire policy: every worker of a cluster
                    # packs/batches identically (the negotiation — a worker
                    # never has to guess a peer's encoding, and the entries
                    # self-describe anyway, so a mismatch fails loud in
                    # decode_ring rather than mis-assembling halos).
                    "ring_pack": self.config.ring_pack,
                    "ring_batch": self.config.ring_batch,
                    "ring_queue_depth": self.config.ring_queue_depth,
                    # Digest plane: workers attach per-tile fingerprint
                    # lanes to PROGRESS at digest-due epochs when on.
                    "obs_digest": self.config.obs_digest,
                    # Quiescence tier (activity-gated sparse stepping):
                    # workers skip provably-repeating chunks and publish
                    # O(1)-byte same-ring markers when on.
                    "sparse_cluster": self.config.sparse_cluster,
                    # Compile & cost observatory: ledger on/off and COST
                    # frame cadence — one source of truth for every
                    # member's program accounting.
                    "obs": {
                        "programs": self.config.obs_programs,
                        "cost_interval_s": self.config.obs_cost_interval_s,
                        "max_s": self.config.obs_profile_max_s,
                        "min_interval_s": self.config.obs_profile_min_interval_s,
                    },
                    **welcome_serve,
                },
            )
            engine = hello.get("engine", "?")
            detail = (
                f" (engine {engine}, pallas {hello.get('pallas', 'auto')})"
                if engine in ("jax", "torch")
                else f" (engine {engine})"
            )
            print(f"backend {member.name} joined{detail}", flush=True)
            self._m_joined.inc()
            self._m_alive.set(len(self.membership.alive_members()))
            self.events.emit(
                "member_joined", member=member.name, engine=str(engine)
            )
            if self.serve_plane is not None:
                # The plane claims unowned shards for a first worker; a
                # late joiner receives its shards through the rebalancer
                # (empty shards flip instantly on the next poll).
                self.serve_plane.on_member_joined(member.name)
            with self._lock:
                late = self._started.is_set() and self.layout is not None
                if late:
                    # Late join (after start_simulation): the deterministic
                    # path is admit-and-idle — the member gets the current
                    # wiring immediately (it can dial peers, serve pulls,
                    # and is a valid migration destination from this
                    # moment) and hosts no tiles until the rebalancer
                    # migrates load onto it.  Scale-out is exactly this
                    # plus a migration.  Queued UNDER the lock, like every
                    # _broadcast_owners_locked call site: a migration committing
                    # concurrently must not slot its OWNERS broadcast
                    # between this snapshot and its send — the stale
                    # snapshot arriving last would make the joiner drop a
                    # tile just migrated onto it.
                    self._safe_send(member, self._owners_msg_locked())
            while True:
                msg = channel.recv()
                if msg is None:
                    break
                if self._stop.is_set():
                    # Post-stop: drain ONLY the workers' final span batches
                    # (flushed on SHUTDOWN receipt, just before their EOF —
                    # and possibly queued behind a last heartbeat/progress
                    # frame); everything else from a stopping cluster is
                    # stale.  Looping to EOF is what makes stop()'s
                    # "members gone ⇒ tail ingested" drain wait sound.
                    if (
                        isinstance(msg, dict)
                        and msg.get("type") == P.SPANS
                        and isinstance(msg.get("spans"), list)
                    ):
                        self.tracer.ingest(msg["spans"])
                    continue
                try:
                    # Validate structure BEFORE dispatch: a malformed message
                    # drops the worker with a one-line reason (tiles
                    # redeploy), while a bug inside _dispatch itself still
                    # surfaces as a real traceback instead of being
                    # misattributed to the worker.
                    _validate_msg(msg)
                except MalformedMessage as e:
                    print(f"dropping {member.name}: {e}", flush=True)
                    break
                self._dispatch(member, msg)
        except (OSError, ValueError) as e:
            if member is not None and isinstance(e, ValueError):
                # A malformed FRAME (bad magic / oversize / bad payload
                # structure, raised by wire.recv) gets the same one-line
                # drop note the malformed-MESSAGE path prints.
                print(f"dropping {member.name}: {e}", flush=True)
        finally:
            if member is not None:
                self._on_member_lost(member.name)

    # -- message handling ----------------------------------------------------

    def _dispatch(self, member: Member, msg: dict) -> None:
        # Any traffic is proof of life — a worker mid-burst on bulk sends
        # may have its HEARTBEAT frames queued behind megabytes of
        # TILE_STATE, and must not be auto-downed for it.
        self.membership.beat(member.name)
        kind = msg.get("type")
        if kind == P.HEARTBEAT:
            pass
        elif kind == P.SPANS:
            # Worker-forwarded finished spans: fold them into this tracer so
            # --trace-file / /trace export the cluster-wide causal timeline
            # from one process (ids are verbatim, so parent links to the
            # epoch spans we minted here just work).
            spans = msg.get("spans")
            if isinstance(spans, list):
                self.tracer.ingest(spans)
        elif kind == P.COST:
            # Worker program-ledger summary: fold into the cluster-merged
            # /programs + /cost view and the member-labeled device gauges.
            self.programs.merge_remote(member.name, msg)
        elif kind == P.PROGRESS:
            # Control-plane ping only — ring bytes ride worker-to-worker
            # (PEER_RING); the frontend just tracks lag for the prune floor
            # and the stuck detector.
            tile = tuple(msg["tile"])
            epoch = int(msg["epoch"])
            inject_due = False
            with self._lock:
                if self.tile_owner.get(tile) != member.name:
                    return  # stale ping from an evicted owner
                self.tile_epochs[tile] = max(self.tile_epochs.get(tile, 0), epoch)
                self._last_ring_time[tile] = time.monotonic()
                q = msg.get("q")
                if isinstance(q, int):
                    if q > 0:
                        self.quiescent[tile] = q
                    else:
                        self.quiescent.pop(tile, None)
                    self._m_tiles_quiescent.set(len(self.quiescent))
                skipped = msg.get("skipped")
                if isinstance(skipped, int) and skipped > 0:
                    # Worker-reported delta of chunks it skipped outright —
                    # the cluster tier's headline counter.
                    self._m_tiles_skipped.inc(skipped)
                if "digest" in msg:
                    self._note_tile_digest_locked(tile, epoch, msg["digest"])
                if (
                    self.injector is not None
                    and self.injector.config.epoch_indexed
                    and self._started.is_set()
                    and self.layout is not None
                ):
                    # Epoch-anchored chaos: the schedule is indexed by the
                    # slowest tile's progress, so a crash due at epoch E
                    # fires before the run can complete past E — no race
                    # against the wall clock.  Evaluated under the lock so
                    # concurrent member threads cannot double-fire one slot.
                    floor = min(
                        (self.tile_epochs.get(t, 0) for t in self.layout.tile_ids),
                        default=0,
                    )
                    inject_due = self.injector.should_crash_at_epoch(floor)
            if inject_due:
                self._inject_crash()
        elif kind == P.TILE_STATE:
            self._on_tile_state(member, msg)
        elif kind == P.REDEPLOY_REQUEST:
            tile = tuple(msg["tile"])
            self._redeploy_tile(tile, preferred=member.name)
        elif kind == P.GATHER_FAILED:
            self._on_gather_failed(member, tuple(msg["tile"]), int(msg["epoch"]))
        elif kind == P.MIGRATE_STATE:
            self._on_migrate_state(member, msg)
        elif kind == P.SERVE_RESULT:
            if self.serve_plane is not None:
                self.serve_plane.on_result(member.name, msg)
        elif kind == P.SHARD_STATE:
            if self.serve_plane is not None:
                self.serve_plane.on_shard_state(member.name, msg)
        elif kind == P.SHARD_REPLICATE:
            if self.serve_plane is not None:
                self.serve_plane.on_shard_replicate(member.name, msg)
        elif kind == P.SHARD_HOME:
            # A worker re-homed its control channel here after its previous
            # frontend died: its session list is the truth that closes the
            # failover window.
            if self.serve_plane is not None:
                self.serve_plane.on_shard_home(member.name, msg)
        elif kind == P.DRAIN_REQUEST:
            self._on_drain_request(member)
        elif kind == P.GOODBYE:
            self._on_member_lost(member.name)

    def _on_tile_state(self, member: Member, msg: dict) -> None:
        """Scale-safe state sink: checkpoint/final tiles arrive bit-packed
        and stream straight to the per-tile store (never assembled), render
        arrives as the frontend's strided sample, metrics as a population
        count — nothing here is O(board) in memory or on the wire."""
        tile = tuple(msg["tile"])
        epoch = int(msg["epoch"])
        reasons = msg.get("reasons", [])
        with self._lock:
            if self.tile_owner.get(tile) != member.name:
                return
            durable = self.store is not None and bool(self.config.checkpoint_every)
            if "final" in reasons and epoch == self.config.max_epochs:
                self._final_tiles[tile] = msg["state"]
                if self.store is not None:
                    self._io_queue.put(("tile", (epoch, tile, msg["state"])))
                if len(self._final_tiles) == len(self.layout.tile_ids):
                    if self.store is not None:
                        self._io_queue.put(
                            (
                                "finalize",
                                (
                                    epoch,
                                    self.rule.rulestring(),
                                    self.layout.grid,
                                    self.config.shape,
                                    self._digest_meta_locked(epoch),
                                ),
                            )
                        )
                    h, w = self.config.shape
                    if h * w <= _ASSEMBLE_LIMIT:
                        self.final_board = self._assemble_locked(self._final_tiles)
                    self.done.set()
            if (
                "checkpoint" in reasons
                and epoch > self._last_ckpt[0]  # a replaying tile re-reports
                # epochs already saved; don't recreate pending entries that
                # can never complete
            ):
                pend = self._ckpt_pending.setdefault(epoch, {})
                pend[tile] = msg["state"]
                if durable:
                    self._io_queue.put(("tile", (epoch, tile, msg["state"])))
                if len(pend) == len(self.layout.tile_ids):
                    if durable:
                        # An explicit cadence means durable saves; the
                        # fallback cadence checkpoints in memory only (the
                        # store still gets the final board).
                        self._io_queue.put(
                            (
                                "finalize",
                                (
                                    epoch,
                                    self.rule.rulestring(),
                                    self.layout.grid,
                                    self.config.shape,
                                    self._digest_meta_locked(epoch),
                                ),
                            )
                        )
                    self._last_ckpt = (epoch, pend)
                    # Older pending epochs can no longer become the recovery
                    # point; drop them along with this one.
                    for e in [e for e in self._ckpt_pending if e <= epoch]:
                        del self._ckpt_pending[e]
                    # Bounded history: broadcast a prune floor so workers
                    # drop rings no tile can ever need again.  The floor is
                    # the *slowest* tile, not the checkpoint epoch — a tile
                    # redeployed from an older checkpoint may still be
                    # replaying epochs below this checkpoint, and pruning
                    # those rings would stall its replay forever (a race
                    # found by the node-loss test).
                    floor = min(
                        [epoch] + [self.tile_epochs[t] for t in self.layout.tile_ids]
                    )
                    for m in self.membership.alive_members():
                        self._safe_send(m, {"type": P.PRUNE, "floor": floor})
            if "render" in reasons:
                self.observer.add_sample(
                    epoch, tile, tuple(msg["scaled_origin"]), msg["sample"]
                )
                if "window" in msg:
                    self.observer.add_window(
                        epoch, tile, tuple(msg["window_origin"]), msg["window"]
                    )
            if "metrics" in reasons:
                self.observer.add_population(epoch, tile, int(msg["population"]))

    def _digest_meta_locked(self, epoch: int) -> Optional[dict]:
        """Checkpoint metadata carrying the epoch's merged digest, or None.
        The merge always completes before the finalize enqueue: each
        tile's PROGRESS (with lanes) precedes its TILE_STATE on the same
        channel, and the finalize fires on the LAST tile's state.  Caller
        holds the lock."""
        from akka_game_of_life_tpu_torch.ops import digest as odigest

        if epoch not in self.epoch_digests:
            return None
        return {"digest": odigest.format_digest(self.epoch_digests[epoch])}

    def _note_tile_digest_locked(self, tile: TileId, epoch: int, lanes) -> None:
        """One tile's digest lanes from a PROGRESS ping; when every tile of
        the epoch has reported, fold them (lane-wise uint32 sum — the same
        merge rule as the mesh ``psum``) into the epoch's 64-bit value.
        O(tiles) bytes total; the board is never assembled.  Re-reports
        from replaying/redeployed tiles are recognized by the monotone
        completion floor (the ``_complete_epoch`` discipline).  Caller
        holds the lock."""
        from akka_game_of_life_tpu_torch.ops import digest as odigest

        if self.layout is None or (
            self._digest_floor is not None and epoch <= self._digest_floor
        ):
            return
        t0 = time.perf_counter()
        parts = self._digest_partial.setdefault(epoch, {})
        parts[tile] = (int(lanes[0]), int(lanes[1]))
        if len(parts) < len(self.layout.tile_ids):
            return
        del self._digest_partial[epoch]
        self._digest_floor = epoch
        for e in [e for e in self._digest_partial if e <= epoch]:
            del self._digest_partial[e]
        merged = odigest.value(odigest.merge_lanes(parts.values()))
        self.epoch_digests[epoch] = merged
        while len(self.epoch_digests) > 16:  # bounded: certificates, not history
            del self.epoch_digests[min(self.epoch_digests)]
        if epoch == self.config.max_epochs:
            self.final_digest = merged
        hexd = odigest.format_digest(merged)
        self._m_digest_checks.inc()
        self._m_digest_seconds.observe(time.perf_counter() - t0)
        with self.tracer.span(
            "obs.digest", parent=self._epoch_span, node="frontend",
            epoch=epoch, digest=hexd, tiles=len(parts),
        ):
            self.events.emit("digest", epoch=epoch, digest=hexd)
        print(f"epoch {epoch}: digest={hexd}", file=self.observer.out, flush=True)

    def _assemble_locked(self, tiles: Dict[TileId, dict]) -> np.ndarray:
        from akka_game_of_life_tpu_torch.runtime.tiles import stitch

        return stitch(
            {self.layout.origin(t): unpack_tile(p) for t, p in tiles.items()}
        )

    def _on_gather_failed(self, member: Member, tile: TileId, epoch: int) -> None:
        """FailedToGatherInfoMsg analog (NextStateCellGathererActor.scala:49-58):
        a tile's halo pulls have gone unanswered past the retry budget.  The
        reporting tile keeps its state; the *parent* repairs the neighborhood
        by redeploying any blocking neighbor that is genuinely stuck — behind
        the requested epoch AND silent (no ring push) for stuck_timeout_s.
        A neighbor that is merely slow keeps its progress and its lease."""
        with self._lock:
            if self.tile_owner.get(tile) != member.name or self.layout is None:
                return
            if (
                self.degraded
                and self.netchaos is not None
                and self.netchaos.partitioned()
            ):
                # A KNOWN partition (the injected chaos plane is
                # self-announcing): redeploying blocked neighbors would
                # thrash the restart budget without making any halo arrive —
                # wait for the heal instead.  A stall with no announced
                # partition keeps this recovery path (a wedged-but-alive
                # worker's tiles MUST move to healthy members; an external
                # partition is then guarded by the restart budget).
                return
            now = time.monotonic()
            stuck = [
                (ntile, self.tile_owner.get(ntile))
                for ntile in sorted(set(self.layout.neighbors(tile).values()))
                if ntile != tile
                and ntile not in self.rebalancer.inflight  # frozen on purpose
                and not self._quiescent_fresh_locked(ntile, now)  # silent on purpose
                and self.tile_epochs.get(ntile, 0) < epoch
                and now - self._last_ring_time.get(ntile, now)
                > self.config.stuck_timeout_s
            ]
        # (tile, owner) snapshotted under the lock above: reading the owner
        # here would race a migration commit and aim `avoid` at the NEW
        # owner, letting the redeploy land back on the wedged member.
        for ntile, owner in stuck:
            self._redeploy_tile(ntile, avoid=owner)

    # -- elastic plane: live migration, scale-out, drain ---------------------

    def _rebalance_poll(self, now: float, drain_only: bool = False) -> None:
        """One maintenance pass of the elastic plane: expire overdue
        migrations, start newly planned ones, release finished drains.
        Suspended while degraded — a stalled cluster must heal, not
        reshape.  ``drain_only`` (the paused cluster) plans drain-driven
        moves but no load balancing."""
        with self._lock:
            if (
                not self._started.is_set()
                or self.layout is None
                or self.degraded
            ):
                return
            overdue = self.rebalancer.expired(now)
        for mig in overdue:
            self._abort_migration(mig, "deadline")
        started: List[Tuple[Migration, Member]] = []
        with self._lock:
            if self._stop.is_set() or self.done.is_set():
                return
            plans = self.rebalancer.plan(
                self.membership.alive_members(),
                self.tile_epochs,
                self.config.max_epochs,
                now,
                drain_only=drain_only,
            )
            for tile, source, dest in plans:
                pair = self._begin_migration_locked(tile, source, dest, now)
                if pair is not None:
                    started.append(pair)
        # PREPARE frames outside the lock (send discipline).
        for mig, src in started:
            self._send_migrate_prepare(mig, src)
        self._check_drains()

    def migrate_tile(self, tile: TileId, dest: str) -> bool:
        """Manually start a live migration of ``tile`` to member ``dest`` —
        the operator/embedder entry to the same three-phase protocol the
        automatic planner drives.  Returns False when the move is not
        currently startable (unknown/departed members, tile already in
        flight, dest draining, or dest already the owner)."""
        now = time.monotonic()
        with self._lock:
            tile = tuple(tile)
            source = self.tile_owner.get(tile)
            if source is None or source == dest or self.layout is None:
                return False
            pair = self._begin_migration_locked(tile, source, dest, now)
        if pair is None:
            return False
        self._send_migrate_prepare(*pair)
        return True

    def _begin_migration_locked(
        self, tile: TileId, source: str, dest: str, now: float
    ) -> Optional[Tuple[Migration, Member]]:
        """Validate and record one migration (caller holds the lock);
        returns (migration, source member) for the PREPARE send, or None."""
        src = self.membership.get(source)
        dst = self.membership.get(dest)
        if (
            src is None or not src.alive
            or dst is None or not dst.alive or dst.draining
            or self.tile_owner.get(tile) != source
            or tile in self.rebalancer.inflight
        ):
            return None
        mig = self.rebalancer.begin(tile, source, dest, now)
        mig.span = self.tracer.start(
            "migrate.tile", parent=self._epoch_span, node="frontend",
            tile=str(tile), source=source, dest=dest,
        )
        self.events.emit(
            "migration_started",
            tile=list(tile),
            source=source,
            dest=dest,
            seq=mig.seq,
        )
        return mig, src

    def _send_migrate_prepare(self, mig: Migration, src: Member) -> None:
        self._safe_send(
            src,
            {
                "type": P.MIGRATE_PREPARE,
                "tile": list(mig.tile),
                "seq": mig.seq,
                "deadline_s": self.rebalancer.deadline_s,
            },
        )

    def _on_migrate_state(self, member: Member, msg: dict) -> None:
        """TRANSFER → CERTIFY → COMMIT.  The payload is certified against
        the source-computed digest lanes BEFORE any ownership change: a
        corrupted transfer rolls back loudly (the source still owns the
        canonical state), never forks the trajectory.  Commit is the atomic
        OWNERS rewiring; the certified payload then deploys to the
        destination at its frozen epoch."""
        from akka_game_of_life_tpu_torch.ops import digest as odigest

        tile = tuple(msg["tile"])
        epoch = int(msg["epoch"])
        seq = int(msg["seq"])
        with self._lock:
            mig = self.rebalancer.get(tile, seq)
            if (
                mig is None
                or mig.source != member.name
                or self.tile_owner.get(tile) != member.name
            ):
                return  # stale state frame from an aborted/unknown attempt
            origin = self.layout.origin(tile)
        # Certification outside the lock: a tile-sized unpack+digest must
        # not stall every reader thread behind the coordinator lock.
        t0 = time.perf_counter()
        lanes = odigest.digest_payload_np(
            msg["state"], origin, self.config.width
        )
        self._m_digest_checks.inc()
        self._m_digest_seconds.observe(time.perf_counter() - t0)
        if [int(lanes[0]), int(lanes[1])] != [int(v) for v in msg["digest"]]:
            self._m_digest_mismatches.inc()
            self.events.emit(
                "digest_mismatch",
                tile=list(tile),
                epoch=epoch,
                source=member.name,
            )
            self._abort_migration(mig, "digest_mismatch")
            return
        with self._lock:
            if self.rebalancer.get(tile, seq) is not mig:
                return  # aborted (deadline/member loss) while certifying
            dest = self.membership.get(mig.dest)
            if dest is None or not dest.alive or dest.draining:
                commit = False
            else:
                commit = True
                now = time.monotonic()
                self.rebalancer.complete(tile)
                self.tile_owner[tile] = dest.name
                if tile in member.tiles:
                    member.tiles.remove(tile)
                if tile not in dest.tiles:
                    dest.tiles.append(tile)
                self.tile_epochs[tile] = epoch
                self._last_ring_time[tile] = now
                if self.quiescent.pop(tile, None) is not None:
                    self._m_tiles_quiescent.set(len(self.quiescent))
                self._m_migrations.inc()
                self._m_migration_seconds.observe(now - mig.started)
                if mig.span is not None:
                    mig.span.set(outcome="commit", epoch=epoch).finish()
                self.events.emit(
                    "migration_committed",
                    tile=list(tile),
                    source=mig.source,
                    dest=dest.name,
                    epoch=epoch,
                )
                # Wiring before data, as everywhere: the OWNERS broadcast
                # IS the commit point — the source drops the tile on
                # receipt, every peer re-aims its ring pushes, and only
                # then does the state land on the destination.
                self._broadcast_owners_locked()
        if not commit:
            self._abort_migration(mig, "dest_lost")
            return
        print(
            f"tile {tile}: migrated {mig.source} -> {dest.name} at epoch "
            f"{epoch}",
            flush=True,
        )
        self._send_deploy(
            dest,
            [tile],
            state_epoch=epoch,
            payloads={tile: msg["state"]},
            ring_history={tile: msg.get("rings") or []},
        )
        self._check_drains()

    def _abort_migration(
        self, mig: Migration, reason: str, *, notify_source: bool = True
    ) -> None:
        """Roll a migration back: the source (which never dropped the tile)
        unfreezes and resumes; the tile cools down under the jittered
        backoff before the planner may retry it.  Always loud: a counter, a
        lifecycle event, and a flight dump — a rollback is a fault artifact
        even though no state was lost."""
        with self._lock:
            if self.rebalancer.get(mig.tile, mig.seq) is not mig:
                return  # already concluded
            self.rebalancer.abort(mig.tile, time.monotonic())
            self._m_migration_aborts.inc()
            if mig.span is not None:
                mig.span.set(outcome="abort", reason=reason).finish()
            self.events.emit(
                "migration_aborted",
                tile=list(mig.tile),
                source=mig.source,
                dest=mig.dest,
                reason=reason,
            )
        print(
            f"tile {mig.tile}: migration {mig.source} -> {mig.dest} "
            f"aborted ({reason})",
            flush=True,
        )
        self.tracer.flight.dump("migration_abort", node="frontend")
        if notify_source:
            src = self.membership.get(mig.source)
            if src is not None and src.alive:
                self._safe_send(
                    src, {"type": P.MIGRATE_ABORT, "tile": list(mig.tile)}
                )

    def _on_drain_request(self, member: Member) -> None:
        """A worker asks to leave gracefully.  With another placeable
        member present, mark it draining — the planner empties it and
        ``_check_drains`` releases it; with nowhere to put its tiles the
        drain is refused immediately (the worker falls back to the abrupt
        GOODBYE path) rather than left hanging."""
        with self._lock:
            others = [
                m
                for m in self.membership.placeable_members()
                if m.name != member.name
            ]
            # A serve-only cluster (serve plane, no simulation) honors
            # drains from the moment it serves — _started never fires.
            active = self._started.is_set() or self.serve_plane is not None
            if not active or not others:
                refused = True
            else:
                refused = False
                if not member.draining:
                    member.draining = True
                    self._drain_spans[member.name] = self.tracer.start(
                        "cluster.drain", parent=self._run_span,
                        node="frontend", member=member.name,
                        tiles=len(member.tiles),
                    )
                    self.events.emit(
                        "drain_requested",
                        member=member.name,
                        tiles=len(member.tiles),
                    )
                    print(
                        f"member {member.name} draining "
                        f"({len(member.tiles)} tiles)",
                        flush=True,
                    )
            self._m_draining.set(
                sum(
                    1
                    for m in self.membership.alive_members()
                    if m.draining
                )
            )
        if refused:
            self.events.emit("drain_refused", member=member.name)
            self._safe_send(
                member, {"type": P.DRAIN_COMPLETE, "drained": False}
            )
            return
        # A tileless worker (e.g. a spare) drains in zero moves.
        self._check_drains()

    def _check_drains(self) -> None:
        """Release every draining member that owns nothing and has no
        in-flight migration — the DRAIN_COMPLETE that lets it exit rc=0
        with the guarantee its departure redeploys nothing."""
        released: List[Member] = []
        with self._lock:
            for m in self.membership.alive_members():
                if not m.draining or m.drain_acked:
                    continue
                busy = any(
                    m.name in (mig.source, mig.dest)
                    for mig in self.rebalancer.inflight.values()
                )
                if m.tiles or busy:
                    continue
                if self.serve_plane is not None and (
                    not self.serve_plane.member_clear(m.name)
                ):
                    # Still owns session shards (or a shard move touches
                    # it): the serve analog of "owns tiles" — release only
                    # once its sessions have migrated off.
                    continue
                m.drain_acked = True
                self._m_drains.inc()
                span = self._drain_spans.pop(m.name, None)
                fields = {}
                if span is not None:
                    span.set(outcome="drained").finish()
                    # Port-only: the drain's length, DRAIN_REQUEST to here.
                    fields["seconds"] = round(time.monotonic() - span.t0_mono, 6)
                self.events.emit("member_drained", member=m.name, **fields)
                released.append(m)
        for m in released:
            print(f"member {m.name} drained", flush=True)
            self._safe_send(m, {"type": P.DRAIN_COMPLETE, "drained": True})

    # -- failure handling / redeployment -------------------------------------

    def _on_member_lost(self, name: str) -> None:
        with self._senders_lock:
            member = self.membership.mark_dead(name)
            sender = None if member is None else self._senders.pop(id(member), None)
        if member is None:
            return
        self._m_lost.inc()
        self._m_alive.set(len(self.membership.alive_members()))
        self.events.emit(
            "member_lost", member=name, tiles=len(member.tiles)
        )
        if sender is not None:
            sender.close()
        try:
            member.channel.close()
        except OSError:
            pass
        # Elastic-plane hygiene: a departed member leaves no stale gauge
        # series, no open drain span, and no in-flight migration.  A dead
        # DESTINATION rolls its migrations back (the live source unfreezes
        # and resumes — no epoch lost); a dead SOURCE just clears the
        # record, and the normal checkpoint redeploy below recovers its
        # tiles, the frozen one included.
        self._m_hb_age.labels(member=name).set(0)
        # Cost-observatory hygiene: the member's ledger contribution and
        # every member:device gauge child it owned go with it.
        self.programs.forget_remote(name)
        with self._lock:
            span = self._drain_spans.pop(name, None)
            if span is not None:
                span.set(outcome="lost").finish()
            self._m_draining.set(
                sum(1 for m in self.membership.alive_members() if m.draining)
            )
            doomed = self.rebalancer.drop_member(name)
        if not (self._stop.is_set() or self.done.is_set()):
            # Mid-run only: at shutdown the in-flight records die with the
            # run (stop() already finished their spans) — aborting them
            # against departing workers would be teardown noise.
            for mig in doomed:
                self._abort_migration(
                    mig, "member_lost", notify_source=(mig.source != name)
                )
            if self.serve_plane is not None:
                # Serve-plane bookkeeping: in-flight ops answered, shard
                # ownership reassigned, gauges reclaimed (never under the
                # frontend lock — plane methods take their own).
                self.serve_plane.on_member_lost(name)
        if not self._started.is_set():
            return
        if self._stop.is_set() or self.done.is_set():
            # Orderly shutdown: workers dropping now is expected, not a
            # failure to recover from.
            return
        tiles = list(member.tiles)
        member.tiles = []
        if not tiles:
            return
        # A node loss with tiles to recover is exactly the moment a
        # post-mortem wants context for: dump the flight ring and trace the
        # whole redeploy under the epoch it interrupts.
        self.tracer.flight.dump("node_loss", node="frontend")
        with self.tracer.span(
            "member.lost", parent=self._epoch_span, node="frontend",
            member=name, tiles=len(tiles),
        ):
            survivors = self.membership.alive_members()
            if not survivors:
                with self._lock:
                    self.error = "all backends lost"
                self.done.set()
                return
            with self._lock:
                # Assign every orphaned tile first, then wire and deploy
                # once — one OWNERS broadcast carrying the final assignment,
                # not one per tile, and no intermediate state advertising
                # the dead member for not-yet-reassigned tiles.
                assigned: Dict[str, List[TileId]] = {}
                for idx, tile in enumerate(tiles):
                    m = self._assign_tile_locked(
                        tile, preferred=survivors[idx % len(survivors)].name
                    )
                    if m is None:
                        return  # budget/survivor escalation already set error
                    assigned.setdefault(m.name, []).append(tile)
                self._broadcast_owners_locked()
            # Bulk sends outside the lock (see _send_deploy).
            for owner, batch in assigned.items():
                m = self.membership.get(owner)
                if m is not None and m.alive:
                    self._send_deploy(m, batch)

    def _quiescent_fresh_locked(self, tile: TileId, now: float) -> bool:
        """Is ``tile`` self-reported quiescent AND recently heard from?
        Quiescent tiles ping only at cadence epochs, so they look silent to
        the stuck/degraded detectors — but the exemption is freshness-bound
        (2x stuck_timeout_s): a worker that wedges after marking its tiles
        quiescent loses the exemption and normal recovery takes over.
        Caller holds the lock."""
        return (
            tile in self.quiescent
            and now - self._last_ring_time.get(tile, 0.0)
            <= 2.0 * self.config.stuck_timeout_s
        )

    def _assign_tile_locked(
        self,
        tile: TileId,
        preferred: Optional[str] = None,
        avoid: Optional[str] = None,
    ) -> Optional[Member]:
        """Pick (and record) a new owner for a tile, enforcing the restart
        budget — the reference's supervision strategy
        (``OneForOneStrategy(Restart, ≤10 retries/min)``,
        ``BoardCreator.scala:42-45``): a tile that keeps dying escalates to
        a run failure instead of redeploy-thrashing forever.  Returns None
        when escalation fired.  Caller holds the lock."""
        now = time.monotonic()
        times = self._redeploy_times.setdefault(tile, deque())
        while times and now - times[0] > self.config.restart_window_s:
            times.popleft()
        if len(times) >= self.config.restart_max:
            self.error = (
                f"tile {tile} exceeded its restart budget "
                f"({self.config.restart_max} redeploys in "
                f"{self.config.restart_window_s:.0f}s); escalating"
            )
            self.done.set()
            return None
        times.append(now)
        member = self.membership.get(preferred) if preferred else None
        if member is None or not member.alive or member.draining:
            # Placeable members first — a draining worker must not be
            # handed recovery work it would immediately hand back — but a
            # draining survivor still beats failing the run.
            survivors = (
                self.membership.placeable_members()
                or self.membership.alive_members()
            )
            if not survivors:
                self.error = "all backends lost"
                self.done.set()
                return None
            # Prefer moving off the current (possibly wedged) owner.
            others = [m for m in survivors if m.name != avoid]
            member = (others or survivors)[0]
        if tile not in member.tiles:
            member.tiles.append(tile)
        # Counted HERE, after every escalation/no-survivor early return: an
        # aborted reassignment redeployed nothing and must not read as
        # recovery activity.
        self._m_redeploys.inc()
        # The supervision-replay span: the recovery decision itself, linked
        # under the epoch it interrupts (the deploy that ships the state is
        # its sibling cluster.deploy span).
        with self.tracer.span(
            "recover.redeploy", parent=self._epoch_span, node="frontend",
            tile=str(tile), owner=member.name, epoch=self._last_ckpt[0],
        ):
            self.events.emit(
                "tile_redeploy",
                tile=list(tile),
                owner=member.name,
                epoch=self._last_ckpt[0],
            )
        self.tile_owner[tile] = member.name
        # A re-placed tile starts with no quiescence history; the marking
        # (and its stuck-exemption) must not survive the move.
        if self.quiescent.pop(tile, None) is not None:
            self._m_tiles_quiescent.set(len(self.quiescent))
        # The tile restarts at the recovery epoch: record that so the
        # ring-prune floor protects every epoch its replay will pull.
        self.tile_epochs[tile] = self._last_ckpt[0]
        return member

    def _redeploy_tile(
        self,
        tile: TileId,
        preferred: Optional[str] = None,
        avoid: Optional[str] = None,
    ) -> None:
        """Redeploy one tile from the recovery source (last checkpoint or the
        deterministic initial board); the new owner replays forward by
        pulling epoch-tagged halos (the ``onCellTermination`` path)."""
        # Supervision replay in flight: dump the ring so the artifact holds
        # the spans/events that led to this tile needing a restart.
        self.tracer.flight.dump("tile_redeploy", node="frontend")
        with self._lock:
            member = self._assign_tile_locked(tile, preferred=preferred, avoid=avoid)
            if member is None:
                return
            # Re-wire everyone first (NeighboursRefs re-send to the whole
            # neighborhood, BoardCreator.scala:149-151), then deploy.
            self._broadcast_owners_locked()
        self._send_deploy(member, [tile])

    # -- maintenance: ticks, auto-down, fault injection ----------------------

    def _maintenance_loop(self) -> None:
        while not self._stop.is_set() and not self.done.is_set():
            time.sleep(_MAINT_INTERVAL_S)
            now = time.monotonic()
            # periodic --metrics-file refresh (atomic; scrape-safe mid-run;
            # failure containment lives in the shared MetricsDumper — an
            # unwritable path must not kill the maintenance thread, which
            # ticks, evicts, and injects).
            if self._metrics_dumper is not None:
                self._metrics_dumper.maybe(now)
            # Advance the wire-chaos partition schedule even when no
            # traffic flows (blocked links poll on send; a fully-stalled
            # cluster still needs the heal clock to tick).
            if self.netchaos is not None:
                self.netchaos.poll(now)
            # Per-member control-plane staleness, refreshed every pass so
            # operators see heartbeat age climbing BEFORE auto-down fires
            # (also surfaced in /healthz as heartbeat_age_s).
            for m in self.membership.alive_members():
                self._m_hb_age.labels(member=m.name).set(
                    max(0.0, now - m.last_seen)
                )
            # Degraded-mode detection BEFORE auto-down: a partition that
            # strands a quorum of tiles must flip the cluster into waiting,
            # not evict every silent-but-alive member.
            self._check_degraded(now)
            # auto-down stale members (application.conf:23 analog) —
            # suppressed while degraded: silence during a partition is the
            # partition's fault, not the members'
            with self._lock:
                degraded = self.degraded
                drain_only = self.paused
            if not degraded:
                for m in self.membership.stale_members(now):
                    self._on_member_lost(m.name)
            # The elastic plane: expire/plan migrations, release drains.
            # A paused cluster still honors drains (a paused tile is not
            # stepping, so moving it is safe; a SIGTERM'd worker must be
            # able to leave gracefully mid-pause) but never reshapes for
            # load.
            self._rebalance_poll(now, drain_only=drain_only)
            # The serve plane's elastic pass (session shards) runs even
            # before/without start_simulation — a serve-only cluster
            # rebalances from its first worker.
            if self.serve_plane is not None and not degraded:
                self.serve_plane.poll(now, drain_only=drain_only)
                self._check_drains()
            # paced epoch announcements
            with self._lock:
                if (
                    self._started.is_set()
                    and not self.paused
                    and self.config.tick_s > 0
                    and self._next_tick is not None
                    and now >= self._next_tick
                    and self.target_epoch < self.config.max_epochs
                ):
                    if self._stop.is_set() or self.done.is_set():
                        # stop() is concurrently finishing the run's spans
                        # (under this lock): rotating now would mint an
                        # epoch span nobody ever finishes.
                        continue
                    self.target_epoch += 1
                    self._next_tick = now + self.config.tick_s
                    # One epoch span per announcement in paced mode: close
                    # the previous target's span, open the next under the
                    # run root, and ride its context on every TICK.
                    if self._epoch_span is not None:
                        self._epoch_span.finish()
                    self._epoch_span = self.tracer.start(
                        "epoch", parent=self._run_span, node="frontend",
                        target=self.target_epoch,
                    )
                    msg = attach_trace(
                        {"type": P.TICK, "target": self.target_epoch},
                        self._epoch_span,
                    )
                    for m in self.membership.alive_members():
                        self._safe_send(m, msg)
            # fault injection (BoardCreator.scala:97-102 analog)
            if (
                self.injector is not None
                and self._started.is_set()
                and self.injector.should_crash(now)
            ):
                self._inject_crash()

    def _check_degraded(self, now: float) -> None:
        """Enter/leave degraded mode.

        *Stranded* means a tile has pushed no ring/progress for
        ``stuck_timeout_s``; when at least half the board is stranded the
        stall is systemic.  Degraded mode makes the recovery source durable
        (checkpoint what we have), logs ``cluster.degraded``, and suspends
        heartbeat auto-down — silence during a partition is the partition's
        fault, and evicting live members would orphan state that will
        resume on heal.  Stuck-neighbor redeploys stay available unless the
        injected chaos plane announces an active partition (see
        ``_on_gather_failed``): a wedged-but-alive worker's tiles must
        still move to healthy members.  When rings flow again the mode
        lifts and the cluster resumes cleanly from live state.
        """
        with self._lock:
            if not self._started.is_set() or self.paused or self.layout is None:
                return
            tiles = self.layout.tile_ids
            stranded = sum(
                1
                for t in tiles
                if not self._quiescent_fresh_locked(t, now)
                and now - self._last_ring_time.get(t, now)
                > self.config.stuck_timeout_s
            )
            quorum = 2 * stranded >= len(tiles)
            if quorum and not self.degraded:
                self.degraded = True
                self._m_degraded.set(1)
                self._m_degraded_entries.inc()
                self._degraded_span = self.tracer.start(
                    "cluster.degraded", parent=self._run_span, node="frontend",
                    stranded=stranded, tiles=len(tiles),
                    epoch=self._last_ckpt[0],
                )
                self.tracer.flight.dump("degraded", node="frontend")
                self.events.emit(
                    "cluster_degraded",
                    stranded=stranded,
                    tiles=len(tiles),
                    epoch=self._last_ckpt[0],
                )
                # Checkpoint what we have: the last consistent per-tile set
                # becomes durable NOW — if the partition outlives the
                # operator's patience, a restarted frontend resumes from it.
                if self.store is not None:
                    epoch, payloads = self._last_ckpt
                    for t, payload in payloads.items():
                        self._io_queue.put(("tile", (epoch, t, payload)))
                    self._io_queue.put(
                        (
                            "finalize",
                            (
                                epoch,
                                self.rule.rulestring(),
                                self.layout.grid,
                                self.config.shape,
                                self._digest_meta_locked(epoch),
                            ),
                        )
                    )
            elif self.degraded and not quorum:
                self.degraded = False
                self._m_degraded.set(0)
                if self._degraded_span is not None:
                    self._degraded_span.set(healed=True).finish()
                    self._degraded_span = None
                self.events.emit("cluster_degraded_healed")

    def _inject_crash(self) -> None:
        members = [m for m in self.membership.alive_members() if m.tiles]
        if not members:
            return
        rng = self.injector.rng
        victim = rng.choice(members)
        mode = self.config.fault_injection.mode
        if mode == "node":
            self.crash_events.append({"mode": "node", "victim": victim.name})
            self.events.emit("crash_injected", mode="node", victim=victim.name)
            # Trace context on the kill order: the victim's backend.crash
            # span (and its flight dump) link to the epoch they interrupt.
            self._safe_send(
                victim, attach_trace({"type": P.CRASH}, self._epoch_span)
            )
        else:
            tile = rng.choice(victim.tiles)
            self.crash_events.append(
                {"mode": "tile", "victim": victim.name, "tile": tile}
            )
            self.events.emit(
                "crash_injected",
                mode="tile",
                victim=victim.name,
                tile=list(tile),
            )
            self._safe_send(
                victim,
                attach_trace(
                    {"type": P.CRASH_TILE, "tile": list(tile)}, self._epoch_span
                ),
            )


def run_frontend(config: SimulationConfig, *, min_backends: int = 1) -> int:
    """CLI entry: serve the cluster until the simulation completes."""
    fe = Frontend(config, min_backends=min_backends)
    fe.start()
    print(f"frontend listening on {config.host}:{fe.port}", flush=True)
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
        # SIGUSR1 toggles pause/resume — the reference's PauseSimulation/
        # ResumeSimulation messages existed but nothing ever sent them
        # (BoardCreator.scala:109-112, dead code); here an operator can.  The
        # handler runs on the main thread (blocked in done.wait(), holding no
        # locks), so calling pause()/resume() directly is safe.
        import signal as _signal

        def _toggle_pause(signum, frame):
            if fe.paused:
                print("resuming (SIGUSR1)", flush=True)
                fe.resume()
            else:
                print("pausing (SIGUSR1)", flush=True)
                fe.pause()

        try:
            _signal.signal(_signal.SIGUSR1, _toggle_pause)
        except (ValueError, AttributeError):  # non-main thread / no SIGUSR1
            pass

        try:
            # A worker may die between quorum and deployment.
            fe.start_simulation()
        except RuntimeError as e:
            print(f"error: {e}", flush=True)
            fe.stop()
            return 1
        fe.done.wait()
    except KeyboardInterrupt:
        # Graceful operator stop (^C / SIGTERM via the CLI mapping), in ANY
        # post-start window — quorum wait, tile deployment, or the serve
        # loop: send SHUTDOWN to every worker so they leave rc=0, drain
        # queued checkpoint writes, close the store.  Durable state = the
        # cadence checkpoints; a restarted frontend resumes from them
        # (tests/test_cluster.py frontend-restart-resumes).  The drain is
        # masked against a second signal — aborting it half-way would drop
        # queued checkpoint writes while still exiting 130.
        from akka_game_of_life_tpu_torch.runtime.signals import mask_interrupts

        print("interrupted; shutting the cluster down", flush=True)
        with mask_interrupts():
            fe.stop()
        return 130
    fe.stop()
    if fe.error:
        print(f"error: {fe.error}", flush=True)
        return 1
    print(f"simulation complete at epoch {config.max_epochs}", flush=True)
    return 0
