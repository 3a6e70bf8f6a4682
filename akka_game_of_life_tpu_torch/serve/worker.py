"""Worker half of the cluster-sharded serving plane.

A :class:`ServeWorkerPlane` turns one :class:`runtime.backend.BackendWorker`
into a serving shard host: it owns a local :class:`serve.sessions.SessionRouter`
(the batch engine, unchanged as the per-worker core) and speaks
the serve wire protocol with the frontend:

- ``SERVE_OPS``  — one frame carrying every op the frontend coalesced for
  this worker (create/step/delete/get, shard ``adopt`` installs, and
  stateless ``step_raw`` tile chunks for frontend-resident mega-board
  sessions).  Ops run on a dedicated executor thread — the control reader
  must never block behind a batch tick.
- ``SERVE_RESULT`` — completions coalesced back: results accumulate while
  a frame is in flight and flush as one frame (the halo plane's coalescing
  discipline, reply side).  Step jobs complete asynchronously via the router's ``on_done``
  callback, so a tick's worth of jobs ride one result frame instead of
  parking one thread each.
- ``SHARD_PREPARE`` / ``SHARD_COMMIT`` / ``SHARD_ABORT`` — the worker side
  of a session-shard migration: freeze the named sessions, run their
  admitted jobs dry, export them digest-stamped (``SHARD_STATE``), then
  drop on commit or unfreeze on abort.  Shard control rides the same
  executor queue as ops, so it orders behind every op frame that preceded
  it on the wire.
- ``SHARD_REPLICATE`` / ``SHARD_REPLICATE_ACK`` — session replication:
  a streamer thread exports *dirty* resident sessions (epoch past the
  acked watermark by ``serve_replicate_every``, or new, or idle-dirty)
  at ``serve_replicate_interval_s`` cadence and ships them to the
  frontend, which relays each shard's payloads to its replica worker as
  a ``replicate`` op and acks this primary with the per-session epoch
  watermark.  Watermarks only advance on ack, so a dropped frame in
  either direction is retransmitted by the next pass — convergence is
  exact once traffic stops.  The replica side is the ``replicate`` /
  ``promote`` / ``replica_drop`` ops below: standby payloads live in a
  plain dict OUTSIDE the router (they must not pollute shard-hash freeze
  sets or session listings) until a promotion certifies and installs
  them.

- ``TILED_HALO`` / ``TILED_HALO_ACK`` — worker-resident tiled sessions:
  a mega-board session's halo-padded chunks are installed ONCE
  (``tiled_install``) and stay resident here across steps; each barrier
  round the frontend sends one ``tiled_step`` op per worker and the
  workers exchange O(perimeter) edge strips directly, worker-to-worker,
  over the peer data plane.  Received halo frames ride THIS plane's op
  FIFO (the backend's peer reader enqueues them), so a strip can never
  reorder against the install/step/migration ops of its session.  The
  sender keeps every strip in a retransmit buffer until the receiver's
  ack clears it — a dropped frame stalls a round for one timeout, never
  corrupts it (a round only steps when all 8 strips for a chunk at the
  barrier epoch are in hand).

The plane is constructed from the WELCOME policy bundle (the frontend owns
the ``serve_*`` knobs cluster-wide, exactly like the ring/retry policy).

Counterpart of ``akka_game_of_life_tpu/serve/worker.py``, frame for frame
(a cluster may mix the two packages' frontends and workers).  The plane
takes the worker's ``device`` (``cuda`` unless the caller names the CPU):
its :class:`SessionRouter` ticks the batched step there, and a round's
resident chunks step there as one ``[B, H, W]`` stack through the dense
``ops/stencil.py:multi_step`` (one host-to-device and one device-to-host
copy per (shape, pad) group).  Every thread that reaches the device pins
it first.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.obs import get_registry
from akka_game_of_life_tpu_torch.obs.tracing import TRACE_KEY, get_tracer
from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.runtime import protocol as P
from akka_game_of_life_tpu_torch.runtime.wire import pack_tile, unpack_tile
from akka_game_of_life_tpu_torch.serve.sessions import (
    AdmissionError,
    SessionRouter,
    shard_of,
)

# WELCOME policy keys the worker adopts into its local router config —
# the cluster's serve knobs have ONE source of truth, the frontend's
# SimulationConfig (the local caps are only the backstop behind the
# frontend's cluster-wide admission budget).
SERVE_POLICY_KEYS = (
    "serve_shards",
    "serve_max_sessions",
    "serve_max_cells",
    "serve_queue_depth",
    "serve_max_steps",
    "serve_tick_s",
    "serve_ttl_s",
    "serve_size_classes",
    "serve_replicate",
    "serve_replicate_every",
    "serve_replicate_interval_s",
    "serve_tiled_resident",
    "serve_tiled_resident_snapshot",
    "serve_tiled_resident_halo_timeout_s",
    "serve_trace",
    "serve_memo",
    "serve_memo_block",
    "serve_memo_max_mb",
    "serve_memo_hit_floor",
    "serve_memo_warmup",
    "serve_memo_disable_after",
    "serve_memo_certify_every",
    "ff_enabled",
    "ff_certify_steps",
)

# The 8 Moore directions a chunk's halo ring decomposes into, as (dy, dx)
# seen FROM the receiving chunk (its neighbor at chunk-grid offset
# (dy, dx) owns that part of the ring).
_HALO_DIRS = tuple(
    (dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)
)

# Retransmit attempts per halo strip before the sender gives up loudly
# (the round then stalls until the frontend's barrier timeout resolves
# the session — promotion or failure, never silent corruption).
_HALO_MAX_TRIES = 6

# Snapshot-history depth cap per resident chunk: the certified floor
# normally prunes history to 1-2 entries; the cap only bounds a parked
# or badly lagging stream.
_SNAP_CAP = 8

# A snapshot streamed but not yet acked is not re-sent until the ack
# timeout passes (the ack may simply be in flight); after it, the next
# pass retransmits — the loss-recovery half of the watermark protocol.
# Scaled with the stream interval, floored here.
REPL_ACK_TIMEOUT_FLOOR_S = 0.5


def serve_policy(config) -> Dict[str, object]:
    """The WELCOME ``serve`` bundle from the frontend's config.

    ``serve_ttl_s`` ships as 0: in cluster mode the FRONTEND owns the TTL
    sweep (it must — it charges the cluster admission budget, and a
    worker evicting locally would leak that budget forever since nothing
    reports evictions upstream).  The frontend sweep issues real delete
    ops, so worker tables and the cluster index retire together."""
    policy = {k: getattr(config, k) for k in SERVE_POLICY_KEYS}
    policy["serve_ttl_s"] = 0.0
    return policy


import functools


@functools.lru_cache(maxsize=None)
def _batched_step_fn(rule, n_steps: int, device):
    """The n-steps-per-call closure over a ``[B, H, W]`` uint8 chunk
    stack on ``device``: a worker advances ALL its ready chunks of a
    round in one batched call (cached per (rule, n, device); the caller
    pads B to a power of two, as the JAX package does for its jit).  The
    dense step rolls only the last two dims, so each board of the stack
    steps on its own torus."""
    from akka_game_of_life_tpu_torch.ops import stencil

    def run(stack):
        return stencil.multi_step(stack, rule, n_steps)

    from akka_game_of_life_tpu_torch.obs.programs import registered_jit, stencil_cost

    return registered_jit(
        "serve_tiled", (str(rule), n_steps, str(device)), run,
        cost=lambda stack: stencil_cost(
            stack.shape[-2], stack.shape[-1], n_steps, boards=stack.shape[0]
        ),
    )


def _pin(device: torch.device) -> None:
    """Make ``device`` the calling thread's current card (a no-op on the
    CPU): each plane thread that reaches the device calls this first, so
    nothing lands on another card's default context."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _chunk_key(cy: int, cx: int) -> str:
    """Wire spelling of a chunk id (dict keys must be strings)."""
    return f"{cy},{cx}"


def _parse_chunk(key) -> tuple:
    if isinstance(key, str):
        cy, cx = key.split(",")
        return (int(cy), int(cx))
    return (int(key[0]), int(key[1]))


class _Chunk:
    """One resident tiled-session chunk: the live board plus its snapshot
    history (the rollback/replication source).  Executor-thread owned;
    only the ``snaps`` dict is shared with the replication streamer
    (mutated under the plane lock)."""

    __slots__ = (
        "sid", "cy", "cx", "gy", "gx", "th", "tw", "ny", "nx",
        "H", "W", "rule_s", "rule", "k", "board", "epoch", "pop",
        "snaps",
    )

    def __init__(self, sid, cy, cx, gy, gx, th, tw, ny, nx, H, W,
                 rule_s, k, board, epoch):
        from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

        self.sid = sid
        self.cy, self.cx = cy, cx
        self.gy, self.gx = gy, gx
        self.th, self.tw = th, tw
        self.ny, self.nx = ny, nx
        self.H, self.W = H, W
        self.rule_s = rule_s
        self.rule = resolve_rule(rule_s)
        self.k = k
        self.board = board
        self.epoch = epoch
        self.pop = int((board == 1).sum())
        # epoch -> self-contained snapshot payload (wire shape), pruned
        # by the frontend-relayed certified floor.
        self.snaps: Dict[int, dict] = {}

    def retain(self, pay: dict) -> None:
        """Retain one snapshot payload (caller holds the plane lock).
        The depth cap THROTTLES instead of evicting: when the history is
        full (certified floor stuck — replica lagging or parked), new
        snapshots are simply not retained until floor pruning frees
        room.  Evicting the oldest would silently delete the very
        barrier the certified-resume contract promises to restore."""
        epoch = int(pay["epoch"])
        if epoch in self.snaps or len(self.snaps) < _SNAP_CAP:
            self.snaps[epoch] = pay

    def payload(self, epoch: int, state: dict, lanes, pop: int) -> dict:
        """A self-contained wire payload for this chunk at ``epoch`` —
        replication, export, and promotion all speak this one shape."""
        return {
            "sid": self.sid,
            "chunk": [self.cy, self.cx],
            "origin": [self.gy, self.gx],
            "shape": [self.th, self.tw],
            "width": self.W,
            "epoch": int(epoch),
            "state": state,
            "digest": [int(lanes[0]), int(lanes[1])],
            "pop": int(pop),
        }

    def lanes(self, board=None):
        board = self.board if board is None else board
        return odigest.digest_dense_np(
            board, origin=(self.gy, self.gx), width=self.W
        )


class _Round:
    """One in-flight halo round on this worker: the listed chunks step
    from ``epoch`` by ``ks[0]`` once every strip at ``epoch`` is in hand.
    A multi-round request (``len(ks) > 1``) CHAINS worker-side — the
    next round registers and its strips go out the moment this one's
    chunks land, with no frontend involvement until the last round's
    result (executor-thread owned)."""

    __slots__ = (
        "rid", "sid", "epoch", "ks", "chunks", "all_chunks", "need",
        "digest", "snap_epochs", "owners", "halo_bytes", "lanes",
        "pops", "started",
    )

    def __init__(self, rid, sid, epoch, ks, chunks, digest, snap_epochs,
                 owners, now):
        self.rid = rid
        self.sid = sid
        self.epoch = epoch
        self.ks = ks  # per-round step counts; ks[0] is THIS round's
        self.chunks = list(chunks)  # still to step this round
        self.all_chunks = tuple(chunks)
        # (cy, cx) -> {(dy, dx): strip} collected for this round
        self.need: Dict[tuple, Dict[tuple, np.ndarray]] = {
            c: {} for c in chunks
        }
        self.digest = digest
        self.snap_epochs = snap_epochs  # absolute epochs to snapshot at
        self.owners = owners
        self.halo_bytes = 0
        self.lanes: Dict[str, list] = {}
        self.pops: Dict[str, int] = {}
        self.started = now

    @property
    def k(self) -> int:
        return self.ks[0]

    def next_round(self, now: float) -> "_Round":
        return _Round(
            self.rid, self.sid, self.epoch + self.ks[0], self.ks[1:],
            self.all_chunks, self.digest, self.snap_epochs, self.owners,
            now,
        )


def _err_entry(rid: int, e: BaseException) -> dict:
    """One failed op as a wire result entry; the frontend re-raises the
    matching exception class at the tenant-facing surface."""
    if isinstance(e, AdmissionError):
        return {"rid": rid, "err": "admission", "reason": e.reason,
                "detail": str(e)}
    kind = {
        KeyError: "key",
        ValueError: "value",
        TypeError: "value",
        TimeoutError: "timeout",
    }.get(type(e), "runtime")
    detail = e.args[0] if kind == "key" and e.args else str(e)
    return {"rid": rid, "err": kind, "detail": str(detail)}


class ServeWorkerPlane:
    """One worker's serving engine + its wire glue.  Thread layout: an
    executor thread runs ops/shard control in arrival order; a reply
    thread coalesces completed results into SERVE_RESULT frames; batch
    step completions arrive via router callbacks."""

    def __init__(
        self,
        policy: Dict[str, object],
        send,
        *,
        name: str = "",
        registry=None,
        tracer=None,
        peer_send=None,
        device="cuda",
    ) -> None:
        from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
        from akka_game_of_life_tpu_torch.runtime.simulation import resolve_device

        # The worker's own device: cuda unless the caller names the CPU
        # (raises without a card; the plane never moves to the CPU).  A
        # bare "cuda" is the constructing thread's card, named by index so
        # the plane's other threads can pin it.
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

        cfg = SimulationConfig(
            **{k: policy[k] for k in SERVE_POLICY_KEYS if k in policy}
        )
        self.name = name
        self._send = send  # callable(msg) -> None; raises OSError when dead
        # callable(name, host, port, msg): queue a frame onto the named
        # peer's async send lane (the backend's _PeerSender — never blocks
        # the executor on a wedged link).  None = loopback-only (tests).
        self._peer_send = peer_send
        self.metrics = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.router = SessionRouter(
            cfg, registry=self.metrics, tracer=self.tracer, device=self.device
        )
        self.n_shards = int(cfg.serve_shards)
        # Per-request tracing (serve_trace through the WELCOME bundle):
        # when an op carries frontend trace ctx, its execution becomes a
        # serve.batch span under the originating serve.request.
        self._trace = bool(getattr(cfg, "serve_trace", True))
        # shard → the sid set THIS worker froze at prepare (executor-thread
        # only, so unlocked): commit/abort without explicit sids act on it.
        self._shard_frozen: Dict[int, List[str]] = {}
        # Replica half: shard → {sid: wire payload} standby copies, kept
        # OUTSIDE the router so they never pollute shard-hash freeze sets,
        # listings, or the local admission backstop (executor-thread only,
        # like _shard_frozen).
        self._standby: Dict[int, Dict[str, dict]] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._inbox: deque = deque()  # graftlint: guarded-by _lock
        self._results: List[dict] = []  # graftlint: guarded-by _lock
        # Held by the reply thread from taking a batch to sending it, so a
        # re-home's discard_results leaves no batch of the dead frontend's
        # still on its way.
        self._reply_lock = threading.Lock()
        self._stopped = False  # graftlint: guarded-by _lock
        # Primary half of replication: per-session watermark state (acked
        # epoch, last streamed epoch/time, last pass's epoch for the
        # idle-flush rule) and the shard park set (no replica placeable —
        # the frontend parks the stream instead of letting this worker
        # re-ship every board every pass in single-copy mode).
        self._repl_state: Dict[str, dict] = {}  # graftlint: guarded-by _lock
        self._repl_parked: set = set()  # graftlint: guarded-by _lock
        self.replicate = bool(cfg.serve_replicate)
        self._repl_interval_s = float(cfg.serve_replicate_interval_s)
        self._repl_every = int(cfg.serve_replicate_every)
        self._ack_timeout_s = max(
            REPL_ACK_TIMEOUT_FLOOR_S, 4 * self._repl_interval_s
        )
        # -- worker-resident tiled sessions ---------------------------------
        self._halo_timeout_s = float(cfg.serve_tiled_resident_halo_timeout_s)
        # (sid, (cy, cx)) -> _Chunk: the resident store (executor-thread
        # only, like _shard_frozen; the replication streamer reads chunk
        # snapshot payloads under self._lock via _tiled_repl).
        self._resident: Dict[tuple, _Chunk] = {}
        # (sid, epoch) -> _Round awaiting halos (executor only).
        self._rounds: Dict[tuple, _Round] = {}
        # Early strips: (sid, (cy,cx), epoch, (dy,dx)) -> (strip, t_seen).
        self._halo_buf: Dict[tuple, tuple] = {}
        # Unacked outgoing strips for retransmit: key -> record.
        self._halo_out: Dict[tuple, dict] = {}
        self._halo_upkeep_t = 0.0
        # Replica half: sid -> {(cy,cx) -> {epoch -> payload}} standby
        # snapshot history (executor only).
        self._tiled_standby: Dict[str, Dict[tuple, Dict[int, dict]]] = {}
        # Primary half: (sid, (cy,cx)) -> watermark record; the chunk's
        # snaps dict is mutated by the executor and read by the repl
        # streamer, both under self._lock.
        self._tiled_repl: Dict[tuple, dict] = {}  # graftlint: guarded-by _lock
        self._tiled_parked: set = set()  # graftlint: guarded-by _lock
        self._m_resident = self.metrics.gauge(
            "gol_serve_tiled_resident_chunks"
        )
        self._m_halo_bytes = self.metrics.counter(
            "gol_serve_tiled_halo_bytes_total"
        )
        self._m_halo_retx = self.metrics.counter(
            "gol_serve_tiled_halo_retx_total"
        )
        self._exec = threading.Thread(
            target=self._exec_loop, daemon=True, name=f"serve-exec-{name}"
        )
        self._reply = threading.Thread(
            target=self._reply_loop, daemon=True, name=f"serve-reply-{name}"
        )
        self._exec.start()
        self._reply.start()
        if self.replicate:
            self._repl = threading.Thread(
                target=self._repl_loop, daemon=True,
                name=f"serve-repl-{name}",
            )
            self._repl.start()

    # -- wire-in (called from the worker's control reader thread) ------------

    def handle(self, msg: dict) -> None:
        """Enqueue one serve-plane control message; never blocks."""
        with self._lock:
            if self._stopped:
                return
            self._inbox.append(msg)
            self._work.notify_all()

    def has_sessions(self) -> bool:
        return self.router.stats()["sessions"] > 0

    def home_summary(self) -> dict:
        """The ``SHARD_HOME`` payload a re-homed control channel announces
        to its adopting frontend after a frontend loss: every session this
        worker hosts (the router's list — id/tenant/rule/epoch/digest per
        row), which IS the truth that closes the federation failover
        window (docs/OPERATIONS.md "Frontend scale-out & HA")."""
        return {"sessions": self.router.list()}

    def barrier(self, done: threading.Event) -> None:
        """Queue ``done`` behind every frame handed so far.  The executor
        sets it once they have run, after it thaws the shards of any
        migration still open: a worker re-homing after its frontend's loss
        waits for it, and the dead frontend can no longer commit or abort
        what it prepared."""
        with self._lock:
            if self._stopped:
                done.set()
                return
            self._inbox.append(done)
            self._work.notify_all()

    def settle(self, timeout: float) -> bool:
        """Block until every job queued on the router has landed, or
        ``timeout`` seconds pass; True when settled.  After :meth:`barrier`,
        a re-homing worker's ``home_summary`` then counts every op its dead
        frontend sent (else the adopting frontend's index, and a client
        reading it back, would see the epoch before it)."""
        sids = [doc["id"] for doc in self.router.list()]
        return self.router.wait_idle(sids, timeout)

    def discard_results(self) -> None:
        """Drop the answers not yet sent: after a control re-home they
        belong to the dead frontend's ops (their rids mean other ops at the
        new frontend)."""
        with self._reply_lock, self._lock:
            self._results = []

    # -- executor -------------------------------------------------------------

    def _exec_loop(self) -> None:
        import time

        _pin(self.device)
        while True:
            with self._lock:
                while not self._stopped and not self._inbox:
                    self._work.wait(timeout=0.2)
                    if self._halo_out or self._halo_buf:
                        break
                if self._stopped:
                    return
                msg = self._inbox.popleft() if self._inbox else None
            try:
                if isinstance(msg, threading.Event):
                    try:
                        for sids in self._shard_frozen.values():
                            self.router.unfreeze_sessions(sids)
                        self._shard_frozen.clear()
                    finally:
                        msg.set()
                elif msg is not None:
                    kind = msg.get("type")
                    if kind == P.SERVE_OPS:
                        for op in msg.get("ops", []):
                            self._run_op(op)
                    elif kind == P.SHARD_PREPARE:
                        self._on_prepare(msg)
                    elif kind == P.SHARD_COMMIT:
                        self.router.drop_sessions(self._shard_sids(msg))
                    elif kind == P.SHARD_ABORT:
                        self.router.unfreeze_sessions(self._shard_sids(msg))
                    elif kind == P.SHARD_REPLICATE_ACK:
                        self._on_replicate_ack(msg)
                    elif kind == P.TILED_HALO:
                        self._on_tiled_halo(msg)
                    elif kind == P.TILED_HALO_ACK:
                        self._halo_out.pop(
                            (str(msg["sid"]), int(msg["epoch"]),
                             str(msg.get("from", ""))),
                            None,
                        )
                self._halo_upkeep(time.monotonic())
            except Exception as e:  # noqa: BLE001 — one bad frame must not
                # kill the executor: every op answers, malformed ones loudly
                print(f"serve plane: dropped bad frame: {e!r}", flush=True)

    def _run_op(self, op: dict) -> None:
        rid = int(op["rid"])
        kind = op.get("op")
        ctx = op.get(TRACE_KEY)  # the originating serve.request's ctx
        if not isinstance(ctx, dict):
            ctx = None
        try:
            if kind == "create":
                doc = self.router.create(
                    tenant=str(op.get("tenant", "default")),
                    rule=op.get("rule", "conway"),
                    height=int(op.get("height", 64)),
                    width=int(op.get("width", 64)),
                    seed=int(op.get("seed", 0)),
                    density=float(op.get("density", 0.5)),
                    with_board=False,
                    sid=str(op["sid"]),
                )
                self._push({"rid": rid, "ok": 1, "doc": doc})
            elif kind == "step":
                # Async: the job's on_done callback pushes the result when
                # its batch lands — the executor moves straight on to the
                # next op, so every step of a frame rides the same tick.
                # With trace ctx riding the op, the whole execution (queue
                # wait + its slice of the batched call) is a serve.batch
                # span under the originating serve.request, and the result
                # entry echoes the ctx back across the serve_result frame.
                span = None
                if self._trace and ctx is not None:
                    span = self.tracer.start(
                        "serve.batch",
                        parent=ctx,
                        node=self.name or None,
                        sid=str(op["sid"]),
                        steps=int(op.get("steps", 1)),
                    )

                def _step_done(job, rid=rid, span=span, ctx=ctx):
                    qw = job.queue_wait_s if job.t_enq else None
                    if span is not None:
                        span.set(
                            outcome="error" if job.error is not None
                            else "ok"
                        )
                        if qw is not None:
                            span.set(queue_wait_s=round(qw, 6))
                        span.finish()
                    if job.error is not None:
                        entry = _err_entry(rid, job.error)
                    else:
                        entry = {
                            "rid": rid,
                            "ok": 1,
                            "epoch": job.result[0],
                            "digest": job.result[1],
                        }
                        if qw is not None:
                            entry["qw"] = round(qw, 6)
                    if ctx is not None:
                        entry[TRACE_KEY] = ctx
                    self._push(entry)

                try:
                    self.router.submit(
                        str(op["sid"]),
                        int(op.get("steps", 1)),
                        on_done=_step_done,
                    )
                except BaseException:
                    if span is not None:
                        # Refused at admission: the job never existed, so
                        # the callback will never fire — close the span
                        # here and let the outer handler answer the op.
                        span.set(outcome="rejected")
                        span.finish()
                    raise
            elif kind == "get":
                self._push(
                    {"rid": rid, "ok": 1, "doc": self.router.get(str(op["sid"]))}
                )
            elif kind == "delete":
                self.router.delete(str(op["sid"]))
                self._push({"rid": rid, "ok": 1})
            elif kind == "adopt":
                self.router.import_sessions(op["sessions"])
                self._push({"rid": rid, "ok": 1})
            elif kind == "replicate":
                self._push(self._replicate_op(rid, op))
            elif kind == "promote":
                self._push(self._promote_op(rid, op))
            elif kind == "replica_drop":
                self._standby.pop(int(op["shard"]), None)
                self._push({"rid": rid, "ok": 1})
            elif kind == "step_raw":
                self._push(self._step_raw(rid, op))
            elif kind == "tiled_install":
                self._push(self._tiled_install(rid, op))
            elif kind == "tiled_step":
                self._tiled_step(rid, op)  # async: pushes when the round completes
            elif kind == "tiled_fetch":
                self._push(self._tiled_fetch(rid, op))
            elif kind == "tiled_export":
                self._push(self._tiled_export(rid, op))
            elif kind == "tiled_adopt":
                self._push(self._tiled_adopt(rid, op))
            elif kind == "tiled_drop":
                self._tiled_drop(str(op["sid"]), None)
                self._push({"rid": rid, "ok": 1})
            elif kind == "tiled_chunk_drop":
                self._tiled_drop(
                    str(op["sid"]),
                    [_parse_chunk(c) for c in op.get("chunks", [])],
                )
                self._push({"rid": rid, "ok": 1})
            elif kind == "tiled_replicate":
                self._push(self._tiled_replicate(rid, op))
            elif kind == "tiled_promote":
                self._push(self._tiled_promote(rid, op))
            elif kind == "tiled_rollback":
                self._push(self._tiled_rollback(rid, op))
            elif kind == "tiled_replica_drop":
                sid = str(op["sid"])
                chunks = op.get("chunks")
                if chunks is None:
                    self._tiled_standby.pop(sid, None)
                else:
                    store = self._tiled_standby.get(sid, {})
                    for c in chunks:
                        store.pop(_parse_chunk(c), None)
                    if not store:
                        self._tiled_standby.pop(sid, None)
                self._push({"rid": rid, "ok": 1})
            else:
                raise ValueError(f"unknown serve op {kind!r}")
        except BaseException as e:  # noqa: BLE001 — answered, never dropped
            self._push(_err_entry(rid, e))

    def _step_raw(self, rid: int, op: dict) -> dict:
        """A stateless tile chunk of a frontend-resident tiled (mega-board)
        session: step the k-halo-padded slab k epochs (halo absorbs the
        padded-torus wrap contamination, so the interior is exactly the
        global evolution), return the interior packed plus its digest
        lanes at the tile's global offsets."""
        from akka_game_of_life_tpu_torch.ops import stencil
        from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

        rule = resolve_rule(op["rule"])
        k = int(op["k"])
        padded = torch.from_numpy(unpack_tile(op["state"])).to(self.device)
        out = stencil.multi_step_fn(rule, k)(padded).cpu().numpy()
        y0, y1, x0, x1 = (int(v) for v in op["interior"])
        interior = np.ascontiguousarray(out[y0:y1, x0:x1])
        lanes = odigest.digest_dense_np(
            interior,
            origin=tuple(int(v) for v in op["origin"]),
            width=int(op["width"]),
        )
        return {
            "rid": rid,
            "ok": 1,
            "state": pack_tile(interior),
            "digest": [int(lanes[0]), int(lanes[1])],
        }

    # -- worker-resident tiled sessions (docs/OPERATIONS.md) ------------------

    def _resident_gauge(self) -> None:
        self._m_resident.set(len(self._resident))

    def _tiled_install(self, rid: int, op: dict) -> dict:
        """Install one resident chunk (create/adopt both land here via
        payload shape).  The install epoch counts as a snapshot barrier:
        the chunk can be promoted from its replica the moment the epoch-0
        stream acks."""
        sid = str(op["sid"])
        cy, cx = _parse_chunk(op["chunk"])
        gy, gx = (int(v) for v in op["origin"])
        th, tw = (int(v) for v in op["shape"])
        ny, nx = (int(v) for v in op["grid"])
        chunk = _Chunk(
            sid, cy, cx, gy, gx, th, tw, ny, nx,
            int(op["H"]), int(op["W"]), str(op["rule"]), int(op["k"]),
            unpack_tile(op["state"]), int(op.get("epoch", 0)),
        )
        self._resident[(sid, (cy, cx))] = chunk
        self._resident_gauge()
        if op.get("replicate", True) and self.replicate:
            self._tiled_snapshot(chunk)
        return {"rid": rid, "ok": 1}

    def _tiled_snapshot(self, chunk: _Chunk) -> None:
        """Retain a snapshot of the chunk at its CURRENT epoch — the
        local rollback source and the replication stream's next payload."""
        lanes = chunk.lanes()
        pay = chunk.payload(
            chunk.epoch, pack_tile(chunk.board), lanes, chunk.pop
        )
        key = (chunk.sid, (chunk.cy, chunk.cx))
        with self._lock:
            chunk.retain(pay)
            self._tiled_repl.setdefault(
                key, {"acked": -1, "sent": -1, "sent_t": 0.0}
            )

    def _strip_for(self, chunk: _Chunk, dy: int, dx: int) -> np.ndarray:
        """The part of this chunk's board a neighbor's halo ring needs,
        for ring direction (dy, dx) as seen FROM the receiver (this chunk
        sits at receiver + (dy, dx) on the torus chunk grid)."""
        k = chunk.k
        rows = {
            -1: slice(chunk.th - k, chunk.th), 0: slice(None),
            1: slice(0, k),
        }[dy]
        cols = {
            -1: slice(chunk.tw - k, chunk.tw), 0: slice(None),
            1: slice(0, k),
        }[dx]
        return np.ascontiguousarray(chunk.board[rows, cols])

    def _send_strips(self, rnd: _Round, owners: Dict[str, list],
                     now: float) -> None:
        """Cut every listed chunk's 8 edge strips at the round's barrier
        epoch and push them: loopback strips deliver straight into the
        local buffer; remote strips COALESCE into one TILED_HALO frame
        per destination worker (the halo plane's discipline — per-strip frames
        cost more in per-frame overhead than the strips themselves),
        each batch with one retransmit record cleared by one ack."""
        sid, E = rnd.sid, rnd.epoch
        me = None
        batches: Dict[str, Tuple[list, List[dict]]] = {}
        for c in rnd.chunks:
            chunk = self._resident[(sid, c)]
            if me is None:
                me = owners.get(_chunk_key(chunk.cy, chunk.cx))
            for dy, dx in _HALO_DIRS:
                rcy = (chunk.cy - dy) % chunk.ny
                rcx = (chunk.cx - dx) % chunk.nx
                strip = self._strip_for(chunk, dy, dx)
                dest = owners.get(_chunk_key(rcy, rcx))
                if dest is None:
                    continue
                if dest[0] == self.name or self._peer_send is None:
                    self._halo_buf[(sid, (rcy, rcx), E, (dy, dx))] = (
                        strip, now
                    )
                    continue
                entry = batches.setdefault(dest[0], (dest, [], []))
                entry[1].append({
                    "chunk": [rcy, rcx], "dir": [dy, dx],
                    "shape": list(strip.shape),
                })
                entry[2].append(strip.reshape(-1))
        for name, (dest, metas, flats) in batches.items():
            # One flat buffer, ONE vectorized packbits per frame (the
            # ring codec's discipline, strip edition): per-strip
            # pack_tile calls cost more CPU than the 8x byte saving is
            # worth, a single batched pack costs neither.  Multi-state
            # rules ride raw uint8.
            flat = (
                flats[0] if len(flats) == 1 else np.concatenate(flats)
            )
            binary = bool(
                self._resident[(sid, rnd.all_chunks[0])].rule.is_binary
            )
            data = np.packbits(flat) if binary else flat
            msg = {
                "type": P.TILED_HALO, "sid": sid, "epoch": E,
                "meta": metas, "data": data, "n": int(flat.size),
                "enc": "bits1" if binary else "raw", "src": me,
            }
            rnd.halo_bytes += int(data.nbytes)
            self._m_halo_bytes.inc(int(data.nbytes))
            self._halo_out[(sid, E, name)] = {
                "msg": msg, "dest": dest, "t": now, "tries": 1,
            }
            self._peer_send(dest[0], dest[1], int(dest[2]), msg)

    def _on_tiled_halo(self, msg: dict) -> None:
        """A peer's strip batch arrived (via the peer reader, through
        this plane's op FIFO): ack the batch, buffer every strip, and
        step anything they complete."""
        import time

        sid = str(msg["sid"])
        E = int(msg["epoch"])
        src = msg.get("src")
        if src and self._peer_send is not None and src[0] != self.name:
            self._peer_send(src[0], src[1], int(src[2]), {
                "type": P.TILED_HALO_ACK, "sid": sid, "epoch": E,
                "from": self.name,
            })
        now = time.monotonic()
        n = int(msg.get("n", 0))
        data = np.asarray(msg["data"], dtype=np.uint8).reshape(-1)
        flat = (
            np.unpackbits(data, count=n)
            if msg.get("enc") == "bits1" else data
        )
        off = 0
        for meta in msg.get("meta", []):
            h, w = (int(v) for v in meta["shape"])
            key = (
                sid, _parse_chunk(meta["chunk"]), E,
                (int(meta["dir"][0]), int(meta["dir"][1])),
            )
            self._halo_buf[key] = (
                flat[off:off + h * w].reshape(h, w), now
            )
            off += h * w
        self._feed_rounds(sid)

    def _halo_upkeep(self, now: float) -> None:
        """Periodic executor pass: retransmit unacked strips past the ack
        timeout, prune stale buffers, fail rounds that can never finish."""
        if now - self._halo_upkeep_t < min(0.2, self._halo_timeout_s):
            return
        self._halo_upkeep_t = now
        for key, rec in list(self._halo_out.items()):
            if now - rec["t"] < self._halo_timeout_s:
                continue
            if rec["tries"] >= _HALO_MAX_TRIES:
                del self._halo_out[key]
                print(
                    f"serve tiled: halo strip {key} unacked after "
                    f"{rec['tries']} sends; giving up",
                    flush=True,
                )
                continue
            rec["tries"] += 1
            rec["t"] = now
            self._m_halo_retx.inc()
            dest = rec["dest"]
            if self._peer_send is not None:
                self._peer_send(dest[0], dest[1], int(dest[2]), rec["msg"])
        for key, (_, seen) in list(self._halo_buf.items()):
            if now - seen > 60.0:
                del self._halo_buf[key]

    def _tiled_step(self, rid: int, op: dict) -> None:
        """One barrier round for this worker's chunks of a tiled session:
        send our strips, register the round, and step as halos land.  The
        result pushes asynchronously when the last chunk steps — the
        executor keeps draining the FIFO meanwhile (the frames that
        complete this round arrive through it)."""
        import time

        sid = str(op["sid"])
        E = int(op["epoch"])
        ks = [int(v) for v in op["ks"]]
        owners = dict(op.get("owners", {}))
        chunks = [_parse_chunk(c) for c in op["chunks"]]
        floor = int(op.get("floor", -1))
        now = time.monotonic()
        for c in chunks:
            chunk = self._resident.get((sid, c))
            if chunk is None:
                raise KeyError(f"{sid}:{c} not resident here")
            if chunk.epoch != E or max(ks) > chunk.k:
                # Strips are always chunk.k wide, so any round of k <=
                # chunk.k epochs is exact; an epoch mismatch means the
                # frontend and this worker disagree about the session
                # state (a cancelled round, a stale op) — fail loudly.
                raise RuntimeError(
                    f"tiled chunk {sid}:{c} at epoch {chunk.epoch} "
                    f"(k={chunk.k}), request asked {E} ks={ks}"
                )
            if floor >= 0:
                self._prune_snaps(chunk, floor)
        rnd = _Round(
            rid, sid, E, ks, chunks,
            bool(op.get("digest", True)),
            frozenset(int(v) for v in op.get("snap_epochs", [])),
            owners, now,
        )
        self._rounds[(sid, E)] = rnd
        self._send_strips(rnd, owners, now)
        self._feed_rounds(sid)

    def _prune_snaps(self, chunk: _Chunk, floor: int) -> None:
        """Drop snapshot history below the session's certified floor —
        but never the newest snapshot (the stream may still need it)."""
        with self._lock:
            for e in [e for e in chunk.snaps if e < floor]:
                if e != max(chunk.snaps):
                    del chunk.snaps[e]

    def _feed_rounds(self, sid: str) -> None:
        """Move buffered strips into this session's active rounds and
        step every chunk whose halo ring is complete — all ready chunks
        of a round advance in ONE batched device call (a per-chunk
        dispatch costs more than a 272² step; residency means the worker
        sees its whole chunk set at once, so it can batch where the
        ship-per-round path's independent ops cannot)."""
        import time

        pending = [
            key for key in self._rounds if key[0] == sid
        ]
        while pending:
            key = pending.pop()
            rnd = self._rounds.get(key)
            if rnd is None:
                continue
            E = rnd.epoch
            ready = []
            for c in list(rnd.chunks):
                got = rnd.need[c]
                for d in _HALO_DIRS:
                    if d in got:
                        continue
                    hit = self._halo_buf.pop((sid, c, E, d), None)
                    if hit is not None:
                        got[d] = hit[0]
                if len(got) == len(_HALO_DIRS):
                    ready.append(c)
            if ready:
                try:
                    self._step_chunks(rnd, ready)
                except Exception as e:  # noqa: BLE001 — answered, never
                    # stalled: a failed device step (a CUDA error on this
                    # thread) fails the round's op with its cause.
                    del self._rounds[key]
                    self._push(_err_entry(rnd.rid, e))
                    continue
            if rnd.chunks:
                continue
            del self._rounds[key]
            if len(rnd.ks) > 1:
                # Chain the request's next round HERE, worker-side: its
                # strips go out now and it may already be steppable from
                # buffered fast-peer strips — the frontend is not in the
                # loop again until the last round's result.
                now = time.monotonic()
                nxt = rnd.next_round(now)
                nxt.halo_bytes = rnd.halo_bytes
                self._rounds[(sid, nxt.epoch)] = nxt
                self._send_strips(nxt, nxt.owners, now)
                pending.append((sid, nxt.epoch))
                continue
            entry = {
                "rid": rnd.rid, "ok": 1, "epoch": E + rnd.k,
                "halo_bytes": rnd.halo_bytes,
            }
            if rnd.digest:
                entry["lanes"] = rnd.lanes
                entry["pop"] = rnd.pops
            self._push(entry)

    def _step_chunks(self, rnd: _Round, ready: List[tuple]) -> None:
        """Advance the ready chunks k epochs in one batched device call
        per (shape, pad) group: assemble the halo-padded slabs, stack
        them (batch padded to a power of two, as the JAX package pads its
        compiled batch), run the batched multi-step once, commit the
        interiors as the new resident state."""
        groups: Dict[tuple, List[tuple]] = {}
        for c in ready:
            chunk = self._resident[(rnd.sid, c)]
            groups.setdefault(
                (chunk.th, chunk.tw, chunk.k), []
            ).append(c)
        for (th, tw, k), cs in groups.items():
            rows = {-1: slice(0, k), 0: slice(k, k + th),
                    1: slice(k + th, k + th + k)}
            cols = {-1: slice(0, k), 0: slice(k, k + tw),
                    1: slice(k + tw, k + tw + k)}
            first = self._resident[(rnd.sid, cs[0])]
            stack = np.empty(
                (_next_pow2(len(cs)), th + 2 * k, tw + 2 * k),
                dtype=np.uint8,
            )
            for i, c in enumerate(cs):
                chunk = self._resident[(rnd.sid, c)]
                padded = stack[i]
                padded[k:k + th, k:k + tw] = chunk.board
                for (dy, dx), strip in rnd.need[c].items():
                    padded[rows[dy], cols[dx]] = strip
            for i in range(len(cs), stack.shape[0]):
                stack[i] = stack[0]  # pow2 pad: dead lanes, never read
            # The round may advance fewer epochs than the halo is wide
            # (rnd.k <= chunk.k): the interior at offset k is exact for
            # any step count up to the pad width.  One copy each way for
            # the whole group.
            out = (
                _batched_step_fn(first.rule, rnd.k, self.device)(
                    torch.from_numpy(stack).to(self.device)
                )
                .cpu()
                .numpy()
            )
            final = len(rnd.ks) == 1
            for i, c in enumerate(cs):
                chunk = self._resident[(rnd.sid, c)]
                chunk.board = np.ascontiguousarray(
                    out[i, k:k + th, k:k + tw]
                )
                chunk.epoch += rnd.k
                rnd.chunks.remove(c)
                snapshot = (
                    self.replicate and chunk.epoch in rnd.snap_epochs
                )
                if (final and rnd.digest) or snapshot:
                    lanes = chunk.lanes()
                    chunk.pop = int((chunk.board == 1).sum())
                    if final and rnd.digest:
                        rnd.lanes[_chunk_key(*c)] = [
                            int(lanes[0]), int(lanes[1])
                        ]
                        rnd.pops[_chunk_key(*c)] = chunk.pop
                    if snapshot:
                        pay = chunk.payload(
                            chunk.epoch, pack_tile(chunk.board), lanes,
                            chunk.pop,
                        )
                        with self._lock:
                            chunk.retain(pay)

    def _tiled_fetch(self, rid: int, op: dict) -> dict:
        """Render pull: the session's resident chunk states, packed (only
        on GET ?with_board=1 — the steady-state path never ships these)."""
        sid = str(op["sid"])
        states = []
        for c in (_parse_chunk(c) for c in op["chunks"]):
            chunk = self._resident.get((sid, c))
            if chunk is None:
                raise KeyError(f"{sid}:{c} not resident here")
            states.append({
                "chunk": list(c), "origin": [chunk.gy, chunk.gx],
                "shape": [chunk.th, chunk.tw], "epoch": chunk.epoch,
                "state": pack_tile(chunk.board),
                "pop": int((chunk.board == 1).sum()),
            })
        return {"rid": rid, "ok": 1, "states": states}

    def _tiled_export(self, rid: int, op: dict) -> dict:
        """Migration TRANSFER: the chunk's live state digest-stamped plus
        its retained snapshot history (the dest must be able to roll back
        to the session's certified floor, exactly like the source)."""
        sid = str(op["sid"])
        out = []
        for c in (_parse_chunk(c) for c in op["chunks"]):
            chunk = self._resident.get((sid, c))
            if chunk is None:
                raise KeyError(f"{sid}:{c} not resident here")
            lanes = chunk.lanes()
            pay = chunk.payload(
                chunk.epoch, pack_tile(chunk.board), lanes,
                int((chunk.board == 1).sum()),
            )
            with self._lock:
                pay["snaps"] = [
                    chunk.snaps[e] for e in sorted(chunk.snaps)
                ]
            out.append(pay)
        return {"rid": rid, "ok": 1, "chunks": out}

    def _tiled_adopt(self, rid: int, op: dict) -> dict:
        """Migration install at the destination: certified payloads (the
        frontend re-derived every digest) become resident chunks, snapshot
        history included; the replication stream restarts from scratch."""
        sid = str(op["sid"])
        meta = op["meta"]
        for pay in op["chunks"]:
            cy, cx = _parse_chunk(pay["chunk"])
            gy, gx = (int(v) for v in pay["origin"])
            th, tw = (int(v) for v in pay["shape"])
            chunk = _Chunk(
                sid, cy, cx, gy, gx, th, tw,
                int(meta["grid"][0]), int(meta["grid"][1]),
                int(meta["H"]), int(meta["W"]), str(meta["rule"]),
                int(meta["k"]), unpack_tile(pay["state"]),
                int(pay["epoch"]),
            )
            self._resident[(sid, (cy, cx))] = chunk
            with self._lock:
                for snap in pay.get("snaps", []):
                    chunk.snaps[int(snap["epoch"])] = snap
                self._tiled_repl[(sid, (cy, cx))] = {
                    "acked": -1, "sent": -1, "sent_t": 0.0,
                }
        self._resident_gauge()
        return {"rid": rid, "ok": 1}

    def _tiled_drop(self, sid: str, chunks) -> None:
        """Release resident chunks (session delete/evict, or the source
        half of a committed chunk migration) and every per-chunk buffer
        that addressed them."""
        keys = [
            key for key in self._resident
            if key[0] == sid and (chunks is None or key[1] in chunks)
        ]
        for key in keys:
            del self._resident[key]
            with self._lock:
                self._tiled_repl.pop(key, None)
        if chunks is None:
            for rk in [k for k in self._rounds if k[0] == sid]:
                rnd = self._rounds.pop(rk)
                self._push(_err_entry(
                    rnd.rid, RuntimeError(f"session {sid} dropped mid-round")
                ))
            for bk in [k for k in self._halo_buf if k[0] == sid]:
                del self._halo_buf[bk]
            for ok_ in [k for k in self._halo_out if k[0] == sid]:
                del self._halo_out[ok_]
            # A full-session drop also retires any standby history this
            # worker replicates for the session — a worker is routinely
            # BOTH an owner and a replica of the same session, and the
            # frontend sends it one cleanup op, not two.
            self._tiled_standby.pop(sid, None)
            with self._lock:
                self._tiled_parked.discard(sid)
        self._resident_gauge()

    def _tiled_replicate(self, rid: int, op: dict) -> dict:
        """Replica half: store standby snapshot payloads (history, pruned
        by the certified floor the frontend relays) and ack the newest
        epoch held per chunk — the watermark the frontend records."""
        sid = str(op["sid"])
        floor = int(op.get("floor", -1))
        store = self._tiled_standby.setdefault(sid, {})
        acked: Dict[str, int] = {}
        for pay in op.get("chunks", []):
            c = _parse_chunk(pay["chunk"])
            hist = store.setdefault(c, {})
            hist[int(pay["epoch"])] = pay
            for e in [e for e in hist if e < floor and e != max(hist)]:
                del hist[e]
            while len(hist) > 4 * _SNAP_CAP:
                # Backstop only: the primary throttles at _SNAP_CAP, so a
                # healthy stream never gets here; evict loudly, never
                # silently (the evicted barrier can no longer promote).
                e = min(hist)
                del hist[e]
                print(
                    f"serve tiled: standby history overflow, evicting "
                    f"epoch {e} of {pay.get('sid')}:{c}",
                    flush=True,
                )
            acked[_chunk_key(*c)] = max(hist)
        return {"rid": rid, "ok": 1, "sid": sid, "acked": acked}

    def _tiled_promote(self, rid: int, op: dict) -> dict:
        """Worker-loss failover, resident-chunk edition: certify the
        standby payloads at the session's certified epoch and install
        them as resident chunks — this worker owns them from here on."""
        sid = str(op["sid"])
        C = int(op["epoch"])
        meta = op["meta"]
        store = self._tiled_standby.get(sid, {})
        installed: List[dict] = []
        failed: List[list] = []
        for c in (_parse_chunk(c) for c in op["chunks"]):
            pay = store.get(c, {}).get(C)
            if pay is None:
                failed.append(list(c))
                continue
            lanes = odigest.digest_payload_np(
                pay["state"],
                tuple(int(v) for v in pay["origin"]),
                int(pay["width"]),
            )
            if [int(lanes[0]), int(lanes[1])] != [
                int(v) for v in pay["digest"]
            ]:
                failed.append(list(c))
                continue
            cy, cx = c
            gy, gx = (int(v) for v in pay["origin"])
            th, tw = (int(v) for v in pay["shape"])
            chunk = _Chunk(
                sid, cy, cx, gy, gx, th, tw,
                int(meta["grid"][0]), int(meta["grid"][1]),
                int(meta["H"]), int(meta["W"]), str(meta["rule"]),
                int(meta["k"]), unpack_tile(pay["state"]), C,
            )
            self._resident[(sid, c)] = chunk
            with self._lock:
                chunk.snaps[C] = pay
                self._tiled_repl[(sid, c)] = {
                    "acked": -1, "sent": -1, "sent_t": 0.0,
                }
            store.pop(c, None)
            installed.append({
                "chunk": list(c), "epoch": C,
                "digest": [int(v) for v in pay["digest"]],
                "pop": int(pay.get("pop", 0)),
            })
        if not store:
            self._tiled_standby.pop(sid, None)
        self._resident_gauge()
        return {
            "rid": rid, "ok": 1, "sid": sid,
            "installed": installed, "failed": failed,
        }

    def _tiled_rollback(self, rid: int, op: dict) -> dict:
        """Survivor half of a tiled promotion: revert this worker's
        resident chunks of the session to their local snapshot at the
        certified epoch, cancel any stalled round (its halos died with
        the worker), and report the restored per-chunk digests."""
        sid = str(op["sid"])
        C = int(op["epoch"])
        for rk in [k for k in self._rounds if k[0] == sid]:
            rnd = self._rounds.pop(rk)
            self._push(_err_entry(
                rnd.rid,
                RuntimeError(f"round at {rk[1]} cancelled by rollback"),
            ))
        for bk in [k for k in self._halo_buf if k[0] == sid]:
            del self._halo_buf[bk]
        for ok_ in [k for k in self._halo_out if k[0] == sid]:
            del self._halo_out[ok_]
        restored: List[dict] = []
        missing: List[list] = []
        for (rsid, c), chunk in list(self._resident.items()):
            if rsid != sid:
                continue
            with self._lock:
                pay = chunk.snaps.get(C)
                if pay is not None:
                    for e in [e for e in chunk.snaps if e > C]:
                        del chunk.snaps[e]
            if pay is None:
                missing.append(list(c))
                continue
            chunk.board = unpack_tile(pay["state"])
            chunk.epoch = C
            chunk.pop = int(pay.get("pop", 0))
            restored.append({
                "chunk": list(c), "epoch": C,
                "digest": [int(v) for v in pay["digest"]],
                "pop": chunk.pop,
            })
        return {
            "rid": rid, "ok": 1, "sid": sid,
            "restored": restored, "missing": missing,
        }

    # -- shard migration (worker side) ---------------------------------------

    def _shard_sids(self, msg: dict) -> List[str]:
        """The sid set a commit/abort acts on: the frontend's explicit
        list when present (a commit carries the exact exported set; the
        ghost-cleanup drop at a destination names adopted sids), else the
        set THIS worker froze at prepare."""
        shard = int(msg["shard"])
        remembered = self._shard_frozen.pop(shard, [])
        if "sids" in msg:
            return [str(s) for s in msg["sids"]]
        return remembered

    def _on_prepare(self, msg: dict) -> None:
        """Freeze → run admitted jobs dry → export digest-stamped.  The
        freeze set is computed HERE, by hash over the sessions actually
        resident when the prepare executes — the executor has already run
        every op frame that preceded it on the wire, so a create routed
        before the migration was planned is included; a frontend snapshot
        could not promise that.  A freeze that cannot go idle in time
        reports the failure instead of exporting a snapshot an in-flight
        write-back could invalidate."""
        import time

        shard = int(msg["shard"])
        seq = int(msg["seq"])
        sids = [
            doc["id"]
            for doc in self.router.list()
            if shard_of(doc["id"], self.n_shards) == shard
        ]
        self._shard_frozen[shard] = sids
        self.router.freeze_sessions(sids)
        reply: dict = {"type": P.SHARD_STATE, "shard": shard, "seq": seq}
        t0 = time.monotonic()
        idle = self.router.wait_idle(sids)
        t1 = time.monotonic()
        # Port-only fields, the worker's half of the move's split (a JAX
        # frontend reads neither).
        reply["freeze_wait_s"] = round(t1 - t0, 6)
        if not idle:
            # Unfreeze here too: the frontend will abort, but its abort
            # frame could race a crash — never leave sessions frozen on a
            # failure the worker itself detected.
            self.router.unfreeze_sessions(sids)
            reply["error"] = "freeze timeout (jobs still in flight)"
            reply["sessions"] = []
        else:
            reply["sessions"] = self.router.export_sessions(sids)
            reply["export_s"] = round(time.monotonic() - t1, 6)
        try:
            self._send(reply)
        except (OSError, ValueError):
            # Dead control channel: the worker is leaving anyway; the
            # frontend's member-loss path owns the outcome.
            self.router.unfreeze_sessions(sids)

    # -- session replication (replica half: standby install + promotion) -----

    def _replicate_op(self, rid: int, op: dict) -> dict:
        """Install/refresh standby copies for one shard (idempotent —
        re-delivered frames after a lost ack just overwrite), drop
        deleted sids, and ack each installed session's epoch — the
        watermark the frontend records and relays to the primary."""
        shard = int(op["shard"])
        store = self._standby.setdefault(shard, {})
        acked: Dict[str, int] = {}
        for pay in op.get("sessions", []):
            sid = str(pay["sid"])
            cur = store.get(sid)
            if cur is None or int(pay["epoch"]) >= int(cur["epoch"]):
                # Never step a standby copy BACKWARD: a reordered/
                # retransmitted older snapshot must not undo a newer one.
                store[sid] = pay
            acked[sid] = int(store[sid]["epoch"])
        for sid in op.get("deleted", []):
            store.pop(str(sid), None)
        if not store:
            self._standby.pop(shard, None)
        return {"rid": rid, "ok": 1, "shard": shard, "acked": acked}

    def _promote_op(self, rid: int, op: dict) -> dict:
        """Worker loss failover: certify this shard's standby payloads
        against their streamed digest lanes and install the good ones
        into the router — this worker is the shard's primary from here
        on.  A corrupt payload is refused per-session (reported in
        ``failed``), never installed with a wrong digest."""
        shard = int(op["shard"])
        store = self._standby.pop(shard, {})
        good: List[dict] = []
        installed: List[dict] = []
        failed: List[str] = []
        for sid, pay in sorted(store.items()):
            lanes = odigest.digest_payload_np(
                pay["state"], (0, 0), int(pay["width"])
            )
            if [int(lanes[0]), int(lanes[1])] == [
                int(v) for v in pay["digest"]
            ]:
                good.append(pay)
            else:
                failed.append(sid)
        self.router.import_sessions(good)
        for pay in good:
            installed.append({
                "sid": pay["sid"],
                "epoch": int(pay["epoch"]),
                "digest": [int(v) for v in pay["digest"]],
            })
        return {
            "rid": rid, "ok": 1, "shard": shard,
            "installed": installed, "failed": failed,
        }

    # -- session replication (primary half: the watermark stream) ------------

    def _on_replicate_ack(self, msg: dict) -> None:
        """The frontend's watermark/park/reset frame, on the op FIFO."""
        shard = int(msg["shard"])
        with self._lock:
            if msg.get("reset"):
                # Replica reassigned (loss, drain re-home, promotion):
                # everything the OLD replica acked is gone — stream the
                # shard from scratch.
                self._repl_parked.discard(shard)
                for sid in list(self._repl_state):
                    if shard_of(sid, self.n_shards) == shard:
                        del self._repl_state[sid]
                return
            if msg.get("parked"):
                # No replica placeable (single-copy mode): stop paying
                # bandwidth for a stream nobody stores; a reset unparks.
                self._repl_parked.add(shard)
                return
            for sid, epoch in dict(msg.get("acked", {})).items():
                st = self._repl_state.get(str(sid))
                if st is not None:
                    st["acked"] = max(st["acked"], int(epoch))
            # Resident tiled chunks share the frame: per-chunk snapshot
            # watermarks, the certified floor (prunes local history), and
            # per-session park/reset arms.
            for sid, by_chunk in dict(msg.get("tiled_acked", {})).items():
                for ck, epoch in dict(by_chunk).items():
                    st = self._tiled_repl.get((str(sid), _parse_chunk(ck)))
                    if st is not None:
                        st["acked"] = max(st["acked"], int(epoch))
            for sid in msg.get("tiled_parked", []):
                self._tiled_parked.add(str(sid))
            for sid, chunks in dict(msg.get("tiled_reset", {})).items():
                self._tiled_parked.discard(str(sid))
                for ck in chunks:
                    st = self._tiled_repl.get((str(sid), _parse_chunk(ck)))
                    if st is not None:
                        st.update(acked=-1, sent=-1, sent_t=0.0)

    def _repl_loop(self) -> None:
        """The primary's stream pass: every interval, export sessions
        dirty past the watermark (cadence-due, never-acked, or idle —
        unchanged since the last pass, so convergence is exact once
        traffic stops) and ship them grouped per shard.  Watermarks only
        advance on ack; anything unacked past REPL_ACK_TIMEOUT_S
        retransmits."""
        import time

        _pin(self.device)
        while True:
            with self._lock:
                if self._stopped:
                    return
            time.sleep(self._repl_interval_s)
            try:
                by_shard = self._repl_pass(time.monotonic())
            except Exception as e:  # noqa: BLE001 — replication is a
                # background best-effort stream; a pass failure must never
                # kill the thread (the next pass retransmits)
                print(f"serve replication pass failed: {e!r}", flush=True)
                continue
            for shard, sessions in sorted(by_shard.items()):
                try:
                    self._send({
                        "type": P.SHARD_REPLICATE,
                        "shard": shard,
                        "sessions": sessions,
                    })
                except (OSError, ValueError):
                    return  # dead control channel: the worker is leaving
            tiled = self._tiled_repl_pass(time.monotonic())
            if tiled:
                try:
                    self._send({"type": P.SHARD_REPLICATE, "tiled": tiled})
                except (OSError, ValueError):
                    return

    def _repl_pass(self, now: float) -> Dict[int, List[dict]]:
        """One pass: pick the dirty-and-due sids, export, mark sent."""
        docs = self.router.list()
        with self._lock:
            live = {d["id"] for d in docs}
            for sid in list(self._repl_state):
                if sid not in live:
                    del self._repl_state[sid]
            due: List[str] = []
            for doc in docs:
                sid, epoch = doc["id"], int(doc["epoch"])
                shard = shard_of(sid, self.n_shards)
                st = self._repl_state.setdefault(
                    sid, {"acked": -1, "sent": -1, "sent_t": 0.0, "seen": -1}
                )
                seen, st["seen"] = st["seen"], epoch
                if shard in self._repl_parked or epoch <= st["acked"]:
                    continue
                cadence_due = (
                    st["acked"] < 0
                    or epoch - st["acked"] >= self._repl_every
                    or epoch == seen  # idle flush: dirty, not advancing
                )
                awaiting = (
                    st["sent"] >= epoch
                    and now - st["sent_t"] < self._ack_timeout_s
                )
                if cadence_due and not awaiting:
                    due.append(sid)
                    st["sent"] = epoch
                    st["sent_t"] = now
        by_shard: Dict[int, List[dict]] = {}
        for pay in self.router.export_sessions(due):
            by_shard.setdefault(
                shard_of(pay["sid"], self.n_shards), []
            ).append(pay)
        return by_shard

    def _tiled_repl_pass(self, now: float) -> List[dict]:
        """The resident-chunk half of a stream pass: ship every snapshot
        past the acked watermark (oldest first, so acks advance in
        barrier order), honoring the per-session park set and the same
        ack-timeout retransmit contract as sessions."""
        out: List[dict] = []
        with self._lock:
            for (sid, c), st in self._tiled_repl.items():
                if sid in self._tiled_parked:
                    continue
                chunk = self._resident.get((sid, c))
                if chunk is None:
                    continue
                due = sorted(e for e in chunk.snaps if e > st["acked"])
                if not due:
                    continue
                if (
                    st["sent"] >= due[-1]
                    and now - st["sent_t"] < self._ack_timeout_s
                ):
                    continue
                out.extend(chunk.snaps[e] for e in due)
                st["sent"] = due[-1]
                st["sent_t"] = now
        return out

    # -- reply coalescer ------------------------------------------------------

    def _push(self, entry: dict) -> None:
        with self._lock:
            if self._stopped:
                return
            self._results.append(entry)
            self._work.notify_all()

    def _reply_loop(self) -> None:
        while True:
            with self._lock:
                while not self._stopped and not self._results:
                    self._work.wait(timeout=0.25)
                if self._stopped:
                    return
            # One frame per flush: results that accumulate while this
            # send is on the wire coalesce into the next frame.
            with self._reply_lock:
                with self._lock:
                    batch, self._results = self._results, []
                if not batch:
                    continue  # discarded by a re-home meanwhile
                try:
                    self._send({"type": P.SERVE_RESULT, "results": batch})
                except (OSError, ValueError):
                    # Dead control channel — nothing to answer to; the
                    # frontend's member-loss path fails the in-flight ops.
                    return

    def close(self) -> None:
        with self._lock:
            self._stopped = True
            self._work.notify_all()
        self.router.close()
