"""Session table + job queue: the router that feeds the batched engine.

One :class:`SessionRouter` owns every tenant board in the process: a
session table (tenant id, rule, seed, epoch, idle-TTL eviction), a bounded
job queue, and a ticker thread that drains the queue in **ticks** — each
tick groups pending step jobs by size class, pads them into one
``[B, C, C]`` stack, and advances the whole group in ONE device program
(:mod:`akka_game_of_life_tpu_torch.serve.batch`), scattering boards, epochs, and
per-board digest lanes back into the table.

Admission control is enforced at the table edge, never inside the engine,
and always answers instead of wedging:

- ``serve_max_sessions`` — session-count cap (per process);
- ``serve_max_cells``    — aggregate live-cell budget across sessions (the
  batch-memory resource a count cap alone cannot bound);
- ``serve_queue_depth``  — pending-job bound; a full queue REJECTS the new
  job (the caller's 429 + retry) rather than dropping a queued one —
  dropping would lose a request whose client is already blocked on it;
- ``serve_max_steps``    — per-request epoch bound for QUEUED jobs (the
  scan length is the ticker's unit of fairness); beyond it, XOR-linear
  rule sessions answer through the O(log T) fast-forward path
  (``ops/fastforward.py``) and everything else is refused ``max_steps``.

Rejections raise :class:`AdmissionError` with a machine-readable
``reason`` (the HTTP layer maps it to 429 and the reason rides the
``gol_serve_rejects_total{reason}`` counter).  Boards live host-side as
plain uint8 arrays between ticks — sessions are small by design (the size
classes top out well below the single-board kernels' territory), and the
host copy is what GET returns without touching the device.

Counterpart of ``akka_game_of_life_tpu/serve/sessions.py``, the same
router with ``device`` threaded through to the batched step
(``serve/batch.py``), the memo plane and the fast-forward: ``cuda`` unless
the caller names the CPU, and a router that wants CUDA without a card
raises at construction (nothing steps on the CPU because no card was
found).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.obs import get_registry
from akka_game_of_life_tpu_torch.obs.tracing import get_tracer
from akka_game_of_life_tpu_torch.ops import digest as odigest, fastforward
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule
from akka_game_of_life_tpu_torch.runtime.wire import pack_tile, unpack_tile
from akka_game_of_life_tpu_torch.serve import batch as sbatch
from akka_game_of_life_tpu_torch.utils.patterns import random_grid

# A step request abandoned by the engine (ticker died, close() raced) must
# never block its client thread forever; this is the server-side bound on
# one job's queue wait + batch run.
JOB_TIMEOUT_S = 120.0
# After JOB_TIMEOUT_S, a job still IN the queue is cancelled (removed —
# guaranteed never applied, the client's retry is safe); a job already
# riding a launched batch gets this much extra grace to land, because its
# write-back cannot be recalled.
JOB_GRACE_S = 60.0

# Bound on CONCURRENT fast-forward jumps (the linear-rule step fast path
# runs on caller threads, not the ticker): each jump is milliseconds on
# serve-class boards, but without a cap N simultaneous over-bound requests
# would run N certify+jump computations at once and starve the ticker's
# CPU — the very monopolization the max_steps bound exists to prevent.
# Over-limit requests get the retryable 429 (reason queue_full), never a
# wedge.
FF_MAX_CONCURRENT = 8

# Tenant ids label metrics (gol_serve_*{tenant=...}); they must be short
# and tame or a client could mint unbounded exposition series from junk.
_TENANT_MAX = 64
_TENANT_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._:-"
)


class AdmissionError(Exception):
    """A request refused by admission control (HTTP 429).  ``reason`` is
    machine-readable: ``max_sessions`` | ``max_cells`` | ``queue_full`` |
    ``draining`` | ``max_steps`` (a step request beyond ``serve_max_steps``
    for a session whose rule cannot fast-forward — linear-rule sessions
    bypass the bound via the O(log T) fast path instead) | ``migrating``
    (the session's shard is mid-migration on the cluster plane — always
    retryable; the cluster frontend holds such ops and replays them at the
    shard's new owner, so tenants never see this reason) | ``failover``
    (the session's shard is mid-promotion after its worker died — always
    retryable: the board provably resumes at its last replicated epoch,
    and the retry lands at the promoted replica)."""

    def __init__(self, reason: str, detail: str, trace_link=None) -> None:
        super().__init__(detail)
        self.reason = reason
        # Optional causal pointer: the trace ctx (trace_id/span_id dict) of
        # the span that CAUSED this rejection — a failover 429 links to the
        # serve.promote span it is waiting on, so the 429'd request's trace
        # clicks through to the promotion.
        self.trace_link = trace_link


def shard_of(sid: str, n_shards: int) -> int:
    """Stable session-shard hash (crc32 — identical across processes and
    restarts).  Lives here because BOTH halves of the cluster serve plane
    route by it: the frontend picks owners, and a worker answering
    SHARD_PREPARE recomputes its OWN resident membership for the shard
    (the authoritative freeze set — a frontend-snapshotted sid list could
    miss a create that was in flight when the migration was planned)."""
    import zlib

    return zlib.crc32(sid.encode("utf-8")) % n_shards


def rendezvous_pick(key: str, names):
    """Highest-random-weight pick: the name maximizing crc32(f"{key}:{n}")
    (name as the deterministic tiebreak).  The ONE placement function
    behind shard replicas, tiled-chunk replicas, and the federation's
    shard→frontend slice map — a membership change re-homes only the keys
    that must move, never ~all of them the way a modulo ring would.
    Returns None on an empty candidate pool."""
    import zlib

    pool = list(names)
    if not pool:
        return None
    return max(
        pool, key=lambda n: (zlib.crc32(f"{key}:{n}".encode("utf-8")), n)
    )


def validate_create(tenant, rule, height: int, width: int, density: float):
    """Shared create-request validation (raises ValueError, the HTTP
    400); returns the resolved Rule.  ONE implementation on purpose: the
    single-process router and the cluster plane must accept exactly the
    same requests, or the two surfaces drift."""
    tenant = str(tenant)
    if not tenant or len(tenant) > _TENANT_MAX or not (
        set(tenant) <= _TENANT_OK
    ):
        raise ValueError(
            f"tenant must be 1..{_TENANT_MAX} chars of [A-Za-z0-9._:-] "
            f"(it labels metrics), got {tenant!r}"
        )
    rule_r = resolve_rule(rule)
    sbatch.rule_operands(rule_r)  # totalistic-only; raises ValueError
    if height < 1 or width < 1:
        raise ValueError(f"board must be positive, got {height}x{width}")
    if not (0.0 <= density <= 1.0):
        raise ValueError(f"density {density} must be in [0, 1]")
    return rule_r


@dataclasses.dataclass
class Session:
    """One tenant board and its serving state."""

    sid: str
    tenant: str
    rule: Rule
    height: int
    width: int
    seed: int
    density: float
    board: np.ndarray  # (height, width) uint8, host-side
    lanes: np.ndarray  # (2,) uint32 digest lanes of `board`
    population: int = 0  # live (state 1) cells of `board`, kept in lockstep
    epoch: int = 0
    created: float = 0.0
    last_used: float = 0.0
    # Per-session memo-plane state (serve/memo.py), lazily attached by the
    # engine; None when the plane is off or the session never qualified.
    # Deliberately NOT exported/imported: a migrated or promoted session
    # restarts with fresh adaptive state against its new router's cache.
    memo: Optional[object] = None

    @property
    def digest(self) -> int:
        return odigest.value(self.lanes)

    def snapshot(self, *, with_board: bool = True) -> dict:
        """The GET document (board copied so a caller can't mutate the
        table's array).  ``with_board=False`` skips the O(h·w) copy for
        summary paths — list() runs under the router lock, and touching
        every board there would stall the ticker for all tenants
        (``population`` is cached at create/write-back for the same
        reason, never scanned here)."""
        doc = {
            "id": self.sid,
            "tenant": self.tenant,
            "rule": self.rule.rulestring(),
            "height": self.height,
            "width": self.width,
            "seed": self.seed,
            "epoch": self.epoch,
            "population": self.population,
            "digest": odigest.format_digest(self.digest),
        }
        if with_board:
            doc["board"] = self.board.copy()
        return doc


@dataclasses.dataclass
class _Job:
    sid: str
    steps: int
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[Tuple[int, int]] = None  # (epoch, digest)
    error: Optional[BaseException] = None
    # Completion callback for async submitters (the cluster serve worker
    # plane coalesces results back onto the wire instead of blocking a
    # thread per job).  Fired exactly once, after result/error is set and
    # ``done`` fires, never under the router lock.
    on_done: Optional[Callable[["_Job"], None]] = None
    # Queue accounting for the SLO plane: enqueue time (monotonic) stamped
    # at submit, queue wait stamped when the ticker takes the job for a
    # batch — the "how long did admission hold this" half of latency.
    t_enq: float = 0.0
    queue_wait_s: float = 0.0


class SessionRouter:
    """The multi-tenant serving engine: session table + job queue + ticker.

    Thread-safe; constructed from a :class:`SimulationConfig`'s ``serve_*``
    knobs (every knob has a ``--serve-*`` flag —
    ``tools/check_serve_config.py`` lint-enforces the bijection).  The
    ``clock`` injection point exists for TTL tests; ``pause()``/``resume()``
    hold the ticker between batches — the deterministic way to fill the
    queue in backpressure drills (bench_serve's 429 drill)."""

    def __init__(
        self,
        config=None,
        *,
        registry=None,
        tracer=None,
        events=None,
        clock=time.monotonic,
        device="cuda",
    ) -> None:
        from akka_game_of_life_tpu_torch.runtime.simulation import resolve_device

        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The constructing thread's card, by index: the tick thread pins it.
            self.device = torch.device("cuda", torch.cuda.current_device())
        if config is None:
            from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig

            config = SimulationConfig()
        self.config = config
        self.max_sessions = config.serve_max_sessions
        self.max_cells = config.serve_max_cells
        self.queue_depth = config.serve_queue_depth
        self.max_steps = config.serve_max_steps
        self.tick_s = config.serve_tick_s
        self.ttl_s = config.serve_ttl_s
        self.size_classes = sbatch.parse_size_classes(
            config.serve_size_classes
        )
        self.metrics = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self._clock = clock
        # Hot-path instruments resolved once (lookup takes the registry
        # lock); per-tenant children minted on demand.
        self._m_sessions = self.metrics.gauge(
            "gol_serve_sessions", labelnames=("tenant",)
        )
        self._m_cells = self.metrics.gauge("gol_serve_cells")
        self._m_creates = self.metrics.counter(
            "gol_serve_session_creates_total", labelnames=("tenant",)
        )
        self._m_evictions = self.metrics.counter(
            "gol_serve_session_evictions_total"
        )
        self._m_steps = self.metrics.counter(
            "gol_serve_steps_total", labelnames=("tenant",)
        )
        self._m_rejects = self.metrics.counter(
            "gol_serve_rejects_total", labelnames=("reason",)
        )
        self._m_queue = self.metrics.gauge("gol_serve_queue_depth")
        self._m_ff = self.metrics.counter("gol_serve_ff_jumps_total")
        self._m_ff_retries = self.metrics.counter(
            "gol_serve_ff_jump_retries_total"
        )
        self._m_digest_mismatch = self.metrics.counter(
            "gol_digest_mismatches_total"
        )
        self._ff_slots = threading.BoundedSemaphore(FF_MAX_CONCURRENT)
        # Buckets passed explicitly (count-scale, not latency-scale): the
        # registry may be a plain MetricsRegistry without the catalog
        # installed, and _get_or_create would not flag the mismatch.
        from akka_game_of_life_tpu_torch.obs.catalog import RING_BATCH_BUCKETS

        self._m_batch = self.metrics.histogram(
            "gol_serve_batch_boards", buckets=RING_BATCH_BUCKETS
        )
        self._m_tick = self.metrics.histogram("gol_serve_tick_seconds")
        self._m_req = self.metrics.histogram("gol_serve_step_seconds")

        # Cross-tenant memoized macro-stepping (serve/memo.py): one engine
        # + content-addressed cache per router, feeding every tenant.
        self._memo = None
        if getattr(config, "serve_memo", False):
            from akka_game_of_life_tpu_torch.serve.memo import MemoEngine

            self._memo = MemoEngine(
                config,
                registry=self.metrics,
                tracer=self.tracer,
                events=events,
                size_classes=self.size_classes,
                device=self.device,
            )

        # Drill hook (None in production): called between a fast-forward
        # jump's compute and its commit attempt, so tests can provoke the
        # optimistic-commit retry deterministically (pause the ticker, queue
        # a batch job, let it land inside this window — the blocked-batch
        # drill that certifies gol_serve_ff_jump_retries_total).
        self._drill_ff_precommit: Optional[Callable[[], None]] = None
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._sessions: Dict[str, Session] = {}  # graftlint: guarded-by _lock
        self._cells = 0  # graftlint: guarded-by _lock
        self._queue: deque = deque()  # graftlint: guarded-by _lock
        self._ids = itertools.count(1)
        # Sessions frozen by an in-flight shard migration: present (GETs
        # still answer) but refusing writes with the retryable "migrating"
        # reason, exempt from TTL eviction, until commit drops them or
        # abort unfreezes them.
        self._frozen: set = set()  # graftlint: guarded-by _lock
        # sids of jobs the ticker has taken for the CURRENT batch (between
        # queue drain and scatter-back) — what wait_idle must see beyond
        # the queue, or an export could snapshot a board whose in-flight
        # write-back lands after the transfer and is silently lost.
        self._inflight_sids: set = set()  # graftlint: guarded-by _lock
        self._paused = False  # graftlint: guarded-by _lock
        self._draining = False  # graftlint: guarded-by _lock
        self._stopped = False  # graftlint: guarded-by _lock
        self._ticker = threading.Thread(
            target=self._tick_loop, daemon=True, name="serve-ticker"
        )
        self._ticker.start()

    # -- session lifecycle ---------------------------------------------------

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
        """Admit a new session and seed its board.  Raises ValueError for a
        malformed request (the HTTP 400), AdmissionError when a capacity
        cap refuses it (the HTTP 429).  ``with_board=False`` skips the
        returned doc's O(h·w) board copy — the HTTP 201 deliberately
        carries no cells.  ``sid`` overrides the locally minted id: the
        cluster frontend allocates ids itself (the id's hash picks the
        shard, so the router must honor the id that routed here)."""
        tenant = str(tenant)
        rule = validate_create(tenant, rule, height, width, density)
        if sbatch.size_class(height, width, self.size_classes) is None:
            raise ValueError(
                f"board {height}x{width} exceeds the largest size class "
                f"({self.size_classes[-1]}); this plane serves small "
                f"boards — run big ones standalone"
            )
        # Admission is checked BEFORE the O(h·w) board generation so a
        # saturated plane sheds rejected creates cheaply (429 is the
        # overload path), then re-checked at insert — the lock is released
        # in between and a racing create may have taken the last slot.
        with self._lock:
            self._admit_locked(height, width)
        board = random_grid((height, width), density=density, seed=seed)
        lanes = odigest.digest_dense_np(board)
        population = int((board == 1).sum())
        with self._lock:
            self._admit_locked(height, width)
            if sid is not None and sid in self._sessions:
                raise ValueError(f"session id {sid!r} already exists")
            now = self._clock()
            sess = Session(
                sid=sid if sid is not None else f"b{next(self._ids):08x}",
                tenant=tenant,
                rule=rule,
                height=height,
                width=width,
                seed=seed,
                density=density,
                board=board,
                lanes=lanes,
                population=population,
                created=now,
                last_used=now,
            )
            self._sessions[sess.sid] = sess
            self._cells += height * width
            self._m_cells.set(self._cells)
            self._m_sessions.labels(tenant=sess.tenant).inc()
            self._m_creates.labels(tenant=sess.tenant).inc()
        # Snapshot OUTSIDE the lock: nobody can step this session before
        # its id is returned, and the O(h·w) board copy must not stall
        # the ticker or concurrent requests.
        return sess.snapshot(with_board=with_board)

    def get(self, sid: str) -> dict:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                raise KeyError(sid)
            sess.last_used = self._clock()
            return sess.snapshot()

    def list(self) -> List[dict]:
        with self._lock:
            return [
                sess.snapshot(with_board=False)
                for sess in self._sessions.values()
            ]

    def delete(self, sid: str) -> None:
        with self._lock:
            if sid in self._frozen:
                # A delete that raced a shard migration: the authoritative
                # copy is in flight — the cluster plane retries it at the
                # shard's post-commit owner.
                self._reject(
                    "migrating",
                    f"session {sid} is mid-shard-migration; retry",
                )
            self._drop_locked(sid, evicted=False)

    def _drop_locked(self, sid: str, *, evicted: bool) -> None:
        """Remove a session (lock held).  An in-flight step job for it
        completes against the ticker's snapshot and its write-back is
        skipped — the client still gets the stepped result."""
        sess = self._sessions.pop(sid, None)
        if sess is None:
            raise KeyError(sid)
        self._cells -= sess.height * sess.width
        self._m_cells.set(self._cells)
        self._m_sessions.labels(tenant=sess.tenant).dec()
        if not any(
            s.tenant == sess.tenant for s in self._sessions.values()
        ):
            # Last session of this tenant: reclaim its metric children, or
            # a create/delete loop over fresh tenant strings would grow
            # the exposition without bound.
            memo_insts = (
                self._memo.tenant_instruments if self._memo is not None else ()
            )
            for inst in (
                self._m_sessions, self._m_creates, self._m_steps,
            ) + memo_insts:
                inst.remove(tenant=sess.tenant)
        if evicted:
            self._m_evictions.inc()

    def _reject(self, reason: str, detail: str) -> None:
        self._m_rejects.labels(reason=reason).inc()
        raise AdmissionError(reason, detail)

    def _admit_locked(self, height: int, width: int) -> None:
        """The create-side admission gate (lock held): closed router,
        drain, session cap, cell budget — raising instead of wedging."""
        if self._stopped:
            raise RuntimeError("router is closed")
        if self._draining:
            self._reject("draining", "router is draining for shutdown")
        if len(self._sessions) >= self.max_sessions:
            self._reject(
                "max_sessions",
                f"session cap {self.max_sessions} reached",
            )
        if self._cells + height * width > self.max_cells:
            self._reject(
                "max_cells",
                f"cell budget {self.max_cells} would be exceeded "
                f"({self._cells} in use, {height * width} asked)",
            )

    # -- stepping ------------------------------------------------------------

    def submit(
        self,
        sid: str,
        steps: int = 1,
        on_done: Optional[Callable[[_Job], None]] = None,
    ) -> _Job:
        """Admit one step request and return its job handle WITHOUT
        blocking on the result — the async half of :meth:`step`.  The
        cluster serve worker plane submits every step of a coalesced
        SERVE_OPS frame this way and lets ``on_done`` route completions
        back onto the wire instead of parking one thread per job.

        Admission refusals (AdmissionError/KeyError/ValueError/
        RuntimeError) raise synchronously — the request never became a
        job.  An over-bound linear-rule request runs the O(log T)
        fast-forward path INLINE on the calling thread (milliseconds on
        serve-class boards) and returns an already-completed job whose
        ``error`` carries any jump failure."""
        if steps < 1:
            raise ValueError(f"steps {steps} must be >= 1")
        if int(steps).bit_length() > fastforward.MAX_SPAN_BITS:
            # A 400, not an admission question: beyond the span ceiling
            # even the fast path refuses (its per-jump program count is
            # bounded by the span's bit length — the DoS guard).
            raise ValueError(
                f"steps {steps} exceeds the fast-forward span ceiling "
                f"(2^{fastforward.MAX_SPAN_BITS})"
            )
        with self._lock:
            if self._stopped:
                # The ticker is gone: enqueueing would strand the caller
                # on JOB_TIMEOUT_S; fail now like create() does.
                raise RuntimeError("router is closed")
            sess = self._sessions.get(sid)
            if sess is None:
                # Looked up BEFORE the drain gate: an unknown id is a
                # terminal 404, not a retryable 429.
                raise KeyError(sid)
            if sid in self._frozen:
                self._reject(
                    "migrating",
                    f"session {sid} is mid-shard-migration; retry",
                )
            if self._draining:
                self._reject("draining", "router is draining for shutdown")
            fast = steps > self.max_steps
            if fast:
                linear = sess.rule.is_linear
                if not linear or not self.config.ff_enabled:
                    why = (
                        "fast-forward is disabled (ff_enabled=False)"
                        if linear
                        else f"rule {sess.rule} is not XOR-linear"
                    )
                    self._reject(
                        "max_steps",
                        f"steps {steps} over serve_max_steps="
                        f"{self.max_steps} and {why}; bound the request "
                        f"(the scan length is the ticker's unit of "
                        f"fairness) or use a linear rule",
                    )
            else:
                if len(self._queue) >= self.queue_depth:
                    self._reject(
                        "queue_full",
                        f"step queue depth {self.queue_depth} reached",
                    )
                sess.last_used = self._clock()
                job = _Job(
                    sid=sid, steps=steps, on_done=on_done,
                    t_enq=self._clock(),
                )
                self._queue.append(job)
                self._m_queue.set(len(self._queue))
                self._wake.notify_all()
                return job
        # Fast path, inline: bypasses the ticker queue, so queue_depth
        # cannot bound it — the slot cap does, with the same retryable
        # 429 contract.
        if not self._ff_slots.acquire(blocking=False):
            self._reject(
                "queue_full",
                f"fast-forward concurrency bound "
                f"({FF_MAX_CONCURRENT}) reached; retry",
            )
        job = _Job(sid=sid, steps=steps, on_done=on_done)
        try:
            job.result = self._fast_forward_step(sess, steps)
        except BaseException as e:  # noqa: BLE001 — carried to the waiter
            job.error = e
        finally:
            self._ff_slots.release()
        self._finish(job)
        return job

    def step(self, sid: str, steps: int = 1) -> Tuple[int, int]:
        """Advance a session by ``steps`` epochs; blocks until the batch
        that carried the job lands.  Returns (epoch, digest).  Raises
        KeyError (404), ValueError (400), AdmissionError (429).

        ``steps`` beyond ``serve_max_steps`` is an *admission* question,
        not a validity one: an XOR-linear rule session takes the O(log T)
        fast-forward path (``ops/fastforward.py`` — answers n=1,000,000
        in milliseconds instead of queueing 10⁶ ticks), everything else
        is refused 429 ``max_steps`` so one giant request can never
        monopolize the ticker for every other tenant."""
        t0 = time.perf_counter()
        job = self.submit(sid, steps)
        if not job.done.wait(JOB_TIMEOUT_S):
            with self._lock:
                try:
                    self._queue.remove(job)
                    cancelled = True
                    self._m_queue.set(len(self._queue))
                except ValueError:
                    cancelled = False
            if cancelled:
                # Still queued → removed before any batch saw it: the
                # board did NOT advance, a client retry is safe.
                raise TimeoutError(
                    f"step job for {sid} timed out in queue (cancelled; "
                    f"board not advanced)"
                )
            # Already riding a launched batch: its write-back cannot be
            # recalled, so give it bounded grace to land rather than
            # reporting failure for epochs that WILL apply.
            if not job.done.wait(JOB_GRACE_S):
                raise TimeoutError(f"step job for {sid} timed out mid-batch")
        if job.error is not None:
            raise job.error
        self._m_req.observe(time.perf_counter() - t0)
        # Hand the measured queue wait up to the HTTP edge's SLO line
        # (same thread: step() blocks the request thread on the job).
        from akka_game_of_life_tpu_torch.obs import slo as _slo

        _slo.note_queue_wait(job.queue_wait_s if job.t_enq else None)
        return job.result

    def tenant_of(self, sid: str) -> Optional[str]:
        """The owning tenant, or None for an unknown id — the cheap
        attribution lookup the SLO access log uses (never raises)."""
        with self._lock:
            sess = self._sessions.get(sid)
            return sess.tenant if sess is not None else None

    def _finish(self, job: _Job) -> None:
        """Fire a job's completion — the done event, then the async
        callback.  Called with result/error already assigned and NEVER
        under the router lock (callbacks enqueue wire replies and must not
        serialize behind, or deadlock against, table operations)."""
        job.done.set()
        if job.on_done is not None:
            try:
                job.on_done(job)
            except Exception:  # noqa: BLE001 — a callback bug must not kill the ticker
                pass

    def _fast_forward_step(self, sess: Session, steps: int) -> Tuple[int, int]:
        """The linear-rule fast path: jump ``steps`` epochs in O(log steps)
        device programs, bypassing the ticker queue entirely.

        The jump computes OUTSIDE every lock (holding the router lock
        across device work would starve all tenants) against a snapshot
        of (board, epoch); the write-back is an optimistic commit — if a
        concurrently queued batch job's scatter-back landed in between,
        the jump recomputes from the new state (bounded retries; jumps
        are milliseconds on serve-class boards, batches serialize one job
        per session per tick, so contention is rare and shrinking).  A
        session deleted mid-jump still gets its stepped result, like a
        mid-batch delete.  Each jump is jump-vs-iterate digest-certified
        on a ``ff_certify_steps`` sample before it commits."""
        for _ in range(8):
            with self._lock:
                if self._sessions.get(sess.sid) is not sess:
                    raise KeyError(sess.sid)
                board0, epoch0 = sess.board, sess.epoch
                sess.last_used = self._clock()
            cert = min(steps, self.config.ff_certify_steps)
            if cert:
                try:
                    fastforward.certify_jump(
                        torch.from_numpy(board0).to(self.device), sess.rule, cert
                    )
                except RuntimeError:
                    # The documented kernel-bug signal: same counter the
                    # Simulation surface ticks on jump-vs-iterate
                    # divergence, so serve-path math failures alert too.
                    self._m_digest_mismatch.inc()
                    raise
            out = fastforward.fast_forward_np(
                board0, sess.rule, steps, device=self.device
            )
            lanes = odigest.digest_dense_np(out)
            population = int((out == 1).sum())
            hook = self._drill_ff_precommit
            if hook is not None:
                # Deterministic interleave point for the retry drill: a
                # test parks here while a blocked batch's scatter-back
                # lands, then observes the commit race below.
                hook()
            with self._lock:
                if self._sessions.get(sess.sid) is not sess:
                    # Deleted mid-jump: the client still gets its result;
                    # the table write-back is skipped (the mid-batch
                    # delete contract).
                    return epoch0 + steps, odigest.value(lanes)
                if sess.board is board0 and sess.epoch == epoch0:
                    sess.board = out
                    sess.lanes = lanes
                    sess.population = population
                    sess.epoch = epoch0 + steps
                    sess.last_used = self._clock()
                    self._m_steps.labels(tenant=sess.tenant).inc(steps)
                    self._m_ff.inc()
                    return sess.epoch, odigest.value(lanes)
            # A batch write-back raced the commit: loop and recompute
            # from the session's new state.  Counted so the (rare, bounded)
            # recompute-on-race residue of the optimistic commit is
            # observable in production, not just documented.
            self._m_ff_retries.inc()
        raise TimeoutError(
            f"fast-forward for {sess.sid} kept losing the commit race to "
            f"batched step jobs; retry"
        )

    # -- drill hooks ---------------------------------------------------------

    def pause(self) -> None:
        """Hold the ticker between batches (jobs queue up; admission still
        answers).  The backpressure-drill hook — bench_serve and the tests
        use it to fill the queue deterministically."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        with self._lock:
            self._paused = False
            self._wake.notify_all()

    # -- shard migration (the cluster serve plane's worker half) -------------

    def freeze_sessions(self, sids) -> None:
        """Freeze sessions for an in-flight shard migration: writes refuse
        with the retryable ``migrating`` reason, TTL eviction skips them,
        reads still answer.  Unknown ids are ignored (already evicted —
        the export simply ships fewer sessions)."""
        with self._lock:
            self._frozen.update(s for s in sids if s in self._sessions)

    def wait_idle(self, sids, timeout: float = 10.0) -> bool:
        """The freeze barrier: block until no queued OR in-flight job
        references ``sids`` — admitted jobs complete (their write-backs
        belong in the exported state), new ones are already refused.
        Bounded by REAL time like :meth:`drain`, and for the same reason."""
        sids = set(sids)
        deadline = time.monotonic() + timeout  # graftlint: waive GL-HAZ04 -- pairs with the real time.sleep pacing below; a frozen injected test clock must not unbound migration
        while time.monotonic() < deadline:
            with self._lock:
                busy = self._inflight_sids | {j.sid for j in self._queue}
                if not (busy & sids):
                    return True
            time.sleep(0.01)
        return False

    def export_sessions(self, sids) -> List[dict]:
        """Snapshot sessions as self-contained wire payloads (``pack_tile``
        boards + digest lanes) — the TRANSFER half of a shard migration.
        Boards pack OUTSIDE the lock: writers only ever replace board
        references, and the sessions are frozen anyway."""
        with self._lock:
            rows = [
                (s, s.board, s.lanes)
                for s in (self._sessions.get(sid) for sid in sids)
                if s is not None
            ]
        return [
            {
                "sid": sess.sid,
                "tenant": sess.tenant,
                "rule": sess.rule.rulestring(),
                "height": sess.height,
                "width": sess.width,
                "seed": sess.seed,
                "density": sess.density,
                "epoch": sess.epoch,
                "population": sess.population,
                "state": pack_tile(board),
                "digest": [int(lanes[0]), int(lanes[1])],
            }
            for sess, board, lanes in rows
        ]

    def unfreeze_sessions(self, sids) -> None:
        """Roll a shard migration back: the sessions never left."""
        with self._lock:
            self._frozen.difference_update(sids)

    def drop_sessions(self, sids) -> None:
        """COMMIT: the shard's sessions now live on the destination —
        release them here (cells/gauges/tenant children), not as
        evictions."""
        with self._lock:
            for sid in sids:
                self._frozen.discard(sid)
                if sid in self._sessions:
                    self._drop_locked(sid, evicted=False)

    def import_sessions(self, payloads: List[dict]) -> None:
        """Install migrated sessions (the destination half of a shard
        move).  Deliberately bypasses the admission caps: cluster-wide
        admission is the frontend's budget, already charged when these
        sessions were created — a move must never bounce off the local
        backstop while both copies transiently exist."""
        rows = []
        for p in payloads:
            board = unpack_tile(p["state"])
            lanes = np.asarray(
                [int(p["digest"][0]), int(p["digest"][1])], dtype=np.uint32
            )
            rows.append((p, board, lanes, int((board == 1).sum())))
        with self._lock:
            if self._stopped:
                raise RuntimeError("router is closed")
            now = self._clock()
            for p, board, lanes, pop in rows:
                if p["sid"] in self._sessions:
                    # A re-delivered adopt (frontend retry): replace, never
                    # double-count.
                    self._drop_locked(p["sid"], evicted=False)
                sess = Session(
                    sid=p["sid"],
                    tenant=p["tenant"],
                    rule=resolve_rule(p["rule"]),
                    height=int(p["height"]),
                    width=int(p["width"]),
                    seed=int(p["seed"]),
                    density=float(p["density"]),
                    board=board,
                    lanes=lanes,
                    population=int(p.get("population", pop)),
                    epoch=int(p["epoch"]),
                    created=now,
                    last_used=now,
                )
                self._sessions[sess.sid] = sess
                self._cells += sess.height * sess.width
                self._m_cells.set(self._cells)
                self._m_sessions.labels(tenant=sess.tenant).inc()

    # -- the tick loop -------------------------------------------------------

    def _tick_loop(self) -> None:
        if self.device.type == "cuda":
            # This thread's current card is the router's own (a cluster
            # worker may run beside others on another card).
            torch.cuda.set_device(self.device)
        while True:
            with self._lock:
                while not self._stopped and (
                    self._paused or not self._queue
                ):
                    # Bounded wait so idle routers still sweep TTLs.
                    self._wake.wait(timeout=0.25)
                    if not self._paused:
                        self._evict_idle_locked()
                if self._stopped:
                    failed = self._fail_pending_locked(
                        RuntimeError("router closed")
                    )
                    taken = None
                else:
                    # Sweep here too: a router under sustained load never
                    # sits in the idle wait above.
                    self._evict_idle_locked()
                    taken, failed = self._take_jobs_locked()
                    self._inflight_sids = {j.sid for j in taken}
            for job in failed:
                self._finish(job)
            if taken is None:
                return
            if taken:
                t0 = time.perf_counter()
                try:
                    with self.tracer.span("serve.tick", jobs=len(taken)):
                        self._run_tick(taken)
                finally:
                    with self._lock:
                        self._inflight_sids = set()
                dt = time.perf_counter() - t0
                self._m_tick.observe(dt)
                if self.tick_s > 0 and dt < self.tick_s:
                    # Pacing floor: at most one batch launch per tick_s.
                    time.sleep(self.tick_s - dt)
            else:
                with self._lock:
                    self._inflight_sids = set()

    def _take_jobs_locked(self) -> Tuple[List[_Job], List[_Job]]:
        """Drain this tick's jobs: at most ONE job per session (a second
        pending step for the same board serializes into the next tick so
        each job's result is the state after exactly its own steps).
        Returns (taken, dead) — dead-session jobs carry their KeyError but
        are finished by the caller OUTSIDE the lock (callback discipline)."""
        taken: List[_Job] = []
        dead: List[_Job] = []
        rest: deque = deque()
        seen = set()
        now = self._clock()
        while self._queue:
            job = self._queue.popleft()
            if job.sid not in self._sessions:
                job.error = KeyError(job.sid)
                dead.append(job)
                continue
            if job.sid in seen:
                rest.append(job)
                continue
            seen.add(job.sid)
            if job.t_enq:
                job.queue_wait_s = max(0.0, now - job.t_enq)
            taken.append(job)
        self._queue = rest
        self._m_queue.set(len(self._queue))
        return taken, dead

    def _fail_pending_locked(self, err: BaseException) -> List[_Job]:
        """Error out every queued job; the caller fires completions
        outside the lock."""
        failed: List[_Job] = []
        while self._queue:
            job = self._queue.popleft()
            job.error = err
            failed.append(job)
        self._m_queue.set(0)
        return failed

    def _evict_idle_locked(self) -> None:
        if self.ttl_s <= 0:
            return
        now = self._clock()
        # A session with an ADMITTED queued job is never idle — evicting
        # it would 404 a client already blocked on that job, breaking the
        # "a queued job always completes" admission contract.  Frozen
        # sessions belong to an in-flight shard migration: their clock
        # stopped with their traffic, so the sweep must not race the
        # commit that is about to move them.
        busy = {job.sid for job in self._queue}
        for sid in [
            s.sid
            for s in self._sessions.values()
            if s.sid not in busy
            and s.sid not in self._frozen
            and now - s.last_used > self.ttl_s
        ]:
            self._drop_locked(sid, evicted=True)

    def _run_tick(self, jobs: List[_Job]) -> None:
        """Advance this tick's jobs: the memo phase first (macro-rounds of
        the Hashlife fast path for eligible jobs — serve/memo.py), then
        every job's dense remainder grouped by size class, one device
        program per group, results scattered back.  A failed batch fails
        its jobs, never the ticker."""
        snapshots: List[Tuple[_Job, Session, np.ndarray, int]] = []
        dead: List[_Job] = []
        with self._lock:
            for job in jobs:
                sess = self._sessions.get(job.sid)
                if sess is None:
                    job.error = KeyError(job.sid)
                    dead.append(job)
                    continue
                # Snapshot the board reference AND epoch: writers only
                # ever REPLACE session boards, so the references are
                # stable outside the lock — and the scatter-back commits
                # only if this exact snapshot is still the session state
                # (a fast-forward jump may land mid-batch).
                snapshots.append((job, sess, sess.board, sess.epoch))
        for job in dead:
            self._finish(job)
        if self._memo is not None:
            entries = self._memo_phase(snapshots)
        else:
            entries = [
                (job, sess, board, epoch0, job.steps)
                for job, sess, board, epoch0 in snapshots
            ]
        groups: Dict[
            int, List[Tuple[_Job, Session, np.ndarray, int, int]]
        ] = {}
        for entry in entries:
            sess = entry[1]
            cls = sbatch.size_class(
                sess.height, sess.width, self.size_classes
            )
            groups.setdefault(cls, []).append(entry)
        from akka_game_of_life_tpu_torch.obs.programs import get_programs

        programs = get_programs()
        before = programs.programs_total
        for cls, centries in sorted(groups.items()):
            try:
                self._run_class_batch(cls, centries)
            except Exception as e:  # noqa: BLE001 — jobs fail, ticker lives
                for job, _, _, _, _ in centries:
                    job.error = e
                    self._finish(job)
        if (
            snapshots
            and not programs.warm
            and programs.programs_total == before
        ):
            # A full tick advanced real jobs without compiling any new
            # program: the router's program set is its steady state.  Arm
            # the storm detector — from here on, a novel (class, length)
            # compile is a latency cliff worth an alert + flight dump.
            programs.mark_warm()

    def _memo_phase(
        self, snapshots: List[Tuple[_Job, Session, np.ndarray, int]]
    ) -> List[Tuple[_Job, Session, np.ndarray, int, int]]:
        """Run the tick's memo-eligible jobs through macro-rounds
        (serve/memo.py), commit what memoization carried, and return the
        dense entries — ``(job, sess, board, epoch0, nsteps)`` — that
        remain: passthroughs, remainders (steps % S), and the full jobs
        of tasks that advanced nothing.

        Commit discipline mirrors the batch scatter-back: a memoized
        board writes back only if the planned snapshot is still the
        session state; a raced task (a fast-forward jump landed, or the
        session was deleted mid-phase) keeps its memo progress for the
        CLIENT — its remainder entry carries the memoized board relative
        to the original snapshot — but the table write is skipped (the
        board-identity check in the dense scatter-back can never pass
        for it, since the memoized array reference was never published).
        """
        tasks, passthrough = self._memo.plan_tasks(snapshots)
        dense: List[Tuple[_Job, Session, np.ndarray, int, int]] = [
            (job, sess, board, epoch0, job.steps)
            for job, sess, board, epoch0 in passthrough
        ]
        if not tasks:
            return dense
        try:
            with self.tracer.span("serve.memo", tasks=len(tasks)):
                self._memo.run(tasks)
        except Exception:  # noqa: BLE001 — an engine bug degrades to dense
            return dense + [
                (t.job, t.sess, t.board0, t.epoch0, t.job.steps)
                for t in tasks
            ]
        s_macro = self._memo.steps
        finished: List[_Job] = []
        with self._lock:
            for t in tasks:
                advanced = t.rounds_done * s_macro
                if advanced == 0:
                    dense.append(
                        (t.job, t.sess, t.board0, t.epoch0, t.job.steps)
                    )
                    continue
                sess = t.sess
                if (
                    self._sessions.get(t.job.sid) is sess
                    and sess.board is t.board0
                    and sess.epoch == t.epoch0
                ):
                    sess.board = t.board
                    sess.lanes = t.lanes
                    sess.population = t.pop
                    sess.epoch = t.epoch0 + advanced
                    sess.last_used = self._clock()
                    self._m_steps.labels(tenant=sess.tenant).inc(advanced)
                rem = t.job.steps - advanced
                if rem == 0:
                    t.job.result = (
                        t.epoch0 + advanced, odigest.value(t.lanes)
                    )
                    finished.append(t.job)
                else:
                    dense.append(
                        (t.job, sess, t.board, t.epoch0 + advanced, rem)
                    )
        for job in finished:
            self._finish(job)
        return dense

    def _run_class_batch(
        self,
        cls: int,
        entries: List[Tuple[_Job, Session, np.ndarray, int, int]],
    ) -> None:
        b_real = len(entries)
        length = sbatch.next_pow2(
            max(nsteps for _, _, _, _, nsteps in entries)
        )
        b_pad = sbatch.next_pow2(b_real)
        boards = np.zeros((b_pad, cls, cls), dtype=np.uint8)
        birth = np.zeros(b_pad, dtype=np.uint32)
        survive = np.zeros(b_pad, dtype=np.uint32)
        states = np.full(b_pad, 2, dtype=np.int32)
        hs = np.ones(b_pad, dtype=np.int32)
        ws = np.ones(b_pad, dtype=np.int32)
        ns = np.zeros(b_pad, dtype=np.int32)
        for i, (job, sess, board, _, nsteps) in enumerate(entries):
            boards[i, : sess.height, : sess.width] = board
            birth[i], survive[i], states[i] = sbatch.rule_operands(sess.rule)
            hs[i], ws[i] = sess.height, sess.width
            ns[i] = nsteps
        out, lanes = sbatch.batch_step_fn(cls, length, self.device)(
            boards, birth, survive, states, hs, ws, ns
        )
        out = out.cpu().numpy()
        lanes = lanes.cpu().numpy().astype(np.uint32)
        self._m_batch.observe(b_real)
        # Slice-copies and popcounts are O(Σ h·w) host work — done OUTSIDE
        # the lock so scatter-back never stalls concurrent create/step/get.
        results = [
            (
                out[i, : sess.height, : sess.width].copy(),
                lanes[i],
            )
            for i, (_, sess, _, _, _) in enumerate(entries)
        ]
        pops = [int((board == 1).sum()) for board, _ in results]
        with self._lock:
            for (job, sess, board0, epoch0, nsteps), (
                new_board, new_lanes,
            ), pop in zip(entries, results, pops):
                if (
                    self._sessions.get(job.sid) is sess
                    and sess.board is board0
                    and sess.epoch == epoch0
                ):
                    sess.board = new_board
                    sess.lanes = new_lanes
                    sess.population = pop
                    sess.epoch = epoch0 + nsteps
                    sess.last_used = self._clock()
                    self._m_steps.labels(tenant=sess.tenant).inc(nsteps)
                else:
                    # Deleted mid-batch — or a fast-forward jump committed
                    # between this batch's gather and scatter-back (the
                    # jump's epochs must never be clobbered by a stale
                    # batch result).  Either way the client still gets its
                    # result, computed from the snapshot it asked about;
                    # the table write-back is skipped, and so is the
                    # per-tenant counter — _drop_locked may just have
                    # reclaimed this tenant's metric children, and
                    # incrementing here would re-mint a leaked child for a
                    # gone tenant.
                    pass
                job.result = (epoch0 + nsteps, odigest.value(new_lanes))
        # Completions fire after the table writes are released: callbacks
        # (the cluster plane's wire replies) must never run under the lock.
        for job, _, _, _, _ in entries:
            self._finish(job)

    def drain(self, timeout: float = 30.0) -> bool:
        """Refuse NEW work and run the already-admitted queue dry (bounded)
        — the graceful half of shutdown: an admitted job completes, it is
        never failed with 'router closed' just because the operator sent
        SIGTERM.  Returns True when the queue emptied in time."""
        with self._lock:
            self._draining = True
            self._wake.notify_all()
        # Bounded by REAL time on purpose: the loop paces with time.sleep,
        # so the deadline must tick with it — on the injected clock a
        # frozen TTL-test clock would turn this bounded shutdown wait into
        # an infinite hang.
        deadline = time.monotonic() + timeout  # graftlint: waive GL-HAZ04 -- the real-time bound pairs with the real time.sleep pacing below; a frozen injected test clock must not unbound shutdown
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue:
                    return True
            time.sleep(0.05)
        return False

    # -- stats / lifecycle ---------------------------------------------------

    def stats(self) -> dict:
        """The /healthz contribution: live table + queue facts."""
        with self._lock:
            return {
                "sessions": len(self._sessions),
                "cells": self._cells,
                "queue_depth": len(self._queue),
                "max_sessions": self.max_sessions,
                "max_cells": self.max_cells,
                "size_classes": list(self.size_classes),
            }

    def close(self) -> None:
        """Stop the ticker and fail any still-pending jobs loudly."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._wake.notify_all()
        self._ticker.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
