"""Distributed span tracing — the causal timeline the metrics registry can't
give.

The metrics counters say *how many* peer retries fired; this tracer says *which
frontend epoch caused them, on which worker, between which halo sends*.  A
span is (trace_id, span_id, parent_id) plus per-node / per-epoch / per-tile
attributes and a monotonic duration; span context rides the cluster wire
protocol inside message envelopes (:data:`TRACE_KEY`, attached by
``runtime/wire.attach_trace``), so one frontend ``epoch`` span links to every
``backend.step``, ``halo.send``/``halo.recv``/``halo.retry``,
``checkpoint.save`` and ``recover.redeploy`` span it transitively caused —
across threads in the in-process harness and across processes in a real
cluster (same ids, one file per process, mergeable by trace_id).

Export is Chrome trace-event JSON (the Perfetto / ``chrome://tracing``
format): ``--trace-file PATH`` writes it on close, and the obs HTTP endpoint
serves the live buffer at ``/trace``.  Timestamps anchor on the wall clock
(cross-node alignment) while durations come from the monotonic clock
(immune to wall jumps) — the same dual-clock contract as the event log.

Nesting is implicit within a thread (a module-level stack, so
``profiling.timed()`` blocks become children of whatever span is active
without knowing about the tracer) and explicit across threads/processes
(pass ``parent=`` a span, its ``ctx``, or a wire dict).

Every span name the runtime emits is declared in :data:`SPAN_CATALOG`;
``tools/check_trace_names.py`` (tier-1) lints that each appears in
``docs/OPERATIONS.md`` so the operator-facing table cannot rot.
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Union

# The wire-envelope key span context rides under (see runtime/wire.py
# attach_trace/extract_trace).  Underscored so it can never collide with a
# protocol payload field.
TRACE_KEY = "_trace"

# Every span name the runtime emits, with its meaning — the single source of
# truth the OPERATIONS.md "Tracing" table and tools/check_trace_names.py
# lint against (the exact analog of obs/catalog.py for metrics).  Spans
# minted by profiling.timed() reuse its @-stripped label (e.g.
# ``checkpoint``) and are documented with the table, not listed here.
SPAN_CATALOG = (
    # -- standalone runtime ---------------------------------------------------
    ("sim.advance", "one Simulation.advance() call (the standalone run loop)"),
    ("sim.chunk", "one stepper chunk (steps_per_call epochs, one device round-trip)"),
    ("sim.fastforward", "one O(log T) linear-rule jump (certify + jump + "
     "board swap)"),
    ("chaos.crash", "injected crash taking effect (state discarded)"),
    ("chaos.recover", "checkpoint restore + deterministic replay after a crash"),
    # -- cluster frontend -----------------------------------------------------
    ("cluster.run", "the whole cluster simulation, start_simulation to done"),
    ("epoch", "one epoch-target announcement driving every tile toward it"),
    ("cluster.deploy", "one DEPLOY batch shipped to a worker"),
    ("recover.redeploy", "tile redeployed from the recovery source"),
    ("member.lost", "node loss handled (eviction + orphaned-tile recovery)"),
    ("migrate.tile", "one live tile migration, PREPARE to COMMIT or abort"),
    ("cluster.drain", "one graceful worker drain, request to release"),
    # -- cluster backend ------------------------------------------------------
    ("backend.step", "one tile chunk stepped on a worker"),
    ("halo.send", "boundary ring encoded and queued for remote peer owners"),
    ("halo.batch_send", "one coalesced PEER_RING_BATCH frame written to a peer"),
    ("halo.recv", "PEER_RING received and stored"),
    ("halo.serve", "PEER_PULL answered from the local ring store"),
    ("halo.retry", "stale-halo retry round (re-asks to missing rings' owners)"),
    ("gather.escalate", "GATHER_FAILED escalation after the retry budget"),
    ("backend.crash", "CRASH/CRASH_TILE handled on the worker"),
    ("tile.quiesce", "a tile entering quiescence (sparse_cluster: chunks "
     "skipped until a neighboring ring changes)"),
    # -- network chaos plane / hardened comms ---------------------------------
    ("net.partition", "one injected partition, open to heal"),
    ("breaker.open", "one circuit-breaker open interval, open to re-close"),
    ("cluster.degraded", "frontend degraded mode, quorum-stranded to heal"),
    # -- multi-tenant serving plane -------------------------------------------
    ("serve.tick", "one serving-plane engine tick (batched device programs "
     "over this tick's step jobs)"),
    ("serve.memo", "one tick's memoized macro-step phase: lockstep "
     "macro-rounds over the tick's eligible jobs, one batched device "
     "call of deduplicated cache misses per round (child of serve.tick)"),
    ("serve.shard_migrate", "one session-shard migration, PREPARE to "
     "COMMIT or abort (cluster-sharded serving)"),
    ("serve.promote", "one shard replica promoted to primary after a "
     "worker loss (digest-certified; sessions resume at their "
     "replicated epoch)"),
    ("serve.fed_promote", "one federation promotion window: a dead "
     "frontend's slice adopted from replicated control rows, open until "
     "the orphaned worker's shard_home announcement (or expiry = honest "
     "session loss)"),
    ("serve.request", "one HTTP request against the /boards surface, "
     "minted (or adopted) at the edge — the root every serve-plane span "
     "for that request links under"),
    ("serve.batch", "one step job executed on a serving worker, op "
     "arrival to result push (queue wait + its slice of the vmapped "
     "batch), child of the serve.request that caused it"),
    ("serve.canary", "one synthetic canary probe round: step the pinned "
     "known-orbit session over real HTTP and digest-certify the answer "
     "against the precomputed oracle trajectory"),
    # -- durability -----------------------------------------------------------
    ("checkpoint.save", "one checkpoint save made durable"),
    ("checkpoint.restore", "one checkpoint load"),
    # -- digest certification plane -------------------------------------------
    ("obs.digest", "one board digest: computed+fetched on device "
     "(standalone) or merged from per-tile lanes (frontend)"),
)

_SPAN_NAMES = frozenset(n for n, _ in SPAN_CATALOG)


class Span:
    """One timed operation.  Created by :meth:`Tracer.span` /
    :meth:`Tracer.start`; immutable identity, mutable attrs until
    :meth:`finish`."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "node",
        "t0_wall", "t0_mono", "duration", "attrs", "tid", "_tracer", "_done",
    )

    def __init__(
        self, tracer: "Tracer", name: str, trace_id: str, span_id: str,
        parent_id: Optional[str], node: str, t0_wall: float, t0_mono: float,
        tid: int, attrs: Dict[str, object],
    ) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.node = node
        self.t0_wall = t0_wall
        self.t0_mono = t0_mono
        self.tid = tid
        self.attrs = attrs
        self.duration: Optional[float] = None
        self._done = False

    @property
    def ctx(self) -> Dict[str, str]:
        """The wire-safe propagation context: what a message envelope
        carries so the receiver's spans join this trace."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def finish(self) -> None:
        """Record the span (idempotent — a double finish keeps the first
        duration)."""
        if self._done:
            return
        self._done = True
        self.duration = self._tracer._clock() - self.t0_mono
        self._tracer._record_finished(self)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "node": self.node,
            "t0_wall": self.t0_wall,
            "t0_mono": self.t0_mono,
            "duration": self.duration,
            "tid": self.tid,
            "attrs": dict(self.attrs),
        }

    # Context-manager form: pushes onto the thread's span stack so nested
    # spans (and profiling.timed blocks) parent themselves automatically.
    def __enter__(self) -> "Span":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        self.finish()
        return False


# Module-level (not per-tracer) active-span stack: profiling.timed() and any
# other instrumentation can ask "what span is active on this thread" without
# holding a tracer reference — and in the in-process cluster harness, spans
# from one shared tracer nest naturally across component boundaries.
_local = threading.local()


def _stack() -> List[Span]:
    stack = getattr(_local, "spans", None)
    if stack is None:
        stack = _local.spans = []
    return stack


def current() -> Optional[Span]:
    """The innermost span active on THIS thread (None outside any span)."""
    stack = getattr(_local, "spans", None)
    return stack[-1] if stack else None


def record_timed(label: str, seconds: float, span: Optional[str] = None) -> None:
    """Attach an after-the-fact measurement as a child of the active span.

    The bridge profiling.timed() calls on exit: when a trace is active on
    this thread, the timed block becomes a proper child span (named from
    ``span`` or the label up to the first ``@`` — epoch-stamped labels must
    not mint one span name per epoch, same rule as the metrics histogram);
    with no active span it is a no-op, so spanless code paths cost one
    attribute check.
    """
    parent = current()
    if parent is None:
        return
    tracer = parent._tracer
    name = span or label.split("@", 1)[0]
    now_mono = tracer._clock()
    child = tracer.start(
        name, parent=parent, node=parent.node, label=label
    )
    # Back-date the start to when the measured block began.
    child.t0_mono = now_mono - seconds
    child.t0_wall = tracer._wall() - seconds
    child.duration = seconds
    child._done = True
    tracer._record_finished(child)


_Parent = Union[Span, Dict[str, str], None]


class Tracer:
    """Thread-safe span factory + bounded buffer + Perfetto exporter.

    One per process by default (:func:`get_tracer`); tests inject isolated
    instances with deterministic clocks/ids.  Finished spans land in a
    bounded ring (oldest dropped, counted in :attr:`dropped`) and are teed
    into the attached :class:`~akka_game_of_life_tpu_torch.obs.flight.FlightRecorder`
    so the crash dump always holds the most recent causal history.
    """

    def __init__(
        self,
        node: str = "proc",
        *,
        max_spans: int = 65536,
        recorder=None,
        seed: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        wallclock: Callable[[], float] = time.time,
        ident: Callable[[], int] = threading.get_ident,
    ) -> None:
        self.node = node
        self._clock = clock
        self._wall = wallclock
        self._ident = ident
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._finished: deque = deque(maxlen=max_spans)
        self.dropped = 0
        self._epoch_wall = wallclock()
        self._sinks: List[Callable[[dict], None]] = []
        if recorder is None:
            from akka_game_of_life_tpu_torch.obs.flight import FlightRecorder

            recorder = FlightRecorder(node=node)
        self.flight = recorder

    # -- span creation -------------------------------------------------------

    def _ids(self, parent: _Parent) -> tuple:
        if isinstance(parent, Span):
            return parent.trace_id, parent.span_id
        if isinstance(parent, dict) and parent.get("trace_id"):
            return str(parent["trace_id"]), parent.get("span_id")
        with self._lock:
            return f"{self._rng.getrandbits(128):032x}", None

    def _span_id(self) -> str:
        with self._lock:
            return f"{self._rng.getrandbits(64):016x}"

    def start(
        self, name: str, *, parent: _Parent = None, node: Optional[str] = None,
        **attrs,
    ) -> Span:
        """Create a live span.  ``parent`` is a Span, a wire ctx dict, or
        None — None adopts this thread's active span, or roots a new trace.
        The caller owns calling :meth:`Span.finish` (or use the span as a
        context manager for stack-nesting semantics)."""
        if parent is None:
            parent = current()
        trace_id, parent_id = self._ids(parent)
        return Span(
            self, name, trace_id, self._span_id(), parent_id,
            node or self.node, self._wall(), self._clock(), self._ident(),
            dict(attrs),
        )

    def span(
        self, name: str, *, parent: _Parent = None, node: Optional[str] = None,
        **attrs,
    ) -> Span:
        """:meth:`start`, intended for ``with`` use (enter pushes the span
        onto the thread stack; exit pops and finishes it)."""
        return self.start(name, parent=parent, node=node, **attrs)

    def _record_finished(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            if len(self._finished) == self._finished.maxlen:
                self.dropped += 1
            self._finished.append(d)
        if self.flight is not None:
            # Pass the dict, not the span: record_span would re-serialize.
            self.flight.record_span(d)
        for sink in self._sinks:
            sink(d)

    def add_sink(self, fn: Callable[[dict], None]) -> None:
        """Subscribe to finished-span dicts (the cluster worker's
        span-forwarding hook).  Sinks run on the finishing thread and must
        be fast and non-raising."""
        self._sinks.append(fn)

    def ingest(self, spans) -> None:
        """Append span dicts produced by ANOTHER tracer (a worker process
        forwarding over the control plane) into this buffer, so the
        frontend's export is the cluster-wide document.  Ids come through
        verbatim — causality links survive the hop.  Entries missing the
        span shape are dropped here (the frontend port is an open TCP
        listener; a malformed batch must not be able to poison every
        later export)."""
        with self._lock:
            for s in spans:
                if not (
                    isinstance(s, dict)
                    and isinstance(s.get("span_id"), str)
                    and isinstance(s.get("name"), str)
                ):
                    continue
                if len(self._finished) == self._finished.maxlen:
                    self.dropped += 1
                self._finished.append(s)

    # -- introspection / export ----------------------------------------------

    def finished(self) -> List[dict]:
        """Finished spans, oldest first (the assertion surface for tests)."""
        with self._lock:
            return list(self._finished)

    def export(self) -> dict:
        """The buffer as a Chrome trace-event / Perfetto JSON object.

        Spans become ``ph: "X"`` complete events; each distinct node label
        becomes a pid with a ``process_name`` metadata event, so a cluster's
        workers render as separate process tracks.  ``ts`` anchors on the
        wall clock relative to tracer creation (microseconds — cross-node
        alignment after a merge); ``dur`` is the monotonic duration.  The
        (trace_id, span_id, parent_id) triple rides in ``args`` for tools
        that rebuild causality exactly.
        """
        spans = self.finished()
        pids: Dict[str, int] = {}
        events: List[dict] = []
        # .get() throughout: ingested spans crossed an unauthenticated wire
        # (see ingest) and one short field must not break every export.
        for s in spans:
            node = str(s.get("node", "?"))
            if node not in pids:
                pid = pids[node] = len(pids)
                events.append(
                    {
                        "ph": "M",
                        "name": "process_name",
                        "pid": pid,
                        "args": {"name": node},
                    }
                )
        for s in spans:
            args = {
                "trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
            }
            attrs = s.get("attrs")
            if isinstance(attrs, dict):
                args.update(attrs)
            try:
                ts = (float(s.get("t0_wall", 0.0)) - self._epoch_wall) * 1e6
                dur = float(s.get("duration") or 0.0) * 1e6
            except (TypeError, ValueError):
                ts, dur = 0.0, 0.0
            events.append(
                {
                    "ph": "X",
                    "name": s["name"],
                    "cat": "gol",
                    "pid": pids[str(s.get("node", "?"))],
                    "tid": s.get("tid", 0),
                    "ts": round(ts, 3),
                    "dur": round(dur, 3),
                    "args": args,
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_json(self) -> str:
        return json.dumps(self.export(), separators=(",", ":"))

    def write(self, path: str) -> None:
        """Dump the Perfetto JSON atomically (tmp + rename), creating parent
        directories — the same durability idiom as the metrics exposition."""
        from akka_game_of_life_tpu_torch.obs.ioutil import atomic_write_text

        atomic_write_text(path, self.export_json(), prefix=".trace_")


def to_dict(span: Span) -> dict:
    """Span → plain dict, exported for flight/tooling callers."""
    return span.to_dict()


_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Optional[Tracer] = None


def get_tracer() -> Tracer:
    """The process-wide default tracer (created on first use, with a flight
    recorder attached so the last-N-spans ring is always armed)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Tracer()
        return _GLOBAL
