"""Crash flight recorder — the last N spans + events, dumped on failure.

The reference's only post-mortem artifact is whatever info.log happened to
say before a JVM died.  This recorder keeps a bounded ring of the most
recent observability records (finished trace spans, teed via
:class:`~akka_game_of_life_tpu_torch.obs.tracing.Tracer`, plus lifecycle events,
teed via :class:`~akka_game_of_life_tpu_torch.obs.events.EventLog` and explicit
``record()`` calls) and writes the whole ring to
``<dir>/flightrec-<node>-<ts>-<seq>.json`` when something goes wrong:

- an injected crash (standalone chaos replay, cluster CRASH / CRASH_TILE);
- a supervision replay (frontend tile redeploy);
- a node-loss redeploy (member eviction);
- SIGTERM (``runtime/signals.flight_dump_on_signals``).

Every injected fault becomes a self-contained post-mortem file: the causal
span history right up to the fault, on the node that saw it.  Dumps are
rate-limited (per reason) and capped per process so a redeploy storm cannot
fill a disk; the write is atomic (tmp + rename) and never raises into the
failure path it is documenting.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import List, Optional

from akka_game_of_life_tpu_torch.obs.ioutil import atomic_write_text

_NODE_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


class FlightRecorder:
    """Bounded in-memory ring of observability records with crash dumps.

    ``directory=None`` (or "") disables dumping — the ring still records,
    so a later :meth:`configure` (e.g. the CLI applying ``--flight-dir``)
    arms dumps with history already in the buffer.
    """

    def __init__(
        self,
        node: str = "proc",
        *,
        capacity: int = 512,
        directory: Optional[str] = "artifacts",
        max_dumps: int = 64,
        min_interval_s: float = 0.5,
        clock=time.monotonic,
        wallclock=time.time,
    ) -> None:
        self.node = node  # graftlint: guarded-by _lock
        self.directory = directory  # graftlint: guarded-by _lock
        self.max_dumps = max_dumps
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._wall = wallclock
        # RLock, not Lock: the SIGTERM dump handler runs ON the main thread,
        # which may be inside record()/record_span() (every span finish on
        # the hot loop takes this lock) at the moment the signal lands — a
        # plain lock would deadlock the shutdown it decorates.
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=capacity)  # graftlint: guarded-by _lock
        self._seq = 0  # graftlint: guarded-by _lock
        self._dumps = 0  # graftlint: guarded-by _lock
        # reason -> monotonic time of last dump
        self._last_dump: dict = {}  # graftlint: guarded-by _lock
        self.dump_paths: List[str] = []  # graftlint: guarded-by _lock

    def configure(
        self, *, directory: Optional[str] = None, node: Optional[str] = None
    ) -> "FlightRecorder":
        """Late-bind the dump directory / node label (CLI config arrives
        after the process-global recorder exists)."""
        with self._lock:
            if directory is not None:
                self.directory = directory or None
            if node is not None:
                self.node = node
        return self

    @property
    def enabled(self) -> bool:
        with self._lock:
            return bool(self.directory)

    # -- recording -----------------------------------------------------------

    def record(self, kind: str, /, **fields) -> None:
        """Append one record to the ring (never raises; non-serializable
        values degrade to ``str`` at dump time)."""
        rec = {
            "kind": kind,
            "t_mono": self._clock(),
            "t_wall": self._wall(),
        }
        for k, v in fields.items():
            if k not in rec:
                rec[k] = v
        with self._lock:
            self._ring.append(rec)

    def record_span(self, span) -> None:
        """Tee one finished tracer span into the ring (Tracer calls this)."""
        d = span.to_dict() if hasattr(span, "to_dict") else dict(span)
        d["kind"] = "span"
        with self._lock:
            self._ring.append(d)

    def record_event(self, event: dict) -> None:
        """Tee one EventLog record into the ring."""
        d = dict(event)
        d["kind"] = "event"
        with self._lock:
            self._ring.append(d)

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    # -- dumping -------------------------------------------------------------

    def dump(self, reason: str, *, node: Optional[str] = None) -> Optional[str]:
        """Write the ring to ``flightrec-<node>-<ts>-<seq>.json``.

        Returns the path, or None when disabled, rate-limited (same reason
        within ``min_interval_s``), or past the per-process dump cap.  Any
        write failure is swallowed after a one-line note: the recorder rides
        failure paths, and a full disk must not mask the original fault.
        """
        now = self._clock()
        with self._lock:
            if not self.directory or self._dumps >= self.max_dumps:
                return None
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.min_interval_s:
                return None
            self._last_dump[reason] = now
            self._dumps += 1
            self._seq += 1
            seq = self._seq
            records = list(self._ring)
            directory = self.directory
            node = node or self.node
        doc = {
            "node": node,
            "reason": reason,
            "dumped_t_wall": self._wall(),
            "dumped_t_mono": now,
            "records": records,
        }
        ts = int(doc["dumped_t_wall"] * 1000)
        fname = f"flightrec-{_NODE_SAFE.sub('_', node)}-{ts}-{seq:03d}.json"
        path = os.path.join(directory, fname)
        try:
            atomic_write_text(
                path, json.dumps(doc, default=str), prefix=".flightrec_"
            )
        except (OSError, TypeError, ValueError) as e:
            # TypeError/ValueError: a hostile record that json cannot
            # serialize even with default=str must not mask the fault
            # being documented.
            _note(f"flight-recorder dump failed: {e}")
            return None
        with self._lock:
            self.dump_paths.append(path)
        _note(f"flight recorder: {reason} -> {path}")
        return path


def _note(msg: str) -> None:
    """A print that cannot raise.  dump() runs inside signal handlers (the
    SIGTERM hook), where a write into a stdout buffer the interrupted main
    thread is mid-write on raises RuntimeError('reentrant call') — which
    would abort the chained graceful-shutdown handler.  Losing the note is
    the acceptable outcome; breaking the shutdown is not."""
    try:
        print(msg, flush=True)
    except (RuntimeError, OSError, ValueError):
        pass


def read_flight(path: str) -> dict:
    """Parse a flight-recorder dump back (the test/offline surface)."""
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
