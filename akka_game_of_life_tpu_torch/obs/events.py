"""Structured JSONL event log — the machine-readable twin of the log stream.

Every lifecycle event the runtime emits (crash injected, crash recovered,
checkpoint saved, member joined/lost, redeploy, run start/end) becomes one
JSON object per line, with both a monotonic timestamp (``t_mono`` — ordering
and intervals survive wall-clock jumps) and a wall timestamp (``t_wall`` —
correlation across nodes), plus a per-node label so multi-process logs can
be merged and still attributed.

Enabled with ``--log-events PATH`` (appends, like the reference's info.log).
The writer is thread-safe (the frontend's reader threads and the simulation
loop both emit) and line-buffered: each event is flushed whole, so a crash
mid-run loses at most the event being written — never tears one.
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, List, Optional


class EventLog:
    """Append-only JSONL event sink with monotonic timestamps."""

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        node: str = "standalone",
        stream: Optional[IO[str]] = None,
        recorder=None,
    ) -> None:
        self.node = node
        # Optional flight-recorder tee: every emitted event also lands in the
        # crash ring buffer, so a post-mortem dump interleaves lifecycle
        # events with trace spans (obs/flight.py).  Tees even when the file
        # sink is disabled — the ring is cheap and the dump wants history.
        self.recorder = recorder
        self._lock = threading.Lock()
        self._own_file = None
        if stream is not None:
            self._out = stream
        elif path is not None:
            self._own_file = open(path, "a", encoding="utf-8")
            self._out = self._own_file
        else:
            self._out = None  # disabled: emit() is a no-op

    @property
    def enabled(self) -> bool:
        return self._out is not None

    def emit(self, event: str, /, **fields) -> None:
        """Write one event line.  ``fields`` must be JSON-serializable
        (non-serializable values degrade to ``str``); reserved keys
        (event/node/t_mono/t_wall) cannot be overridden."""
        if self._out is None and self.recorder is None:
            return
        rec = {
            "event": event,
            "node": self.node,
            "t_mono": time.monotonic(),
            "t_wall": time.time(),
        }
        for k, v in fields.items():
            if k not in rec:
                rec[k] = v
        if self.recorder is not None:
            self.recorder.record_event(rec)
        if self._out is None:
            return
        line = json.dumps(rec, separators=(",", ":"), default=str)
        with self._lock:
            if self._out is None:
                return
            self._out.write(line + "\n")
            self._out.flush()

    def close(self) -> None:
        with self._lock:
            if self._own_file is not None:
                self._own_file.close()
                self._own_file = None
            self._out = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# Shared disabled sink: callers hold an EventLog unconditionally and emit
# without guarding, paying one attribute check when logging is off.
NULL_EVENTS = EventLog(None)


def read_events(path: str) -> List[dict]:
    """Parse a JSONL event file back into dicts (the round-trip surface for
    tests and offline analysis).  Blank lines are skipped; a torn final line
    (crash mid-write) raises, by design — silent truncation would hide it."""
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
