"""Shared ``--metrics-file`` dump policy — one helper for every role.

Three call sites need the same loop: the standalone simulation's cadence
hook, the frontend maintenance loop's wall-clock refresh, and the backend's
dump thread.  They share one
contract, so it lives here once:

- the write is the registry's atomic tmp+rename exposition dump;
- a write failure (ENOSPC blip, NFS hiccup, directory removed mid-run) must
  never abort or freeze the path it observes — warn ONCE per outage, keep
  retrying, and re-arm the warning after a success;
- a final best-effort dump on the way out, with the same containment.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class MetricsDumper:
    """Warn-once, failure-contained exposition dumps to one file.

    Thread-safe: the frontend calls :meth:`maybe` from its maintenance
    thread while :meth:`final` runs on the stopping thread; the backend runs
    :meth:`loop` on its own daemon thread.
    """

    def __init__(
        self,
        registry,
        path: str,
        *,
        interval_s: float = 5.0,
        label: str = "metrics-file",
        out=None,
    ) -> None:
        self.registry = registry
        self.path = path
        self.interval_s = interval_s
        self.label = label
        self._out = out  # None = stdout (print default)
        self._lock = threading.Lock()
        self._warned = False
        self._next_due = time.monotonic() + interval_s

    def _warn(self, e: OSError) -> None:
        print(
            f"{self.label} write failed (will keep retrying): {e}",
            file=self._out,
            flush=True,
        )

    def dump(self) -> bool:
        """One write attempt.  Returns True on success; on failure warns
        once per outage and returns False (never raises)."""
        try:
            self.registry.write(self.path)
        except OSError as e:
            with self._lock:
                warn = not self._warned
                self._warned = True
            if warn:
                self._warn(e)
            return False
        with self._lock:
            self._warned = False
        return True

    def maybe(self, now: Optional[float] = None) -> bool:
        """Interval-gated :meth:`dump` for callers with their own loop (the
        frontend maintenance thread).  Returns True if a write happened."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            if now < self._next_due:
                return False
            self._next_due = now + self.interval_s
        self.dump()
        return True

    def loop(self, stop: threading.Event) -> None:
        """Dump every ``interval_s`` until ``stop`` is set (the backend's
        dump-thread body)."""
        while not stop.wait(self.interval_s):
            self.dump()

    def start_thread(self, stop: threading.Event) -> threading.Thread:
        t = threading.Thread(
            target=self.loop, args=(stop,), daemon=True, name="metrics-dump"
        )
        t.start()
        return t

    def final(self) -> bool:
        """Best-effort exit dump: always warns on failure (an exit snapshot
        failing is worth one line even mid-outage) and never raises — the
        teardown behind it must complete."""
        try:
            self.registry.write(self.path)
        except OSError as e:
            print(f"final {self.label} write failed: {e}", file=self._out, flush=True)
            return False
        return True
