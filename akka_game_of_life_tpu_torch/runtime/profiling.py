"""Tracing and profiling on ``torch.profiler``.

Counterpart of ``akka_game_of_life_tpu/runtime/profiling.py``, with the XLA
profiler replaced by PyTorch's: :func:`trace` captures a host and device
timeline (CPU activities, and CUDA kernels and copies where a card is
present) and writes it as a Chrome trace-event / Perfetto JSON file into the
directory; :func:`annotate_epochs` marks each host-loop chunk on that
timeline through ``record_function``.

Usage:

    from akka_game_of_life_tpu_torch.runtime import profiling
    with profiling.trace("/tmp/gol-trace"):
        sim.advance(512)

or ``python -m akka_game_of_life_tpu_torch run ... --trace-dir /tmp/gol-trace``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, Optional

import torch

from akka_game_of_life_tpu_torch.obs.programs import device_memory_stats

TRACE_FILE = "trace.json"


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(trace_dir: str) -> torch.profiler.profile:
    """Start a profiler whose :func:`stop_trace` writes
    ``<trace_dir>/trace.json``."""
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    prof.trace_dir = trace_dir
    return prof


def stop_trace(prof: torch.profiler.profile) -> str:
    """Stop ``prof`` and export its timeline; returns the file's path."""
    prof.stop()
    path = os.path.join(prof.trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Capture a ``torch.profiler`` trace into ``trace_dir`` (no-op when
    None or empty); yields the profiler, whose ``key_averages()`` are read
    after the block."""
    if not trace_dir:
        yield None
        return
    prof = start_trace(trace_dir)
    try:
        yield prof
    finally:
        stop_trace(prof)


def annotate_epochs(name: str, epoch: int):
    """Mark one host-loop chunk on the profiler timeline (``name@epoch``);
    costs a few microseconds when no profiler runs."""
    return torch.profiler.record_function(f"{name}@{epoch}")


class TimedSpan:
    """The measurement a :func:`timed` block yields: ``seconds`` is 0.0
    while the block runs and the measured duration once it exits."""

    __slots__ = ("label", "seconds")

    def __init__(self, label: str) -> None:
        self.label = label
        self.seconds = 0.0

    @property
    def ms(self) -> float:
        return self.seconds * 1e3


@contextlib.contextmanager
def timed(
    label: str, out=None, registry=None, span: Optional[str] = None
) -> Iterator[TimedSpan]:
    """Host-side wall-clock span, printed on exit as ``[profile] label: ms``.

    With ``registry`` the duration is also observed into the
    ``gol_span_seconds`` histogram under the ``span`` label (default:
    ``label`` up to the first ``@``, so epoch-stamped labels do not mint one
    series per epoch); inside an active trace span the block becomes its
    child (same naming rule)."""
    rec = TimedSpan(label)
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec.seconds = time.perf_counter() - t0
        print(f"[profile] {label}: {rec.ms:.2f} ms", file=out, flush=True)
        if registry is not None:
            registry.histogram(
                "gol_span_seconds", labelnames=("span",)
            ).labels(span=span or label.split("@", 1)[0]).observe(rec.seconds)
        from akka_game_of_life_tpu_torch.obs import tracing

        tracing.record_timed(label, rec.seconds, span=span)


class ProfilerCapture:
    """On-demand, rate-limited profiler capture — ``POST /profile``'s engine
    on every role.

    One capture at a time per process (a second request while one runs gets
    ``status: 409``), at most one per ``min_interval_s`` (``status: 429``
    with ``retry_after_s``), each clamped to ``max_seconds``: an
    unauthenticated scraper of the obs port must not turn the profiler into
    a denial of service.  Each capture lands in
    ``<artifacts_dir>/profile-<node>-<seq>/trace.json``.

    ``start``/``stop``/``sleep``/``clock`` are injectable so tests drive
    captures without a real profiler or wall time.
    """

    def __init__(
        self,
        artifacts_dir: str = "artifacts",
        *,
        node: Optional[str] = None,
        max_seconds: float = 30.0,
        min_interval_s: float = 60.0,
        default_seconds: float = 3.0,
        clock=time.monotonic,
        sleep=time.sleep,
        start=None,
        stop=None,
    ) -> None:
        self.artifacts_dir = artifacts_dir
        self.node = node or "local"
        self.max_seconds = float(max_seconds)
        self.min_interval_s = float(min_interval_s)
        self.default_seconds = float(default_seconds)
        self._clock = clock
        self._sleep = sleep
        self._start = start if start is not None else start_trace
        self._stop = stop if stop is not None else stop_trace
        self._lock = threading.Lock()
        self._running = False  # guarded by _lock
        self._last: Optional[float] = None  # guarded by _lock
        self._seq = 0  # guarded by _lock

    def capture(self, seconds: Optional[float] = None) -> dict:
        """Run one capture window, blocking for its duration.  Returns a
        JSON-ready result: ``{"ok": True, "artifact", "seconds", ...}`` or
        ``{"ok": False, "error", "status"}`` (409 busy, 429 rate-limited,
        500 profiler failure)."""
        want = self.default_seconds if seconds is None else float(seconds)
        want = min(max(want, 0.1), self.max_seconds)
        with self._lock:
            if self._running:
                return {
                    "ok": False,
                    "status": 409,
                    "error": "a profiler capture is already running",
                }
            now = self._clock()
            if self._last is not None and now - self._last < self.min_interval_s:
                return {
                    "ok": False,
                    "status": 429,
                    "error": "profiler capture rate-limited",
                    "retry_after_s": round(
                        self.min_interval_s - (now - self._last), 3
                    ),
                }
            self._running = True
            self._last = now
            self._seq += 1
            seq = self._seq
        path = os.path.join(self.artifacts_dir, f"profile-{self.node}-{seq:04d}")
        try:
            prof = self._start(path)
            try:
                self._sleep(want)
            finally:
                self._stop(prof)
        except Exception as e:  # noqa: BLE001 — report, never kill the route
            return {"ok": False, "status": 500, "error": repr(e)}
        finally:
            with self._lock:
                self._running = False
        from akka_game_of_life_tpu_torch.obs.metrics import get_registry

        get_registry().counter(
            "gol_profile_captures_total",
            "On-demand profiler captures taken (POST /profile)",
        ).inc()
        return {
            "ok": True,
            "node": self.node,
            "artifact": path,
            "seconds": want,
            "devices": device_memory_stats(),
        }
