"""Process-wide jit-program ledger: the compile & device-cost observatory.

Every cached program factory in the repo (the ``ops/`` kernel families,
``serve/batch.py``'s per-(class, length) batch programs, the runtime
backend's chunk programs) registers the callable it is about to cache
through :func:`registered_jit`.  The wrapper is the whole integration
surface — one line per factory site — and buys three things:

- **a program ledger**: which jitted programs exist (per ``family`` and
  ``key``), when each compiled, and what its first call cost — the
  compile bill that XLA otherwise hides inside a mysteriously slow call;
- **a live roofline**: each call's host-observed seconds plus the site's
  plan-priced cells/bytes/FLOPs accumulate into per-family cell-updates/s
  and arithmetic intensity, reported by :meth:`ProgramRegistry.cost_doc`;
- **a compile-storm alarm**: after :meth:`ProgramRegistry.mark_warm`
  (the serve router calls it once its steady-state classes have all
  compiled), any NEW program compiling is the invisible p99 killer — a
  novel (class, length) pair stalling a whole ticker batch — and edges
  an event + flight-recorder dump (``obs/flight.py``) the moment it happens.

Honesty note on "device seconds": per-call timing is host wall time
around the jitted call.  Under JAX async dispatch this is dispatch time
unless the caller blocks on the result (the runtime's chunk loops do;
the serve ticker does).  The ledger documents a *lower bound* on
throughput, not a device-counter truth — the on-demand profiler
(``POST /profile``) exists for the latter.

Federation: workers ship :data:`runtime.protocol.COST` frames built from
:meth:`summary` on a low cadence; the frontend feeds them to
:meth:`merge_remote` so its ``/programs``, ``/cost``, and ``/healthz``
show the cluster-merged ledger, and calls :meth:`forget_remote` on member
loss so gauge labels are reclaimed (the breaker-reset hygiene rule).

The registry is process-global (:func:`get_programs`) for the same reason
the metrics registry is: factory sites are module-level caches with no
config in scope.  Roles configure it (node name, event log, flight
recorder, enable/disable) at startup via :meth:`configure`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from akka_game_of_life_tpu_torch.obs.metrics import get_registry

_COST_FIELDS = ("cells", "bytes", "flops")


# Cataloged-metric accessors: label names must match obs/catalog.py exactly
# (the registry refuses a mismatched re-registration), and passing them here
# keeps the ledger working even on a bare registry that never ran install().
def device_memory_stats() -> dict:
    """Per-device memory of the CUDA caching allocator (empty on a host
    without CUDA, or before this process touched the card)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    return {
        f"cuda:{i}": {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
        for i in range(torch.cuda.device_count())
    }


def _g_programs_live(reg):
    return reg.gauge(
        "gol_programs_live", "Jitted programs registered, per family",
        ("family",),
    )


def _g_device(reg, name: str, help: str):
    return reg.gauge(name, help, ("device",))


def _c_family(reg, name: str, help: str):
    return reg.counter(name, help, ("family",))


def _h_compile(reg):
    from akka_game_of_life_tpu_torch.obs.catalog import COMPILE_BUCKETS

    return reg.histogram(
        "gol_compile_seconds",
        "First-call (compile) wall seconds per jitted program",
        ("family",), buckets=COMPILE_BUCKETS,
    )


def stencil_cost(
    h: int,
    w: int,
    steps: int = 1,
    *,
    boards: int = 1,
    itemsize: int = 1,
    flops_per_cell: float = 18.0,
) -> dict:
    """Plan-priced per-call cost of a dense stencil program: ``boards``
    boards of ``h×w`` cells advanced ``steps`` generations per invocation.

    ``bytes`` prices the streaming minimum (one read + one write of the
    board per step at ``itemsize`` bytes/cell); ``flops_per_cell``
    defaults to the 3×3 neighbor-sum + rule-select budget (~18 int ops).
    Families with a real plan (banded matmul, packed kernels) should
    price from the plan instead of this helper.
    """
    cells = float(boards) * float(h) * float(w) * float(steps)
    return {
        "cells": cells,
        "bytes": 2.0 * float(boards) * float(h) * float(w) * itemsize * steps,
        "flops": flops_per_cell * cells,
    }


class ProgramRecord:
    """One jitted program: identity, compile bill, and running totals."""

    __slots__ = (
        "family", "key", "compile_s", "compile_started", "calls",
        "seconds", "cells", "bytes", "flops", "post_warm", "storm_fired",
    )

    def __init__(self, family: str, key: str, post_warm: bool) -> None:
        self.family = family
        self.key = key
        self.compile_s: Optional[float] = None
        self.compile_started = False
        self.calls = 0
        self.seconds = 0.0
        self.cells = 0.0
        self.bytes = 0.0
        self.flops = 0.0
        self.post_warm = post_warm
        self.storm_fired = False

    def to_dict(self) -> dict:
        return {
            "family": self.family,
            "key": self.key,
            "compile_seconds": self.compile_s,
            "calls": self.calls,
            "seconds": self.seconds,
            "cells": self.cells,
            "bytes": self.bytes,
            "flops": self.flops,
            "post_warm": self.post_warm,
        }


class ProgramRegistry:
    """The process-wide jit-program ledger (see module docstring)."""

    def __init__(self, *, node: Optional[str] = None, clock=time.perf_counter):
        self._lock = threading.Lock()
        self._clock = clock
        self._programs: Dict[Tuple[str, str], ProgramRecord] = {}
        # member -> last COST summary doc ({"families", "devices", ...})
        self._remote: Dict[str, dict] = {}
        # label sets currently exported on the device gauges, for reclaim
        self._device_labels: Dict[str, set] = {}  # owner ("" = local) -> labels
        self._warm = False
        self._storms = 0
        self.enabled = True
        self.node = node
        self._events = None
        self._flight = None
        self._metrics = None
        # Named cost sections: auxiliary planes (the serve memo cache)
        # publish their economics into /cost and COST frames through a
        # provider callable instead of the ledger knowing their shape.
        self._sections: Dict[str, Callable[[], dict]] = {}

    def _reg(self):
        return self._metrics if self._metrics is not None else get_registry()

    # -- role wiring ---------------------------------------------------------

    def configure(
        self,
        *,
        node: Optional[str] = None,
        events=None,
        flight=None,
        metrics=None,
        enabled: Optional[bool] = None,
    ) -> "ProgramRegistry":
        """Attach role context: node name (labels COST frames and storm
        dumps), an EventLog and FlightRecorder for storm alerts, the
        MetricsRegistry the gauges/counters land in (default: the process
        registry), and the ``obs_programs`` enable switch (disabling makes
        :func:`registered_jit` a pass-through for programs built after)."""
        with self._lock:
            if node is not None:
                self.node = node
            if events is not None:
                self._events = events
            if flight is not None:
                self._flight = flight
            if metrics is not None:
                self._metrics = metrics
            if enabled is not None:
                self.enabled = enabled
        return self

    def reset(self) -> None:
        """Forget everything (tests)."""
        with self._lock:
            self._programs.clear()
            self._remote.clear()
            self._device_labels.clear()
            self._warm = False
            self._storms = 0
            self.enabled = True
            self._events = None
            self._flight = None
            self._metrics = None
            self._sections.clear()

    # -- the one integration surface -----------------------------------------

    def wrap(
        self,
        family: str,
        key,
        fn: Callable,
        *,
        cost=None,
    ) -> Callable:
        """Register ``fn`` (a jitted callable a factory is about to cache)
        under ``(family, key)`` and return the instrumented callable.

        ``cost`` prices one invocation: a static dict with ``cells`` /
        ``bytes`` / ``flops`` keys (factory keys encode shapes, so the
        per-call cost is usually static), or a callable over the call's
        arguments returning one.  First call timing is recorded as the
        compile bill; every call adds host-observed seconds and priced
        work to the family totals.
        """
        if not self.enabled:
            return fn
        skey = key if isinstance(key, str) else repr(key)
        with self._lock:
            rec = self._programs.get((family, skey))
            if rec is None:
                rec = ProgramRecord(family, skey, post_warm=self._warm)
                self._programs[(family, skey)] = rec
                live = sum(
                    1 for f, _ in self._programs if f == family
                )
            else:
                live = None
        if live is not None:
            _g_programs_live(self._reg()).labels(family=family).set(live)

        def call(*args, **kwargs):
            with self._lock:
                first = not rec.compile_started
                if first:
                    rec.compile_started = True
            t0 = self._clock()
            out = fn(*args, **kwargs)
            dt = self._clock() - t0
            c = cost(*args, **kwargs) if callable(cost) else cost
            storm = False
            with self._lock:
                rec.calls += 1
                rec.seconds += dt
                if first:
                    rec.compile_s = dt
                if c:
                    rec.cells += float(c.get("cells", 0.0))
                    rec.bytes += float(c.get("bytes", 0.0))
                    rec.flops += float(c.get("flops", 0.0))
                if first and rec.post_warm and not rec.storm_fired:
                    rec.storm_fired = True
                    self._storms += 1
                    storm = True
            mreg = self._reg()
            _c_family(
                mreg, "gol_program_invocations_total",
                "Invocations of registered jitted programs",
            ).labels(family=family).inc()
            _c_family(
                mreg, "gol_program_device_seconds_total",
                "Host-observed seconds inside registered jitted programs",
            ).labels(family=family).inc(dt)
            if first:
                _h_compile(mreg).labels(family=family).observe(dt)
            if storm:
                self._emit_storm(rec)
            return out

        call.__wrapped__ = fn
        return call

    def _emit_storm(self, rec: ProgramRecord) -> None:
        self._reg().counter(
            "gol_compile_storms_total",
            "New programs compiled after warmup (each one stalled a batch)",
        ).inc()
        events, flight = self._events, self._flight
        if events is not None:
            try:
                events.emit(
                    "compile_storm",
                    family=rec.family,
                    key=rec.key,
                    compile_seconds=rec.compile_s,
                    node=self.node,
                )
            except Exception:  # noqa: BLE001 — alerting must not break the call
                pass
        if flight is not None:
            try:
                flight.dump("compile_storm", node=self.node)
            except Exception:  # noqa: BLE001
                pass

    # -- named cost sections -------------------------------------------------

    def register_section(
        self, name: str, provider: Callable[[], dict]
    ) -> None:
        """Attach a named cost section: ``provider()`` returns a flat dict
        of numbers that rides :meth:`summary` (so workers federate it in
        COST frames) and lands merged in :meth:`cost_doc`.  Re-registering
        a name replaces the provider (routers restart in-process under
        tests); :meth:`reset` clears them."""
        with self._lock:
            self._sections[name] = provider

    def sections_doc(self) -> Dict[str, dict]:
        """Every local section's current numbers.  A provider that raises
        reports an empty section — /cost must render whatever else it has."""
        with self._lock:
            providers = dict(self._sections)
        out: Dict[str, dict] = {}
        for name, provider in providers.items():
            try:
                out[name] = dict(provider())
            except Exception:  # noqa: BLE001 — reporting must never raise
                out[name] = {}
        return out

    def _merged_sections(self) -> Dict[str, dict]:
        """Cluster-merged sections: numeric fields sum across the local
        doc and every member's COST frame; ``hit_rate`` is recomputed from
        the merged hits/misses (a mean of ratios would weight a cold
        worker's 0.0 the same as a hot one's 0.9)."""
        merged: Dict[str, dict] = {}
        with self._lock:
            remotes = list(self._remote.values())
        docs = [self.sections_doc()] + [
            doc.get("sections") or {} for doc in remotes
        ]
        for sections in docs:
            for name, fields in sections.items():
                tot = merged.setdefault(name, {})
                for k, v in fields.items():
                    if isinstance(v, (int, float)) and not isinstance(v, bool):
                        tot[k] = tot.get(k, 0) + v
        for tot in merged.values():
            if "hits" in tot and "misses" in tot:
                probes = tot["hits"] + tot["misses"]
                tot["hit_rate"] = tot["hits"] / probes if probes else 0.0
        return merged

    # -- warmup / storm state ------------------------------------------------

    def mark_warm(self) -> None:
        """Arm the storm detector: every program that exists now is the
        expected steady state; a NEW program compiling after this is a
        compile storm.  Idempotent."""
        with self._lock:
            self._warm = True

    @property
    def warm(self) -> bool:
        with self._lock:
            return self._warm

    @property
    def storms(self) -> int:
        with self._lock:
            return self._storms

    @property
    def programs_total(self) -> int:
        """Count of registered local programs — cheap enough to sample
        around a batch tick (the serve router's warm heuristic: a tick
        that ran jobs without growing this is steady state)."""
        with self._lock:
            return len(self._programs)

    # -- device-memory watermarks --------------------------------------------

    def refresh_device_gauges(
        self, stats: Optional[dict] = None, *, owner: str = ""
    ) -> dict:
        """Export ``device_memory_stats()``-shaped watermarks as the
        cataloged per-device gauges, reclaiming labels that disappeared
        for the same ``owner`` (``""`` = this process's devices; a member
        name namespaces a worker's devices as ``member:device``).
        Returns the stats it exported."""
        if stats is None:
            stats = device_memory_stats()
        mreg = self._reg()
        in_use = _g_device(
            mreg, "gol_device_bytes_in_use", "Device memory currently allocated"
        )
        peak = _g_device(
            mreg, "gol_device_peak_bytes_in_use",
            "Device memory high-water mark since process start",
        )
        labels = set()
        for dev, s in stats.items():
            label = f"{owner}:{dev}" if owner else str(dev)
            labels.add(label)
            in_use.labels(device=label).set(float(s.get("bytes_in_use", 0)))
            peak.labels(device=label).set(
                float(s.get("peak_bytes_in_use", s.get("bytes_in_use", 0)))
            )
        with self._lock:
            stale = self._device_labels.get(owner, set()) - labels
            self._device_labels[owner] = labels
        for label in stale:
            in_use.remove(device=label)
            peak.remove(device=label)
        return stats

    # -- cluster federation ---------------------------------------------------

    def merge_remote(self, member: str, doc: dict) -> None:
        """Fold one worker's COST frame into the cluster view: stash its
        family summary for /programs //cost, export its device watermarks
        as ``member:device`` gauge children, refresh the merged
        programs-live gauges."""
        with self._lock:
            self._remote[member] = dict(doc)
        self.refresh_device_gauges(doc.get("devices") or {}, owner=member)
        self._refresh_family_gauges()

    def forget_remote(self, member: str) -> None:
        """Member loss: drop its ledger contribution and reclaim every
        gauge child it owned."""
        with self._lock:
            self._remote.pop(member, None)
        self.refresh_device_gauges({}, owner=member)
        self._refresh_family_gauges()

    def _refresh_family_gauges(self) -> None:
        merged = self._merged_families()
        gauge = _g_programs_live(self._reg())
        for family, agg in merged.items():
            gauge.labels(family=family).set(agg["programs"])
        # Reclaim families that only a departed member contributed.
        exported = [labels.get("family") for labels, _ in gauge.series()]
        for fam in exported:
            if fam is not None and fam not in merged:
                gauge.remove(family=fam)

    # -- reporting ------------------------------------------------------------

    def family_summary(self) -> Dict[str, dict]:
        """Local per-family aggregates (what a COST frame carries)."""
        out: Dict[str, dict] = {}
        with self._lock:
            for rec in self._programs.values():
                agg = out.setdefault(
                    rec.family,
                    {
                        "programs": 0,
                        "compile_seconds": 0.0,
                        "calls": 0,
                        "seconds": 0.0,
                        "cells": 0.0,
                        "bytes": 0.0,
                        "flops": 0.0,
                    },
                )
                agg["programs"] += 1
                agg["compile_seconds"] += rec.compile_s or 0.0
                agg["calls"] += rec.calls
                agg["seconds"] += rec.seconds
                agg["cells"] += rec.cells
                agg["bytes"] += rec.bytes
                agg["flops"] += rec.flops
        return out

    def summary(self) -> dict:
        """The COST-frame / bench-record snapshot: node identity, warmth,
        storm count, per-family aggregates, device watermarks."""
        with self._lock:
            node, warm, storms = self.node, self._warm, self._storms
        try:
            devices = device_memory_stats()
        except Exception:  # noqa: BLE001 — reporting must never raise
            devices = {}
        return {
            "node": node,
            "warm": warm,
            "storms": storms,
            "families": self.family_summary(),
            "devices": devices,
            "sections": self.sections_doc(),
        }

    def snapshot(self) -> dict:
        """The ``/programs`` document: every local program, plus each
        member's federated family summary."""
        with self._lock:
            programs = sorted(
                (rec.to_dict() for rec in self._programs.values()),
                key=lambda d: (d["family"], d["key"]),
            )
            remote = {m: dict(doc) for m, doc in self._remote.items()}
            node, warm, storms = self.node, self._warm, self._storms
        return {
            "node": node,
            "warm": warm,
            "storms": storms,
            "programs": programs,
            "members": remote,
        }

    def _merged_families(self) -> Dict[str, dict]:
        merged = self.family_summary()
        with self._lock:
            remotes = list(self._remote.values())
        for doc in remotes:
            for family, agg in (doc.get("families") or {}).items():
                tot = merged.setdefault(
                    family,
                    {
                        "programs": 0,
                        "compile_seconds": 0.0,
                        "calls": 0,
                        "seconds": 0.0,
                        "cells": 0.0,
                        "bytes": 0.0,
                        "flops": 0.0,
                    },
                )
                for k in (
                    "programs", "compile_seconds", "calls",
                    "seconds", "cells", "bytes", "flops",
                ):
                    tot[k] += agg.get(k, 0)
        return merged

    def cost_doc(self) -> dict:
        """The ``/cost`` document — the live roofline ledger: cluster-
        merged per-family cell-updates/s and arithmetic intensity, plus
        every device's memory watermark."""
        families = {}
        for family, agg in sorted(self._merged_families().items()):
            seconds = agg["seconds"]
            rate = agg["cells"] / seconds if seconds > 0 else 0.0
            families[family] = {
                **agg,
                "cell_updates_per_s": rate,
                "arithmetic_intensity": (
                    agg["flops"] / agg["bytes"] if agg["bytes"] > 0 else 0.0
                ),
            }
        devices: Dict[str, dict] = {}
        try:
            for dev, s in device_memory_stats().items():
                devices[str(dev)] = dict(s)
        except Exception:  # noqa: BLE001
            pass
        with self._lock:
            remotes = {m: dict(doc) for m, doc in self._remote.items()}
            storms = self._storms
            node, warm = self.node, self._warm
        for member, doc in remotes.items():
            storms += int(doc.get("storms") or 0)
            for dev, s in (doc.get("devices") or {}).items():
                devices[f"{member}:{dev}"] = dict(s)
        return {
            "node": node,
            "warm": warm,
            "storms": storms,
            "families": families,
            "devices": devices,
            "sections": self._merged_sections(),
        }

    def health_summary(self) -> dict:
        """The compact block /healthz embeds: program counts, compile
        bill, storm count, per-member warmth."""
        fams = self._merged_families()
        with self._lock:
            members = {
                m: {
                    "warm": bool(doc.get("warm")),
                    "storms": int(doc.get("storms") or 0),
                    "programs": sum(
                        int(f.get("programs") or 0)
                        for f in (doc.get("families") or {}).values()
                    ),
                }
                for m, doc in self._remote.items()
            }
            storms = self._storms
        return {
            "programs": sum(f["programs"] for f in fams.values()),
            "compile_seconds": round(
                sum(f["compile_seconds"] for f in fams.values()), 6
            ),
            "storms": storms + sum(m["storms"] for m in members.values()),
            "families": {f: a["programs"] for f, a in sorted(fams.items())},
            "members": members,
        }


_GLOBAL = ProgramRegistry()
_GLOBAL_LOCK = threading.Lock()


def get_programs() -> ProgramRegistry:
    """The process-wide registry every factory site registers through."""
    return _GLOBAL


def registered_jit(family: str, key, fn: Callable, *, cost=None) -> Callable:
    """Module-level sugar for ``get_programs().wrap(...)`` — the one-line
    integration every cached jit-factory site uses (GL-HAZ05 enforces
    that they do)."""
    return _GLOBAL.wrap(family, key, fn, cost=cost)


def register_section(name: str, provider: Callable[[], dict]) -> None:
    """Module-level sugar for ``get_programs().register_section(...)``."""
    _GLOBAL.register_section(name, provider)


# -- HTTP surface -------------------------------------------------------------


def _query_param(path: str, name: str) -> Optional[str]:
    from urllib.parse import parse_qs, urlsplit

    vals = parse_qs(urlsplit(path).query).get(name)
    return vals[0] if vals else None


def http_routes(
    *,
    registry: Optional[ProgramRegistry] = None,
    profile: Optional[Callable[[Optional[float]], dict]] = None,
) -> dict:
    """The ``/programs`` + ``/cost`` (+ ``/profile`` when a capture
    callable is supplied) route table, mountable on any MetricsServer.

    ``profile(seconds)`` performs the capture and returns a JSON-ready
    dict; ``{"ok": False, "status": N}`` maps to that HTTP status (429
    rate-limited, 409 already running)."""
    from akka_game_of_life_tpu_torch.obs.httpd import json_response

    reg = registry or get_programs()

    def programs_route(method, path, body):
        if method != "GET":
            return json_response(405, {"error": f"{method} /programs"})
        return json_response(200, reg.snapshot())

    def cost_route(method, path, body):
        if method != "GET":
            return json_response(405, {"error": f"{method} /cost"})
        return json_response(200, reg.cost_doc())

    routes = {"/programs": programs_route, "/cost": cost_route}

    if profile is not None:

        def profile_route(method, path, body):
            if method != "POST":
                return json_response(405, {"error": f"{method} /profile"})
            seconds: Optional[float] = None
            raw = _query_param(path, "seconds")
            if raw is None and body:
                import json as _json

                try:
                    doc = _json.loads(body.decode("utf-8"))
                    raw = doc.get("seconds") if isinstance(doc, dict) else None
                except (ValueError, UnicodeDecodeError):
                    return json_response(400, {"error": "body is not JSON"})
            if raw is not None:
                try:
                    seconds = float(raw)
                except (TypeError, ValueError):
                    return json_response(
                        400, {"error": f"seconds={raw!r} is not a number"}
                    )
            result = profile(seconds)
            status = 200 if result.get("ok") else int(
                result.get("status") or 429
            )
            return json_response(status, result)

        routes["/profile"] = profile_route

    return routes
