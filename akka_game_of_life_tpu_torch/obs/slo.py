"""Per-tenant SLO accounting for the serving plane.

The metrics registry says *how fast* the serve path is; this tracker says
*whether we are keeping the promise*: every ``/boards`` request lands here
with its tenant, route, outcome, queue wait, latency, and trace id, and
three products fall out:

- a **structured JSONL access log** (``serve_slo_log``) — one line per
  request, the replayable ground truth ``tools/slo_report.py`` folds into
  a per-tenant SLO table;
- **per-tenant RED metrics** (``gol_serve_slo_*``) with the
  label-reclaim hygiene: tenant cardinality is capped at
  ``serve_slo_max_tenants``, the least-recently-seen tenant's series are
  removed from the exposition and its traffic folds into
  ``tenant="~overflow"`` — a tenant id is client-supplied and must never
  be an unbounded-cardinality lever.  The latency histogram records
  **trace-id exemplars**, so a p99 bucket clicks through to a concrete
  trace in the ``/trace`` export;
- a **sliding multi-window burn-rate tracker**: two objectives
  (availability — 5xx/timeouts over everything; latency — slow OKs over
  OKs, both scored against ``serve_slo_availability``'s target fraction)
  over per-second ring buckets spanning ``serve_slo_slow_window_s``.  An
  alert fires only when BOTH the fast and the slow window burn error
  budget faster than :data:`BURN_THRESHOLD` — the standard multiwindow
  discipline (the fast window catches the cliff, the slow window keeps a
  blip from paging), and it is transition-edged: one ``slo_burn_alert``
  event + one flight dump (``reason=slo_burn``) per False→True edge,
  one all-clear event per True→False, never a per-request stream.

A 429 is a **correct answer**, not a burn: admission control shedding
load is the plane working as designed, so rejects count toward traffic
but toward neither objective.

``/slo`` on the obs endpoint serves :meth:`SloTracker.summary` live.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

from akka_game_of_life_tpu_torch.obs.events import NULL_EVENTS

# Budget-burn multiple both windows must exceed before the alert edges:
# at 14.4x a 99.9% objective's whole 30-day budget dies in ~2 days — the
# classic "page now" rate (2% of a 30-day budget per hour).
BURN_THRESHOLD = 14.4

# Ring ceiling: one bucket per second, so a day-long slow window is the
# largest we will hold resident (config validation keeps windows sane;
# this is the allocation backstop).
_MAX_BUCKETS = 86_400

# The label every evicted tenant's traffic folds into.  "~" keeps it
# outside the client-legal tenant alphabet, so a real tenant can never
# collide with (or squat on) the overflow series.
OVERFLOW_TENANT = "~overflow"


# -- queue-wait relay ---------------------------------------------------------
# The queue wait is measured deep in the engine (the ticker stamping a job,
# a worker echoing it on a serve_result) while the access-log line is cut
# at the HTTP edge on the request thread.  A thread-local hands the number
# up the stack without threading a context object through every layer.
_tl = threading.local()


def note_queue_wait(seconds: Optional[float]) -> None:
    """Record this request thread's queue wait (engine-side callers)."""
    _tl.queue_wait_s = seconds


def take_queue_wait() -> Optional[float]:
    """Consume the queue wait noted on this thread (edge-side caller);
    clears it so one request's wait can never bleed into the next."""
    qw = getattr(_tl, "queue_wait_s", None)
    _tl.queue_wait_s = None
    return qw


class _Window:
    """Per-second ring of (total, avail_bad, ok, lat_bad) buckets — O(1)
    record, O(window) read, bounded memory regardless of uptime."""

    def __init__(self, span_s: int) -> None:
        self.span = max(1, min(int(span_s), _MAX_BUCKETS))
        # [second_epoch, total, avail_bad, ok, lat_bad] per slot; the
        # epoch tag lazily zeroes slots last written a full lap ago.
        self.slots = [[-1, 0, 0, 0, 0] for _ in range(self.span)]

    def add(self, sec: int, avail_bad: bool, ok: bool, lat_bad: bool) -> None:
        slot = self.slots[sec % self.span]
        if slot[0] != sec:
            slot[0], slot[1], slot[2], slot[3], slot[4] = sec, 0, 0, 0, 0
        slot[1] += 1
        slot[2] += 1 if avail_bad else 0
        slot[3] += 1 if ok else 0
        slot[4] += 1 if lat_bad else 0

    def sums(self, now_sec: int, window_s: int) -> tuple:
        """(total, avail_bad, ok, lat_bad) over the trailing window."""
        lo = now_sec - min(int(window_s), self.span) + 1
        total = avail_bad = ok = lat_bad = 0
        for slot in self.slots:
            if lo <= slot[0] <= now_sec:
                total += slot[1]
                avail_bad += slot[2]
                ok += slot[3]
                lat_bad += slot[4]
        return total, avail_bad, ok, lat_bad


class SloTracker:
    """Access log + per-tenant RED metrics + multi-window burn alerting.

    Thread-safe; one per serve surface (the single-process router and the
    cluster frontend each mount one on their obs endpoint).  ``clock`` is
    injectable so the burn-window drills are deterministic."""

    def __init__(
        self,
        config=None,
        *,
        registry=None,
        tracer=None,
        events=None,
        node: str = "serve",
        clock=time.monotonic,
        wallclock=time.time,
    ) -> None:
        get = (lambda k, d: getattr(config, k, d)) if config else (
            lambda k, d: d
        )
        self.availability = float(get("serve_slo_availability", 0.999))
        self.latency_s = float(get("serve_slo_latency_ms", 250.0)) / 1e3
        self.fast_window_s = float(get("serve_slo_fast_window_s", 300.0))
        self.slow_window_s = float(get("serve_slo_slow_window_s", 3600.0))
        self.max_tenants = int(get("serve_slo_max_tenants", 64))
        self.log_path = str(get("serve_slo_log", "") or "")
        self.node = node
        self._clock = clock
        self._wall = wallclock
        self.events = events if events is not None else NULL_EVENTS
        if registry is None:
            from akka_game_of_life_tpu_torch.obs.metrics import get_registry

            registry = get_registry()
        self.metrics = registry
        self.tracer = tracer
        self._m_requests = registry.counter(
            "gol_serve_slo_requests_total",
            labelnames=("tenant", "route", "outcome"),
        )
        self._m_latency = registry.histogram(
            "gol_serve_slo_latency_seconds", labelnames=("tenant",)
        )
        self._m_queue_wait = registry.histogram(
            "gol_serve_slo_queue_wait_seconds"
        )
        self._m_burn = registry.gauge(
            "gol_serve_slo_burn_rate", labelnames=("objective", "window")
        )
        self._m_alert = registry.gauge(
            "gol_serve_slo_burn_alert", labelnames=("objective",)
        )
        self._m_alerts = registry.counter(
            "gol_serve_slo_alerts_total", labelnames=("objective",)
        )
        self._m_tenants = registry.gauge("gol_serve_slo_tenants")
        self._lock = threading.Lock()
        self._window = _Window(int(self.slow_window_s))  # graftlint: guarded-by _lock
        # tenant -> {"series": set of (route, outcome), "stats": dict},
        # LRU-ordered so the cardinality cap evicts the coldest tenant.
        self._tenants: "OrderedDict[str, dict]" = OrderedDict()  # graftlint: guarded-by _lock
        self._alerting = {"availability": False, "latency": False}  # graftlint: guarded-by _lock
        self._last_check = -1  # graftlint: guarded-by _lock
        self._log_fh = None
        self._log_lock = threading.Lock()
        if self.log_path:
            import os

            d = os.path.dirname(self.log_path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._log_fh = open(  # noqa: SIM115 — held for the tracker's life
                self.log_path, "a", encoding="utf-8", buffering=1
            )

    # -- recording -----------------------------------------------------------

    @staticmethod
    def outcome_of(status: int) -> str:
        if status < 300:
            return "ok"
        if status == 429:
            return "rejected"
        if status < 500:
            return "client_error"
        return "error"

    def record(
        self,
        *,
        route: str,
        tenant: str = "default",
        sid: Optional[str] = None,
        status: int = 200,
        reason: Optional[str] = None,
        latency_s: float = 0.0,
        queue_wait_s: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> None:
        """Score one finished request into every SLO product."""
        outcome = self.outcome_of(int(status))
        ok = outcome == "ok"
        avail_bad = outcome == "error"
        lat_bad = ok and latency_s > self.latency_s
        with self._lock:
            label_tenant = self._touch_tenant_locked(
                tenant, route, outcome, ok, avail_bad, lat_bad, latency_s
            )
            sec = int(self._clock())
            self._window.add(sec, avail_bad, ok, lat_bad)
            edges = self._check_burn_locked(sec)
        self._m_requests.labels(
            tenant=label_tenant, route=route, outcome=outcome
        ).inc()
        exemplar = {"trace_id": trace_id} if trace_id else None
        self._m_latency.labels(tenant=label_tenant).observe(
            latency_s, exemplar
        )
        if queue_wait_s is not None:
            self._m_queue_wait.observe(float(queue_wait_s))
        if self._log_fh is not None:
            line = json.dumps(
                {
                    "t": round(self._wall(), 6),
                    "trace": trace_id,
                    "tenant": tenant,
                    "route": route,
                    "sid": sid,
                    "status": int(status),
                    "outcome": outcome,
                    "reason": reason,
                    "queue_wait_s": (
                        round(queue_wait_s, 6)
                        if queue_wait_s is not None
                        else None
                    ),
                    "latency_s": round(latency_s, 6),
                },
                separators=(",", ":"),
            )
            with self._log_lock:
                self._log_fh.write(line + "\n")
        for objective, alerting, burns in edges:
            self._edge_alert(objective, alerting, burns, trace_id)

    def _touch_tenant_locked(
        self, tenant, route, outcome, ok, avail_bad, lat_bad, latency_s
    ) -> str:
        """LRU-touch the tenant; evict + reclaim past the cap.  Returns
        the label to record under (the tenant, or the overflow fold)."""
        entry = self._tenants.get(tenant)
        if entry is None:
            if (
                len(self._tenants) >= self.max_tenants
                and tenant != OVERFLOW_TENANT
            ):
                # Reclaim the coldest tenant's exposition series (the
                # label-reclaim hygiene), fold the newcomer into the overflow label.
                old_tenant, old = self._tenants.popitem(last=False)
                for r, o in old["series"]:
                    self._m_requests.remove(
                        tenant=old_tenant, route=r, outcome=o
                    )
                self._m_latency.remove(tenant=old_tenant)
                self._m_tenants.set(len(self._tenants))
                return self._touch_tenant_locked(
                    OVERFLOW_TENANT, route, outcome, ok, avail_bad,
                    lat_bad, latency_s,
                )
            entry = self._tenants[tenant] = {
                "series": set(),
                "stats": {
                    "requests": 0, "ok": 0, "errors": 0, "rejected": 0,
                    "latency_bad": 0, "latency_sum": 0.0,
                },
            }
            self._m_tenants.set(len(self._tenants))
        else:
            self._tenants.move_to_end(tenant)
        entry["series"].add((route, outcome))
        st = entry["stats"]
        st["requests"] += 1
        st["ok"] += 1 if ok else 0
        st["errors"] += 1 if avail_bad else 0
        st["rejected"] += 1 if outcome == "rejected" else 0
        st["latency_bad"] += 1 if lat_bad else 0
        st["latency_sum"] += latency_s
        return tenant

    # -- burn-rate alerting --------------------------------------------------

    def _burns_locked(self, sec: int) -> Dict[str, Dict[str, float]]:
        """{objective: {window: burn_rate}} over the trailing windows.
        Burn 1.0 = consuming exactly the error budget; > BURN_THRESHOLD in
        both windows pages."""
        budget = max(1e-9, 1.0 - self.availability)
        out: Dict[str, Dict[str, float]] = {
            "availability": {}, "latency": {},
        }
        for wname, wspan in (
            ("fast", self.fast_window_s), ("slow", self.slow_window_s),
        ):
            total, avail_bad, ok, lat_bad = self._window.sums(
                sec, int(wspan)
            )
            out["availability"][wname] = (
                (avail_bad / total) / budget if total else 0.0
            )
            out["latency"][wname] = (
                (lat_bad / ok) / budget if ok else 0.0
            )
        return out

    def _check_burn_locked(self, sec: int) -> list:
        """At most one evaluation per second; returns the transition
        edges to emit (outside the lock)."""
        if sec == self._last_check:
            return []
        self._last_check = sec
        burns = self._burns_locked(sec)
        edges = []
        for objective, by_window in burns.items():
            for wname, rate in by_window.items():
                self._m_burn.labels(objective=objective, window=wname).set(
                    round(rate, 4)
                )
            burning = all(
                rate > BURN_THRESHOLD for rate in by_window.values()
            )
            if burning != self._alerting[objective]:
                self._alerting[objective] = burning
                edges.append((objective, burning, dict(by_window)))
        return edges

    def _edge_alert(self, objective, alerting, burns, trace_id) -> None:
        self._m_alert.labels(objective=objective).set(1 if alerting else 0)
        self.events.emit(
            "slo_burn_alert",
            objective=objective,
            state="firing" if alerting else "resolved",
            burn_fast=round(burns.get("fast", 0.0), 3),
            burn_slow=round(burns.get("slow", 0.0), 3),
            threshold=BURN_THRESHOLD,
            trace=trace_id,
        )
        if alerting:
            self._m_alerts.labels(objective=objective).inc()
            if self.tracer is not None and self.tracer.flight is not None:
                self.tracer.flight.dump("slo_burn", node=self.node)

    # -- exposition ----------------------------------------------------------

    def summary(self) -> dict:
        """The ``/slo`` document: objectives, live burn rates + alert
        states, per-tenant availability/latency, and the latency
        exemplars that link buckets to traces."""
        with self._lock:
            sec = int(self._clock())
            burns = self._burns_locked(sec)
            alerting = dict(self._alerting)
            tenants = {
                t: dict(e["stats"]) for t, e in self._tenants.items()
            }
        per_tenant = {}
        for t, st in tenants.items():
            n = st["requests"]
            scored = max(1, n - st["rejected"])
            per_tenant[t] = {
                "requests": n,
                "rejected": st["rejected"],
                "availability": round(1.0 - st["errors"] / scored, 6),
                "latency_ok_ratio": round(
                    1.0 - st["latency_bad"] / max(1, st["ok"]), 6
                ),
                "mean_latency_s": round(st["latency_sum"] / max(1, n), 6),
            }
            child = self._m_latency.labels(tenant=t)
            snap = child.snapshot()
            per_tenant[t]["exemplars"] = child.exemplar_snapshot()
            per_tenant[t]["latency_count"] = snap["count"]
        return {
            "objectives": {
                "availability": self.availability,
                "latency_ms": round(self.latency_s * 1e3, 3),
                "burn_threshold": BURN_THRESHOLD,
            },
            "windows": {
                "fast_s": self.fast_window_s,
                "slow_s": self.slow_window_s,
            },
            "burn": burns,
            "alerting": alerting,
            "tenants": per_tenant,
            "access_log": self.log_path or None,
        }

    def close(self) -> None:
        if self._log_fh is not None:
            with self._log_lock:
                try:
                    self._log_fh.close()
                finally:
                    self._log_fh = None


def read_access_log(path: str) -> list:
    """Parse a JSONL access log back into dicts (tests/tooling twin of
    the writer; torn trailing lines are skipped, matching read_events)."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def fold_report(records) -> dict:
    """Fold access-log records into a per-tenant SLO table — the
    ``tools/slo_report.py`` engine, importable for the tier-1 smoke
    test.  Pure function: records in, table out."""
    tenants: Dict[str, dict] = {}
    for r in records:
        t = str(r.get("tenant", "default"))
        st = tenants.setdefault(
            t,
            {
                "requests": 0, "ok": 0, "errors": 0, "rejected": 0,
                "latencies": [],
            },
        )
        st["requests"] += 1
        outcome = r.get("outcome")
        if outcome == "ok":
            st["ok"] += 1
        elif outcome == "error":
            st["errors"] += 1
        elif outcome == "rejected":
            st["rejected"] += 1
        lat = r.get("latency_s")
        if isinstance(lat, (int, float)):
            st["latencies"].append(float(lat))
    table = {}
    for t, st in sorted(tenants.items()):
        lats = sorted(st["latencies"])

        def pct(q):
            if not lats:
                return None
            i = min(len(lats) - 1, int(math.ceil(q * len(lats))) - 1)
            return round(lats[max(0, i)], 6)

        scored = max(1, st["requests"] - st["rejected"])
        table[t] = {
            "requests": st["requests"],
            "ok": st["ok"],
            "errors": st["errors"],
            "rejected": st["rejected"],
            "availability": round(1.0 - st["errors"] / scored, 6),
            "p50_s": pct(0.50),
            "p99_s": pct(0.99),
        }
    return table
