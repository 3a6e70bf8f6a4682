"""Unified observability: metrics, events, tracing, flight recorder.

The runtime's answer to "what is the steps/s right now, how many peer
retries fired, which epoch caused them, and what happened in the second
before that worker died" — without grepping stdout:

- :class:`MetricsRegistry` — thread-safe counters/gauges/histograms,
  rendered as Prometheus text exposition (``registry.render()`` /
  ``registry.write(path)``);
- :class:`EventLog` — structured JSONL lifecycle events with monotonic
  timestamps and per-node labels (``--log-events``);
- :class:`Tracer` — causally-linked spans (trace/span/parent ids) whose
  context propagates through the cluster wire protocol; exported as
  Chrome trace-event / Perfetto JSON (``--trace-file``, ``/trace``);
- :class:`FlightRecorder` — a bounded ring of the last N spans + events,
  dumped to ``artifacts/flightrec-<node>-<ts>.json`` on crashes,
  supervision replays, node-loss redeploys, and SIGTERM;
- :class:`MetricsServer` — live ``/metrics`` + ``/healthz`` + ``/trace``
  HTTP endpoint (``--metrics-port``);
- :class:`MetricsDumper` — the shared ``--metrics-file`` dump policy
  (atomic writes, warn-once failure containment) every role uses;
- :class:`ProgramRegistry` (:mod:`.programs`) — the jit-program ledger:
  compile bills, per-family throughput/roofline pricing, compile-storm
  alerts, and the cluster-merged ``/programs`` + ``/cost`` endpoints;
- :mod:`.catalog` — every exported metric, declared once, pre-registered
  into the default registry and lint-checked against the operations doc
  (span names get the same treatment via ``tracing.SPAN_CATALOG`` and
  ``tools/check_trace_names.py``).

Instrumented layers: the simulation hot loop, the cluster backend's peer
data plane and retry machinery, the frontend's membership/redeploy paths,
the chaos injector, and both checkpoint stores.
"""

from akka_game_of_life_tpu_torch.obs.catalog import CATALOG, install
from akka_game_of_life_tpu_torch.obs.dump import MetricsDumper
from akka_game_of_life_tpu_torch.obs.events import NULL_EVENTS, EventLog, read_events
from akka_game_of_life_tpu_torch.obs.flight import FlightRecorder, read_flight
from akka_game_of_life_tpu_torch.obs.httpd import MetricsServer
from akka_game_of_life_tpu_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    MetricsRegistry,
    escape_label_value,
    get_registry,
)
from akka_game_of_life_tpu_torch.obs.programs import (
    ProgramRegistry,
    get_programs,
    registered_jit,
)
from akka_game_of_life_tpu_torch.obs.tracing import (
    SPAN_CATALOG,
    TRACE_KEY,
    Span,
    Tracer,
    get_tracer,
)

__all__ = [
    "CATALOG",
    "DEFAULT_BUCKETS",
    "EventLog",
    "FlightRecorder",
    "MetricsDumper",
    "MetricsRegistry",
    "MetricsServer",
    "NULL_EVENTS",
    "ProgramRegistry",
    "SPAN_CATALOG",
    "Span",
    "TRACE_KEY",
    "Tracer",
    "escape_label_value",
    "get_programs",
    "get_registry",
    "get_tracer",
    "install",
    "registered_jit",
    "read_events",
    "read_flight",
]
