"""Thread-safe runtime metrics — counters, gauges, fixed-bucket histograms.

The reference system's only runtime signal is its log stream; this registry
is the first-class replacement: every hot and failure path (stepper chunks,
peer retries, chaos crashes, checkpoint IO) records into named instruments,
and the whole registry renders as Prometheus text exposition (format 0.0.4)
— dumped to ``--metrics-file`` on exit and served live at ``/metrics`` by
:mod:`akka_game_of_life_tpu_torch.obs.httpd`.

Design points:

- One lock per registry, taken only for child-creation and rendering;
  increments hit per-instrument locks (counters are on hot-ish paths — the
  retry loop, per-chunk accounting — but never inside jitted code).
- Instruments are created idempotently: ``registry.counter(name)`` returns
  the existing counter if the name is known, so instrumentation sites never
  need to coordinate registration order.
- Labeled instruments follow the Prometheus child model:
  ``c.labels(mode="tile").inc()``.  Unlabeled instruments expose a sample
  even at zero; labeled ones expose HELP/TYPE headers until a child exists
  (so the catalog is visible in every scrape either way).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

# Latency buckets shared by the step/obs/checkpoint histograms: half-decade
# log spacing from 0.5 ms to 60 s — wide enough for a CPU-interpret chunk
# and fine enough to separate a 2 ms from a 5 ms TPU chunk.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or any(ch not in _NAME_OK for ch in name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def escape_label_value(value: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double-quote,
    and newline (in that order, so the backslash pass cannot re-escape)."""
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def format_value(v: float) -> str:
    """Render a sample value: integers without a trailing .0, infinities in
    Prometheus spelling."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v != int(v):
        return repr(v)
    return str(int(v))


def _labels_suffix(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


class _Child:
    """One (labelset, value) series of an instrument."""

    __slots__ = ("_lock", "_value", "touched")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0  # graftlint: guarded-by _lock
        # Ever mutated?  snapshot() filters on this, not the value — a gauge
        # that was set and legitimately returned to 0 is still reported.
        self.touched = False

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters are monotonic; cannot inc by {amount}")
        with self._lock:
            self._value += amount
            self.touched = True


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self.touched = True

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self.touched = True

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount
            self.touched = True


class _HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count", "exemplars")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # graftlint: guarded-by _lock
        self.sum = 0.0  # graftlint: guarded-by _lock
        self.count = 0  # graftlint: guarded-by _lock
        # Last exemplar per bucket index: (value, labels dict) — the click-
        # through from a latency bucket to a concrete trace.  Sparse: only
        # observes that pass an exemplar populate it.
        self.exemplars: Dict[int, Tuple[float, Dict[str, str]]] = {}  # graftlint: guarded-by _lock

    @property
    def touched(self) -> bool:
        # graftlint: waive GL-LOCK01 -- GIL-atomic read of a monotonic int used only as the exposition filter; a stale read under-reports one scrape and the next corrects it
        return self.count > 0

    def observe(
        self, value: float, exemplar: Optional[Mapping[str, str]] = None
    ) -> None:
        with self._lock:
            i = 0
            for i, le in enumerate(self.buckets):  # noqa: B007
                if value <= le:
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            self.sum += value
            self.count += 1
            if exemplar:
                self.exemplars[i] = (value, dict(exemplar))

    def exemplar_snapshot(self) -> list:
        """Per-bucket exemplars as ``[{"le", "value", "labels"}]`` (newest
        per bucket), keyed by the bucket's upper bound — what ``/slo``
        serves so a p99 spike clicks through to its trace id."""
        with self._lock:
            items = sorted(self.exemplars.items())
        bounds = list(self.buckets) + [math.inf]
        return [
            {"le": format_value(bounds[i]), "value": v, "labels": labels}
            for i, (v, labels) in items
        ]

    def snapshot(self) -> dict:
        """Cumulative bucket counts keyed by upper bound, plus sum/count."""
        with self._lock:
            counts = list(self.counts)
            total, n = self.sum, self.count
        out, cum = {}, 0
        for le, c in zip(self.buckets, counts):
            cum += c
            out[le] = cum
        out[math.inf] = cum + counts[-1]
        return {"buckets": out, "sum": total, "count": n}


class _Instrument:
    """A named metric family: type, help text, label names, children."""

    def __init__(
        self,
        name: str,
        kind: str,
        help: str,
        labelnames: Tuple[str, ...],
        buckets: Optional[Tuple[float, ...]] = None,
    ) -> None:
        self.name = _check_name(name)
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}  # graftlint: guarded-by _lock
        if not labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        if self.kind == "histogram":
            return _HistogramChild(self.buckets)
        return _CounterChild() if self.kind == "counter" else _GaugeChild()

    def labels(self, **labels: str):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{tuple(labels)}"
            )
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def remove(self, **labels: str) -> None:
        """Drop one labeled child from the exposition.  A departed label
        set (an evicted tenant, a drained peer) must not export forever —
        unbounded label cardinality is a memory leak.  Removing a counter
        child forfeits its monotonic history (rate() handles the reset);
        callers own that trade.  No-op when the child never existed."""
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    # Unlabeled convenience passthroughs -------------------------------------

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels(...)"
            )
        # graftlint: waive GL-LOCK01 -- the () child is created in __init__ and never replaced; a GIL-atomic dict read of an immortal key needs no lock on the hot inc() path
        return self._children[()]

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(
        self, value: float, exemplar: Optional[Mapping[str, str]] = None
    ) -> None:
        self._default().observe(value, exemplar)

    @property
    def value(self) -> float:
        return self._default().value

    def series(self) -> Iterable[Tuple[Dict[str, str], object]]:
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            yield dict(zip(self.labelnames, key)), child


class MetricsRegistry:
    """A process- or component-scoped set of named instruments.

    ``counter``/``gauge``/``histogram`` are get-or-create: re-asking for a
    known name returns the existing instrument (mismatched type or labels
    raises, so two call sites cannot silently split a metric)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}  # graftlint: guarded-by _lock

    def _get_or_create(
        self,
        name: str,
        kind: str,
        help: str,
        labelnames: Sequence[str],
        buckets: Optional[Sequence[float]] = None,
    ) -> _Instrument:
        labelnames = tuple(labelnames)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if inst.kind != kind or inst.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name} already registered as {inst.kind}"
                        f"{inst.labelnames}; asked for {kind}{labelnames}"
                    )
                return inst
            if buckets is not None:
                buckets = tuple(sorted(float(b) for b in buckets))
                if not buckets:
                    raise ValueError("histogram needs at least one bucket")
            inst = _Instrument(name, kind, help, labelnames, buckets)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        return self._get_or_create(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        return self._get_or_create(name, "gauge", help, labelnames)

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        return self._get_or_create(name, "histogram", help, labelnames, buckets)

    def names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._instruments))

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def value(self, name: str, **labels: str) -> float:
        """Read one series' current value (0.0 for a never-touched labelset
        of a known instrument) — the test/assertion surface."""
        inst = self.get(name)
        if inst is None:
            raise KeyError(name)
        if labels or inst.labelnames:
            return inst.labels(**labels).value
        return inst.value

    # -- exposition ----------------------------------------------------------

    def render(self) -> str:
        """The whole registry in Prometheus text exposition format 0.0.4,
        families sorted by name, with HELP/TYPE headers for every family
        (including labeled families that have no series yet)."""
        lines = []
        with self._lock:
            families = [self._instruments[n] for n in sorted(self._instruments)]
        for inst in families:
            if inst.help:
                lines.append(f"# HELP {inst.name} {_escape_help(inst.help)}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            for labels, child in inst.series():
                if inst.kind == "histogram":
                    snap = child.snapshot()
                    for le, cum in snap["buckets"].items():
                        bl = dict(labels)
                        bl["le"] = format_value(le)
                        lines.append(
                            f"{inst.name}_bucket{_labels_suffix(bl)} {cum}"
                        )
                    lines.append(
                        f"{inst.name}_sum{_labels_suffix(labels)} "
                        f"{repr(snap['sum']) if snap['sum'] else '0'}"
                    )
                    lines.append(
                        f"{inst.name}_count{_labels_suffix(labels)} "
                        f"{snap['count']}"
                    )
                else:
                    lines.append(
                        f"{inst.name}{_labels_suffix(labels)} "
                        f"{format_value(child.value)}"
                    )
        return "\n".join(lines) + "\n"

    def snapshot(self, nonzero_only: bool = True) -> Dict[str, object]:
        """A compact JSON-able view of every live series — the shape bench
        records embed so a throughput line carries its halo-bytes and
        span-latency context.  Counters/gauges map name (with a label
        suffix for labeled series) to value; histograms map to
        ``{"count", "sum"}``.  ``nonzero_only`` drops never-*touched*
        series (so the pre-installed catalog doesn't bloat every record) —
        a gauge that was set and legitimately returned to 0 stays in."""
        out: Dict[str, object] = {}
        with self._lock:
            families = [self._instruments[n] for n in sorted(self._instruments)]
        for inst in families:
            for labels, child in inst.series():
                if nonzero_only and not child.touched:
                    continue
                key = f"{inst.name}{_labels_suffix(labels)}"
                if inst.kind == "histogram":
                    snap = child.snapshot()
                    out[key] = {"count": snap["count"], "sum": snap["sum"]}
                else:
                    out[key] = child.value
        return out

    def write(self, path: str) -> None:
        """Dump the exposition atomically (tmp + rename): a scrape of the
        file never sees a torn write, matching the checkpoint store's
        durability idiom."""
        from akka_game_of_life_tpu_torch.obs.ioutil import atomic_write_text

        atomic_write_text(path, self.render(), prefix=".metrics_")


_GLOBAL_LOCK = threading.Lock()
_GLOBAL: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (created on first use, with the
    standard catalog installed so every exposition shows the full metric
    surface — zeros included)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            from akka_game_of_life_tpu_torch.obs.catalog import install

            _GLOBAL = MetricsRegistry()
            install(_GLOBAL)
        return _GLOBAL
