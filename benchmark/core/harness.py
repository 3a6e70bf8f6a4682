"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

A driver (``benchmark/traffic/<driver>.py``) exposes ``run(run: Run) ->
Outcome``.  It builds the system under test, warms up the shapes its
traffic uses, measures for ``run.seconds``, and compares what the timed
path produced with the configuration's plain reference once the window
has closed.  The harness here owns what is common: finding the cell, the
per-layer readers, the check for a card and for JAX, and the line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from benchmark.core import spec, window
from benchmark.core.trace import TraceSummary

# Top-level module names the process that prints a result may not hold.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "akka_game_of_life_tpu")


def process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (``/proc/self/stat``, to the kernel's clock tick)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    return time.perf_counter() - age


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read, all of it from one window."""

    config: dict
    mix: dict
    window: Tuple[float, float]
    trace: Optional[TraceSummary] = None
    # The program's metrics registry at the window's start and end.
    registry: Tuple[dict, dict] = ({}, {})
    # The program ledger's records, (family, key) -> {"calls", "seconds"}.
    programs: Tuple[dict, dict] = ({}, {})
    # Spans the benchmark records around calls into the program:
    # name -> [(start perf_counter, seconds)].
    spans: Dict[str, List[Tuple[float, float]]] = dataclasses.field(default_factory=dict)
    # Counts the driver makes (calls in the window, calls traced, ...).
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    def histogram(self, name: str) -> Optional[dict]:
        return window.delta(self.registry[0], self.registry[1], name)

    def span_seconds(self, name: str) -> List[float]:
        lo, hi = self.window
        return [s for t, s in self.spans.get(name, []) if lo <= t < hi]

    def program_delta(self, family: str) -> Dict[str, dict]:
        before, after = self.programs
        out = {}
        for (fam, key), rec in after.items():
            if fam != family:
                continue
            old = before.get((fam, key), {"calls": 0, "seconds": 0.0})
            calls = rec["calls"] - old["calls"]
            if calls > 0:
                out[key] = {"calls": calls, "seconds": rec["seconds"] - old["seconds"]}
        return out


@dataclasses.dataclass
class Outcome:
    setup_s: float
    # End-to-end values by metric name (setup_s apart).
    values: Dict[str, float]
    readings: Readings
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    # Lines for standard error before the checks (sample counts, medians).
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the run's arguments, and where the
    benchmark's own spans land."""

    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    started: float
    spans: Dict[str, List[Tuple[float, float]]] = dataclasses.field(default_factory=dict)

    def span(self, name: str, fn: Callable, finish: Callable[[object], None]) -> Callable:
        """``fn`` wrapped in a host-clock span named ``name``; ``finish``
        waits for the call's result to be ready before the span closes."""
        record = self.spans.setdefault(name, [])

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            finish(out)
            record.append((t0, time.perf_counter() - t0))
            return out

        return timed


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
             started: Optional[float] = None) -> Tuple[Outcome, dict]:
    """Drive one run of ``cell`` on ``device``; returns the outcome and the
    metrics of the result line (end-to-end ones, or with ``trace`` the
    per-layer ones)."""
    run = Run(cell, seed, seconds, trace, device,
              started if started is not None else process_start())
    readers = cell.readers() if trace else {}
    undo = [r.install(run) for r in readers.values() if hasattr(r, "install")]
    try:
        outcome = cell.driver().run(run)
    finally:
        for u in reversed(undo):
            u()
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for name, reader in readers.items():
            v = reader.read(outcome.readings)
            if v is not None:
                values[name] = v
    else:
        values = {m["name"]: outcome.values[m["name"]] for m in cell.end_to_end if m["name"] != "setup_s"}
        values["setup_s"] = outcome.setup_s
    metrics = {name: {"value": v, "unit": units[name]} for name, v in values.items()}
    return outcome, metrics


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def result_line(outcome: Outcome, metrics: dict, trace: bool, device: dict) -> dict:
    line = {
        "correct": all(c.ok for c in outcome.checks),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": device,
    }
    if trace and outcome.readings.trace is not None:
        line["breakdown"] = outcome.readings.trace.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def device_facts(cell: spec.Cell, outcome: Outcome, trace: bool) -> dict:
    import torch

    facts = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": outcome.memory_peak_bytes,
    }
    if trace and outcome.readings.trace is not None:
        facts["busy_s"] = outcome.readings.trace.busy_s
        facts["window_s"] = outcome.readings.trace.window_s
    return facts


def _finite(v):
    return v if not (isinstance(v, float) and math.isinf(v)) else str(v)


def main(argv: List[str]) -> int:
    started = process_start()
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    outcome, metrics = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"modules the benchmark may not load were loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(outcome, metrics, bool(args.trace), device_facts(cell, outcome, bool(args.trace)))
    for key, value in outcome.notes.items():
        print(f"{key}: {_finite(value)}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name}: {c.value} (limit {c.limit}){'' if c.ok else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
