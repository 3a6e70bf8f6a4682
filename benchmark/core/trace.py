"""The device's timeline over one traced slice of the window.

``torch.profiler`` (CPU and CUDA activities) runs from :meth:`Tracer.start`
to :meth:`Tracer.stop`; a ``bench.window`` annotation marks the slice on
the timeline.  The exported Chrome trace is read back into a
:class:`TraceSummary`: the union of the device's intervals (kernels,
copies, sets) inside the slice, the device time of each operation by
name, and the gaps in which the device idled, named by what the host was
doing then.  The file goes to a temporary directory under ``TMPDIR`` and
is deleted once read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

from benchmark.core import window

WINDOW_MARK = "bench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
IDLE_UNNAMED = "host: nothing recorded"
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # Device seconds per operation name, inside the slice.
    ops: Dict[str, float]
    # Idle seconds per host activity, inside the slice.
    idle: Dict[str, float]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def op_seconds(self, fragment: str) -> float:
        """Device seconds of every operation whose name holds ``fragment``."""
        return sum(s for name, s in self.ops.items() if fragment in name)

    def breakdown(self) -> dict:
        def top(d):
            return [[name, s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(self.ops), "idle_gaps": top(self.idle)}


def _normalize(name: str) -> str:
    """Per-epoch annotations (``advance_chunk@1234``) fold into one name."""
    return re.sub(r"@\d+$", "", name)[:160]


def summarize(events: List[dict]) -> TraceSummary:
    """Reduce Chrome trace events to the slice's device busy time,
    operations and idle gaps (seconds)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in complete if e.get("name") == WINDOW_MARK and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise RuntimeError(f"{len(marks)} {WINDOW_MARK} marks in the trace, expected 1")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    device = [e for e in complete if e.get("cat") in DEVICE_CATEGORIES]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    busy = window.union_length(intervals, lo, hi)
    ops: Dict[str, float] = {}
    for e, (a, b) in zip(device, intervals):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            name = _normalize(e.get("name", "?"))
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), _normalize(e.get("name", "?")))
        for e in complete
        if e.get("cat") in HOST_CATEGORIES and e is not marks[0]
    )
    idle: Dict[str, float] = {}
    for (a, b), name in zip(*_name_gaps(window.gaps(intervals, lo, hi), host)):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return TraceSummary(
        window_s=(hi - lo) / 1e6,
        busy_s=busy / 1e6,
        ops=ops,
        idle=idle,
    )


def _name_gaps(gaps: List[Tuple[float, float]], host: List[Tuple[float, float, str]]):
    """Each gap (sorted) named by the shortest host event that covers its
    midpoint: one sweep over the host events, sorted by start."""
    names, active, i = [], [], 0
    for a, b in gaps:
        t = (a + b) / 2
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [e for e in active if e[1] >= t]
        names.append(min(active, key=lambda e: e[1] - e[0])[2] if active else IDLE_UNNAMED)
    return gaps, names


class Tracer:
    """``torch.profiler`` over one slice of the window, every thread's host
    and device operations."""

    def __init__(self) -> None:
        self._prof = None
        self._mark = None
        # The profiler's first start in a process initialises CUPTI, which
        # takes seconds on the card: do it in set-up, not in the window.
        warm = self._profiler()
        warm.start()
        warm.stop()

    @staticmethod
    def _profiler():
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # Every thread's host operations: the serve plane's ticker and
        # handlers run beside the thread that traces, and their kernels are
        # kept only with them.
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        return torch.profiler.profile(activities=acts, experimental_config=config)

    def start(self) -> float:
        """Start the slice; returns when it started (``perf_counter``)."""
        import time

        import torch

        self._prof = self._profiler()
        self._prof.start()
        self._mark = torch.profiler.record_function(WINDOW_MARK)
        self._mark.__enter__()
        return time.perf_counter()

    def stop(self) -> None:
        """End the slice once the device has finished its queued work."""
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()

    def summary(self) -> TraceSummary:
        """Export and read the slice; called once the window has closed, so
        the reading takes no time from the measured system."""
        with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        return summarize(events)
