"""Window arithmetic: rates, percentiles, spreads and device intervals.

Every end-to-end number is all the work over all the time of one measured
window; nothing here takes a median of chunks or of ticks.
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def rate(work: float, seconds: float) -> float:
    """Work per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the samples at or below it.  A failed sample
    is ``math.inf``, slower than any other."""
    if not values:
        raise ValueError("percentile of no samples")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, with Python's ``statistics.quantiles(n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of ``intervals`` inside [lo, hi], sorted by start."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    out.sort()
    return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Overlapping or touching intervals merged, sorted by start."""
    merged: List[Interval] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def union_length(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """How long at least one interval covers inside [lo, hi]."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers."""
    out, reach = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > reach:
            out.append((reach, a))
        reach = max(reach, b)
    if hi > reach:
        out.append((reach, hi))
    return out


def delta(before: dict, after: dict, name: str) -> Optional[dict]:
    """A histogram's ``{"count", "sum"}`` change between two registry
    snapshots, or None where the window observed nothing."""
    a = after.get(name)
    if not isinstance(a, dict):
        return None
    b = before.get(name) or {"count": 0, "sum": 0.0}
    count = a["count"] - b["count"]
    if count <= 0:
        return None
    return {"count": count, "sum": a["sum"] - b["sum"]}
