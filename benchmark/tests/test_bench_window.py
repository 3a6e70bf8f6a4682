"""The window arithmetic on synthetic records."""

import math

import pytest

from benchmark.core import trace, window


def test_rate_is_all_the_work_over_all_the_time():
    assert window.rate(4.3e9 * 600, 2.0) == pytest.approx(1.29e12)
    with pytest.raises(ValueError):
        window.rate(1, 0)


def test_percentile_counts_failures_as_slowest():
    ok = [float(v) for v in range(1, 101)]
    assert window.percentile(ok, 95) == 95.0
    assert window.percentile(ok, 50) == 50.0
    # Six failures of 100: the 95th percentile is a failure.
    failed = ok[:94] + [math.inf] * 6
    assert window.percentile(failed, 95) == math.inf
    assert window.percentile(failed, 94) == 94.0


def test_quartile_spread_uses_python_quartiles():
    assert window.quartile_spread([10, 10, 10, 10]) == 0.0
    q1, med, q3 = 9.25, 10.5, 11.75  # statistics.quantiles([9, 10, 11, 12], n=4)
    assert window.quartile_spread([9, 10, 11, 12]) == pytest.approx((q3 - q1) / med)


def test_union_of_device_intervals():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert window.union(spans) == [(0, 3), (5, 6), (9, 12)]
    assert window.union_length(spans, 0, 10) == pytest.approx(5.0)
    assert window.gaps(spans, 0, 10) == [(3, 5), (6, 9)]


def test_histogram_delta_over_the_window():
    before = {"h": {"count": 2, "sum": 1.0}}
    after = {"h": {"count": 5, "sum": 4.0}}
    assert window.delta(before, after, "h") == {"count": 3, "sum": 3.0}
    assert window.delta(after, after, "h") is None
    assert window.delta({}, {}, "h") is None


def _x(name, cat, ts, dur, **kw):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **kw}


def test_trace_summary_clips_to_the_marked_slice():
    events = [
        _x(trace.WINDOW_MARK, "user_annotation", 100.0, 1000.0),
        _x("k", "kernel", 50.0, 100.0),       # half inside
        _x("k", "kernel", 300.0, 100.0),
        _x("copy", "gpu_memcpy", 350.0, 100.0),  # overlaps the kernel
        _x("k", "kernel", 1050.0, 200.0),     # half inside
        _x("aten::add", "cpu_op", 450.0, 400.0),
        _x("gpu side", "gpu_user_annotation", 100.0, 1000.0),  # not a device op
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1e-3)
    busy = 50 + (450 - 300) + 50
    assert s.busy_s == pytest.approx(busy / 1e6)
    assert s.idle_share == pytest.approx(1 - busy / 1000)
    assert s.op_seconds("k") == pytest.approx((50 + 100 + 50) / 1e6)
    # Gaps: 150-300 (nothing on the host), 450-1050 (aten::add covers 650).
    assert s.idle["aten::add"] == pytest.approx(600 / 1e6)
    assert s.idle[trace.IDLE_UNNAMED] == pytest.approx(150 / 1e6)
    top = s.breakdown()
    assert top["device_ops"][0][0] == "k" and len(top["idle_gaps"]) == 2


def test_trace_summary_needs_one_mark():
    with pytest.raises(RuntimeError):
        trace.summarize([_x("k", "kernel", 0.0, 1.0)])
