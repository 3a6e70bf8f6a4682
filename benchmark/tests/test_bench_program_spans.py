"""The readers of the program's own spans and of the digest's ledger
family, on synthetic readings: the arithmetic, and None where the window
observed nothing (as on a program that has no such span or family)."""

import pytest

from benchmark.core import spec
from benchmark.core.harness import Readings


def _reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py")


def _span(name):
    return f'gol_span_seconds{{span="{name}"}}'


def _readings(before=None, after=None, programs=({}, {})):
    return Readings(config={}, mix={}, window=(0.0, 1.0),
                    registry=(before or {}, after or {}), programs=programs)


@pytest.mark.parametrize("metric,span", [("obs_fetch_ms_per_cadence", "obs.fetch"),
                                         ("obs_dispatch_ms_per_cadence", "obs.dispatch"),
                                         ("obs_emit_ms_per_cadence", "obs.emit")])
def test_observation_spans_sum_over_count(metric, span):
    read = _reader(metric).read
    r = _readings({_span(span): {"count": 4, "sum": 0.5}},
                  {_span(span): {"count": 14, "sum": 0.5 + 10 * 0.0061},
                   _span("obs.sync"): {"count": 14, "sum": 3.0}})
    assert read(r) == pytest.approx(6.1)
    # A series new in the window counts from zero.
    assert read(_readings({}, {_span(span): {"count": 2, "sum": 0.004}})) == pytest.approx(2.0)
    # Nothing observed in the window, or no such span at all.
    assert read(_readings({_span(span): {"count": 4, "sum": 0.5}},
                          {_span(span): {"count": 4, "sum": 0.5}})) is None
    assert read(_readings({}, {"gol_obs_seconds": {"count": 9, "sum": 0.1}})) is None


def _serve(spans, before_spans=None):
    """Readings of a window of 20 router ticks."""
    before = {"gol_serve_tick_seconds": {"count": 10, "sum": 14.5}}
    after = {"gol_serve_tick_seconds": {"count": 30, "sum": 43.5}}
    before.update({_span(k): v for k, v in (before_spans or {}).items()})
    after.update({_span(k): v for k, v in spans.items()})
    return _readings(before, after)


@pytest.mark.parametrize("metric,span", [("serve_dispatch_ms_per_tick", "serve.dispatch"),
                                         ("serve_fetch_ms_per_tick", "serve.fetch")])
def test_serve_span_per_tick(metric, span):
    read = _reader(metric).read
    # 20 ticks in the window, two class batches a tick: per tick, not per batch.
    r = _serve({span: {"count": 45, "sum": 1.0 + 20 * 0.43}}, {span: {"count": 5, "sum": 1.0}})
    assert read(r) == pytest.approx(430.0)
    assert read(_serve({})) is None
    assert read(_readings({}, {_span(span): {"count": 1, "sum": 0.4}})) is None


def test_serve_host_sums_pad_and_scatter_per_tick():
    read = _reader("serve_host_ms_per_tick").read
    r = _serve({"serve.pad": {"count": 20, "sum": 20 * 0.004},
                "serve.scatter": {"count": 20, "sum": 20 * 0.011},
                "serve.fetch": {"count": 20, "sum": 20.0}})
    assert read(r) == pytest.approx(15.0)
    assert read(_serve({"serve.dispatch": {"count": 20, "sum": 8.0}})) is None


def test_digest_device_time_per_call_from_the_ledger():
    read = _reader("digest_device_ms_per_call").read
    key = repr(("packed", 65536, 2048, 65536))
    before = {("digest", key): {"calls": 3, "seconds": 3.75},
              ("pallas", "k"): {"calls": 30, "seconds": 0.25}}
    after = {("digest", key): {"calls": 37, "seconds": 3.75 + 34 * 1.2571},
             ("pallas", "k"): {"calls": 300, "seconds": 2.5}}
    assert read(_readings(programs=(before, after))) == pytest.approx(1257.1)
    # A second shape's calls pool with the first's.
    after[("digest", "other")] = {"calls": 6, "seconds": 6 * 0.0125}
    assert read(_readings(programs=(before, after))) == pytest.approx(
        1e3 * (34 * 1.2571 + 6 * 0.0125) / 40)
    # No call in the window; no digest family (a program without it).
    assert read(_readings(programs=(before, before))) is None
    assert read(_readings(programs=({}, {("pallas", "k"): {"calls": 3, "seconds": 0.1}}))) is None
