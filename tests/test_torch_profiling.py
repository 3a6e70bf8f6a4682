"""``runtime/profiling.py`` on ``torch.profiler``: traces, timed spans,
device memory, the rate-limited capture, and ``POST /profile`` on the
standalone run's endpoint and the cluster frontend (with its ``P.PROFILE``
fan-out to the workers).  Mirrors ``tests/test_profiling.py`` and the
capture contract of ``tests/test_programs.py``.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.obs import FlightRecorder, Tracer, get_tracer, tracing
from akka_game_of_life_tpu_torch.runtime import profiling
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(base, path):
    req = urllib.request.Request(base + path, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    sim = Simulation(SimulationConfig(height=32, width=32, steps_per_call=4, flight_dir=""),
                     device="cpu")
    with profiling.trace(str(tmp_path / "trace")) as prof:
        sim.advance(8)
    assert sim.epoch == 8
    doc = json.loads((tmp_path / "trace" / profiling.TRACE_FILE).read_text())
    # Each chunk's span lands on the timeline.
    chunks = [e for e in doc["traceEvents"]
              if e.get("name") == "sim.chunk" and e.get("cat") == "user_annotation"]
    assert len(chunks) == 2
    assert prof.key_averages()


def test_trace_none_is_noop():
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(""):
        pass


def test_timed_prints_label(capsys):
    with profiling.timed("unit-test-span") as span:
        pass
    assert "[profile] unit-test-span:" in capsys.readouterr().out
    assert span.seconds >= 0 and span.ms == span.seconds * 1e3


def test_timed_becomes_child_span_of_active_trace(capsys):
    t = Tracer(node="n0", recorder=FlightRecorder(directory=None))
    with t.span("sim.advance") as parent:
        with profiling.timed("checkpoint@64"):
            pass
    spans = {s["name"]: s for s in t.finished()}
    child = spans["checkpoint"]
    assert child["parent_id"] == parent.span_id
    assert child["trace_id"] == parent.trace_id
    assert child["attrs"]["label"] == "checkpoint@64"
    capsys.readouterr()


def test_timed_without_active_trace_records_no_span(capsys):
    assert tracing.current() is None
    before = len(get_tracer().finished())
    with profiling.timed("orphan-span"):
        pass
    assert len(get_tracer().finished()) == before
    capsys.readouterr()


def test_device_memory_stats_empty_on_cpu():
    assert profiling.device_memory_stats() == {}


def _capture(tmp_path, now, **kw):
    taken = []
    cap = profiling.ProfilerCapture(
        str(tmp_path), node="t", max_seconds=kw.get("max_seconds", 5.0),
        min_interval_s=kw.get("min_interval_s", 60.0), clock=lambda: now[0],
        sleep=taken.append, start=lambda path: path, stop=lambda prof: None,
    )
    return taken, cap


def test_profiler_capture_clamps_rate_limits_and_sequences(tmp_path):
    now = [1000.0]
    taken, cap = _capture(tmp_path, now)
    res = cap.capture(99.0)  # clamped to max_seconds
    assert res["ok"] and res["seconds"] == 5.0 and taken == [5.0]
    assert res["artifact"].endswith("profile-t-0001") and res["devices"] == {}
    res2 = cap.capture(1.0)  # same instant: rate-limited
    assert not res2["ok"] and res2["status"] == 429
    assert res2["retry_after_s"] == pytest.approx(60.0)
    now[0] += 61.0
    res3 = cap.capture(None)  # the default window, the next sequence number
    assert res3["ok"] and res3["seconds"] == 3.0
    assert res3["artifact"].endswith("profile-t-0002")
    now[0] += 61.0
    assert cap.capture(0.0)["seconds"] == 0.1


def test_profiler_capture_single_flight(tmp_path):
    started, release = threading.Event(), threading.Event()

    def slow_sleep(_s):
        started.set()
        release.wait(30)

    cap = profiling.ProfilerCapture(
        str(tmp_path), node="t", min_interval_s=0.0, clock=lambda: 0.0,
        sleep=slow_sleep, start=lambda path: path, stop=lambda prof: None,
    )
    t = threading.Thread(target=cap.capture, args=(1.0,), daemon=True)
    t.start()
    assert started.wait(30)
    busy = cap.capture(1.0)
    assert not busy["ok"] and busy["status"] == 409
    release.set()
    t.join(30)
    assert not t.is_alive()


def test_profiler_failure_is_a_500(tmp_path):
    def broken(path):
        raise RuntimeError("no profiler")

    cap = profiling.ProfilerCapture(str(tmp_path), start=broken, sleep=lambda s: None)
    res = cap.capture(0.1)
    assert res["status"] == 500 and "no profiler" in res["error"]


def test_real_capture_writes_a_trace(tmp_path):
    cap = profiling.ProfilerCapture(str(tmp_path), node="real", min_interval_s=0.0)
    res = cap.capture(0.1)
    assert res["ok"], res
    assert os.path.exists(os.path.join(res["artifact"], profiling.TRACE_FILE))


def test_run_endpoint_serves_profile(tmp_path, capsys):
    """``run --metrics-port``: /healthz and POST /profile answer while the
    run is alive."""
    port = _free_port()
    results = {}

    def run():
        results["rc"] = tcli.main([
            "run", "--device", "cpu", "--height", "32", "--width", "32",
            "--max-epochs", "400", "--steps-per-call", "1", "--tick", "10ms",
            "--metrics-port", str(port), "--flight-dir", str(tmp_path),
        ])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 60
    while True:
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
                health = json.loads(resp.read())
                break
        except OSError:
            assert time.time() < deadline, "the run's endpoint never came up"
            time.sleep(0.05)
    assert health["ok"] is True
    status, doc = _post(base, "/profile?seconds=0.1")
    assert status == 200 and doc["ok"] and doc["node"] == "standalone"
    assert os.path.exists(os.path.join(doc["artifact"], profiling.TRACE_FILE))
    status, doc = _post(base, "/profile?seconds=0.1")
    assert status == 429  # obs_profile_min_interval_s
    t.join(120)
    assert not t.is_alive() and results["rc"] == 0
    assert f"metrics on :{port}/metrics (+/healthz,/trace,/programs,/cost,/profile)" in (
        capsys.readouterr().out
    )


def test_frontend_profile_captures_and_fans_out(tmp_path):
    """The cluster frontend's POST /profile captures (no longer 501) and
    sends P.PROFILE to every live worker, which captures on its own
    thread."""
    from akka_game_of_life_tpu_torch.runtime.harness import cluster

    cfg = SimulationConfig(height=32, width=32, max_epochs=4, metrics_port=_free_port(),
                           flight_dir=str(tmp_path / "fe"), obs_profile_min_interval_s=0)
    with cluster(cfg, 1, engine="numpy") as h:
        assert h.frontend.wait_for_backends(timeout=30)
        h.workers[0].profile_dir = str(tmp_path / "w0")
        status, doc = _post(f"http://127.0.0.1:{cfg.metrics_port}", "/profile?seconds=0.1")
        assert status == 200 and doc["ok"] and doc["queued"] == ["w0"]
        assert os.path.exists(os.path.join(doc["artifact"], profiling.TRACE_FILE))
        worker_trace = tmp_path / "w0" / "profile-w0-0001" / profiling.TRACE_FILE
        deadline = time.time() + 60
        while not worker_trace.exists():
            assert time.time() < deadline, "the worker never captured"
            time.sleep(0.05)
