"""The port's tracer spans on the profiler's timeline and in
``gol_span_seconds``: the run's chunk and the parts of a cadence
observation, the serve tick's parts, the cost with no profiler running,
and the port's span names against its ``SPAN_CATALOG`` and its documents
(the port's counterpart of GL-DOC02: the JAX package's tracing table in
``docs/OPERATIONS.md``, the port's own spans in ``README.md``)."""

import io
import json
import re
import threading
from pathlib import Path

import pytest
import torch

from akka_game_of_life_tpu_torch.obs import FlightRecorder, Tracer, catalog, tracing
from akka_game_of_life_tpu_torch.obs.metrics import MetricsRegistry
from akka_game_of_life_tpu_torch.runtime import profiling
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation
from akka_game_of_life_tpu_torch.serve.sessions import SessionRouter

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "akka_game_of_life_tpu_torch"
OBSERVE = ("sim.observe", "obs.sync", "obs.dispatch", "obs.fetch", "obs.emit")
SERVE = ("serve.pad", "serve.dispatch", "serve.fetch", "serve.scatter")


def _sim(registry=None, tracer=None, **kw):
    cfg = dict(height=64, width=64, seed=3, steps_per_call=4, metrics_every=4, flight_dir="")
    cfg.update(kw)
    return Simulation(SimulationConfig(**cfg),
                      observer=BoardObserver(out=io.StringIO(), metrics_every=cfg["metrics_every"]),
                      device="cpu", registry=registry, tracer=tracer)


def _tracer():
    return Tracer(node="t", recorder=FlightRecorder(directory=None))


def _span_counts(registry) -> dict:
    return {labels["span"]: child.snapshot()["count"]
            for labels, child in registry.get("gol_span_seconds").series()}


def _annotations(path) -> list:
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("digest", [False, True])
def test_a_traced_run_puts_its_spans_on_the_timeline(tmp_path, digest):
    sim = _sim(obs_digest=digest)
    with profiling.trace(str(tmp_path)):
        sim.advance(8)
    sim.close()
    marks = _annotations(tmp_path / profiling.TRACE_FILE)
    by_name = {}
    for e in marks:
        by_name.setdefault(e["name"], []).append(e)
    assert len(by_name["sim.chunk"]) == 2
    for name in OBSERVE:
        assert len(by_name[name]) == 2, name
    for part in OBSERVE[1:]:
        assert all(any(_inside(p, o) for o in by_name["sim.observe"]) for p in by_name[part])
    if digest:
        assert len(by_name["obs.digest"]) == 2
        assert all(any(_inside(d, o) for o in by_name["obs.dispatch"])
                   for d in by_name["obs.digest"])
    else:
        assert "obs.digest" not in by_name


@pytest.fixture
def record_functions(monkeypatch):
    """Every ``torch.profiler.record_function`` the tracer enters."""
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return entered


def test_no_profiler_no_record_function(record_functions, tmp_path):
    assert not tracing.profiler_running()
    sim = _sim(obs_digest=True)
    sim.advance(8)
    assert record_functions == []
    with profiling.trace(str(tmp_path)):
        assert tracing.profiler_running()
        sim.advance(4)
    sim.close()
    assert not tracing.profiler_running()
    assert record_functions.count("sim.chunk") == 1
    assert record_functions.count("obs.digest") == 1


def test_a_span_started_apart_is_not_annotated(record_functions, tmp_path):
    t = _tracer()
    with profiling.trace(str(tmp_path)):
        t.start("sim.observe").finish()
        with t.span("sim.chunk"):
            with profiling.timed("checkpoint@8", out=io.StringIO()):
                pass
    assert record_functions == ["sim.chunk"]
    assert {s["name"] for s in t.finished()} == {"sim.observe", "sim.chunk", "checkpoint"}


def test_each_span_counts_once_in_its_registry(tmp_path):
    registry = catalog.install(MetricsRegistry())
    tracer = _tracer()
    sim = _sim(registry, tracer, obs_digest=True, checkpoint_dir=str(tmp_path),
               checkpoint_every=8, checkpoint_async=False)
    sim.advance(16)
    sim.close()
    counts = _span_counts(registry)
    assert {name: counts[name] for name in OBSERVE} == {name: 4 for name in OBSERVE}
    # One series per interval: the chunk is gol_step_seconds and the digest
    # gol_digest_seconds, and profiling.timed keeps its one observation
    # (the tracer's child span of it adds none).
    assert "sim.chunk" not in counts and "obs.digest" not in counts
    snap = registry.snapshot()
    assert snap["gol_step_seconds"]["count"] == 4
    assert snap["gol_digest_seconds"]["count"] == 4
    assert counts["checkpoint"] == 2
    assert [s["name"] for s in tracer.finished()].count("checkpoint") == 2
    digest_spans = [s for s in tracer.finished() if s["name"] == "obs.digest"]
    assert len(digest_spans) == 4
    assert snap["gol_digest_seconds"]["sum"] == pytest.approx(
        sum(s["duration"] for s in digest_spans))
    assert all(re.fullmatch("[0-9a-f]{16}", s["attrs"]["digest"])
               for s in tracer.finished() if s["name"] == "obs.emit")
    # Every observation's parts are children of its sim.observe.
    spans = tracer.finished()
    ids = {s["span_id"]: s for s in spans}
    for s in spans:
        if s["name"] in OBSERVE[1:]:
            assert ids[s["parent_id"]]["name"] == "sim.observe"
        if s["name"] == "obs.digest":
            assert ids[s["parent_id"]]["name"] == "obs.dispatch"


def test_deferred_dispatch_and_emit_each_open_their_own_observe():
    registry = MetricsRegistry()
    tracer = _tracer()
    sim = _sim(registry, tracer, obs_defer=True, obs_digest=True)
    sim.advance(12)
    sim.close()
    spans = tracer.finished()
    ids = {s["span_id"]: s for s in spans}
    observes = [s for s in spans if s["name"] == "sim.observe"]
    assert len(observes) == 6
    children = {}
    for s in spans:
        if s["parent_id"] in ids and ids[s["parent_id"]]["name"] == "sim.observe":
            children.setdefault(s["parent_id"], []).append(s["name"])
    parts = sorted(tuple(sorted(c)) for c in children.values())
    assert parts == [("obs.dispatch",)] * 3 + [("obs.emit", "obs.fetch")] * 3
    counts = _span_counts(registry)
    assert counts["sim.observe"] == 6 and "obs.sync" not in counts
    assert counts["obs.dispatch"] == counts["obs.fetch"] == counts["obs.emit"] == 3


def test_a_serve_tick_splits_into_its_parts():
    registry = catalog.install(MetricsRegistry())
    tracer = _tracer()
    router = SessionRouter(SimulationConfig(role="serve", flight_dir=""), registry=registry,
                           tracer=tracer, device="cpu")
    try:
        sids = [router.create(height=h, width=w, seed=i, with_board=False)["id"]
                for i, (h, w) in enumerate([(32, 32), (20, 30), (64, 64)])]
        router.pause()
        jobs = [router.submit(sid, 8) for sid in sids]
        router.resume()
        assert all(job.done.wait(60) for job in jobs)
        assert all(job.error is None for job in jobs)
        router.wait_idle(sids)
    finally:
        router.close()
    spans = tracer.finished()
    ids = {s["span_id"]: s for s in spans}
    ticks = [s for s in spans if s["name"] == "serve.tick"]
    assert len(ticks) == 1
    # One tick, two size classes (32 and 64): each part once a class batch.
    for name in SERVE:
        mine = [s for s in spans if s["name"] == name]
        assert len(mine) == 2, name
        assert all(ids[s["parent_id"]] is ticks[0] for s in mine)
    counts = _span_counts(registry)
    assert {name: counts[name] for name in SERVE} == {name: 2 for name in SERVE}
    assert registry.snapshot()["gol_serve_tick_seconds"]["count"] == 1


def test_serve_spans_land_on_an_all_threads_timeline(tmp_path):
    """The ticker's spans reach a profiler started on another thread with
    ``profile_all_threads`` (the benchmark's traced slice)."""
    registry = MetricsRegistry()
    router = SessionRouter(SimulationConfig(role="serve", flight_dir=""), registry=registry,
                           tracer=_tracer(), device="cpu")
    try:
        sid = router.create(height=32, width=32, seed=5, with_board=False)["id"]
        router.step(sid, 1)
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                      experimental_config=config)
        prof.start()
        try:
            done = []
            t = threading.Thread(target=lambda: done.append(router.step(sid, 4)))
            t.start()
            t.join(60)
            assert done
        finally:
            prof.stop()
    finally:
        router.close()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in _annotations(path)}
    assert {"serve.tick", *SERVE} <= names


# -- the port's span names: code, catalog, doc ---------------------------------

# A span-name literal opened through the tracer (the JAX package's GL-DOC02
# pattern, over the port's sources).
SPAN_CALL = re.compile(r"""\.(?:span|start|_span)\(\s*\n?\s*["']([a-z][a-z0-9_.]*)["']""", re.M)


def _catalog() -> set:
    return {name for name, _ in tracing.SPAN_CATALOG}


def _port_sources():
    return sorted(PORT.rglob("*.py"))


def test_every_span_the_port_opens_is_cataloged():
    emitted = {}
    for path in _port_sources():
        for m in SPAN_CALL.finditer(path.read_text()):
            emitted.setdefault(m.group(1), path.relative_to(ROOT).as_posix())
    assert {"sim.observe", "obs.fetch", "serve.dispatch"} <= set(emitted)
    assert {n: where for n, where in emitted.items() if n not in _catalog()} == {}


def test_every_cataloged_span_is_emitted_and_documented():
    # Emitted: the name as a literal anywhere in the port outside the
    # catalog (the checkpoint store opens its spans through a helper).
    text = "\n".join(p.read_text() for p in _port_sources() if p.name != "tracing.py")
    quoted = set(re.findall(r"""["']([a-z][a-z0-9_.]*)["']""", text))
    assert sorted(_catalog() - quoted) == []
    # Documented: the JAX package's table, whose names the port shares, or
    # the port's own table in README.md.
    doc = "\n".join((ROOT / name).read_text() for name in ("docs/OPERATIONS.md", "README.md"))
    assert sorted(n for n in _catalog() if f"`{n}`" not in doc) == []
    readme = (ROOT / "README.md").read_text()
    assert all(f"| `{n}` |" in readme for n in (*OBSERVE, *SERVE))
