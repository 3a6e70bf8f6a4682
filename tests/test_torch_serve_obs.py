"""The port's serve observability: the SLO plane (``obs/slo.py``) and the
canary prober (``serve/canary.py``) against the JAX package's.

SLO burn windows run on an injected clock and both packages' trackers must
emit the same alert edges and gauges; the canary probes a real HTTP
surface over the port's router and certifies every answer.
"""

import json


import akka_game_of_life_tpu.obs.events as j_events
import akka_game_of_life_tpu.obs.slo as j_slo
import akka_game_of_life_tpu.obs.tracing as j_tracing
import akka_game_of_life_tpu_torch.obs.events as t_events
import akka_game_of_life_tpu_torch.obs.slo as t_slo
import akka_game_of_life_tpu_torch.obs.tracing as t_tracing
from akka_game_of_life_tpu_torch.serve.canary import CanaryProber
from _torch_serve_pkgs import PKGS, cfg, http, serve_stack

MODS = {"jax": (j_slo, j_events, j_tracing), "torch": (t_slo, t_events, t_tracing)}


def _burn_drill(name, tmp_path):
    slo_mod, events_mod, tracing_mod = MODS[name]
    pkg = PKGS[name]
    now = [1000.0]
    flight_dir = tmp_path / name
    tracer = tracing_mod.Tracer(node="slo-test")
    tracer.flight.configure(directory=str(flight_dir), node="slo-test")
    events = []
    log = events_mod.EventLog(None, node="slo-test")
    log.emit = lambda event, **f: events.append((event, f))
    registry = pkg.registry()
    config = cfg(pkg, serve_slo_fast_window_s=5.0, serve_slo_slow_window_s=20.0,
                 flight_dir=str(flight_dir))
    slo = slo_mod.SloTracker(config, registry=registry, tracer=tracer, events=log,
                             clock=lambda: now[0])
    trail = []
    for latency, n in ((0.9, 25), (0.001, 30)):
        for _ in range(n):
            slo.record(route="step", tenant="t", latency_s=latency, trace_id="abc")
            now[0] += 1.0
        trail.append((
            registry.value("gol_serve_slo_burn_alert", objective="latency"),
            registry.value("gol_serve_slo_alerts_total", objective="latency"),
            registry.value("gol_serve_slo_burn_alert", objective="availability"),
        ))
    summary = slo.summary()
    slo.close()
    edges = [(f["objective"], f["state"], round(f["burn_fast"], 6)) for e, f in events
             if e == "slo_burn_alert"]
    dumps = sorted(json.loads(p.read_text())["reason"] for p in flight_dir.glob("flightrec-*.json"))
    return edges, trail, dumps, summary["tenants"]["t"]["requests"]


def test_slo_burn_windows_match_jax_on_an_injected_clock(tmp_path):
    got = _burn_drill("torch", tmp_path)
    assert got == _burn_drill("jax", tmp_path)
    edges, trail, dumps, requests = got
    assert [e[:2] for e in edges] == [("latency", "firing"), ("latency", "resolved")]
    assert edges[0][2] > t_slo.BURN_THRESHOLD
    assert trail[0][:2] == (1, 1) and trail[1][0] == 0
    assert "slo_burn" in dumps and requests == 55


def test_slo_route_and_access_log(tmp_path):
    """/slo next to /boards scores the tenant; the JSONL access log folds
    into the same table."""
    pkg = PKGS["torch"]
    log = tmp_path / "access.log"
    router, server, base = serve_stack(pkg, cfg(pkg, serve_slo_log=str(log)))
    try:
        _, doc = http(base, "POST", "/boards", {"tenant": "acme", "height": 16, "width": 16, "seed": 3})
        for _ in range(3):
            assert http(base, "POST", f"/boards/{doc['id']}/step", {})[0] == 200
        assert http(base, "GET", "/boards/nope")[0] == 404
        status, slo = http(base, "GET", "/slo")
        assert status == 200 and slo["objectives"]["burn_threshold"] == t_slo.BURN_THRESHOLD
        assert slo["tenants"]["acme"]["requests"] >= 4
        assert slo["tenants"]["acme"]["availability"] == 1.0
    finally:
        server.close()
        router.close()
    records = t_slo.read_access_log(str(log))
    step = next(r for r in records if r["route"] == "step")
    assert step["tenant"] == "acme" and step["outcome"] == "ok" and step["sid"] == doc["id"]
    folded = t_slo.fold_report(records)
    assert folded["acme"]["ok"] >= 4 and folded["acme"]["errors"] == 0


def test_canary_round_is_certified_then_pages_on_corruption(tmp_path):
    pkg = PKGS["torch"]
    registry = pkg.registry()
    router, server, base = serve_stack(pkg, registry=registry)
    tracer = t_tracing.Tracer(node="canary-test")
    tracer.flight.configure(directory=str(tmp_path), node="canary-test")
    canary = CanaryProber(cfg(pkg, serve_canary=True), base=base, registry=registry, tracer=tracer)
    try:
        assert canary.probe_now() == {"local": "ok"}
        assert canary.probe_now() == {"local": "ok"}
        assert registry.value("gol_canary_sessions") == 1
        assert (registry.value("gol_canary_failures_total") or 0) == 0
        pin = next(iter(canary._pins.values()))
        with router._lock:
            board = router._sessions[pin.sid].board.copy()
            board[:4, :4] ^= 1
            router._sessions[pin.sid].board = board
        assert canary.probe_now() == {"local": "mismatch"}
        assert registry.value("gol_canary_failures_total") == 1
        assert canary.probe_now() == {"local": "ok"}  # re-pinned
    finally:
        canary.close()
        server.close()
        router.close()
