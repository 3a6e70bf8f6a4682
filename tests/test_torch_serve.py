"""The port's single-process serving plane against the JAX package's.

Each case is one script driven through both routers (the port's on
``device="cpu"``, the JAX package's on its CPU backend); the transcripts —
boards' digests, epochs, rejection reasons, JSON answers — must be equal,
and the digests must equal the numpy oracle's.  Waits use events and
explicit timeouts, TTLs an injected clock, servers port 0.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from _torch_serve_pkgs import (
    PKGS,
    both,
    cfg,
    http,
    oracle,
    oracle_digest,
    random_grid,
    serve_stack,
    wait_for,
)

# The heterogeneous mix: binary life-likes and Generations, square and
# ragged shapes (one class, so one batched call), zero steps excluded (the
# router refuses steps < 1).
MIX = (
    ("conway", 16, 16, 1),
    ("highlife", 12, 30, 2),
    ("seeds", 8, 8, 3),
    ("day-and-night", 32, 17, 4),
    ("brians-brain", 24, 24, 5),
    ("star-wars", 20, 9, 6),
    ("conway", 3, 32, 7),
    ("highlife", 32, 32, 8),
)


def _no_board(doc):
    return {k: v for k, v in doc.items() if k != "board"}


def test_router_lifecycle_and_oracle_digest():
    def script(pkg):
        out = []
        with pkg.Router(cfg(pkg), registry=pkg.registry()) as router:
            doc = router.create(tenant="alice", rule="highlife", height=20, width=12, seed=42)
            sid = doc["id"]
            board0 = random_grid((20, 12), density=0.5, seed=42)
            np.testing.assert_array_equal(doc["board"], board0)
            out.append(_no_board(doc))
            epoch, digest = router.step(sid, steps=5)
            assert digest == oracle_digest("highlife", board0, 5)
            out.append((epoch, digest))
            got = router.get(sid)
            np.testing.assert_array_equal(got["board"], oracle("highlife", board0, 5))
            out.append(_no_board(got))
            out.append(router.list())
            router.delete(sid)
            for call in (router.get, router.step):
                with pytest.raises(KeyError):
                    call(sid)
        return out

    both(script)


def test_router_one_tick_batches_many_sessions():
    """Concurrent step requests land in one batched call (one size class),
    and every session's result is its own oracle's."""

    def script(pkg):
        registry = pkg.registry()
        with pkg.Router(cfg(pkg), registry=registry) as router:
            specs = []
            for i, (rule, h, w, seed) in enumerate(MIX):
                doc = router.create(tenant=f"t{i % 3}", rule=rule, height=h, width=w, seed=seed)
                specs.append((doc["id"], rule, (h, w), seed))
            router.pause()
            results = {}
            pool = [
                threading.Thread(target=lambda s=sid: results.__setitem__(s, router.step(s, steps=3)))
                for sid, _, _, _ in specs
            ]
            for t in pool:
                t.start()
            wait_for(lambda: router.stats()["queue_depth"] == len(specs))
            router.resume()
            for t in pool:
                t.join(30)
                assert not t.is_alive()
            for sid, rule, (h, w), seed in specs:
                board0 = random_grid((h, w), density=0.5, seed=seed)
                assert results[sid] == (3, oracle_digest(rule, board0, 3)), (sid, rule)
            snap = registry.snapshot()
            assert snap["gol_serve_batch_boards"]["count"] == 1
            assert snap["gol_serve_batch_boards"]["sum"] == len(specs)
            return sorted(results.items())

    both(script)


def _reason(fn):
    """What a call answers: its result, or its error's type, reason and text."""
    try:
        return ("ok", fn())
    except PKGS["jax"].AdmissionError as e:
        return ("admission", e.reason, str(e))
    except PKGS["torch"].AdmissionError as e:
        return ("admission", e.reason, str(e))
    except (ValueError, KeyError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def test_router_rejects_malformed_creates():
    def script(pkg):
        with pkg.Router(cfg(pkg), registry=pkg.registry()) as router:
            calls = [
                dict(rule="wireworld"), dict(height=0), dict(density=1.5),
                dict(height=10_000), dict(height=257, width=1),
            ] + [dict(tenant=bad, height=8, width=8) for bad in ("", "a b", 'x"y', "t\n", "q" * 65)]
            out = [_reason(lambda kw=kw: router.create(**kw)) for kw in calls]
            assert all(o[0] == "ValueError" for o in out)
            return out

    both(script)


def test_admission_session_cap_and_cell_budget():
    def script(pkg):
        registry = pkg.registry()
        with pkg.Router(cfg(pkg, serve_max_sessions=2, serve_max_cells=3000), registry=registry) as router:
            out = [_reason(lambda: router.create(height=32, width=32, seed=1)["id"])]
            out.append(_reason(lambda: router.create(height=45, width=45, seed=2)))
            out.append(_reason(lambda: router.create(height=32, width=32, seed=2)["id"]))
            out.append(_reason(lambda: router.create(height=8, width=8, seed=3)))
            snap = registry.snapshot()
            out.append((
                snap['gol_serve_rejects_total{reason="max_cells"}'],
                snap['gol_serve_rejects_total{reason="max_sessions"}'],
                snap["gol_serve_cells"],
            ))
            router.delete(router.list()[0]["id"])
            out.append(_reason(lambda: router.create(height=40, width=40, seed=4)["id"]))
        assert [o[1] for o in out if o[0] == "admission"] == ["max_cells", "max_sessions"]
        return out

    both(script)


def test_admission_queue_backpressure_never_drops_admitted():
    def script(pkg):
        registry = pkg.registry()
        with pkg.Router(cfg(pkg, serve_queue_depth=4), registry=registry) as router:
            sids = [router.create(height=8, width=8, seed=i)["id"] for i in range(4)]
            router.pause()
            results = []
            pool = [threading.Thread(target=lambda s=s: results.append(router.step(s, steps=1))) for s in sids]
            for t in pool:
                t.start()
            wait_for(lambda: router.stats()["queue_depth"] == 4)
            refused = _reason(lambda: router.step(sids[0], steps=1))
            router.resume()
            for t in pool:
                t.join(30)
            assert refused[:2] == ("admission", "queue_full")
            assert registry.snapshot()["gol_serve_queue_depth"] == 0.0
            return refused, sorted(results)

    both(script)


def test_idle_ttl_eviction_injected_clock():
    def script(pkg):
        clock = {"now": 1000.0}
        registry = pkg.registry()
        with pkg.Router(cfg(pkg, serve_ttl_s=60.0), registry=registry, clock=lambda: clock["now"]) as router:
            a = router.create(height=8, width=8, seed=1)["id"]
            b = router.create(height=8, width=8, seed=2)["id"]
            clock["now"] += 50
            router.get(a)
            clock["now"] += 20  # b is 70 s idle, a 20 s
            wait_for(lambda: len(router.list()) == 1)
            snap = registry.snapshot()
            return (
                [d["id"] for d in router.list()], _reason(lambda: router.get(b)),
                snap["gol_serve_session_evictions_total"], snap["gol_serve_cells"],
            )

    assert both(script)[2:] == (1.0, 64.0)


def test_drain_completes_admitted_jobs_and_rejects_new_work():
    def script(pkg):
        with pkg.Router(cfg(pkg), registry=pkg.registry()) as router:
            sids = [router.create(height=8, width=8, seed=i)["id"] for i in range(3)]
            router.pause()
            results = []
            pool = [threading.Thread(target=lambda s=s: results.append(router.step(s, steps=1))) for s in sids]
            for t in pool:
                t.start()
            wait_for(lambda: router.stats()["queue_depth"] == 3)
            done = {}
            drainer = threading.Thread(target=lambda: done.update(v=router.drain(timeout=30)))
            drainer.start()
            wait_for(lambda: router._draining)
            refused = (
                _reason(lambda: router.step(sids[0], steps=1)),
                _reason(lambda: router.create(height=8, width=8, seed=99)),
            )
            router.resume()
            for t in pool + [drainer]:
                t.join(30)
                assert not t.is_alive()
            assert done["v"] is True and refused[0][1] == "draining"
            return refused, sorted(results)

    both(script)


def test_step_bounds_and_closed_router():
    def script(pkg):
        router = pkg.Router(cfg(pkg, serve_max_steps=16), registry=pkg.registry())
        sid = router.create(height=8, width=8)["id"]
        out = [_reason(lambda: router.step(sid, steps=0)), _reason(lambda: router.step(sid, steps=17))]
        router.close()
        out += [_reason(lambda: router.create(height=8, width=8)), _reason(lambda: router.step(sid, steps=1))]
        assert [o[0] for o in out] == ["ValueError", "admission", "RuntimeError", "RuntimeError"]
        assert out[1][1] == "max_steps"
        return out

    both(script)


def test_linear_rule_fast_forward_bypasses_step_bound():
    """A replicator session answers far past serve_max_steps through the
    O(log n) jump; the small span is checked against the numpy oracle."""

    def script(pkg):
        registry = pkg.registry()
        with pkg.Router(cfg(pkg, serve_max_steps=16), registry=registry) as router:
            sid = router.create(rule="replicator", height=16, width=16, seed=5)["id"]
            board0 = random_grid((16, 16), density=0.5, seed=5)
            n = 101
            first = router.step(sid, steps=n)
            assert first == (n, oracle_digest("replicator", board0, n))
            np.testing.assert_array_equal(router.get(sid)["board"], oracle("replicator", board0, n))
            far = router.step(sid, steps=1_000_000 - n)
            after = router.step(sid, steps=4)  # back on the batched ticker
            snap = registry.snapshot()
            assert snap["gol_serve_ff_jumps_total"] == 2.0
            assert snap['gol_serve_steps_total{tenant="default"}'] == 1_000_004.0
            return first, far, after

    got = both(script)
    want = PKGS["torch"].ff_np(random_grid((16, 16), density=0.5, seed=5), "replicator", 1_000_000, device="cpu")
    assert got[1][1] == PKGS["torch"].digest.value(PKGS["torch"].digest.digest_dense_np(want))


def test_fast_forward_concurrency_bound_rejects_not_wedges():
    def script(pkg):
        with pkg.Router(cfg(pkg, serve_max_steps=16), registry=pkg.registry()) as router:
            sid = router.create(rule="replicator", height=8, width=8)["id"]
            taken = 0
            while router._ff_slots.acquire(blocking=False):
                taken += 1
            refused = _reason(lambda: router.step(sid, steps=17))
            for _ in range(taken):
                router._ff_slots.release()
            return taken, refused, router.step(sid, steps=17)

    taken, refused, _ = both(script)
    assert taken == PKGS["torch"].sessions.FF_MAX_CONCURRENT and refused[1] == "queue_full"


@pytest.mark.parametrize("kw,steps", [(dict(ff_enabled=False), 17), (dict(), 10**100)])
def test_fast_forward_disabled_and_span_ceiling(kw, steps):
    def script(pkg):
        registry = pkg.registry()
        with pkg.Router(cfg(pkg, serve_max_steps=16, **kw), registry=registry) as router:
            sid = router.create(rule="replicator", height=8, width=8)["id"]
            return _reason(lambda: router.step(sid, steps=steps)), router.step(sid, steps=16)[0]

    refused, epoch = both(script)
    assert epoch == 16
    assert refused[1] == "max_steps" if kw else refused[0] == "ValueError"


def test_batch_scatter_back_never_clobbers_a_midbatch_jump(monkeypatch):
    """A batch whose snapshot went stale (a jump committed between its
    gather and its scatter-back) must not write back; its client still
    gets its own snapshot's result."""
    pkg = PKGS["torch"]
    gathered, release = threading.Event(), threading.Event()
    real = pkg.batch.batch_step_fn

    def slow(cls, length, device):
        fn = real(cls, length, device)

        def run(*operands):
            gathered.set()
            assert release.wait(30)
            return fn(*operands)

        return run

    monkeypatch.setattr(pkg.batch, "batch_step_fn", slow)
    router = pkg.Router(cfg(pkg, serve_max_steps=16), registry=pkg.registry())
    try:
        sid = router.create(rule="replicator", height=8, width=8, seed=1)["id"]
        results = {}
        tb = threading.Thread(target=lambda: results.setdefault("batch", router.step(sid, steps=4)))
        tb.start()
        assert gathered.wait(30)
        epoch_ff, dig_ff = router.step(sid, steps=1_000_000)
        release.set()
        tb.join(30)
        assert results["batch"][0] == 4 and epoch_ff == 1_000_000
        doc = router.get(sid)
        assert doc["epoch"] == 1_000_000
        assert pkg.digest.value(pkg.digest.digest_dense_np(doc["board"])) == dig_ff
    finally:
        release.set()
        router.close()


# -- the HTTP surface ---------------------------------------------------------


def test_http_boards_api_contract():
    def script(pkg):
        router, server, base = serve_stack(pkg)
        out = []
        try:
            status, doc = http(base, "POST", "/boards", {"tenant": "bob", "rule": "brians-brain",
                                                         "height": 10, "width": 14, "seed": 9})
            assert status == 201 and "board_b64" not in doc
            out.append((status, doc))
            sid = doc["id"]
            status, doc = http(base, "GET", f"/boards/{sid}")
            board0 = random_grid((10, 14), density=0.5, seed=9)
            np.testing.assert_array_equal(pkg.api.decode_board_b64(doc), board0)
            out.append((status, doc))
            status, doc = http(base, "POST", f"/boards/{sid}/step", {"steps": 4})
            assert doc["digest"] == pkg.digest.format_digest(oracle_digest("brians-brain", board0, 4))
            out.append((status, doc))
            status, doc = http(base, "GET", f"/boards/{sid}")
            np.testing.assert_array_equal(pkg.api.decode_board_b64(doc), oracle("brians-brain", board0, 4))
            out += [(status, doc), http(base, "GET", "/boards"), http(base, "DELETE", f"/boards/{sid}"),
                    http(base, "GET", f"/boards/{sid}")[0]]
        finally:
            server.close()
            router.close()
        return out

    assert both(script)[-1] == 404


def test_http_error_mapping():
    def script(pkg):
        router, server, base = serve_stack(pkg, cfg(pkg, serve_max_sessions=1))
        try:
            out = [http(base, "POST", "/boards", body) for body in (
                {"bogus": 1}, {"rule": "wireworld"}, {"height": 9999}, {"height": 8, "width": 8},
                {"height": 8, "width": 8},
            )]
            sid = router.list()[0]["id"]
            out += [
                http(base, "GET", "/boards/nope"), http(base, "GET", f"/boards/{sid}/bogus"),
                http(base, "DELETE", "/boards"), http(base, "GET", f"/boards/{sid}/step"),
                http(base, "POST", f"/boards/{sid}/step", {"steps": 0}),
                http(base, "POST", f"/boards/{sid}/step", {"steps": "lots"}),
            ]
        finally:
            server.close()
            router.close()
        # trace ids are minted per request: equal in shape, not in value
        for _, doc in out:
            doc.pop("trace_id", None)
        return out

    out = both(script)
    assert [s for s, _ in out] == [400, 400, 400, 201, 429, 404, 404, 405, 405, 400, 400]
    assert out[4][1]["reason"] == "max_sessions" and "retry_after_s" in out[4][1]


def test_http_step_fast_path_and_max_steps_reason():
    def script(pkg):
        router, server, base = serve_stack(pkg, cfg(pkg, serve_max_steps=16))
        try:
            _, doc = http(base, "POST", "/boards", {"height": 8, "width": 8})
            refused = http(base, "POST", f"/boards/{doc['id']}/step", {"steps": 1_000_000})
            refused[1].pop("trace_id", None)
            _, doc = http(base, "POST", "/boards", {"rule": "replicator", "height": 8, "width": 8, "seed": 2})
            jumped = http(base, "POST", f"/boards/{doc['id']}/step", {"steps": 1_000_000})
        finally:
            server.close()
            router.close()
        return refused, jumped

    refused, jumped = both(script)
    assert refused[0] == 429 and refused[1]["reason"] == "max_steps"
    assert jumped[0] == 200 and jumped[1]["epoch"] == 1_000_000


def test_http_shares_port_with_metrics_and_healthz():
    def script(pkg):
        router, server, base = serve_stack(pkg, health=lambda r: (lambda: {"ok": True, **r.stats()}))
        try:
            http(base, "POST", "/boards", {"tenant": "t9", "height": 8, "width": 8})
            with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
                text = resp.read().decode()
            assert 'gol_serve_sessions{tenant="t9"} 1' in text
            return [http(base, "GET", "/healthz"), http(base, "GET", "/nothing-here")[0],
                    http(base, "POST", "/metrics", {})[0], http(base, "DELETE", "/healthz")[0]]
        finally:
            server.close()
            router.close()

    out = both(script)
    assert out[0][1]["sessions"] == 1 and out[1:] == [404, 405, 405]


def test_http_burst_of_concurrent_tenants_is_answered():
    """Many clients at once: every request is answered (the endpoint's
    listen backlog holds the burst), none reset."""
    import concurrent.futures

    pkg = PKGS["torch"]
    router, server, base = serve_stack(pkg)
    try:
        assert server._server.request_queue_size >= 1024
        with concurrent.futures.ThreadPoolExecutor(64) as pool:
            created = list(pool.map(lambda i: http(base, "POST", "/boards", {"height": 8, "width": 8, "seed": i}),
                                    range(128)))
            stepped = list(pool.map(lambda doc: http(base, "POST", f"/boards/{doc[1]['id']}/step", {"steps": 2}),
                                    created))
    finally:
        server.close()
        router.close()
    assert {s for s, _ in created} == {201} and {s for s, _ in stepped} == {200}
    assert all(doc["epoch"] == 2 for _, doc in stepped)


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_board_hand_over_between_packages(src, dst):
    """A session exported by one package's router (``wire.pack_tile``
    bytes) imports into the other's and steps to the same digest as the
    exporter's own next steps; the GET documents agree too."""
    a, b = PKGS[src], PKGS[dst]
    with a.Router(cfg(a), registry=a.registry()) as ra, b.Router(cfg(b), registry=b.registry()) as rb:
        sid = ra.create(tenant="mover", rule="star-wars", height=24, width=40, seed=11)["id"]
        ra.step(sid, steps=9)
        (payload,) = ra.export_sessions([sid])
        rb.import_sessions([payload])
        assert _no_board(rb.get(sid)) == _no_board(ra.get(sid))
        assert rb.step(sid, steps=7) == ra.step(sid, steps=7)
        board0 = random_grid((24, 40), density=0.5, seed=11)
        assert ra.step(sid, steps=1) == (17, oracle_digest("star-wars", board0, 17))


def test_cli_serve_role_real_process(tmp_path):
    """``serve --device cpu`` on a real process: banner with its port, a
    create/step/get round trip, then SIGTERM drains and exits 130."""
    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(repo) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "akka_game_of_life_tpu_torch", "serve", "--device", "cpu",
         "--metrics-port", "0", "--serve-max-sessions", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp_path,
    )
    try:
        m = None
        deadline = time.monotonic() + 60
        while m is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, "serve exited before its banner"
            m = re.search(r"on :(\d+)", line)
        base = f"http://127.0.0.1:{m.group(1)}"
        status, doc = http(base, "POST", "/boards", {"rule": "conway", "height": 12, "width": 12, "seed": 5})
        assert status == 201
        status, stepped = http(base, "POST", f"/boards/{doc['id']}/step", {"steps": 7})
        board0 = random_grid((12, 12), density=0.5, seed=5)
        assert status == 200 and stepped["epoch"] == 7
        assert stepped["digest"] == f"{oracle_digest('conway', board0, 7):016x}"
        assert http(base, "GET", f"/boards/{doc['id']}")[1]["epoch"] == 7
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 130, out
        assert "draining" in out and "drained" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
