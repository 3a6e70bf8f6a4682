"""The ``/boards`` HTTP API: the serving plane's tenant-facing surface.

Mounted on the existing obs endpoint through its registered-routes table
(:meth:`akka_game_of_life_tpu_torch.obs.httpd.MetricsServer.add_route`) — one
port serves ``/metrics``, ``/healthz``, ``/trace``, ``/slo``, AND the
board API.

| Method & path            | Body (JSON)                               | Returns |
|--------------------------|-------------------------------------------|---------|
| POST /boards             | {tenant?, rule?, height?, width?, seed?, density?, sid?} | 201 session doc |
| GET /boards              | —                                         | 200 {boards: [...]} (no cells) |
| GET /boards/<id>         | —                                         | 200 session doc (+ board cells) |
| POST /boards/<id>/step   | {steps?}                                  | 200 {epoch, digest, steps} |
| DELETE /boards/<id>      | —                                         | 200 {deleted} |

``steps`` beyond ``serve_max_steps`` is an admission question: an
XOR-linear rule session answers through the O(log T) fast-forward path
(``ops/fastforward.py`` — n=1,000,000 in milliseconds, bypassing the
ticker), while any other session is refused **429** ``max_steps`` so a
giant request can never monopolize the ticker.

Every request is a first-class traced, SLO-scored object
(``serve_trace`` / docs/OPERATIONS.md "Serve observability & SLOs"):
the route mints a ``serve.request`` span — or adopts the trace ctx a
client passed under the ``"_trace"`` body key — leaves it active for the
whole dispatch so every downstream serve-plane span (and, on the cluster
plane, every ``serve_ops`` frame) links under it, and records the
finished request into the :class:`~akka_game_of_life_tpu_torch.obs.slo.SloTracker`
(access log, per-tenant RED metrics with trace-id exemplars, burn-rate
windows, all served live at ``/slo``).

Error mapping — admission control answers, it never wedges: a capacity
refusal (session cap, cell budget, full step queue, shutdown drain,
over-bound steps on a non-linear rule) is
**429** with the machine-readable ``reason`` (the same string on
``gol_serve_rejects_total{reason}``) and a ``Retry-After`` hint in the
body; a step that timed out is **503** (the body says whether it was
cancelled in-queue — board provably not advanced, retry safe); malformed
requests are 400; unknown ids 404; everything else 500 with the error
repr.  429/503 bodies carry the request's ``trace_id`` so a refused
client can hand support a clickable trace.  Board cells travel as base64
of the raw row-major
uint8 bytes (``board_b64`` + the height/width already in the doc) — JSON-
safe at any state alphabet without a 4-byte-per-cell integer list.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from typing import Optional, Tuple

import numpy as np

from akka_game_of_life_tpu_torch.obs import slo as slo_mod
from akka_game_of_life_tpu_torch.obs.httpd import (
    JSON_TYPE,
    json_response,
    strip_query,
)
from akka_game_of_life_tpu_torch.obs.tracing import TRACE_KEY
from akka_game_of_life_tpu_torch.serve.federation import FederationRedirect
from akka_game_of_life_tpu_torch.serve.sessions import AdmissionError, SessionRouter


def _doc(snapshot: dict, *, with_board: bool = True) -> dict:
    doc = dict(snapshot)
    board = doc.pop("board", None)
    if with_board and board is not None:
        doc["board_b64"] = base64.b64encode(
            np.ascontiguousarray(board).tobytes()
        ).decode("ascii")
    return doc


def decode_board_b64(doc: dict) -> np.ndarray:
    """Client-side twin of the ``board_b64`` encoding (bench/tests)."""
    raw = base64.b64decode(doc["board_b64"])
    return np.frombuffer(raw, dtype=np.uint8).reshape(
        doc["height"], doc["width"]
    )


# Create-side tenant relay: _create knows the tenant from the body; the
# request wrapper cuts the SLO line after dispatch on the same thread.
_tl = threading.local()


class BoardsRoute:
    """The ``/boards`` route handler (callable with the httpd route
    contract: ``(method, path, body) -> (status, ctype, bytes)``)."""

    def __init__(
        self,
        router: SessionRouter,
        *,
        tracer=None,
        slo=None,
        trace: Optional[bool] = None,
    ) -> None:
        self.router = router
        self.tracer = tracer if tracer is not None else getattr(
            router, "tracer", None
        )
        self.slo = slo
        if trace is None:
            trace = bool(
                getattr(
                    getattr(router, "config", None), "serve_trace", True
                )
            )
        self.trace = trace

    def __call__(self, method: str, path: str, body: bytes):
        # The server hands over the RAW path (query included); this route
        # dispatches on path segments, so normalize once at the door.
        path = strip_query(path)
        if not self.trace or self.tracer is None:
            return self._respond(method, path, body, None)
        with self.tracer.start(
            "serve.request",
            parent=self._adopt(body),
            method=method,
            path=path,
        ) as span:
            return self._respond(method, path, body, span)

    @staticmethod
    def _adopt(body: bytes):
        """Trace ctx a client rode in under the ``"_trace"`` body key
        (the route contract carries no headers); None mints a new root.
        The substring probe keeps the no-ctx hot path parse-free."""
        if not body or b'"_trace"' not in body:
            return None
        try:
            doc = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        ctx = doc.get(TRACE_KEY) if isinstance(doc, dict) else None
        return ctx if isinstance(ctx, dict) else None

    @staticmethod
    def _route_of(method: str, path: str) -> Tuple[Optional[str], str]:
        """(sid, route label) without raising — the SLO/span attribution
        must survive any path the dispatcher will 404."""
        parts = [p for p in path.split("/") if p]
        if parts[:1] != ["boards"]:
            return None, "other"
        sid = parts[1] if len(parts) > 1 else None
        if len(parts) >= 3:
            ok = len(parts) == 3 and parts[2] == "step" and method == "POST"
            return sid, "step" if ok else "other"
        if sid is None:
            return None, "create" if method == "POST" else "list"
        return sid, {"GET": "get", "DELETE": "delete"}.get(method, "other")

    def _respond(self, method: str, path: str, body: bytes, span):
        t0 = time.perf_counter()
        slo_mod.take_queue_wait()  # clear any stale relay from this thread
        _tl.tenant = None
        sid, route = self._route_of(method, path)
        reason: Optional[str] = None
        try:
            resp = self._dispatch(method, path, body)
        except FederationRedirect as e:
            # Federation: the board lives on a peer frontend and its
            # payload is too fat to proxy — 307 preserves the method and
            # points the client straight at the owner.
            resp = (
                307, JSON_TYPE,
                (json.dumps({"location": e.url}) + "\n").encode("utf-8"),
                {"Location": e.url},
            )
        except AdmissionError as e:
            reason = e.reason
            doc = {
                "error": str(e), "reason": e.reason, "retry_after_s": 0.1,
            }
            if isinstance(e.trace_link, dict):
                # The span that CAUSED the refusal (a failover 429's
                # serve.promote) — the click-through from the 429'd
                # request's trace into the promotion.
                doc["trace_link"] = dict(e.trace_link)
            if span is not None:
                doc["trace_id"] = span.trace_id
                if isinstance(e.trace_link, dict):
                    span.set(
                        link_trace_id=e.trace_link.get("trace_id"),
                        link_span_id=e.trace_link.get("span_id"),
                    )
            resp = json_response(429, doc)
        except KeyError as e:
            resp = json_response(404, {"error": f"no board {e.args[0]!r}"})
        except (ValueError, TypeError) as e:
            resp = json_response(400, {"error": str(e)})
        except TimeoutError as e:
            # The router's distinguished outcomes ("cancelled; board not
            # advanced" = a safe retry) ride str(e) — a generic 500 would
            # read as a route bug and lose the retry signal.
            doc = {"error": str(e), "retry_after_s": 1.0}
            if span is not None:
                doc["trace_id"] = span.trace_id
            resp = json_response(503, doc)
        status = resp[0]
        latency_s = time.perf_counter() - t0
        queue_wait_s = slo_mod.take_queue_wait()
        tenant = getattr(_tl, "tenant", None)
        if tenant is None and sid is not None:
            lookup = getattr(self.router, "tenant_of", None)
            tenant = lookup(sid) if lookup is not None else None
        tenant = tenant or "default"
        if span is not None:
            span.set(
                route=route, status=status, tenant=tenant,
                outcome=slo_mod.SloTracker.outcome_of(status),
            )
            if sid is not None:
                span.set(sid=sid)
            if reason is not None:
                span.set(reason=reason)
            if queue_wait_s is not None:
                span.set(queue_wait_s=round(queue_wait_s, 6))
        if self.slo is not None:
            self.slo.record(
                route=route,
                tenant=tenant,
                sid=sid,
                status=status,
                reason=reason,
                latency_s=latency_s,
                queue_wait_s=queue_wait_s,
                trace_id=span.trace_id if span is not None else None,
            )
        return resp

    def _dispatch(self, method: str, path: str, body: bytes):
        sid, action = self._parse_path(path)
        if sid is None:
            if method == "POST":
                return self._create(body)
            if method == "GET":
                return json_response(200, {"boards": self.router.list()})
            return json_response(405, {"error": f"{method} /boards"})
        if action == "step":
            if method != "POST":
                return json_response(405, {"error": f"{method} {path}"})
            return self._step(sid, body)
        if action is not None:
            raise KeyError(action)
        if method == "GET":
            return json_response(200, _doc(self.router.get(sid)))
        if method == "DELETE":
            self.router.delete(sid)
            return json_response(200, {"deleted": sid})
        return json_response(405, {"error": f"{method} {path}"})

    @staticmethod
    def _parse_path(path: str) -> Tuple[Optional[str], Optional[str]]:
        """"/boards" → (None, None); "/boards/<id>" → (id, None);
        "/boards/<id>/step" → (id, "step")."""
        parts = [p for p in path.split("/") if p]
        if parts[:1] != ["boards"] or len(parts) > 3:
            raise KeyError(path)
        sid = parts[1] if len(parts) > 1 else None
        action = parts[2] if len(parts) > 2 else None
        return sid, action

    @staticmethod
    def _payload(body: bytes) -> dict:
        if not body:
            return {}
        doc = json.loads(body.decode("utf-8"))
        if not isinstance(doc, dict):
            raise ValueError("request body must be a JSON object")
        doc.pop(TRACE_KEY, None)  # propagation envelope, not a field
        return doc

    def _create(self, body: bytes):
        doc = self._payload(body)
        allowed = {
            "tenant", "rule", "height", "width", "seed", "density", "sid",
        }
        unknown = set(doc) - allowed
        if unknown:
            raise ValueError(f"unknown fields: {sorted(unknown)}")
        tenant = str(doc.get("tenant", "default"))
        _tl.tenant = tenant
        kwargs = {}
        if doc.get("sid") is not None:
            # Client-chosen session id (the canary prober aims the crc32
            # shard hash with it); routers validate/refuse collisions.
            kwargs["sid"] = str(doc["sid"])
        snap = self.router.create(
            tenant=tenant,
            rule=doc.get("rule", "conway"),
            height=int(doc.get("height", 64)),
            width=int(doc.get("width", 64)),
            seed=int(doc.get("seed", 0)),
            density=float(doc.get("density", 0.5)),
            # The 201 deliberately carries no cells; skip the O(h·w) copy.
            with_board=False,
            **kwargs,
        )
        return json_response(201, _doc(snap, with_board=False))

    def _step(self, sid: str, body: bytes):
        doc = self._payload(body)
        steps = int(doc.get("steps", 1))
        epoch, digest = self.router.step(sid, steps)
        from akka_game_of_life_tpu_torch.ops.digest import format_digest

        return json_response(
            200,
            {"id": sid, "epoch": epoch, "steps": steps,
             "digest": format_digest(digest)},
        )


class SloRoute:
    """``GET /slo`` → the live :meth:`SloTracker.summary` document."""

    def __init__(self, slo) -> None:
        self.slo = slo

    def __call__(self, method: str, path: str, body: bytes):
        if method != "GET":
            return json_response(405, {"error": f"{method} /slo"})
        return json_response(200, self.slo.summary())


def board_routes(
    router: SessionRouter, *, tracer=None, slo=None, trace=None
) -> dict:
    """The route table to mount on a MetricsServer (``routes=`` kwarg or
    ``add_route`` per entry): ``/boards`` plus ``/slo``.  ``slo=None``
    builds a default :class:`SloTracker` from the router's config and
    registry, so every serve surface is SLO-scored without wiring."""
    if slo is None:
        slo = slo_mod.SloTracker(
            getattr(router, "config", None),
            registry=getattr(router, "metrics", None),
            tracer=tracer if tracer is not None else getattr(
                router, "tracer", None
            ),
        )
    route = BoardsRoute(router, tracer=tracer, slo=slo, trace=trace)
    return {"/boards": route, "/slo": SloRoute(slo)}


def run_serve(config, *, registry=None, tracer=None, device="cuda") -> int:
    """The ``serve`` CLI role body: a SessionRouter stepping on ``device``
    (``cuda`` unless the caller names the CPU; raises without a card) + one
    obs endpoint carrying /metrics, /healthz, /trace, /slo, and /boards,
    until interrupted.  ``serve_canary`` adds the background
    digest-certified prober against the same (real) HTTP surface."""
    from akka_game_of_life_tpu_torch.obs import MetricsServer, get_registry
    from akka_game_of_life_tpu_torch.obs.events import NULL_EVENTS, EventLog
    from akka_game_of_life_tpu_torch.obs.tracing import get_tracer

    registry = registry if registry is not None else get_registry()
    tracer = tracer if tracer is not None else get_tracer()
    events = (
        EventLog(config.log_events, node="serve", recorder=tracer.flight)
        if getattr(config, "log_events", None)
        else NULL_EVENTS
    )
    router = SessionRouter(
        config, registry=registry, tracer=tracer, events=events, device=device
    )
    slo = slo_mod.SloTracker(
        config, registry=registry, tracer=tracer, events=events,
    )
    # Compile & cost observatory: the serve role is the storm detector's
    # prime customer — a novel (class, length) program compiling after
    # warmup is a latency cliff for live tenants.  Storm alerts fire into
    # this role's event log + flight recorder; /profile captures land
    # beside the flight dumps.
    from akka_game_of_life_tpu_torch.obs.programs import get_programs, http_routes
    from akka_game_of_life_tpu_torch.runtime.profiling import ProfilerCapture

    programs = get_programs().configure(
        node="serve",
        events=events,
        flight=tracer.flight,
        metrics=registry,
        enabled=config.obs_programs,
    )
    profiler = ProfilerCapture(
        config.flight_dir or "artifacts",
        node="serve",
        max_seconds=config.obs_profile_max_s,
        min_interval_s=config.obs_profile_min_interval_s,
    )

    def health() -> dict:
        doc = {"ok": True, "role": "serve", **router.stats()}
        doc["programs"] = programs.health_summary()
        return doc

    routes = dict(http_routes(registry=programs, profile=profiler.capture))
    routes.update(board_routes(router, tracer=tracer, slo=slo))
    server = MetricsServer(
        registry,
        port=config.metrics_port,
        health=health,
        tracer=tracer,
        routes=routes,
    )
    canary = None
    if config.serve_canary:
        from akka_game_of_life_tpu_torch.serve.canary import CanaryProber

        canary = CanaryProber(
            config,
            base=f"http://127.0.0.1:{server.port}",
            registry=registry,
            tracer=tracer,
            events=events,
        )
        canary.start()
    print(
        f"serving /boards (+/metrics,/healthz,/trace,/slo,"
        f"/programs,/cost,/profile) on "
        f":{server.port} — "
        f"max {router.max_sessions} sessions, {router.max_cells} cells, "
        f"size classes {list(router.size_classes)}",
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        # A real drain, not just the word: refuse NEW work (429 reason
        # "draining") and run the admitted queue dry before closing — an
        # accepted job is never failed with "router closed" because the
        # operator sent SIGTERM.
        print("serve: interrupted; draining", flush=True)
        if canary is not None:
            canary.close()
        drained = router.drain()
        print(
            "serve: drained" if drained
            else "serve: drain timed out; aborting pending jobs",
            flush=True,
        )
        return 130
    finally:
        if canary is not None:
            canary.close()
        server.close()
        slo.close()
        if events is not NULL_EVENTS:
            events.close()
        router.close()
