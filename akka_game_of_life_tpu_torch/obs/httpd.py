"""Live exposition endpoint: registered routes over one tiny HTTP server.

``--metrics-port N`` on the ``run``, ``frontend``, ``backend``, and
``serve`` roles starts this server.  The built-in routes:

- ``/metrics`` — the registry in Prometheus text format;
- ``/healthz`` — a one-line JSON health document (HTTP 200 while the role
  considers itself healthy, 503 once it does not — the shape load
  balancers and k8s probes expect);
- ``/trace`` — the live span buffer as Chrome trace-event / Perfetto JSON
  (when a tracer is attached).

Subsystems mount more: every route lives in one registered-routes table
keyed by path prefix (:meth:`MetricsServer.add_route`), dispatched by
longest matching prefix — the serving plane's ``/boards`` API
(:mod:`akka_game_of_life_tpu_torch.serve.api`) rides the same server, the same
``_respond`` discipline, and the same port as the scrape endpoint instead
of growing a second listener or an if/elif chain here.

A route handler is ``handler(method, path, body) -> (status, content_type,
body_bytes)``; it must render its response fully (taking whatever locks it
needs) before returning.  Raising maps to a 500 with the error repr; a
method the handler rejects should return 405 itself.  ``path`` is the RAW
request path — query string included (``POST /profile?seconds=3`` reads
its parameter from it); routing matches on the query-stripped path, and
handlers that parse path segments use :func:`strip_query` first.

Stdlib-only (``http.server``), threaded, daemonized: a scrape can never
block the simulation loop, and an abandoned server cannot hold the process
open.  Port 0 binds an ephemeral port (tests); the bound port is on
``server.port``.

Response discipline: every endpoint renders its body fully — taking
whatever registry/tracer locks rendering needs — BEFORE the first header
byte is written, so no internal lock is ever held across a socket write to
a possibly-slow scraper, concurrent requests serialize only on the
in-memory render, and every response (including 404s) carries
``Content-Length``.

The default bind is ``0.0.0.0`` — deliberate: probes and scrapers reach a
containerized role over the pod/VM network, not loopback (the exporter
convention).  The endpoint is unauthenticated and ``/healthz`` includes
internal error strings, so on shared hosts either firewall the port or
pass ``host="127.0.0.1"`` when constructing :class:`MetricsServer`.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Mapping, Optional, Tuple

from akka_game_of_life_tpu_torch.obs.metrics import MetricsRegistry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_TYPE = "application/json"

# A request body larger than this is refused with 413 before being read
# into memory — no route here needs more than a small JSON document.
MAX_BODY_BYTES = 4 << 20

# handler(method, path, body) -> (status, content_type, body_bytes)
RouteHandler = Callable[[str, str, bytes], Tuple[int, str, bytes]]


def json_response(status: int, doc: dict) -> Tuple[int, str, bytes]:
    """The common route-handler return shape for JSON documents."""
    return status, JSON_TYPE, (json.dumps(doc) + "\n").encode("utf-8")


def strip_query(path: str) -> str:
    """The request path without its query string.  Handlers receive the
    raw path (query included, so parameterized routes can read it); any
    handler that parses path *segments* strips first."""
    return path.split("?", 1)[0]


class _Server(ThreadingHTTPServer):
    """The endpoint's server: one daemon thread per connection, and a listen
    backlog for the ``/boards`` routes' bursts of concurrent tenants
    (socketserver's default of 5 resets connections past it)."""

    daemon_threads = True
    request_queue_size = 1024


class MetricsServer:
    """Serve one registry's exposition — and any registered routes — until
    :meth:`close`."""

    def __init__(
        self,
        registry: MetricsRegistry,
        port: int = 0,
        host: str = "0.0.0.0",
        health: Optional[Callable[[], dict]] = None,
        tracer=None,
        routes: Optional[Mapping[str, RouteHandler]] = None,
    ) -> None:
        self.registry = registry
        self.tracer = tracer
        # Health contract: return a JSON-serializable dict; "ok" (default
        # True) picks the status code.  Exceptions read as unhealthy.
        self._health = health or (lambda: {"ok": True})
        self._routes: dict = {}
        self.add_route("/metrics", self._metrics_route)
        self.add_route("/healthz", self._healthz_route)
        if tracer is not None:
            self.add_route("/trace", self._trace_route)
        for prefix, handler in (routes or {}).items():
            self.add_route(prefix, handler)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # Per-socket-op deadline (StreamRequestHandler applies it via
            # settimeout): a client that declares a Content-Length and then
            # withholds the bytes must not pin this connection thread
            # forever — the stalled read raises and the connection closes.
            timeout = 30
            # HTTP/1.1 so clients can keep connections alive: every
            # response here carries an exact Content-Length (the _respond
            # invariant), which is the precondition.  A serving-plane
            # client stepping a board per tick would otherwise pay a TCP
            # setup per request.
            protocol_version = "HTTP/1.1"
            def _respond(
                self, code: int, ctype: str, body: bytes, headers=None
            ) -> None:
                # Headers + body only AFTER the body is a finished byte
                # string: rendering (and its locks) never overlaps the
                # socket write, and Content-Length is always exact.
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    # Optional extra headers (a 307's Location) from
                    # 4-tuple route returns.
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(body)

            def _dispatch(self, method: str) -> None:
                path = self.path.split("?", 1)[0]
                handler = outer._route_for(path)
                if handler is None:
                    self._respond(
                        *json_response(404, {"error": f"no route {path}"})
                    )
                    return
                if self.headers.get("Transfer-Encoding"):
                    # Chunked bodies are not decoded here; treating one
                    # as empty would silently serve wrong defaults.  411
                    # tells the client to resend with a Content-Length.
                    self._respond(
                        *json_response(
                            411, {"error": "send a Content-Length; chunked "
                                  "bodies are not supported"}
                        )
                    )
                    return
                try:
                    # max(0, ·): a negative declared length must not turn
                    # into rfile.read(-1) — a read-until-EOF that pins
                    # this connection thread until the client closes.
                    length = max(
                        0, int(self.headers.get("Content-Length") or 0)
                    )
                except ValueError:
                    length = 0
                if length > MAX_BODY_BYTES:
                    self._respond(
                        *json_response(413, {"error": "body too large"})
                    )
                    return
                body = self.rfile.read(length) if length else b""
                try:
                    # Handlers get the RAW request path — query string
                    # included — so routes like POST /profile?seconds=N
                    # can read parameters; routing above matched on the
                    # stripped path.  Handlers that parse path segments
                    # must split off "?" themselves (see strip_query).
                    # Returns are (status, ctype, body) or, for routes
                    # that set extra headers (the federation's 307
                    # Location), (status, ctype, body, headers).
                    result = handler(method, self.path, body)
                except Exception as e:  # noqa: BLE001 — a route bug must
                    # not kill the connection thread silently
                    result = json_response(500, {"error": repr(e)})
                self._respond(*result[:3], result[3] if len(result) > 3 else None)

            def do_GET(self):  # noqa: N802 — http.server API
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802
                self._dispatch("POST")

            def do_DELETE(self):  # noqa: N802
                self._dispatch("DELETE")

            def log_message(self, fmt, *args):  # requests must not spam stdout
                pass

        self._server = _Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            daemon=True,
            name=f"metrics-http-{self.port}",
        )
        self._thread.start()

    # -- route table ---------------------------------------------------------

    def add_route(self, prefix: str, handler: RouteHandler) -> None:
        """Register ``handler`` for ``prefix`` (an exact path or a subtree
        root: ``/boards`` also receives ``/boards/<id>/...``).  Longest
        registered prefix wins; re-registering a prefix replaces it."""
        if not prefix.startswith("/") or (prefix != "/" and prefix.endswith("/")):
            raise ValueError(f"route prefix must look like /name, got {prefix!r}")
        self._routes[prefix] = handler

    def _route_for(self, path: str) -> Optional[RouteHandler]:
        best = None
        # Snapshot: add_route() on a live server must not resize the dict
        # under a request thread's iteration.
        for prefix, handler in tuple(self._routes.items()):
            if path == prefix or path.startswith(prefix + "/"):
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, handler)
        return best[1] if best else None

    # -- built-in routes -----------------------------------------------------

    def _metrics_route(self, method, path, body):
        if method != "GET":
            return json_response(405, {"error": f"{method} {path}"})
        return 200, CONTENT_TYPE, self.registry.render().encode("utf-8")

    def _healthz_route(self, method, path, body):
        if method != "GET":
            return json_response(405, {"error": f"{method} {path}"})
        try:
            doc = dict(self._health())
        except Exception as e:  # noqa: BLE001 — report, not raise
            doc = {"ok": False, "error": repr(e)}
        return json_response(200 if doc.get("ok", True) else 503, doc)

    def _trace_route(self, method, path, body):
        if method != "GET":
            return json_response(405, {"error": f"{method} {path}"})
        return 200, JSON_TYPE, self.tracer.export_json().encode("utf-8")

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
