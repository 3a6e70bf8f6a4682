"""The two serving planes side by side, for the port's serve tests.

``PKGS["jax"]`` and ``PKGS["torch"]`` expose the same names from each
package (the port's router on ``device="cpu"``), so one test script drives
both and the two transcripts must be equal.  The oracle is the port's numpy
stepper (``ops/npkernel.step_np``), which neither router uses.
"""

import functools
import json
import time
import types
import urllib.error
import urllib.request

import numpy as np

import akka_game_of_life_tpu.obs.catalog as j_catalog
import akka_game_of_life_tpu.obs.httpd as j_httpd
import akka_game_of_life_tpu.obs.metrics as j_metrics
import akka_game_of_life_tpu.ops.digest as j_digest
import akka_game_of_life_tpu.ops.fastforward as j_ff
import akka_game_of_life_tpu.runtime.config as j_config
import akka_game_of_life_tpu.serve as j_serve
import akka_game_of_life_tpu.serve.api as j_api
import akka_game_of_life_tpu.serve.batch as j_batch
import akka_game_of_life_tpu.serve.sessions as j_sessions
import akka_game_of_life_tpu_torch.obs.catalog as t_catalog
import akka_game_of_life_tpu_torch.obs.httpd as t_httpd
import akka_game_of_life_tpu_torch.obs.metrics as t_metrics
import akka_game_of_life_tpu_torch.ops.digest as t_digest
import akka_game_of_life_tpu_torch.ops.fastforward as t_ff
import akka_game_of_life_tpu_torch.runtime.config as t_config
import akka_game_of_life_tpu_torch.serve as t_serve
import akka_game_of_life_tpu_torch.serve.api as t_api
import akka_game_of_life_tpu_torch.serve.batch as t_batch
import akka_game_of_life_tpu_torch.serve.sessions as t_sessions
from akka_game_of_life_tpu_torch.ops.npkernel import step_np
from akka_game_of_life_tpu_torch.utils.patterns import random_grid


def _pkg(name, serve, sessions, batch, api, config, catalog, metrics, httpd, digest, ff, **router_kw):
    return types.SimpleNamespace(
        name=name,
        Router=functools.partial(serve.SessionRouter, **router_kw),
        AdmissionError=serve.AdmissionError,
        sessions=sessions,
        batch=batch,
        api=api,
        Config=config.SimulationConfig,
        registry=lambda: catalog.install(metrics.MetricsRegistry()),
        MetricsServer=httpd.MetricsServer,
        board_routes=serve.board_routes,
        digest=digest,
        ff_np=ff.fast_forward_np,
    )


PKGS = {
    "jax": _pkg("jax", j_serve, j_sessions, j_batch, j_api, j_config, j_catalog,
                j_metrics, j_httpd, j_digest, j_ff),
    "torch": _pkg("torch", t_serve, t_sessions, t_batch, t_api, t_config, t_catalog,
                  t_metrics, t_httpd, t_digest, t_ff, device="cpu"),
}


def cfg(pkg, **kw):
    kw.setdefault("role", "serve")
    kw.setdefault("flight_dir", "")
    return pkg.Config(**kw)


def oracle(rule, board0, steps):
    """``steps`` toroidal generations of ``board0`` by the numpy oracle."""
    board = np.asarray(board0, dtype=np.uint8)
    for _ in range(steps):
        board = step_np(board, rule)
    return board


def oracle_digest(rule, board0, steps) -> int:
    return t_digest.value(t_digest.digest_dense_np(oracle(rule, board0, steps)))


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def http(base, method, path, doc=None):
    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_stack(pkg, config=None, registry=None, health=None):
    """A router and a MetricsServer with the /boards routes on port 0."""
    registry = registry if registry is not None else pkg.registry()
    router = pkg.Router(config or cfg(pkg), registry=registry)
    server = pkg.MetricsServer(
        registry, port=0, host="127.0.0.1", routes=pkg.board_routes(router),
        health=health(router) if health else None,
    )
    return router, server, f"http://127.0.0.1:{server.port}"


def both(script):
    """Run ``script(pkg)`` through both packages; their transcripts must be
    equal.  Returns the port's."""
    got = {name: script(pkg) for name, pkg in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]

