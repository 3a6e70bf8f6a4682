"""Digest-certified canary prober: black-box serve-plane health.

White-box metrics say what the plane *thinks* it is doing; the canary
says what a tenant actually *gets*.  A background synthetic tenant
(``tenant="canary"``) pins one small session per serving worker — on the
cluster plane, :meth:`ClusterServePlane.canary_targets` names one owned
shard per worker and the prober *mines* a session id whose crc32 shard
hash lands there (the routing function is pure, so the aim is
exact) — then steps each pinned board at a fixed cadence through the
REAL HTTP surface: the same URL parsing, admission, routing, wire
framing, batched engine, and digest pipeline every tenant request
rides.

Every answer is **digest-certified**: the prober maintains a local
pure-numpy oracle (:func:`ops.npkernel.step_np`, the same oracle the
test suite trusts) for each pinned board and compares the served digest
at the served epoch against the oracle chain.  The chain is a dict keyed
by epoch, so a failover that legitimately rolls a session back to its
replicated epoch still certifies — only an answer that matches *no*
epoch's truth is corruption.

Failure modes become paged signals within ONE cadence:

- **silent corruption** (a worker serving wrong cells with a confident
  digest) → digest mismatch → ``gol_canary_failures_total`` +
  flight dump (``reason=canary_fail``) carrying the failing probe's
  trace id;
- **a wedged worker** (routes fine, never answers) → probe timeout →
  the same failure path, plus ``gol_canary_staleness_seconds`` growing
  past the cadence;
- **an honest loss** (404 after an unreplicated crash) → the prober
  re-pins a fresh session and keeps probing — loss is the serve plane's
  own loud metric, not a canary corruption.

A 429 (failover window, draining) is *retryable by contract* and counts
as a ``rejected`` probe, never a failure — the canary measures the
tenant contract, and the contract says retry.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, Optional

import numpy as np

from akka_game_of_life_tpu_torch.obs import get_registry
from akka_game_of_life_tpu_torch.obs.tracing import get_tracer
from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.ops.npkernel import step_np
from akka_game_of_life_tpu_torch.serve.sessions import shard_of
from akka_game_of_life_tpu_torch.utils.patterns import random_grid

TENANT = "canary"
# Fixed seed: every pinned board is the same reproducible orbit, so a
# post-mortem can replay the oracle chain from the access log alone.
SEED = 7
DENSITY = 0.5
RULE = "conway"
# Oracle-chain retention (epochs): far past any legitimate failover
# rollback window, bounded so a long-lived prober cannot grow unbounded.
CHAIN_KEEP = 4096
# Sid-mining bound: P(miss) per draw is (1 - 1/n_shards); even 256
# shards clears in ~1500 draws with probability ~1-1e-3, and mining is
# a one-time cost per (re-)pin.
MINE_LIMIT = 100_000


class _Pin:
    """One pinned canary session: its id, its oracle board, and the
    digest chain the served answers are certified against."""

    __slots__ = ("worker", "shard", "sid", "board", "epoch", "digests",
                 "last_ok")

    def __init__(self, worker: str, shard: Optional[int], sid: str,
                 board: np.ndarray, now: float):
        self.worker = worker
        self.shard = shard
        self.sid = sid
        self.board = board
        self.epoch = 0
        self.digests: Dict[int, str] = {
            0: odigest.format_digest(odigest.value(
                odigest.digest_dense_np(board)
            ))
        }
        self.last_ok = now

    def expect(self, epoch: int) -> Optional[str]:
        """The oracle digest at ``epoch`` — stepping the local board
        forward as needed (None: the epoch fell off the kept chain)."""
        while self.epoch < epoch:
            self.board = step_np(self.board, RULE)
            self.epoch += 1
            self.digests[self.epoch] = odigest.format_digest(
                odigest.value(odigest.digest_dense_np(self.board))
            )
            stale = self.epoch - CHAIN_KEEP
            if stale in self.digests:
                del self.digests[stale]
        return self.digests.get(epoch)


class CanaryProber:
    """Background prober against a serve endpoint's real HTTP surface.

    ``plane`` (the cluster frontend's :class:`ClusterServePlane`) turns
    on per-worker pinning; without it one local session covers the
    single-process serve role.  ``probe_now()`` runs one full round
    synchronously — the unit the background thread repeats at
    ``serve_canary_interval_s``, and the handle tests drive directly.
    """

    def __init__(self, config, *, base: str, registry=None, tracer=None,
                 events=None, plane=None):
        self.base = base.rstrip("/")
        self.interval = float(getattr(config, "serve_canary_interval_s", 2.0))
        self.side = int(getattr(config, "serve_canary_side", 32))
        # Generous floor: a first-compile step legitimately takes seconds,
        # and a slow-but-correct answer must not page as a failure — a
        # truly wedged worker still pages via the staleness gauge within
        # one cadence, then via timeout failures past the floor.
        self.timeout = max(5.0, 2.0 * self.interval)
        self.plane = plane
        self.events = events
        self.tracer = tracer if tracer is not None else get_tracer()
        registry = registry if registry is not None else get_registry()
        self._m_probes = registry.counter(
            "gol_canary_probes_total", labelnames=("outcome",)
        )
        self._m_failures = registry.counter("gol_canary_failures_total")
        self._m_latency = registry.histogram("gol_canary_latency_seconds")
        self._m_staleness = registry.gauge("gol_canary_staleness_seconds")
        self._m_sessions = registry.gauge("gol_canary_sessions")
        self._pins: Dict[str, _Pin] = {}  # worker -> pin
        self._no_pin_since: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-canary"
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.timeout + 1.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.probe_now()
            except Exception:  # noqa: BLE001 — the prober must outlive any single bad round
                pass

    # -- one round ------------------------------------------------------------

    def probe_now(self) -> Dict[str, str]:
        """Pin any missing sessions, probe every pin once; returns
        worker -> outcome (the test surface)."""
        outcomes: Dict[str, str] = {}
        targets = self._targets()
        for worker, shard in targets.items():
            pin = self._pins.get(worker)
            if pin is None or pin.shard != shard:
                pin = self._pin(worker, shard)
                if pin is None:
                    # Couldn't (re-)seed this round: a transient refusal
                    # (draining, failover) or a birth mismatch (already
                    # counted as a failure by _pin).  Staleness keeps
                    # growing either way — a persistent inability to pin
                    # pages through that gauge, not a false corruption.
                    outcomes[worker] = "pin_failed"
                    self._m_probes.labels(outcome="pin_failed").inc()
                    continue
                self._pins[worker] = pin
            outcomes[worker] = self._probe(pin)
        # Stale pins for departed workers: drop (their sessions died or
        # migrated; coverage follows the live target set).
        for worker in [w for w in self._pins if w not in outcomes]:
            del self._pins[worker]
        self._m_sessions.set(len(self._pins))
        now = time.monotonic()
        if targets and not self._pins:
            # Nothing pinnable at all (surface down / every create
            # refused): the staleness clock must still run, or a dead
            # plane would read perfectly fresh.
            if self._no_pin_since is None:
                self._no_pin_since = now
            self._m_staleness.set(now - self._no_pin_since)
        else:
            self._no_pin_since = None
            self._m_staleness.set(max(
                (now - p.last_ok for p in self._pins.values()), default=0.0
            ))
        return outcomes

    def _targets(self) -> Dict[str, Optional[int]]:
        if self.plane is None:
            return {"local": None}
        try:
            return dict(self.plane.canary_targets())
        except Exception:  # noqa: BLE001 — a draining plane has no targets this round
            return {}

    def _mine_sid(self, worker: str, shard: Optional[int]) -> Optional[str]:
        if shard is None:
            return f"canary-{worker}-0"
        n = int(self.plane.n_shards)
        for i in itertools.count():
            if i >= MINE_LIMIT:
                return None
            sid = f"canary-{worker}-{i}"
            if shard_of(sid, n) == shard:
                return sid

    def _pin(self, worker: str, shard: Optional[int]) -> Optional[_Pin]:
        """Create (or re-create) the pinned session for one worker."""
        sid = self._mine_sid(worker, shard)
        if sid is None:
            return None
        body = {
            "tenant": TENANT, "sid": sid, "height": self.side,
            "width": self.side, "seed": SEED, "density": DENSITY,
            "rule": RULE,
        }
        status, doc = self._http("POST", "/boards", body)
        if status == 400 and "exists" in str(doc.get("error", "")):
            # A stale pin from a previous prober life owns the id: the
            # canary namespace is ours — reclaim and re-seed.
            self._http("DELETE", f"/boards/{sid}", None)
            status, doc = self._http("POST", "/boards", body)
        if status != 201:
            return None
        board = random_grid(
            (self.side, self.side), density=DENSITY, seed=SEED
        )
        pin = _Pin(worker, shard, sid, board, time.monotonic())
        served = doc.get("digest")
        if served is not None and served != pin.digests[0]:
            # Corrupt from birth — certify the create answer too.
            self._fail(pin, 0, pin.digests[0], served, trace=None)
            return None
        return pin

    def _probe(self, pin: _Pin) -> str:
        span = self.tracer.start(
            "serve.canary", node=None, worker=pin.worker, sid=pin.sid,
        )
        t0 = time.perf_counter()
        with span:
            status, doc = self._http(
                "POST", f"/boards/{pin.sid}/step",
                {"steps": 1, "_trace": span.ctx},
            )
            latency = time.perf_counter() - t0
            if status == 200:
                epoch = int(doc.get("epoch", -1))
                expected = pin.expect(epoch) if epoch >= 0 else None
                served = doc.get("digest")
                if expected is not None and served == expected:
                    pin.last_ok = time.monotonic()
                    self._m_probes.labels(outcome="ok").inc()
                    self._m_latency.observe(latency)
                    span.set(outcome="ok", epoch=epoch,
                             latency_s=round(latency, 6))
                    return "ok"
                span.set(outcome="mismatch", epoch=epoch)
                self._fail(pin, epoch, expected, served,
                           trace=span.trace_id)
                return "mismatch"
            if status == 429:
                # Retryable by contract (failover window / draining):
                # not corruption; staleness keeps the clock honest.
                self._m_probes.labels(outcome="rejected").inc()
                span.set(outcome="rejected", status=status)
                return "rejected"
            if status == 404:
                # Honest loss: drop the pin; next round re-creates it.
                self._pins.pop(pin.worker, None)
                self._m_probes.labels(outcome="lost").inc()
                span.set(outcome="lost", status=status)
                return "lost"
            span.set(outcome="error", status=status)
            self._count("error", failure=True, worker=pin.worker,
                        sid=pin.sid, trace=span.trace_id)
            return "error"

    # -- plumbing -------------------------------------------------------------

    def _fail(self, pin: _Pin, epoch: int, expected, served,
              trace: Optional[str]) -> None:
        self._count(
            "mismatch", failure=True, worker=pin.worker, sid=pin.sid,
            trace=trace, epoch=epoch, expected=expected, served=served,
        )
        # A corrupt answer means the board is untrusted from here on:
        # drop the pin so the next round re-seeds from epoch 0 and keeps
        # watching (one alarm per corrupt answer, not one forever).
        self._pins.pop(pin.worker, None)

    def _count(self, outcome: str, *, failure: bool, worker: str,
               sid: str = "", trace: Optional[str] = None,
               **fields) -> None:
        self._m_probes.labels(outcome=outcome).inc()
        if not failure:
            return
        self._m_failures.inc()
        if self.events is not None:
            self.events.emit(
                "canary_fail", outcome=outcome, worker=worker, sid=sid,
                trace=trace or "", **fields,
            )
        flight = getattr(self.tracer, "flight", None)
        if flight is not None:
            flight.dump("canary_fail", node="canary")

    def _http(self, method: str, path: str, body) -> tuple:
        data = (
            json.dumps(body).encode("utf-8") if body is not None else None
        )
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, self._json(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, self._json(e.read())
        except Exception as e:  # noqa: BLE001 — timeouts/conn refuse → probe error
            return 0, {"error": repr(e)}

    @staticmethod
    def _json(raw: bytes) -> dict:
        try:
            doc = json.loads(raw.decode("utf-8"))
            return doc if isinstance(doc, dict) else {"value": doc}
        except Exception:  # noqa: BLE001 — a torn body is an error document
            return {"error": "unparseable response"}
