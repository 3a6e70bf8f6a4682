"""The frontend federation: N serving-cluster frontends, one keyspace.

Counterpart of ``akka_game_of_life_tpu/serve/federation.py``, frame for
frame, so a federation may mix the port's frontends with the JAX package's.
Each frontend (``serve --serve-cluster on --frontend-seeds ...``) owns a
*slice* of the serve shard space, with no coordinator: ``shard_of(sid)``
picks the shard, and a rendezvous hash over the live frontends
(:func:`serve.sessions.rendezvous_pick`) picks the shard's owning frontend,
so any frontend answers any request:

- an op on a self-owned slice goes straight to the local
  :class:`serve.cluster.ClusterServePlane`;
- a create/step/delete on a foreign slice is forwarded over the peer link
  (``P_FWD_OPS`` / ``P_FWD_RESULT``; the owner runs one origin's ops on a
  session in their arrival order);
- a GET (it carries the board) answers 307 with the owner's own HTTP URL.

Frontends find each other from ``frontend_seeds`` and gossip membership,
the slice table (last writer wins by ``(version, owner)``) and budget
shares (``P_GOSSIP``), aged by :class:`runtime.membership.Membership`.
Each frontend streams its control rows (session index rows with their
epoch and digest) to a rendezvous-chosen *standby* peer (``P_REPLICATE`` /
``P_REPLICATE_ACK``).  The peer plane shares the frontend's worker
listener: a connection whose first frame is ``P_HELLO`` is a peer.

Silence alone never moves ownership.  A peer whose gossip is older than
``frontend_gossip_timeout_s`` is SUSPECT: ops on its slices answer the
retryable 429 ``partitioned``, never a 404 and never a second owner.  A
peer is CONFIRMED dead only on link EOF plus a redial that is refused
(the process is gone); its standby then adopts its slices and installs the
replicated rows (``ClusterServePlane.begin_federation_promotion``: ops in
the window answer the retryable 429 ``failover``), and the dead frontend's
workers re-home their control channel to a peer from their ``FED_PEERS``
list and announce their sessions with ``SHARD_HOME``, which closes the
window with no admitted session lost.

Seven changes from the JAX module and its worker's re-home, each with its
test (the frames and the placement functions stay the JAX module's, so
mixed fleets agree; ROADMAP's queue 3 lists the same seven):

- The standby installs a dead peer's rows and opens their windows under
  the same lock hold that moves the peer's slices to it.  The JAX module
  moves the slices first and installs after the lock is released, so an
  op in between finds this frontend the owner of a session it does not
  hold yet: a 404 for a board that survived.
- The gossip tick and the gossip merge read the plane's session index
  through a snapshot of its keys (``list()`` of the dict, which holds the
  GIL throughout), where the JAX module iterates the live dict; a create
  racing that loop raised "dictionary changed size during iteration",
  which cost the tick its gossip send or, in a merge, ended the peer
  link's reader thread.
- The re-home fallbacks a frontend gives its workers list its standby
  first.  The JAX module lists them by name, so with three or more
  frontends a worker may re-home to a peer that is not the standby: the
  standby's windows then never see a SHARD_HOME and expire, and the
  sessions the worker still holds are counted lost.
- The owner runs one origin's forwarded ops in arrival order per session,
  on ``FWD_LANES`` lanes, where the JAX module runs them one at a time.
  When a frontend dies, its clients move to a survivor, which forwards a
  third of the keyspace to the standby at once; one at a time, each op
  waiting for its worker's tick, they outlast ``FWD_TIMEOUT_S`` and
  answer 503.
- A frontend the placement leaves without a slice forwards its auto-id
  creates to the peer owning most slices (:meth:`FederationPlane._sid_host`);
  the JAX module refuses them with a 429 for as long as it lives.
- A worker that re-homes first lets the ops its dead frontend sent land
  (``BackendWorker._settle``: a barrier through its dispatch loop and the
  serve plane's FIFO, then the router's jobs), so its ``SHARD_HOME``
  counts them; the JAX worker announces the sessions as they stand, and a
  client reading an epoch back after the failover may step a second time.
- The answers to the dead frontend's ops are dropped at the re-home
  (``ServeWorkerPlane.discard_results``), where the JAX worker sends them
  to the new frontend after the swap, and there a result's rid names
  another op.
"""

from __future__ import annotations

import itertools
import queue
import socket
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from akka_game_of_life_tpu_torch.runtime import protocol as P
from akka_game_of_life_tpu_torch.runtime.membership import Membership
from akka_game_of_life_tpu_torch.runtime.wire import dial
from akka_game_of_life_tpu_torch.serve.sessions import (
    AdmissionError,
    rendezvous_pick,
    shard_of,
)

# A forwarded op rides two HTTP-ish hops; give it the cluster op budget
# plus slack for the owner's own worker round-trip.
FWD_TIMEOUT_S = 15.0
# Confirmed-death probe: how long a redial may take before it reads as
# "unreachable" (partition) rather than "refused" (dead).
PROBE_TIMEOUT_S = 1.0
# A federation promotion window with no SHARD_HOME closes honestly after
# this many gossip timeouts (the dead frontend's workers died with it).
REHOME_GRACE_TIMEOUTS = 6.0
# Bounded auto-sid mining: expected attempts ≈ live frontends, so this
# bound is never reached in practice (the canary sid-mining discipline).
SID_MINE_ATTEMPTS = 4096
# Lanes of one origin's forwarded ops on the owner: ops on one session keep
# their lane (and so their order); ops on different sessions run side by
# side, up to this many at once.
FWD_LANES = 64


class FederationRedirect(Exception):
    """A request whose payload is too fat to proxy (GET ``/boards/<id>``
    carries the board): answer 307 with the owning frontend's URL.  The
    HTTP layer (``BoardsRoute._respond``) maps this to a ``Location``
    header; every other surface treats it as an error."""

    def __init__(self, url: str) -> None:
        super().__init__(url)
        self.url = url


def parse_seeds(spec: str) -> List[Tuple[str, int]]:
    """``host:port,host:port`` → [(host, port)] (config validated the
    shape; this just splits)."""
    out: List[Tuple[str, int]] = []
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append((host, int(port)))
    return out


class _Moved(Exception):
    """Owner-side: the forwarded op's slice moved after the origin routed
    it — carries the owner this side currently believes in, so the origin
    can retry toward it exactly once."""

    def __init__(self, owner: str) -> None:
        super().__init__(owner)
        self.owner = owner


class _OriginExec:
    """The forwarded ops of one origin frontend, executed in arrival order
    per session: an op runs on the lane of its sid (crc32 mod
    ``FWD_LANES``), a FIFO thread started at the lane's first op.  Two ops
    on one session never reorder (the per-peer wire FIFO extended through
    execution), while ops on different sessions, which no client orders,
    proceed in parallel, as their HTTP requests do on the owner."""

    def __init__(self, fed: "FederationPlane", origin: str) -> None:
        self._fed = fed
        self._origin = origin
        self._lock = threading.Lock()
        self._lanes: Dict[int, "queue.Queue[Optional[dict]]"] = {}
        self._closed = False

    def put(self, msg: dict) -> None:
        sid = str((msg.get("kwargs") or {}).get("sid", ""))
        lane = zlib.crc32(sid.encode("utf-8")) % FWD_LANES
        with self._lock:
            if self._closed:
                return
            q = self._lanes.get(lane)
            if q is None:
                q = self._lanes[lane] = queue.Queue()
                threading.Thread(
                    target=self._run, args=(q,), daemon=True,
                    name=f"fed-exec-{self._origin}-{lane}",
                ).start()
        q.put(msg)

    def _run(self, q: "queue.Queue[Optional[dict]]") -> None:
        while True:
            msg = q.get()
            if msg is None:
                return
            self._fed._exec_fwd(self._origin, msg)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            lanes = list(self._lanes.values())
        for q in lanes:
            q.put(None)


class _Peer:
    """One live peer frontend: its identity, addresses, and the single
    FIFO channel both directions of traffic ride."""

    __slots__ = ("name", "channel", "advertise", "cluster", "http_port",
                 "dialer", "slices")

    def __init__(self, name: str, channel, *, advertise, cluster,
                 http_port: int, dialer: str) -> None:
        self.name = name
        self.channel = channel
        self.advertise = tuple(advertise)  # (host, port) peers dial
        self.cluster = tuple(cluster)      # (host, port) workers dial
        self.http_port = int(http_port)    # tenant/obs endpoint
        self.dialer = dialer               # which side dialed (dedupe key)
        self.slices = 0                    # last gossiped owned count


class FederationPlane:
    """Peer-plane state machine for ONE frontend process.  Wraps (never
    replaces) the local :class:`ClusterServePlane`; the tenant surface
    mounts :attr:`router`, a :class:`FederatedRouter` exposing the same
    SessionRouter shape ``BoardsRoute`` already speaks.

    Lock discipline mirrors the plane's: ``self._lock`` orders the peer
    table, the slice map, and forwarding bookkeeping; NOTHING is sent on
    the wire while it is held (channel sends are themselves
    thread-safe)."""

    def __init__(self, config, plane, *, name: str,
                 cluster_addr: Tuple[str, int], events=None) -> None:
        self.config = config
        self.plane = plane
        self.name = name
        self.cluster_addr = tuple(cluster_addr)
        self.http_port = 0  # set once the obs endpoint binds
        self.events = events
        self.metrics = plane.metrics
        self.tracer = plane.tracer
        self.router = FederatedRouter(self)
        self.n_shards = plane.n_shards

        self.gossip_interval_s = float(config.frontend_gossip_interval_s)
        self.gossip_timeout_s = float(config.frontend_gossip_timeout_s)
        self.replicate_every = int(config.frontend_replicate_every)
        self.replicate_interval_s = float(config.frontend_replicate_interval_s)
        self._seeds = parse_seeds(config.frontend_seeds)

        self._lock = threading.RLock()
        self.membership = Membership(self.gossip_timeout_s)
        self.peers: Dict[str, _Peer] = {}  # graftlint: guarded-by _lock
        self._suspect: set = set()  # graftlint: guarded-by _lock
        # Peers whose slice table we have merged at least once; claiming
        # "unowned" slices is gated on it (see _claim_unowned_locked).
        self._gossip_heard: set = set()  # graftlint: guarded-by _lock
        self._dead: Dict[str, float] = {}  # graftlint: guarded-by _lock
        self._probing: set = set()  # graftlint: guarded-by _lock
        # shard → (owner frontend, version): the federated slice map,
        # merged LWW by version (ties break to the larger name — both
        # sides compute the same winner with no coordinator).
        self.slices: Dict[int, Tuple[str, int]] = {}  # graftlint: guarded-by _lock
        self._budget: Dict[str, dict] = {}  # graftlint: guarded-by _lock
        # Known member addresses (relayed via gossip for transitive
        # discovery): name → {"advertise": (h, p), "cluster": (h, p),
        # "http": port}.
        self._known: Dict[str, dict] = {}  # graftlint: guarded-by _lock

        # Forwarding: rid → {"ev", "result"}.
        self._fwd: Dict[int, dict] = {}  # graftlint: guarded-by _lock
        self._rids = itertools.count(1)
        self._exec: Dict[str, _OriginExec] = {}  # graftlint: guarded-by _lock

        # Control-state replication (origin side): sid → (epoch, digest)
        # the standby has ACKED; seq → (updates, drops) in flight.
        self._repl_acked: Dict[str, tuple] = {}  # graftlint: guarded-by _lock
        self._repl_inflight: Dict[int, tuple] = {}  # graftlint: guarded-by _lock
        self._repl_seq = itertools.count(1)
        self._standby: Optional[str] = None  # graftlint: guarded-by _lock
        # Standby side: origin → {sid: row} (the peer's replicated slice
        # of control state, promoted on confirmed death).
        self._store: Dict[str, Dict[str, dict]] = {}  # graftlint: guarded-by _lock
        # Federation promotion windows awaiting SHARD_HOME: shard → deadline.
        self._promote_deadline: Dict[int, float] = {}  # graftlint: guarded-by _lock

        self._sid_counter = itertools.count(1)
        self._sid_prefix = f"s{abs(hash(name)) & 0xFFFF:04x}-"
        self._stop = threading.Event()
        self._on_peers_changed = None  # frontend hook: push FED_PEERS

        self._m_peers = self.metrics.gauge(
            "gol_frontend_peers", "Live federation peer frontends", ()
        )
        self._m_gossip_age = self.metrics.gauge(
            "gol_frontend_gossip_age_seconds",
            "Seconds since the last gossip/frame from each peer frontend",
            ("peer",),
        )
        self._m_fwd_ops = self.metrics.counter(
            "gol_frontend_forwarded_ops_total"
        )
        self._m_redirects = self.metrics.counter(
            "gol_frontend_forward_redirects_total"
        )
        self._m_promotions = self.metrics.counter(
            "gol_frontend_slice_promotions_total"
        )
        self._m_slices = self.metrics.gauge(
            "gol_frontend_slices_owned",
            "Serve-keyspace slices this frontend owns", ()
        )
        self._m_parked = self.metrics.counter(
            "gol_frontend_parked_ops_total"
        )
        self._m_repl_rows = self.metrics.counter(
            "gol_frontend_replicated_rows_total"
        )
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for fn in (self._gossip_loop, self._replicate_loop):
            t = threading.Thread(target=fn, daemon=True, name=fn.__name__)
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            peers = list(self.peers.values())
            self.peers.clear()
            execs = list(self._exec.values())
            self._exec.clear()
            for slot in self._fwd.values():
                slot["result"] = {
                    "ok": False,
                    "error": {"kind": "error", "detail": "federation closed"},
                }
                slot["ev"].set()
            self._fwd.clear()
        for ex in execs:
            ex.close()
        for p in peers:
            try:
                p.channel.close()
            except OSError:
                pass

    # -- identity / addressing -----------------------------------------------

    def set_http_port(self, port: int) -> None:
        self.http_port = int(port)

    def on_peers_changed(self, fn) -> None:
        """Frontend hook: called (outside the lock) whenever the live
        peer set changes, so workers get a fresh FED_PEERS fallback
        list."""
        self._on_peers_changed = fn

    def worker_fallbacks(self) -> List[List]:
        """Live peers' cluster (worker-listener) addresses — the control
        re-home targets a WELCOME/FED_PEERS frame carries, in the order a
        worker tries them: this frontend's standby first (the peer that
        adopts its slices and waits for the workers' SHARD_HOME), then the
        rest by name."""
        alive = {m.name for m in self.membership.alive_members()}
        with self._lock:
            standby = self._standby_locked()
            return [
                [p.cluster[0], p.cluster[1]]
                for n, p in sorted(
                    self.peers.items(), key=lambda kv: (kv[0] != standby, kv[0])
                )
                if n in alive
            ]

    def _hello_doc(self) -> dict:
        return {
            "type": P.P_HELLO,
            "name": self.name,
            "advertise": list(self.cluster_addr),
            "cluster": list(self.cluster_addr),
            "http": self.http_port,
            "dialer": "",  # stamped by the dialing side
        }

    # -- peer connections ----------------------------------------------------

    def serve_peer(self, channel, hello: dict) -> None:
        """Acceptor side: a freshly accepted connection whose first frame
        was a P_HELLO (the frontend's listener hands it over).  Replies
        with our own hello, registers the peer, then reads frames until
        EOF — this IS the connection's reader thread."""
        name = str(hello.get("name") or "")
        if not name or name == self.name:
            channel.close()
            return
        try:
            channel.send(self._hello_doc())
        except OSError:
            channel.close()
            return
        if not self._register_peer(channel, hello,
                                   dialer=str(hello.get("dialer") or name)):
            channel.close()
            return
        self._read_peer(name, channel)

    def _dial_peer(self, host: str, port: int) -> bool:
        """Dialer side: connect, exchange hellos, register, spawn the
        reader.  Returns True when a live peer link came up."""
        try:
            channel = dial(host, port, timeout_s=PROBE_TIMEOUT_S,
                           send_deadline_s=self.config.send_deadline_s)
            doc = self._hello_doc()
            doc["dialer"] = self.name
            channel.send(doc)
            hello = channel.recv()
        except (OSError, ValueError):
            return False
        if (
            not isinstance(hello, dict)
            or hello.get("type") != P.P_HELLO
            or not hello.get("name")
            or hello["name"] == self.name
        ):
            channel.close()
            return False
        if not self._register_peer(channel, hello, dialer=self.name):
            channel.close()
            return False
        name = str(hello["name"])
        t = threading.Thread(
            target=self._read_peer, args=(name, channel), daemon=True,
            name=f"fed-peer-{name}",
        )
        t.start()
        return True

    def _register_peer(self, channel, hello: dict, *, dialer: str) -> bool:
        """Install (or dedupe) one peer link.  Simultaneous mutual dials
        produce two connections for one name; both sides keep the one
        whose DIALER is the lexicographically smaller frontend — a
        deterministic rule needing no extra round-trip."""
        name = str(hello["name"])
        peer = _Peer(
            name, channel,
            advertise=hello.get("advertise") or [channel.sock.getpeername()[0], 0],
            cluster=hello.get("cluster") or hello.get("advertise") or ["", 0],
            http_port=int(hello.get("http", 0) or 0),
            dialer=dialer,
        )
        with self._lock:
            old = self.peers.get(name)
            if old is not None and old.channel is not channel:
                # Keep the link dialed by min(name): both ends agree.
                if min(old.dialer, peer.dialer) == old.dialer:
                    return False
                try:
                    old.channel.close()
                except OSError:
                    pass
            self.peers[name] = peer
            self._dead.pop(name, None)
            self._suspect.discard(name)
            # A (re)joined incarnation must gossip its table before it
            # counts as heard — pause unowned-slice claims one round.
            self._gossip_heard.discard(name)
            # A restarted peer comes back empty: its OLD replicated rows
            # describe sessions that no longer exist anywhere.
            self._store.pop(name, None)
            self._known[name] = {
                "advertise": peer.advertise, "cluster": peer.cluster,
                "http": peer.http_port,
            }
        m = self.membership.get(name)
        if m is None or not m.alive:
            self.membership.register(
                channel, name,
                peer_host=peer.advertise[0], peer_port=int(peer.advertise[1]),
            )
        else:
            m.channel = channel
            self.membership.beat(name)
        if self.events is not None:
            self.events.emit("frontend_peer_joined", peer=name)
        self._refresh_gauges()
        self._notify_peers_changed()
        return True

    def _read_peer(self, name: str, channel) -> None:
        try:
            while not self._stop.is_set():
                msg = channel.recv()
                if msg is None:
                    break
                if isinstance(msg, dict):
                    self._on_peer_msg(name, msg)
        except (OSError, ValueError):
            pass
        finally:
            with self._lock:
                peer = self.peers.get(name)
                stale = peer is not None and peer.channel is channel
            if stale and not self._stop.is_set():
                self._on_peer_link_down(name)

    # -- failure detection ---------------------------------------------------

    def _on_peer_link_down(self, name: str) -> None:
        """Link EOF: probe the peer's address until the verdict resolves.
        Connection-refused means the process is gone (port unbound) —
        CONFIRMED dead, promote.  Anything else (timeout, unreachable, or
        an accepting socket) is a partition or restart-in-progress:
        SUSPECT, park, and probe again from this (now otherwise idle)
        reader thread — a one-shot verdict would let a single transient
        non-refused probe park the peer's slices forever."""
        with self._lock:
            if name in self._probing:
                return
            self._probing.add(name)
            peer = self.peers.get(name)
            down_channel = peer.channel if peer is not None else None
        suspected = False
        try:
            while not self._stop.is_set():
                verdict = self._probe(name)
                if verdict == "dead":
                    self._confirm_dead(name)
                    return
                with self._lock:
                    peer = self.peers.get(name)
                    if peer is None or peer.channel is not down_channel:
                        # Re-registered (a restart dialed back in) or
                        # confirmed dead by another path: verdict settled.
                        return
                    self._suspect.add(name)
                if not suspected:
                    suspected = True
                    if self.events is not None:
                        self.events.emit(
                            "frontend_peer_suspect", peer=name,
                            verdict=verdict,
                        )
                if self._stop.wait(self.gossip_interval_s):
                    return
        finally:
            with self._lock:
                self._probing.discard(name)

    def _probe(self, name: str) -> str:
        with self._lock:
            peer = self.peers.get(name)
            addr = peer.advertise if peer is not None else (
                self._known.get(name, {}).get("advertise")
            )
        if not addr or not addr[0]:
            return "unknown"
        try:
            s = socket.create_connection(
                (addr[0], int(addr[1])), timeout=PROBE_TIMEOUT_S
            )
            s.close()
            return "accepting"  # something listens there: NOT provably dead
        except ConnectionRefusedError:
            return "dead"
        except OSError:
            return "partitioned"

    def _confirm_dead(self, name: str) -> None:
        """EOF + redial-refused: the peer process is gone.  Its standby
        (rendezvous over the survivors) adopts ALL of its slices and
        promotes the replicated control rows; everyone else just marks
        the owner dead (ops park retryable until the standby's claims
        gossip in)."""
        self.membership.mark_dead(name)
        rows: List[dict] = []
        adopt: List[int] = []
        with self._lock:
            peer = self.peers.pop(name, None)
            self._suspect.discard(name)
            self._dead[name] = time.monotonic()
            survivors = sorted(
                {self.name}
                | {m.name for m in self.membership.alive_members()}
            )
            standby = rendezvous_pick(f"fe-standby:{name}", survivors)
            if standby == self.name:
                rows = list(self._store.pop(name, {}).values())
                deadline = time.monotonic() + max(
                    10.0, REHOME_GRACE_TIMEOUTS * self.gossip_timeout_s
                )
                for shard, (owner, version) in self.slices.items():
                    if owner == name:
                        self.slices[shard] = (self.name, version + 1)
                        adopt.append(shard)
                        self._promote_deadline[shard] = deadline
                if adopt:
                    # Under the lock that flips the slices: an op that
                    # sees this frontend own them finds the placeholder
                    # rows and their windows (a 429), never a 404.  The
                    # plane's lock nests inside this one, as in the tick.
                    self.plane.begin_federation_promotion(rows, origin=name)
            # Unanswered forwarded ops toward the dead peer fail fast as
            # retryable (never silently lost).
            for rid, slot in list(self._fwd.items()):
                if slot.get("peer") == name:
                    slot["result"] = {
                        "ok": False,
                        "error": {
                            "kind": "admission", "reason": "failover",
                            "detail": f"frontend {name} died mid-forward; "
                                      f"retry",
                        },
                    }
                    slot["ev"].set()
                    del self._fwd[rid]
            ex = self._exec.pop(name, None)
        if ex is not None:
            ex.close()
        if peer is not None:
            try:
                peer.channel.close()
            except OSError:
                pass
        # Label-cardinality reclaim: a dead peer must not export forever.
        self._m_gossip_age.remove(peer=name)
        if self.events is not None:
            self.events.emit(
                "frontend_peer_dead", peer=name,
                standby=standby, slices_adopted=len(adopt),
            )
        if adopt:
            self._m_promotions.inc(len(adopt))
        self._refresh_gauges()
        self._notify_peers_changed()

    # -- gossip --------------------------------------------------------------

    def _gossip_loop(self) -> None:
        while not self._stop.wait(self.gossip_interval_s):
            try:
                self._dial_missing()
                self._gossip_tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    def _dial_missing(self) -> None:
        """Connect to every seed and every gossip-learned member we hold
        no live link to (transitive discovery — a new frontend needs only
        ONE live seed to find the whole federation)."""
        targets: List[Tuple[str, int]] = []
        with self._lock:
            connected = set(self.peers)
            known = dict(self._known)
        for host, port in self._seeds:
            if (host, port) == self.cluster_addr:
                continue
            if any(
                tuple(meta["advertise"]) == (host, port)
                for n, meta in known.items() if n in connected
            ):
                continue
            targets.append((host, port))
        for name, meta in known.items():
            if name in connected or name == self.name:
                continue
            addr = tuple(meta["advertise"])
            if addr not in targets and addr != self.cluster_addr:
                targets.append(addr)
        for host, port in targets:
            if self._stop.is_set():
                return
            self._dial_peer(host, port)

    def _gossip_tick(self) -> None:
        now = time.monotonic()
        alive = {m.name: m for m in self.membership.alive_members()}
        with self._lock:
            self._claim_unowned_locked(alive)
            self._release_empty_locked(alive)
            doc = self._gossip_doc_locked(alive, now)
            channels = [
                (n, p.channel) for n, p in self.peers.items() if n in alive
            ]
            # Suspects age in and out with evidence: traffic resumed →
            # clear; stale past the timeout with a live link → suspect.
            for name, m in alive.items():
                age = now - m.last_seen
                self._m_gossip_age.labels(peer=name).set(round(age, 3))
                if age > self.gossip_timeout_s:
                    if name not in self._suspect:
                        self._suspect.add(name)
                        if self.events is not None:
                            self.events.emit(
                                "frontend_peer_suspect", peer=name,
                                verdict="gossip_stale",
                            )
                else:
                    self._suspect.discard(name)
        for _name, ch in channels:
            try:
                ch.send(doc)
            except OSError:
                pass  # the reader thread's EOF path owns the verdict
        self._expire_promotions(now)
        self._refresh_gauges()

    def _claim_unowned_locked(self, alive: dict) -> None:
        """Claim UNOWNED slices whose rendezvous-desired owner is this
        frontend.  Never claims an owned slice — ownership moves only by
        owner-initiated release (empty slices) or confirmed-death
        promotion; that asymmetry is the split-brain guard."""
        for name in alive:
            if name not in self._gossip_heard and name not in self._suspect:
                # A live peer whose slice table we have never merged: a
                # shard that LOOKS unowned may carry its claim — a fresh
                # boot that claimed here would steal owned slices and
                # bounce forwarded ops off an owner with no session rows.
                # One gossip round (or the stale-suspect timeout) settles
                # which shards are genuinely unowned.
                return
        names = sorted({self.name} | set(alive))
        for shard in range(self.n_shards):
            if shard in self.slices:
                continue
            if rendezvous_pick(f"slice:{shard}", names) == self.name:
                self.slices[shard] = (self.name, 1)

    def _release_empty_locked(self, alive: dict) -> None:
        """The elastic planner's FOURTH resource type: EMPTY self-owned
        slices flip (budget-free, like ``plan_shards`` empties) to their
        rendezvous-desired owner, so a late-joining frontend absorbs its
        share of an idle keyspace in one gossip round."""
        live = sorted({self.name} | set(alive))
        if len(live) < 2:
            return
        weights: Dict[int, int] = {}
        # A snapshot of the keys (advisory: a create racing it lands in a
        # slice this pass skips, with a non-zero weight on the next).
        for sid in list(self.plane.sessions):
            s = shard_of(sid, self.n_shards)
            weights[s] = weights.get(s, 0) + 1
        owners = {
            s: rec[0] for s, rec in self.slices.items() if rec[0] == self.name
        }
        for shard, _src, dest in self.plane.rebalancer.plan_slices(
            owners, weights, live, self.name,
        ):
            _owner, version = self.slices[shard]
            self.slices[shard] = (dest, version + 1)

    def _gossip_doc_locked(self, alive: dict, now: float) -> dict:
        members = {
            self.name: {
                "advertise": list(self.cluster_addr),
                "cluster": list(self.cluster_addr),
                "http": self.http_port,
            }
        }
        for name, meta in self._known.items():
            if name in alive:
                members[name] = {
                    "advertise": list(meta["advertise"]),
                    "cluster": list(meta["cluster"]),
                    "http": meta["http"],
                }
        stats = self.plane.stats()
        self._budget[self.name] = {
            "sessions": stats["sessions"], "cells": stats["cells"],
        }
        return {
            "type": P.P_GOSSIP,
            "from": self.name,
            "members": members,
            "slices": {str(s): [o, v] for s, (o, v) in self.slices.items()},
            "budget": dict(self._budget[self.name]),
            "owned": sum(
                1 for o, _v in self.slices.values() if o == self.name
            ),
        }

    def _merge_gossip(self, origin: str, msg: dict) -> None:
        self.membership.beat(origin)
        members = msg.get("members") or {}
        slices = msg.get("slices") or {}
        budget = msg.get("budget")
        with self._lock:
            self._gossip_heard.add(origin)
            for name, meta in members.items():
                if name == self.name or not isinstance(meta, dict):
                    continue
                if meta.get("advertise"):
                    self._known[name] = {
                        "advertise": tuple(meta["advertise"]),
                        "cluster": tuple(
                            meta.get("cluster") or meta["advertise"]
                        ),
                        "http": int(meta.get("http", 0) or 0),
                    }
            if isinstance(budget, dict):
                self._budget[origin] = {
                    "sessions": int(budget.get("sessions", 0)),
                    "cells": int(budget.get("cells", 0)),
                }
            peer = self.peers.get(origin)
            if peer is not None:
                peer.slices = int(msg.get("owned", peer.slices))
            for key, rec in slices.items():
                try:
                    shard = int(key)
                    owner, version = str(rec[0]), int(rec[1])
                except (TypeError, ValueError, IndexError):
                    continue
                if shard < 0 or shard >= self.n_shards:
                    continue
                mine = self.slices.get(shard)
                if mine is None:
                    self.slices[shard] = (owner, version)
                    continue
                if (version, owner) > (mine[1], mine[0]) and owner != mine[0]:
                    if mine[0] == self.name and self._slice_nonempty(shard):
                        # A conflicting claim would strand live local
                        # sessions: re-assert with a higher version (the
                        # non-empty side always wins — sessions never
                        # live-migrate between frontends).
                        self.slices[shard] = (self.name, version + 1)
                    else:
                        self.slices[shard] = (owner, version)
                elif (version, owner) > (mine[1], mine[0]):
                    self.slices[shard] = (owner, version)

    def _slice_nonempty(self, shard: int) -> bool:
        return any(
            shard_of(sid, self.n_shards) == shard
            for sid in list(self.plane.sessions)
        )

    def _expire_promotions(self, now: float) -> None:
        expired: List[int] = []
        with self._lock:
            for shard, deadline in list(self._promote_deadline.items()):
                if now >= deadline:
                    del self._promote_deadline[shard]
                    expired.append(shard)
        for shard in expired:
            self.plane.expire_federation_promotion(shard)

    # -- peer frame dispatch -------------------------------------------------

    def _on_peer_msg(self, origin: str, msg: dict) -> None:
        kind = msg.get("type")
        self.membership.beat(origin)
        if kind == P.P_GOSSIP:
            self._merge_gossip(origin, msg)
        elif kind == P.P_FWD_OPS:
            with self._lock:
                ex = self._exec.get(origin)
                if ex is None:
                    ex = self._exec[origin] = _OriginExec(self, origin)
            ex.put(msg)
        elif kind == P.P_FWD_RESULT:
            with self._lock:
                slot = self._fwd.pop(int(msg.get("rid", 0)), None)
            if slot is not None:
                slot["result"] = msg
                slot["ev"].set()
        elif kind == P.P_REPLICATE:
            self._on_replicate(origin, msg)
        elif kind == P.P_REPLICATE_ACK:
            self._on_replicate_ack(origin, msg)

    # -- op forwarding (origin side) -----------------------------------------

    def owner_of(self, shard: int) -> str:
        """The shard's owning frontend — or a retryable 429 when the
        slice is unowned (bootstrap), its owner is suspect
        (``partitioned`` — the split-brain park), or its owner is
        confirmed dead with promotion still in flight (``failover``)."""
        with self._lock:
            rec = self.slices.get(shard)
            if rec is None:
                self.plane._reject(
                    "failover",
                    f"slice {shard} is unowned while the federation "
                    f"bootstraps; retry",
                )
            owner = rec[0]
            if owner == self.name:
                return owner
            if owner in self._suspect:
                self._m_parked.inc()
                self.plane._reject(
                    "partitioned",
                    f"slice {shard} owner {owner} is unreachable but not "
                    f"provably dead; writes park to avoid a split brain — "
                    f"retry",
                )
            peer = self.peers.get(owner)
        m = self.membership.get(owner)
        if peer is None or m is None or not m.alive:
            self.plane._reject(
                "failover",
                f"slice {shard} owner {owner} is down; its standby is "
                f"promoting — retry",
            )
        return owner

    def forward(self, owner: str, call: str, kwargs: dict,
                *, retried: bool = False):
        """Execute one router call on the owning frontend over the peer
        link.  Per-peer wire FIFO + per-origin executor = end-to-end
        FIFO.  A ``moved`` answer (the slice flipped after we routed)
        retries exactly once toward the owner's successor."""
        with self._lock:
            peer = self.peers.get(owner)
            if peer is None:
                self.plane._reject(
                    "failover", f"frontend {owner} is not connected; retry"
                )
            rid = next(self._rids)
            slot = {"ev": threading.Event(), "peer": owner}
            self._fwd[rid] = slot
        try:
            peer.channel.send({
                "type": P.P_FWD_OPS, "rid": rid, "call": call,
                "kwargs": kwargs, "origin": self.name,
            })
        except OSError:
            with self._lock:
                self._fwd.pop(rid, None)
            self.plane._reject(
                "failover", f"frontend {owner} link failed mid-send; retry"
            )
        self._m_fwd_ops.inc()
        if not slot["ev"].wait(FWD_TIMEOUT_S):
            with self._lock:
                self._fwd.pop(rid, None)
            raise TimeoutError(
                f"op forwarded to frontend {owner} timed out in flight"
            )
        res = slot["result"]
        if res.get("ok"):
            return res.get("value")
        err = res.get("error") or {}
        kind = err.get("kind")
        detail = str(err.get("detail", ""))
        if kind == "moved" and not retried:
            succ = str(err.get("owner") or "")
            if succ == self.name:
                raise _Moved(succ)  # caller re-runs locally
            if succ:
                return self.forward(succ, call, kwargs, retried=True)
        if kind == "admission":
            raise AdmissionError(str(err.get("reason", "failover")), detail)
        if kind == "key":
            raise KeyError(err.get("sid", detail))
        if kind == "value":
            raise ValueError(detail)
        if kind == "timeout":
            raise TimeoutError(detail)
        raise RuntimeError(f"forwarded op failed on {owner}: {detail}")

    # -- op forwarding (owner side) ------------------------------------------

    def _exec_fwd(self, origin: str, msg: dict) -> None:
        rid = int(msg.get("rid", 0))
        try:
            value = self._apply_local(
                str(msg.get("call", "")), msg.get("kwargs") or {}
            )
            reply = {"type": P.P_FWD_RESULT, "rid": rid, "ok": True,
                     "value": value}
        except _Moved as e:
            reply = self._fwd_error(rid, "moved", owner=e.owner)
        except AdmissionError as e:
            reply = self._fwd_error(
                rid, "admission", reason=e.reason, detail=str(e)
            )
        except KeyError as e:
            reply = self._fwd_error(rid, "key", sid=str(e.args[0]))
        except (ValueError, TypeError) as e:
            reply = self._fwd_error(rid, "value", detail=str(e))
        except TimeoutError as e:
            reply = self._fwd_error(rid, "timeout", detail=str(e))
        except Exception as e:  # noqa: BLE001 — every forwarded op answers
            reply = self._fwd_error(rid, "error", detail=repr(e))
        with self._lock:
            peer = self.peers.get(origin)
        if peer is None:
            return  # origin died mid-op; its failover path answered it
        try:
            peer.channel.send(reply)
        except OSError:
            pass

    @staticmethod
    def _fwd_error(rid: int, kind: str, **fields) -> dict:
        return {"type": P.P_FWD_RESULT, "rid": rid, "ok": False,
                "error": {"kind": kind, **fields}}

    def _apply_local(self, call: str, kwargs: dict):
        sid = str(kwargs.get("sid", ""))
        shard = shard_of(sid, self.n_shards)
        with self._lock:
            rec = self.slices.get(shard)
            if rec is None or rec[0] != self.name:
                raise _Moved(rec[0] if rec is not None else "")
        if call == "create":
            doc = self.plane.create(
                tenant=str(kwargs.get("tenant", "default")),
                rule=kwargs.get("rule", "conway"),
                height=int(kwargs.get("height", 64)),
                width=int(kwargs.get("width", 64)),
                seed=int(kwargs.get("seed", 0)),
                density=float(kwargs.get("density", 0.5)),
                with_board=False,  # fat payloads redirect, never forward
                sid=sid,
            )
            doc.pop("board", None)
            return doc
        if call == "step":
            epoch, digest = self.plane.step(
                sid, int(kwargs.get("steps", 1))
            )
            return [epoch, digest]
        if call == "delete":
            self.plane.delete(sid)
            return sid
        raise ValueError(f"unknown forwarded call {call!r}")

    # -- control-state replication -------------------------------------------

    def _replicate_loop(self) -> None:
        while not self._stop.wait(self.replicate_interval_s):
            try:
                self._replicate_tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    def _standby_locked(self) -> Optional[str]:
        alive = [
            m.name for m in self.membership.alive_members()
            if m.name not in self._suspect
        ]
        return rendezvous_pick(f"fe-standby:{self.name}", alive)

    def _replicate_tick(self) -> None:
        rows = self.plane.control_rows()
        with self._lock:
            standby = self._standby_locked()
            if standby != self._standby:
                # New standby (join/leave/promotion): reset and resend
                # the whole slice from scratch.
                self._standby = standby
                self._repl_acked.clear()
                self._repl_inflight.clear()
                reset = True
            else:
                reset = False
            if standby is None:
                return
            mine = {
                r["sid"]: r for r in rows
                if self.slices.get(r["slice"], ("",))[0] == self.name
            }
            dirty = [
                r for sid, r in mine.items()
                if self._repl_acked.get(sid) != (r["epoch"], r["digest"])
                and not any(
                    sid in upd for upd, _ in self._repl_inflight.values()
                )
            ]
            gone = [
                sid for sid in self._repl_acked
                if sid not in mine and not any(
                    sid in drops for _, drops in self._repl_inflight.values()
                )
            ]
            frames = []
            batch = max(1, self.replicate_every)
            first = True
            while dirty or gone or (reset and first):
                chunk, dirty = dirty[:batch], dirty[batch:]
                drops, gone = gone[:batch], gone[batch:]
                seq = next(self._repl_seq)
                self._repl_inflight[seq] = (
                    {r["sid"]: (r["epoch"], r["digest"]) for r in chunk},
                    list(drops),
                )
                frames.append({
                    "type": P.P_REPLICATE, "seq": seq, "rows": chunk,
                    "drop": drops, "reset": reset and first,
                })
                first = False
            peer = self.peers.get(standby)
        if peer is None:
            return
        for frame in frames:
            try:
                peer.channel.send(frame)
            except OSError:
                return
            self._m_repl_rows.inc(len(frame["rows"]))

    def _on_replicate(self, origin: str, msg: dict) -> None:
        """Standby side: install the origin's rows, ACK the seq (the
        origin's watermark advances exactly like a worker's
        SHARD_REPLICATE_ACK)."""
        with self._lock:
            store = self._store.setdefault(origin, {})
            if msg.get("reset"):
                store.clear()
            for row in msg.get("rows") or []:
                if isinstance(row, dict) and row.get("sid"):
                    store[str(row["sid"])] = row
            for sid in msg.get("drop") or []:
                store.pop(str(sid), None)
            peer = self.peers.get(origin)
        if peer is None:
            return
        try:
            peer.channel.send({
                "type": P.P_REPLICATE_ACK, "seq": int(msg.get("seq", 0)),
            })
        except OSError:
            pass

    def _on_replicate_ack(self, origin: str, msg: dict) -> None:
        with self._lock:
            if origin != self._standby:
                return  # stale ack from a previous standby
            inflight = self._repl_inflight.pop(int(msg.get("seq", 0)), None)
            if inflight is None:
                return
            updates, drops = inflight
            self._repl_acked.update(updates)
            for sid in drops:
                self._repl_acked.pop(sid, None)

    # -- sid mining ----------------------------------------------------------

    def mine_local_sid(self) -> str:
        """An auto-generated session id whose crc32 shard lands in a
        self-owned slice (bounded attempts, the canary sid-mining
        discipline) — every session's sid hashes to a slice owned by its
        hosting frontend, so routing by ``shard_of(sid)`` is uniform."""
        return self._mine_sid(self.name)

    def _sid_host(self) -> str:
        """Where an auto-id create lands: this frontend while it owns a
        slice, or while any slice is unowned (bootstrapping: the create
        answers 429); else the live peer owning most slices.  The
        rendezvous placement can leave a frontend no slice at all (its
        crc32 scores are XOR-linear in the key, so with few slices one
        frontend may never score highest); such a frontend forwards its
        creates instead of refusing them forever."""
        alive = {m.name for m in self.membership.alive_members()}
        with self._lock:
            counts: Dict[str, int] = {}
            for owner, _v in self.slices.values():
                counts[owner] = counts.get(owner, 0) + 1
            if counts.get(self.name) or len(self.slices) < self.n_shards:
                return self.name
            peers = [
                (n, c) for n, c in counts.items()
                if n in alive and n in self.peers and n not in self._suspect
            ]
        if not peers:
            return self.name
        return max(peers, key=lambda nc: (nc[1], nc[0]))[0]

    def _mine_sid(self, host: str) -> str:
        """An auto-generated session id whose shard lands in a slice owned
        by ``host`` (this frontend, or the peer a slice-less frontend
        forwards its creates to)."""
        with self._lock:
            owned = {
                s for s, (o, _v) in self.slices.items() if o == host
            }
        if not owned:
            self.plane._reject(
                "failover",
                "this frontend owns no slices yet (federation "
                "bootstrapping); retry",
            )
        for _ in range(SID_MINE_ATTEMPTS):
            sid = f"{self._sid_prefix}{next(self._sid_counter):08x}"
            if shard_of(sid, self.n_shards) in owned:
                return sid
        self.plane._reject(
            "failover", "could not mine a self-owned session id; retry"
        )
        raise AssertionError("unreachable")  # _reject always raises

    # -- cluster budget ------------------------------------------------------

    def check_cluster_budget(self, cells: int) -> None:
        """Gossiped budget shares make the cluster-wide caps meaningful
        across N frontends: the sum of everyone's shares (plus this
        create) must fit.  The local plane's ``_admit_locked`` stays as
        the per-process backstop."""
        max_sessions = self.plane.max_sessions
        max_cells = self.plane.max_cells
        with self._lock:
            alive = {m.name for m in self.membership.alive_members()}
            total_sessions = sum(
                b["sessions"] for n, b in self._budget.items()
                if n in alive and n != self.name
            )
            total_cells = sum(
                b["cells"] for n, b in self._budget.items()
                if n in alive and n != self.name
            )
        stats = self.plane.stats()
        total_sessions += stats["sessions"]
        total_cells += stats["cells"]
        if max_sessions and total_sessions + 1 > max_sessions:
            self.plane._reject(
                "max_sessions",
                f"cluster session budget exhausted "
                f"({total_sessions}/{max_sessions} across the federation)",
            )
        if max_cells and total_cells + cells > max_cells:
            self.plane._reject(
                "max_cells",
                f"cluster cell budget exhausted ({total_cells} + {cells} "
                f"> {max_cells} across the federation)",
            )

    # -- redirect targets ----------------------------------------------------

    def redirect_url(self, owner: str, sid: str) -> str:
        with self._lock:
            peer = self.peers.get(owner)
            meta = self._known.get(owner, {})
        host = peer.advertise[0] if peer is not None else (
            meta.get("advertise", ("", 0))[0]
        )
        http = peer.http_port if peer is not None else int(
            meta.get("http", 0) or 0
        )
        if not host or not http:
            self.plane._reject(
                "failover",
                f"frontend {owner} has no known HTTP endpoint yet; retry",
            )
        self._m_redirects.inc()
        return f"http://{host}:{http}/boards/{sid}"

    # -- observability -------------------------------------------------------

    def _refresh_gauges(self) -> None:
        alive = {m.name for m in self.membership.alive_members()}
        with self._lock:
            self._m_peers.set(len(alive & set(self.peers)))
            self._m_slices.set(sum(
                1 for o, _v in self.slices.values() if o == self.name
            ))

    def _notify_peers_changed(self) -> None:
        fn = self._on_peers_changed
        if fn is not None:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a push failure is advisory
                pass

    def health(self) -> dict:
        """The /healthz ``federation`` block: the peer view, the slice
        map, forwarded-op counters, promotion windows — what an operator
        checks first when one frontend of N misbehaves."""
        now = time.monotonic()
        alive = {m.name: m for m in self.membership.alive_members()}
        with self._lock:
            by_frontend: Dict[str, int] = {}
            for owner, _v in self.slices.values():
                by_frontend[owner] = by_frontend.get(owner, 0) + 1
            return {
                "name": self.name,
                "peers": {
                    name: {
                        "gossip_age_s": round(
                            max(0.0, now - alive[name].last_seen), 3
                        ) if name in alive else None,
                        "suspect": name in self._suspect,
                        "http": p.http_port,
                        "cluster": list(p.cluster),
                    }
                    for name, p in sorted(self.peers.items())
                },
                "suspect": sorted(self._suspect),
                "dead": sorted(self._dead),
                "slices": {
                    "total": self.n_shards,
                    "owned": by_frontend.get(self.name, 0),
                    "unowned": self.n_shards - sum(by_frontend.values()),
                    "by_frontend": by_frontend,
                },
                "standby": self._standby,
                "replicated_rows_held": {
                    origin: len(rows)
                    for origin, rows in sorted(self._store.items())
                },
                "forwarded_ops": int(self._m_fwd_ops.value),
                "forward_redirects": int(self._m_redirects.value),
                "parked_ops": int(self._m_parked.value),
                "promotions_inflight": len(self._promote_deadline),
                "budget": {
                    n: dict(b) for n, b in sorted(self._budget.items())
                },
            }


class FederatedRouter:
    """The SessionRouter-shaped surface ``BoardsRoute`` mounts when
    federation is on: resolves the owning frontend one level above the
    local plane's shard→worker table, then delegates, forwards, or
    redirects.  Everything else (config/metrics/tracer, the attributes
    the HTTP layer sniffs) passes through to the plane."""

    def __init__(self, fed: FederationPlane) -> None:
        self.fed = fed
        self.plane = fed.plane
        self.config = fed.plane.config
        self.metrics = fed.plane.metrics
        self.tracer = fed.plane.tracer

    def create(self, tenant: str = "default", rule="conway",
               height: int = 64, width: int = 64, seed: int = 0,
               density: float = 0.5, with_board: bool = True,
               sid: Optional[str] = None) -> dict:
        fed = self.fed
        fed.check_cluster_budget(int(height) * int(width))
        if sid is None:
            host = fed._sid_host()
            if host == fed.name:
                # Auto ids mine into a self-owned slice: creates stay local.
                sid = fed.mine_local_sid()
                return self.plane.create(
                    tenant=tenant, rule=rule, height=height, width=width,
                    seed=seed, density=density, with_board=with_board,
                    sid=sid,
                )
            # The placement left this frontend no slice: the id lands in
            # the slices of the peer owning most, and the create forwards.
            sid = fed._mine_sid(host)
        sid = str(sid)
        shard = shard_of(sid, fed.n_shards)
        owner = fed.owner_of(shard)
        if owner == fed.name:
            return self.plane.create(
                tenant=tenant, rule=rule, height=height, width=width,
                seed=seed, density=density, with_board=with_board, sid=sid,
            )
        try:
            return fed.forward(owner, "create", {
                "sid": sid, "tenant": tenant,
                "rule": rule if isinstance(rule, str) else str(rule),
                "height": int(height), "width": int(width),
                "seed": int(seed), "density": float(density),
            })
        except _Moved:
            return self.plane.create(
                tenant=tenant, rule=rule, height=height, width=width,
                seed=seed, density=density, with_board=with_board, sid=sid,
            )

    def get(self, sid: str) -> dict:
        fed = self.fed
        shard = shard_of(str(sid), fed.n_shards)
        owner = fed.owner_of(shard)
        if owner == fed.name:
            return self.plane.get(sid)
        # The one op whose answer carries the board: 307 to the owner
        # instead of hauling O(h·w) cells through a middleman frontend.
        raise FederationRedirect(fed.redirect_url(owner, str(sid)))

    def step(self, sid: str, steps: int = 1) -> Tuple[int, int]:
        fed = self.fed
        shard = shard_of(str(sid), fed.n_shards)
        owner = fed.owner_of(shard)
        if owner == fed.name:
            return self.plane.step(sid, steps)
        try:
            value = fed.forward(
                owner, "step", {"sid": str(sid), "steps": int(steps)}
            )
        except _Moved:
            return self.plane.step(sid, steps)
        return int(value[0]), int(value[1])

    def delete(self, sid: str) -> None:
        fed = self.fed
        shard = shard_of(str(sid), fed.n_shards)
        owner = fed.owner_of(shard)
        if owner == fed.name:
            self.plane.delete(sid)
            return
        try:
            fed.forward(owner, "delete", {"sid": str(sid)})
        except _Moved:
            self.plane.delete(sid)

    def list(self) -> List[dict]:
        # Each frontend lists its own slice of the keyspace (operators
        # aggregate across /boards endpoints; a cluster-wide list would
        # be a fan-out fat payload, exactly what forwarding avoids).
        return self.plane.list()

    def tenant_of(self, sid: str) -> Optional[str]:
        return self.plane.tenant_of(sid)

    def stats(self) -> dict:
        return self.plane.stats()
