"""Network chaos plane + the hardened-communications primitives it exercises.

:mod:`runtime/chaos.py` reproduces the reference's in-app killer — faults in
what the runtime *hosts* (``BoardCreator.scala:97-102``).  This module
injects faults in what the runtime *says*: a seeded, config-driven
:class:`NetworkChaos` policy (per-message drop / delay / duplicate / reorder
probabilities, plus scheduled bidirectional *partitions* between node groups
with heal times — the Jepsen-style drill) and a :class:`ChaosChannel`
wrapper that interposes on :class:`runtime.wire.Channel` send/recv without
touching the frame format.  It installs on the frontend control plane, the
worker control channel, and the backend peer data plane
(``--chaos-net-*`` / ``[net_chaos]`` config; see
:class:`runtime.config.NetworkChaosConfig`).

The partition schedule follows the :class:`runtime.chaos.CrashInjector`
schedule/budget contract exactly: first due after ``partition_after_s``,
then every ``partition_every_s``, each healing after ``partition_heal_s``,
at most ``max_partitions`` times — deterministic given the clock readings
and the seed.

:class:`CircuitBreaker` is the data-plane hardening the chaos plane
exercises: per-peer closed → open on consecutive send failures → half-open
probe after a cooldown → closed on success, so a dead or partitioned peer
stops burning the hot path on connect timeouts (production collectives'
standard discipline; cf. PAPERS.md *Casper* on comm-path stalls dominating
stencil pipelines).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, FrozenSet, Iterable, Optional, Tuple

from akka_game_of_life_tpu_torch.runtime.config import NetworkChaosConfig


class Decision:
    """What the policy ruled for one outgoing message."""

    __slots__ = ("blocked", "drop", "delay_s", "duplicate", "reorder")

    def __init__(
        self,
        blocked: bool = False,
        drop: bool = False,
        delay_s: float = 0.0,
        duplicate: bool = False,
        reorder: bool = False,
    ) -> None:
        self.blocked = blocked
        self.drop = drop
        self.delay_s = delay_s
        self.duplicate = duplicate
        self.reorder = reorder


class NetworkChaos:
    """Seeded wire-fault policy, shared by every :class:`ChaosChannel` of a
    run (one instance per process; the in-process harness shares one across
    the whole cluster, so partition sides are consistent end to end).

    Thread-safe: channels consult it from reader threads, compute threads,
    and delay timers concurrently.  The partition state machine is polled on
    traffic (every ``on_send``/``blocked`` call) — no dedicated thread — so
    a fully idle wire also has no partitions to observe.
    """

    def __init__(
        self,
        config: NetworkChaosConfig,
        *,
        start_time: Optional[float] = None,
        registry=None,
        tracer=None,
    ) -> None:
        self.config = config
        self.rng = random.Random(config.seed)
        self.partitions = 0
        self._lock = threading.RLock()
        self._start = start_time if start_time is not None else time.monotonic()
        self._next_due: Optional[float] = (
            self._start + config.partition_after_s
            if config.enabled and config.max_partitions > 0
            else None
        )
        self._groups: Optional[Tuple[FrozenSet[str], FrozenSet[str]]] = None
        self._heal_at = 0.0
        self._nodes: set = set()
        self._partition_span = None
        if registry is None:
            from akka_game_of_life_tpu_torch.obs import get_registry

            registry = get_registry()
        if tracer is None:
            from akka_game_of_life_tpu_torch.obs.tracing import get_tracer

            tracer = get_tracer()
        self.tracer = tracer
        self._m_dropped = registry.counter("gol_net_chaos_dropped_total")
        self._m_delayed = registry.counter("gol_net_chaos_delayed_total")
        self._m_duplicated = registry.counter("gol_net_chaos_duplicated_total")
        self._m_reordered = registry.counter("gol_net_chaos_reordered_total")
        self._m_partitions = registry.counter("gol_net_partitions_total")
        self._m_heals = registry.counter("gol_net_partition_heals_total")

    # -- node registry (partition sides are drawn from it) -------------------

    def register_node(self, name: Optional[str]) -> None:
        """Tell the policy a node name exists on the wire.  Channels register
        their endpoints as they are wrapped; the scheduled partition picker
        splits whatever set is known when a partition fires."""
        if name:
            with self._lock:
                self._nodes.add(name)

    # -- partition state machine ---------------------------------------------

    @property
    def exhausted(self) -> bool:
        return self.partitions >= self.config.max_partitions

    def partitioned(self) -> bool:
        with self._lock:
            return self._groups is not None

    def poll(self, now: Optional[float] = None) -> None:
        """Advance the partition schedule: heal an expired partition, fire a
        due one.  Deterministic given clock readings (the CrashInjector
        contract); safe to call from any thread, any number of times."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            if self._groups is not None and now >= self._heal_at:
                self._heal_locked()
            if (
                self._groups is None
                and self._next_due is not None
                and not self.exhausted
                and now >= self._next_due
            ):
                # A partition needs two sides; with fewer than two known
                # nodes the slot stays armed (not consumed) until the wire
                # has peers to split.
                nodes = sorted(self._nodes)
                if len(nodes) < 2:
                    return
                side_a = frozenset(self.rng.sample(nodes, len(nodes) // 2))
                side_b = frozenset(n for n in nodes if n not in side_a)
                self._start_locked(side_a, side_b, self.config.partition_heal_s, now)
                self._next_due = now + self.config.partition_every_s

    def start_partition(
        self,
        side_a: Iterable[str],
        side_b: Iterable[str],
        heal_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> None:
        """Manually open a bidirectional partition between two node groups
        (the drill/test entry; the schedule calls the same machinery).
        Counts against the budget and metrics exactly like a scheduled one."""
        now = now if now is not None else time.monotonic()
        with self._lock:
            if self._groups is not None:
                self._heal_locked()
            self._start_locked(
                frozenset(side_a),
                frozenset(side_b),
                heal_s if heal_s is not None else self.config.partition_heal_s,
                now,
            )

    def _start_locked(
        self,
        side_a: FrozenSet[str],
        side_b: FrozenSet[str],
        heal_s: float,
        now: float,
    ) -> None:
        self._groups = (side_a, side_b)
        self._heal_at = now + heal_s
        self.partitions += 1
        self._m_partitions.inc()
        self._partition_span = self.tracer.start(
            "net.partition",
            side_a=",".join(sorted(side_a)),
            side_b=",".join(sorted(side_b)),
            heal_s=heal_s,
            n=self.partitions,
        )
        # At-the-source flight record, like CrashInjector._fired: the
        # partition opening is on record even if a victim dies mid-drill.
        self.tracer.flight.record(
            "net_partition",
            n=self.partitions,
            side_a=sorted(side_a),
            side_b=sorted(side_b),
            heal_s=heal_s,
        )

    def heal(self) -> None:
        """Heal the active partition immediately (no-op when none is open)."""
        with self._lock:
            if self._groups is not None:
                self._heal_locked()

    def _heal_locked(self) -> None:
        self._groups = None
        self._m_heals.inc()
        self.tracer.flight.record("net_partition_healed", n=self.partitions)
        if self._partition_span is not None:
            self._partition_span.finish()
            self._partition_span = None

    def blocked(self, a: str, b: str, now: Optional[float] = None) -> bool:
        """Is traffic between nodes ``a`` and ``b`` cut by the active
        partition?  Unknown/unnamed endpoints are never blocked."""
        if not a or not b:
            return False
        self.poll(now)
        with self._lock:
            if self._groups is None:
                return False
            ga, gb = self._groups
            return (a in ga and b in gb) or (a in gb and b in ga)

    # -- per-message policy ---------------------------------------------------

    def on_send(self, src: str, dst: str, now: Optional[float] = None) -> Decision:
        """Rule on one outgoing message.  One rng draw per fault class,
        under the lock (decisions are a seeded deterministic stream given
        the call order)."""
        if self.blocked(src, dst, now):
            self._m_dropped.inc()
            return Decision(blocked=True)
        cfg = self.config
        if not cfg.enabled:
            return Decision()
        with self._lock:
            if cfg.drop_p and self.rng.random() < cfg.drop_p:
                self._m_dropped.inc()
                return Decision(drop=True)
            delay = (
                self.rng.uniform(0.0, cfg.delay_s)
                if cfg.delay_p and self.rng.random() < cfg.delay_p
                else 0.0
            )
            duplicate = bool(
                cfg.duplicate_p and self.rng.random() < cfg.duplicate_p
            )
            reorder = bool(cfg.reorder_p and self.rng.random() < cfg.reorder_p)
        if delay:
            self._m_delayed.inc()
        if duplicate:
            self._m_duplicated.inc()
        if reorder:
            self._m_reordered.inc()
        return Decision(delay_s=delay, duplicate=duplicate, reorder=reorder)


class ChaosChannel:
    """A :class:`runtime.wire.Channel` with the chaos policy interposed on
    send/recv.  The frame format is untouched — the wrapper only decides
    whether/when frames flow:

    - *drop*: the send silently vanishes (packet loss semantics);
    - *delay*: the send fires from a timer thread after the ruled latency
      (``Channel.send`` is already thread-safe, so a delayed frame can never
      interleave mid-frame with a live one);
    - *duplicate*: the frame is sent twice back-to-back (consumers must be
      idempotent — ring pushes and control messages are);
    - *reorder*: the frame is held and the NEXT send overtakes it;
    - *partition*: sends between separated groups are refused —
      ``fail_blocked=True`` (the peer data plane) raises ``ConnectionError``
      so the sender's failure handling (peer drop, circuit breaker) engages
      exactly as for a broken link; ``fail_blocked=False`` (the control
      plane) drops silently, which the heartbeat/eviction machinery sees as
      a lossy wire.  ``recv`` additionally filters frames arriving across an
      active partition, so a one-sided install still cuts both directions.

    ``src``/``dst`` are mutable attributes: accepted channels learn the far
    end's name mid-conversation (REGISTER / PEER_HELLO) and label the
    wrapper then.
    """

    def __init__(
        self,
        inner,
        chaos: NetworkChaos,
        *,
        src: str = "",
        dst: str = "",
        fail_blocked: bool = False,
    ) -> None:
        self.inner = inner
        self.chaos = chaos
        self.src = src
        self.dst = dst
        self.fail_blocked = fail_blocked
        self._held: Optional[dict] = None
        self._hold_lock = threading.Lock()
        chaos.register_node(src)
        chaos.register_node(dst)

    def send(self, msg: dict) -> None:
        self.chaos.register_node(self.dst)
        d = self.chaos.on_send(self.src, self.dst)
        if d.blocked:
            if self.fail_blocked:
                raise ConnectionResetError(
                    f"chaos: partition blocks {self.src or '?'} -> "
                    f"{self.dst or '?'}"
                )
            return
        if d.drop:
            return
        with self._hold_lock:
            held, self._held = self._held, None
            if held is None and d.reorder:
                self._held = msg
                return
        if d.delay_s:
            t = threading.Timer(
                d.delay_s, self._late_send, args=(msg, d.duplicate)
            )
            t.daemon = True
            t.start()
        else:
            self.inner.send(msg)
            if d.duplicate:
                self.inner.send(msg)
        if held is not None:
            # The overtaken frame goes out right after the overtaking one.
            self.inner.send(held)

    def _late_send(self, msg: dict, duplicate: bool = False) -> None:
        try:
            self.inner.send(msg)
            if duplicate:
                self.inner.send(msg)
        except (OSError, ValueError):
            pass  # the channel died while the frame was in the air

    def recv(self) -> Optional[dict]:
        while True:
            msg = self.inner.recv()
            if msg is None:
                return None
            if self.chaos.blocked(self.src, self.dst):
                # In-flight frame crossing an active partition: lost.
                self.chaos._m_dropped.inc()
                continue
            return msg

    def close(self) -> None:
        with self._hold_lock:
            held, self._held = self._held, None
        if held is not None:
            # The flush is still a send: it must not cross an active
            # partition (one-sided installs have no recv filter to save it).
            if self.chaos.blocked(self.src, self.dst):
                self.chaos._m_dropped.inc()
            else:
                try:
                    self.inner.send(held)
                except (OSError, ValueError):
                    pass
        self.inner.close()

    def __getattr__(self, name):
        # Everything else (sock, set_send_deadline, ...) is the wrapped
        # channel's business.
        return getattr(self.inner, name)


def wrap_channel(
    channel,
    chaos: Optional[NetworkChaos],
    *,
    src: str = "",
    dst: str = "",
    fail_blocked: bool = False,
):
    """``channel`` wrapped in chaos when a policy is installed, else as-is —
    the no-chaos path stays a plain :class:`Channel` with zero overhead."""
    if chaos is None:
        return channel
    return ChaosChannel(
        channel, chaos, src=src, dst=dst, fail_blocked=fail_blocked
    )


# -- circuit breaker ----------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}


class _PeerBreaker:
    __slots__ = ("state", "consecutive", "retry_at", "span")

    def __init__(self) -> None:
        self.state = CLOSED
        self.consecutive = 0
        self.retry_at = 0.0
        self.span = None


class CircuitBreaker:
    """Per-peer circuit breaker for the worker data plane.

    State machine (per peer)::

        CLOSED --[failures consecutive send failures]--> OPEN
        OPEN   --[cooldown_s elapsed]-----------------> HALF_OPEN (one probe)
        HALF_OPEN --[probe succeeds]------------------> CLOSED
        HALF_OPEN --[probe fails]---------------------> OPEN (cooldown re-arms)

    While OPEN, :meth:`allow` refuses sends (counted in
    ``gol_breaker_skipped_sends_total``) so a dead peer costs one state read
    instead of a connect timeout on every ring publish.  The open interval
    is one ``breaker.open`` span (started on the opening failure, finished
    by the closing success) and each opening bumps
    ``gol_breaker_open_total``; ``gol_breaker_state{peer=...}`` mirrors the
    live state (0=closed, 1=open, 2=half-open).
    """

    def __init__(
        self,
        *,
        failures: int = 3,
        cooldown_s: float = 2.0,
        registry=None,
        tracer=None,
        node: str = "",
        clock=time.monotonic,
    ) -> None:
        self.failures = max(1, int(failures))
        self.cooldown_s = cooldown_s
        self.node = node
        self._clock = clock
        self._lock = threading.Lock()
        self._peers: Dict[str, _PeerBreaker] = {}
        if registry is None:
            from akka_game_of_life_tpu_torch.obs import get_registry

            registry = get_registry()
        if tracer is None:
            from akka_game_of_life_tpu_torch.obs.tracing import get_tracer

            tracer = get_tracer()
        self.tracer = tracer
        self._m_state = registry.gauge(
            "gol_breaker_state",
            "Per-peer circuit breaker state (0=closed, 1=open, 2=half-open)",
            ("peer",),
        )
        self._m_opens = registry.counter("gol_breaker_open_total")
        self._m_skipped = registry.counter("gol_breaker_skipped_sends_total")

    def _peer(self, peer: str) -> _PeerBreaker:
        b = self._peers.get(peer)
        if b is None:
            b = self._peers[peer] = _PeerBreaker()
        return b

    def state(self, peer: str) -> int:
        with self._lock:
            b = self._peers.get(peer)
            return b.state if b is not None else CLOSED

    def peers(self) -> list:
        """Peers with breaker state (the cleanup surface for OWNERS
        rewiring: reset entries whose peer left the cluster)."""
        with self._lock:
            return list(self._peers)

    def allow(self, peer: str) -> bool:
        """May we attempt a send to ``peer`` right now?  OPEN past its
        cooldown transitions to HALF_OPEN and admits exactly one probe;
        callers MUST report the probe's outcome via :meth:`success` /
        :meth:`failure` or the breaker stays half-open until the next
        cooldown re-arms it."""
        now = self._clock()
        with self._lock:
            b = self._peers.get(peer)
            if b is None or b.state == CLOSED:
                return True
            if b.state == OPEN and now >= b.retry_at:
                b.state = HALF_OPEN
                # Re-arm: if the probe's outcome is never reported (caller
                # died mid-send), the next cooldown admits another probe.
                b.retry_at = now + self.cooldown_s
                self._m_state.labels(peer=peer).set(HALF_OPEN)
                return True
            self._m_skipped.inc()
            return False

    def success(self, peer: str) -> None:
        with self._lock:
            b = self._peers.get(peer)
            if b is None:
                return
            was_open = b.state != CLOSED
            b.state = CLOSED
            b.consecutive = 0
            span, b.span = b.span, None
        if was_open:
            self._m_state.labels(peer=peer).set(CLOSED)
            if span is not None:
                span.set(outcome="closed").finish()

    def failure(self, peer: str) -> None:
        now = self._clock()
        opened = False
        with self._lock:
            b = self._peer(peer)
            if b.state == HALF_OPEN:
                # The probe failed: back to OPEN for another cooldown.
                b.state = OPEN
                b.retry_at = now + self.cooldown_s
            elif b.state == CLOSED:
                b.consecutive += 1
                if b.consecutive >= self.failures:
                    b.state = OPEN
                    b.retry_at = now + self.cooldown_s
                    opened = True
            else:  # OPEN: an in-flight send failed after the state flipped
                b.retry_at = now + self.cooldown_s
            state = b.state
        if state != CLOSED:
            self._m_state.labels(peer=peer).set(state)
        if opened:
            self._m_opens.inc()
            span = self.tracer.start(
                "breaker.open", node=self.node or "backend", peer=peer,
                failures=self.failures,
            )
            self.tracer.flight.record(
                "breaker_open", peer=peer, node=self.node or "backend"
            )
            with self._lock:
                b = self._peer(peer)
                if b.span is None:
                    b.span = span
                else:
                    span.finish()

    def reset(self, peer: str) -> None:
        """Forget a peer entirely (it left the cluster)."""
        with self._lock:
            b = self._peers.pop(peer, None)
            span = b.span if b is not None else None
        if b is not None:
            self._m_state.labels(peer=peer).set(CLOSED)
        if span is not None:
            span.set(outcome="reset").finish()
