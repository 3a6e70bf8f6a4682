"""The backend worker: the ``backend`` role of the cluster.

Counterpart of ``akka_game_of_life_tpu/runtime/backend.py``.  The worker owns
nothing until the frontend DEPLOYs tiles; each deployed tile is advanced in
chunks of up to ``exchange_width`` epochs by a chunk engine:

- ``engine="torch"`` (the default): :func:`_torch_engine` on the worker's
  device — binary multi-step chunks through the hand-written packed sweep
  (``csrc/packed_sweep.cu``) on a CUDA device, its plain version on the CPU;
  a worker given several devices (or ``cuda`` with several visible cards)
  row-shards each chunk's slab over them (:func:`_meshed_engine`);
- ``engine="numpy"``: :func:`_np_chunk`, host stepping (the oracle);
- ``engine="swar"``: the C++ SWAR chunk steppers (``native/engine.py``:
  binary, WireWorld and Generations rules; any other rule through
  :func:`_np_chunk`), host machine code built with g++ at construction;
- ``engine="actor"`` / ``"actor-native"``: one stateful per-cell actor
  engine per tile (``runtime/actor_engine.py`` or its C++ twin), built at
  each (re)deploy and dropped with the tile; they step one epoch per
  exchange (the frontend refuses them when ``exchange_width > 1``).

The data plane is peer-to-peer, byte-compatible with the JAX package's
workers (a cluster may mix the two): each tile pulls its halo at epoch E
from the local :class:`BoundaryStore` (queued until all 8 neighbour rings at
E are present), steps to E + c, publishes its ring locally and to every
distinct owner of its neighbours (PEER_RING / PEER_RING_BATCH from per-peer
writer threads), and pings the frontend with PROGRESS (with digest lanes at
digest-due epochs).  A stale pull re-asks the missing rings' owners with
PEER_PULL under decorrelated-jitter backoff and escalates with GATHER_FAILED
after ``max_pull_retries``.

With the frontend's serve plane on (WELCOME's ``serve_cluster``), the worker
also hosts session shards and resident tiled chunks in a
``serve/worker.py:ServeWorkerPlane`` on its device (the torch engine's, else
the one it was given).

In a federated serving cluster (``serve/federation.py``) the worker holds
the peer frontends' listeners (WELCOME's ``federation``, refreshed by
``FED_PEERS``).  When its frontend's channel ends, the control reader
re-homes it there: it dials a fallback, registers under the same name and
announces its sessions with ``SHARD_HOME``, then reads the new channel;
run()'s dispatch loop never sees the swap, and a control send that meets
the dead channel waits for the swap and goes out on the new one.

Not carried over: the ``jax`` engine (refused by name; the port's device
engine is ``torch``).
``P.PROFILE`` captures a ``torch.profiler`` window on a thread of its own.
"""

from __future__ import annotations

import os
import queue
import random
import socket
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from akka_game_of_life_tpu_torch.obs import get_registry
from akka_game_of_life_tpu_torch.obs.tracing import get_tracer
from akka_game_of_life_tpu_torch.ops.npkernel import step_padded_np
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule
from akka_game_of_life_tpu_torch.runtime import protocol as P
from akka_game_of_life_tpu_torch.runtime.boundary import (
    BoundaryStore,
    Halo,
    halos_equal,
)
from akka_game_of_life_tpu_torch.runtime.netchaos import (
    ChaosChannel,
    CircuitBreaker,
    NetworkChaos,
    wrap_channel,
)
from akka_game_of_life_tpu_torch.runtime.signals import interrupts_as_messages
from akka_game_of_life_tpu_torch.runtime.tiles import Ring, TileId, TileLayout
from akka_game_of_life_tpu_torch.runtime.wire import (
    Channel,
    decode_ring,
    encode_ring,
    extract_trace,
    pack_tile,
    ring_entry_nbytes,
    split_ring_batches,
    unpack_tile,
)


class _Tile:
    def __init__(self, arr: np.ndarray, epoch: int, retry_s: float = 1.0) -> None:
        self.arr = arr
        self.epoch = epoch
        self.awaiting_since: Optional[float] = None  # the waitingForNewState latch
        self.retries = 0
        # Adaptive re-pull pacing (decorrelated-jitter backoff): the delay
        # the LAST retry chose (feeds the next draw) and the deadline the
        # next retry fires at.  Both reset when a pull succeeds.
        self.retry_delay = retry_s
        self.next_retry_at = 0.0
        # Live-migration freeze (MIGRATE_PREPARE): while monotonic time is
        # before this, the tile starts no new chunk — its state is the
        # canonical copy a migration is shipping.  0 = not frozen.  The
        # deadline is the self-healing rollback: if the frontend's COMMIT
        # (an OWNERS rewiring that drops the tile) or MIGRATE_ABORT never
        # arrives, the retry loop unfreezes and resumes at expiry.
        self.frozen_until = 0.0
        # Quiescence tier (sparse_cluster): the last up-to-two chunk inputs
        # as (state, halo, chunk_len) — references, never copies (compute
        # always allocates a new array, so old ones stay valid).  A chunk
        # whose (state, halo, len) matches inputs[0] is a fixed point
        # (period 1); matching inputs[1] is period 2 — either way its
        # output is already known and the compute is skipped.
        self.inputs: Deque[Tuple[np.ndarray, object, int]] = deque(maxlen=2)
        # The last two published (Ring, epoch) pairs, for the O(1)-byte
        # "same-ring" markers a skipped chunk publishes instead of payload.
        self.last_ring: Optional[Tuple[object, int]] = None
        self.prev_ring: Optional[Tuple[object, int]] = None
        self.q_period = 0  # 0 = active; 1/2 = quiescent at that period
        self.q_skipped = 0  # chunks skipped since the last PROGRESS ping
        # Adaptive backoff for the O(tile) quiescence probes: an interior-
        # active tile behind a static halo doubles its wait (capped) after
        # each failed state compare, so the gate's detection cost amortizes
        # toward zero on tiles that refuse to quiesce.
        self.q_probe_wait = 0
        self.q_probe_backoff = 0


ENGINES = ("torch", "numpy", "swar", "actor", "actor-native")
# The JAX package's device engine; the port's is ``torch``.
_NOT_PORTED_ENGINES = ("jax",)
# The marker a signal queues in the worker's inbox: run() raises the
# KeyboardInterrupt when it reaches it (``signals.interrupts_as_messages``).
_INTERRUPT = object()


def _check_pallas(pallas: Optional[str]) -> None:
    """The torch engine's sweep pins: None/"auto" and "off"."""
    if pallas == "interpret":
        raise ValueError(
            "pallas='interpret' is not supported by the PyTorch port: run the "
            "worker on device='cpu' for the plain version"
        )
    if pallas not in (None, "auto", "off"):
        raise ValueError(f"unknown pallas mode {pallas!r}; use auto or off")


def _torch_engine(
    rule: Rule, pallas: Optional[str] = None, device=None
) -> Callable[[np.ndarray, int, int], np.ndarray]:
    """Tile stepping on the worker's device: the counterpart of the JAX
    package's ``_jax_engine``.

    Takes a width-``halo`` halo-padded (h+2k, w+2k) uint8 slab and returns
    the (h, w) interior after ``steps`` (<= halo) generations, in one device
    round trip: upload, then ``steps`` *toroidal* steps at constant shape —
    the wraps only corrupt the outermost halo cells, cut edges whose garbage
    front moves one cell per step, so the interior slice is exact — then
    download.  Binary rules with ``steps >= 2`` step bit-packed: the columns
    are padded to a multiple of 32 (the junk sits between the east halo and
    the wrapped west halo, both cut edges), packed, advanced by
    :func:`packed_sweep.packed_multi_step_fn` (the CUDA kernel on a CUDA
    tensor, at most 31 generations per launch), unpacked, and the junk cut
    before the interior slice.  The CUDA kernel wraps every index modulo
    the height, so unlike the TPU's Mosaic sweep no junk rows are needed.
    Generations and WireWorld chunks with ``steps >= 2`` step the plain bit
    planes on the device, and single-step chunks the plain dense stencil,
    as the JAX engine keeps those on XLA.

    ``pallas``: ``None``/``"auto"`` steps binary chunks through the packed
    sweep wrapper (the kernel on ``cuda``, its plain version on a CPU
    tensor); ``"off"`` pins the plain packed step loop on the device;
    ``"interpret"`` is refused — the CPU device plays that part.  There is
    no demotion: a kernel that fails to build or launch raises, and the
    worker's error reaches the frontend.

    ``device``: one device, or a sequence of them; a sequence of more than
    one, or ``cuda``/None with more than one visible card, takes
    :func:`_meshed_engine`."""
    import torch

    from akka_game_of_life_tpu_torch.obs.programs import registered_jit, stencil_cost
    from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen, packed_sweep
    from akka_game_of_life_tpu_torch.ops import stencil
    from akka_game_of_life_tpu_torch.runtime.simulation import (
        resolve_device,
        resolve_devices,
    )

    _check_pallas(pallas)
    use_sweep = pallas != "off"
    plane_capable = _plane_capable(rule)
    devices = resolve_devices(device)
    if len(devices) > 1:
        return _meshed_engine(rule, devices, use_sweep)
    single = device is None or isinstance(device, (str, torch.device))
    dev = resolve_device(device) if single else devices[0]
    compiled: Dict[tuple, Callable] = {}  # (steps, col_pad) → chunk fn

    def _chunk_fn(steps: int, col_pad: int):
        packed = rule.is_binary and steps >= 2
        planes = plane_capable and steps >= 2
        sweep = (
            packed_sweep.packed_multi_step_fn(rule, steps)
            if packed and use_sweep
            else None
        )

        def chunk(padded: np.ndarray, halo: int) -> np.ndarray:
            x = torch.from_numpy(padded).to(dev)
            if col_pad:
                x = torch.nn.functional.pad(x, (0, col_pad))
            if packed:
                words = bitpack.pack(x)
                if sweep is not None:
                    words = sweep(words)
                else:
                    words = bitpack.packed_multi_step(words, rule, steps)
                out = bitpack.unpack(words)
            elif planes:
                out = bitpack_gen.unpack_gen(
                    bitpack_gen.gen_multi_step(
                        bitpack_gen.pack_gen(x, rule.states), rule, steps
                    )
                )
            else:
                out = stencil.multi_step(x, rule, steps)
            if col_pad:
                out = out[:, :-col_pad]
            return out[halo:-halo, halo:-halo].cpu().numpy()

        return chunk

    def run(padded: np.ndarray, steps: int, halo: int) -> np.ndarray:
        assert steps <= halo, (steps, halo)
        vector = (rule.is_binary or plane_capable) and steps >= 2
        col_pad = (-padded.shape[1]) % bitpack.LANE_BITS if vector else 0
        key = (steps, col_pad)
        fn = compiled.get(key)
        if fn is None:
            fn = compiled[key] = registered_jit(
                "worker_chunk", ("single", rule.name, key),
                _chunk_fn(*key),
                cost=lambda p, _h, _s=steps: stencil_cost(
                    p.shape[-2], p.shape[-1], _s
                ),
            )
        return fn(np.ascontiguousarray(padded, dtype=np.uint8), halo)

    return run


def _plane_capable(rule: Rule) -> bool:
    """Generations / WireWorld rules that step as bit planes."""
    return (
        not rule.is_binary
        and (rule.is_totalistic or rule.kind == "wireworld")
        and rule.states <= 256
    )


def _meshed_engine(
    rule: Rule, devices, use_sweep: bool = True
) -> Callable[[np.ndarray, int, int], np.ndarray]:
    """A worker's chunk spread over its devices: the counterpart of the JAX
    package's meshed ``_jax_engine`` branch.

    The halo-padded (h+2k, w+2k) slab is row-padded to a multiple of the n
    devices (the junk rows sit below the south halo; the toroidal wrap
    feeds their garbage into the outermost halo rows, cut edges, and both
    fronts move one row per step, so with ``steps <= halo`` the interior is
    never reached), sharded over an (n, 1) :class:`~..parallel.mesh.GridMesh`
    and advanced ``steps`` generations as a torus by the mesh's steppers:
    binary chunks of at least 2 steps through ``sharded_sweep_step_fn`` (the
    packed sweep on each CUDA tile), plane chunks through
    ``sharded_gen_sweep_step_fn`` (the plane sweep), the rest through the
    dense ``halo.sharded_step_fn``; ``use_sweep=False`` (``pallas="off"``)
    pins the plain sharded packed and plane steps.  The tiles are gathered
    and the interior cut.  The JAX package lets GSPMD shard an XLA scan
    here; the port runs the sharded sweeps its mesh runs."""
    import torch

    from akka_game_of_life_tpu_torch.obs.programs import registered_jit, stencil_cost
    from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen
    from akka_game_of_life_tpu_torch.parallel import halo as phalo
    from akka_game_of_life_tpu_torch.parallel.mesh import GridMesh, gather, shard_board
    from akka_game_of_life_tpu_torch.parallel.packed_halo2d import (
        sharded_gen_step_fn,
        sharded_packed2d_step_fn,
    )
    from akka_game_of_life_tpu_torch.parallel.sweep_halo import (
        sharded_gen_sweep_step_fn,
        sharded_sweep_step_fn,
    )

    n = len(devices)
    mesh = GridMesh((n, 1), devices)  # every slot in this process
    plane_capable = _plane_capable(rule)
    compiled: Dict[tuple, Callable] = {}  # (steps, col_pad) → chunk fn

    def _chunk_fn(steps: int, col_pad: int):
        if rule.is_binary and steps >= 2:
            pack, unpack = bitpack.pack, bitpack.unpack
            step = (
                sharded_sweep_step_fn(mesh, rule, steps_per_call=steps)
                if use_sweep
                else sharded_packed2d_step_fn(mesh, rule, steps_per_call=steps, halo_rows=1)
            )
        elif plane_capable and steps >= 2:
            pack = lambda t: bitpack_gen.pack_gen(t, rule.states)  # noqa: E731
            unpack = bitpack_gen.unpack_gen
            step = (
                sharded_gen_sweep_step_fn(mesh, rule, steps_per_call=steps)
                if use_sweep
                else sharded_gen_step_fn(mesh, rule, steps_per_call=steps, halo_rows=1)
            )
        else:
            pack = unpack = None
            step = phalo.sharded_step_fn(mesh, rule, steps_per_call=steps, halo_width=1)

        def chunk(padded: np.ndarray, halo: int, h_out: int) -> np.ndarray:
            tiles = shard_board(torch.from_numpy(padded), mesh)
            if col_pad:
                tiles = [torch.nn.functional.pad(t, (0, col_pad)) for t in tiles]
            if pack is not None:
                tiles = [unpack(t) for t in step([pack(t) for t in tiles])]
            else:
                tiles = step(tiles)
            out = gather(tiles, mesh)
            if col_pad:
                out = out[:, :-col_pad]
            return out[halo : halo + h_out, halo:-halo]

        return chunk

    def run(padded: np.ndarray, steps: int, halo: int) -> np.ndarray:
        assert steps <= halo, (steps, halo)
        h_out = padded.shape[0] - 2 * halo
        pad = (-padded.shape[0]) % n
        if pad:
            padded = np.pad(padded, ((0, pad), (0, 0)))
        vector = (rule.is_binary or plane_capable) and steps >= 2
        col_pad = (-padded.shape[1]) % bitpack.LANE_BITS if vector else 0
        key = (steps, col_pad)
        fn = compiled.get(key)
        if fn is None:
            fn = compiled[key] = registered_jit(
                "worker_chunk", ("meshed", rule.name, n, key),
                _chunk_fn(*key),
                cost=lambda p, _h, _o, _s=steps: stencil_cost(
                    p.shape[-2], p.shape[-1], _s
                ),
            )
        return fn(np.ascontiguousarray(padded, dtype=np.uint8), halo, h_out)

    return run


def _swar_engine(rule: Rule) -> Callable[[np.ndarray, int, int], np.ndarray]:
    """The ``swar`` chunk engine for ``rule``: the C++ SWAR stepper of its
    family (binary life-like, WireWorld, Generations), else
    :func:`_np_chunk` (the JAX package's wiring)."""
    from akka_game_of_life_tpu_torch.native.engine import (
        swar_chunk_native,
        swar_gen_chunk_native,
        swar_wire_chunk_native,
    )

    if rule.is_binary and rule.is_totalistic:
        native = swar_chunk_native
    elif rule.kind == "wireworld":
        native = swar_wire_chunk_native
    elif rule.is_totalistic:
        # Generations (Rule() caps states at 255, so no extra gate).
        native = swar_gen_chunk_native
    else:
        return lambda padded, steps, halo: _np_chunk(padded, steps, halo, rule)
    return lambda padded, steps, halo: native(padded, steps, halo, rule)


def _np_chunk(padded: np.ndarray, steps: int, halo: int, rule: Rule) -> np.ndarray:
    """Host-engine chunk: ``steps`` (<= halo) epochs on a width-``halo``
    padded slab; each step peels one boundary layer, then the exact (h, w)
    interior is sliced out."""
    assert steps <= halo, (steps, halo)
    h, w = padded.shape[0] - 2 * halo, padded.shape[1] - 2 * halo
    out = padded
    for _ in range(steps):
        out = step_padded_np(out, rule)
    m = halo - steps  # remaining margin after `steps` peels
    return out[m : m + h, m : m + w]


# Batch linger: a pending outbound ring batch that has not been sealed by
# its expected contributors (tiles redeployed away, catch-up replay at mixed
# epochs) flushes after this long.  A backstop, not the steady-state path —
# in steady state the LAST contributing tile's publish seals the batch with
# zero added latency — and even a wedged batch self-heals through the
# receiver's PEER_PULL re-asks (our rings are always in our local store).
_RING_LINGER_S = 0.02
# How long a federated worker whose frontend died waits for that
# frontend's last ops to land before it announces its sessions, and then
# how long it tries its fallbacks before the loss is an ordinary
# disconnect.  Two bounds: a slow settle never eats the dialing.
REHOME_SETTLE_S = 5.0
REHOME_TIMEOUT_S = 15.0


def _fallbacks(addrs) -> List[Tuple[str, int]]:
    """WELCOME's ``federation`` or FED_PEERS' ``peers``: [[host, port]]."""
    return [
        (str(a[0]), int(a[1]))
        for a in addrs or []
        if isinstance(a, (list, tuple)) and len(a) == 2
    ]


class _PeerSender:
    """One peer's async outbound lane: a bounded queue drained by a writer
    thread, so ``_publish_ring`` never blocks the step loop on a slow
    socket, a connect timeout, or a chaos-blocked link.

    Ring entries coalesce: entries for one epoch accumulate into a pending
    batch that *seals* (becomes one PEER_RING_BATCH frame) when every local
    tile known to border this peer has contributed, when an entry for a
    different epoch arrives, or after ``_RING_LINGER_S`` — whichever comes
    first.  Control messages (PEER_PULL asks, unbatched rings) bypass the
    pending batch but share the queue, the depth bound, and the writer.

    The writer composes with the rest of the hardened stack unchanged: the
    per-peer circuit breaker gates each drain, the channel may be a
    ``ChaosChannel`` (partition blocks raise here, on the writer — never on
    a compute thread), and a send deadline surfaces as the same ``OSError``
    drop-and-redial path."""

    # Lock discipline (tools/graftlint): every batch/queue field belongs to
    # the condition; the writer and every producer agree on one monitor.
    _GRAFTLINT_GUARDED = {
        "_items": "_cond",
        "_pending": "_cond",
        "_pending_tiles": "_cond",
        "_expect": "_cond",
        "_pending_epoch": "_cond",
        "_pending_since": "_cond",
        "_depth": "_cond",
        "_closed": "_cond",
    }

    def __init__(self, worker: "BackendWorker", owner: str) -> None:
        self.worker = worker
        self.owner = owner
        self._cond = threading.Condition()
        # ("batch", [entry, ...]) | ("msg", dict) — sealed, ready to send.
        self._items: Deque[Tuple[str, object]] = deque()
        self._pending: List[dict] = []
        self._pending_tiles: set = set()
        self._expect: set = set()
        self._pending_epoch: Optional[int] = None
        self._pending_since = 0.0
        self._depth = 0  # running entry count (pending + items), O(1) trim
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"peer-send-{owner}"
        )
        self._thread.start()

    # -- producer side (compute/serve threads; never touches the socket) -----

    def enqueue_msg(self, msg: dict) -> None:
        with self._cond:
            if self._closed:
                return
            self._items.append(("msg", msg))
            self._depth += 1
            self._trim_locked()
            self._cond.notify()

    def enqueue_ring(self, entry: dict, expect) -> None:
        """Add one encoded ring entry to the peer's building batch.
        ``expect`` is the set of local tiles currently bordering this peer —
        the seal condition that gives full batches with zero added latency
        in steady state."""
        with self._cond:
            if self._closed:
                return
            epoch = entry["epoch"]
            if self._pending and epoch != self._pending_epoch:
                self._seal_locked()
            if not self._pending:
                self._pending_epoch = epoch
                self._expect = set(expect)
                self._pending_since = time.monotonic()
            self._pending.append(entry)
            self._pending_tiles.add(tuple(entry["tile"]))
            self._depth += 1
            if self._pending_tiles >= self._expect:
                self._seal_locked()
            self._trim_locked()
            self._cond.notify()

    def _seal_locked(self) -> None:
        if self._pending:
            self._items.append(("batch", self._pending))
            self._pending = []
            self._pending_tiles = set()
            self._pending_epoch = None

    def _trim_locked(self) -> None:
        """Bounded queue, drop-OLDEST: a wedged peer must not grow worker
        memory, and anything dropped is recoverable — the receiver's retry
        loop re-asks via PEER_PULL and our rings stay in the local store.
        ``_depth`` is a running counter so the hot enqueue path stays O(1)
        even when the queue is full (the wedged-peer case is exactly when
        an O(queue) rescan per publish would hurt most)."""
        w = self.worker
        while self._depth > w.ring_queue_depth and self._items:
            kind, payload = self._items.popleft()
            dropped = len(payload) if kind == "batch" else 1
            self._depth -= dropped
            w._m_queue_drops.inc(dropped)
        w._m_queue_depth.labels(peer=self.owner).set(self._depth)

    # -- writer side ----------------------------------------------------------

    def close(self) -> None:
        with self._cond:
            self._closed = True
            # Gauge hygiene (the breaker-reset discipline): a departed
            # peer must not leave a stale non-zero queue-depth series.
            # Under the condition lock, and mirrored by the writer's own
            # exit path — whichever runs last leaves the series at 0.
            self.worker._m_queue_depth.labels(peer=self.owner).set(0)
            self._cond.notify()

    def _run(self) -> None:
        w = self.worker
        while True:
            with self._cond:
                while not self._items:
                    if self._closed or w._stop.is_set():
                        w._m_queue_depth.labels(peer=self.owner).set(0)
                        return
                    timeout = 0.2  # poll _stop even if nobody notifies
                    if self._pending:
                        timeout = (
                            self._pending_since + _RING_LINGER_S
                            - time.monotonic()
                        )
                        if timeout <= 0:
                            self._seal_locked()
                            break
                        timeout = min(timeout, 0.2)
                    self._cond.wait(timeout)
                items = list(self._items)
                self._items.clear()
                self._depth = len(self._pending)
                w._m_queue_depth.labels(peer=self.owner).set(self._depth)
            self._send(items)

    @staticmethod
    def _coalesce_pulls(
        items: List[Tuple[str, object]]
    ) -> List[Tuple[str, object]]:
        """Merge queued PEER_PULL asks for the same epoch into one frame —
        the ask-side analog of ring batching.  When several local tiles go
        stale on the same peer in the same chunk (the common case: they all
        wait on one in-flight batch), the drain sends O(epochs) ask frames
        instead of O(tiles)."""
        merged: List[Tuple[str, object]] = []
        pulls: Dict[int, dict] = {}
        for kind, payload in items:
            if (
                kind == "msg"
                and isinstance(payload, dict)
                and payload.get("type") == P.PEER_PULL
            ):
                tiles = [
                    list(t)
                    for t in (payload.get("tiles") or [payload["tile"]])
                ]
                epoch = int(payload["epoch"])
                m = pulls.get(epoch)
                if m is None:
                    m = {"type": P.PEER_PULL, "tiles": tiles, "epoch": epoch}
                    pulls[epoch] = m
                    merged.append(("msg", m))
                else:
                    seen = {tuple(t) for t in m["tiles"]}
                    m["tiles"].extend(
                        t for t in tiles if tuple(t) not in seen
                    )
                continue
            merged.append((kind, payload))
        return merged

    def _send(self, items: List[Tuple[str, object]]) -> None:
        w = self.worker
        items = self._coalesce_pulls(items)
        # Breaker first: a dead/partitioned peer costs one state read per
        # drain, not a connect timeout — the retry loop (backoff) and the
        # breaker's own half-open probes are the only traffic re-testing it.
        if not w.breaker.allow(self.owner):
            return
        ch = w._peer_channel(self.owner)
        if ch is None:
            w.breaker.failure(self.owner)
            return
        try:
            for kind, payload in items:
                if kind == "batch":
                    for frame in split_ring_batches(payload):
                        with w.tracer.span(
                            "halo.batch_send", parent=w._trace_ctx,
                            node=w.name or "backend", peer=self.owner,
                            rings=len(frame),
                        ):
                            ch.send(
                                {"type": P.PEER_RING_BATCH, "rings": frame}
                            )
                        w._m_batch_size.observe(len(frame))
                        w._m_sends.inc()
                else:
                    ch.send(payload)
                    w._m_sends.inc()
            w.breaker.success(self.owner)
        except (OSError, ValueError):
            # OSError: stale address, dead peer, partition, send deadline.
            # ValueError: Channel.send's MAX_FRAME backstop — same
            # dead-channel class the serve loops treat it as; either way,
            # NEVER let it escape and kill this writer thread (a dead lane
            # would silently eat every future send to this peer).  Drop
            # the rest of this drain; OWNERS rewiring + the retry loop's
            # PEER_PULLs recover anything the peer still needs.
            w._drop_peer(self.owner)
            w.breaker.failure(self.owner)


def _ring_msg(tid: TileId, epoch: int, ring: Ring) -> dict:
    return {
        "type": P.PEER_RING,
        "tile": list(tid),
        "epoch": epoch,
        "top": ring.top,
        "bottom": ring.bottom,
        "left": ring.left,
        "right": ring.right,
        "corners": ring.corners,
    }


def _ring_of_msg(msg: dict) -> Ring:
    return Ring(
        top=msg["top"],
        bottom=msg["bottom"],
        left=msg["left"],
        right=msg["right"],
        corners=dict(msg["corners"]),  # (k, k) blocks, decoded as arrays
    )


class BackendWorker:
    """One worker process/thread: joins, hosts tiles, steps them, and serves
    its boundary rings to peer workers directly."""

    # Lock discipline (tools/graftlint, pass GL-LOCK01): the mutable shared
    # state each lock actually orders.  The worker RLock serializes the tile
    # table, wiring, and pause/target; the peer/sender/pre-stop locks own
    # their maps.  Set-once run config (rule, layout, store, cadences) is
    # deliberately undeclared: replaced atomically at (re)wiring, and
    # BoundaryStore is internally thread-safe.
    _GRAFTLINT_GUARDED = {
        "tiles": "_lock",
        "owners": "_lock",
        "_owner_map": "_lock",
        "paused": "_lock",
        "target": "_lock",
        "origins": "_lock",
        "_actor_engines": "_lock",
        "_peers": "_peer_lock",
        "_senders": "_sender_lock",
        "_pre_stop_hooks": "_pre_stop_lock",
        "_pre_stop_done": "_pre_stop_lock",
        "_serve_peer_addrs": "_lock",
    }

    def __init__(
        self,
        host: str,
        port: int,
        *,
        name: Optional[str] = None,
        engine: str = "torch",
        pallas: Optional[str] = None,
        device=None,
        retry_s: float = 1.0,
        retry_max_s: float = 8.0,
        max_pull_retries: int = 10,
        breaker_failures: int = 3,
        breaker_cooldown_s: float = 2.0,
        send_deadline_s: float = 0.0,
        ring_pack: bool = True,
        ring_batch: bool = True,
        ring_queue_depth: int = 1024,
        peer_host: str = "0.0.0.0",
        crash_hook: Optional[Callable[[], None]] = None,
        registry=None,
        tracer=None,
        netchaos: Optional[NetworkChaos] = None,
    ) -> None:
        if engine in _NOT_PORTED_ENGINES:
            raise ValueError(
                f"engine {engine!r} is not supported by the PyTorch port; "
                f"use one of {ENGINES}"
            )
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")
        if engine in ("swar", "actor-native"):
            from akka_game_of_life_tpu_torch.native import load

            load()  # the g++ build, before the worker joins; raises on failure
        self.host = host
        self.port = port
        self.name = name
        self.engine = engine
        # The torch engine's sweep pin: None/"auto" steps binary chunks
        # through the packed sweep wrapper, "off" pins the plain packed
        # step loop.  Checked here so a bad pin fails at construction.
        _check_pallas(pallas)
        self.pallas = pallas
        # The torch engine's device: cuda unless the caller names the CPU
        # (resolved now, so a worker without CUDA fails before it joins).
        if engine == "torch":
            from akka_game_of_life_tpu_torch.runtime.simulation import (
                resolve_device,
                resolve_devices,
            )

            import torch

            devices = resolve_devices(device)
            # One device keeps the single-device engine exactly; several
            # (an explicit list, or cuda with several cards) mesh each chunk.
            device = (
                devices if len(devices) > 1
                else resolve_device(device)
                if device is None or isinstance(device, (str, torch.device))
                else devices[0]
            )
        self.device = device
        # Retry policy (cluster config, overridden by WELCOME): base
        # interval, backoff cap, and the per-tile budget before escalation.
        self.retry_s = retry_s
        self.retry_max_s = max(retry_s, retry_max_s)
        self.max_pull_retries = max_pull_retries
        self.send_deadline_s = send_deadline_s
        # Halo-plane wire policy (cluster config, overridden by WELCOME):
        # bit-pack binary rings on the wire, coalesce per-peer batches, and
        # bound each peer's async send queue.
        self.ring_pack = ring_pack
        self.ring_batch = ring_batch
        self.ring_queue_depth = max(1, int(ring_queue_depth))
        # Digest plane (cluster config, shipped in WELCOME): at digest-due
        # epochs (metrics/checkpoint cadence + final) each tile's 64-bit
        # fingerprint lanes ride the PROGRESS ping — O(tiles) bytes for the
        # frontend to certify cluster state, no board assembly anywhere.
        self.obs_digest = False
        # Quiescence tier (cluster config, shipped in WELCOME): skip the
        # step compute / ring payload / per-chunk PROGRESS ping of tiles
        # whose chunk input (state + halo) repeats (period 1 or 2).  Actor
        # engines are stateful and never skip regardless.
        self.sparse_cluster = False
        # Compile & cost observatory (cluster config, shipped in WELCOME's
        # "obs" bundle): cadence of the P.COST frames carrying this worker's
        # program-ledger summary (0 disables the loop), and the profiler
        # capture policy for P.PROFILE fan-outs (captures land in
        # ``profile_dir``, which run_backend points at the flight dir).
        self.cost_interval_s = 5.0
        self.profile_dir = "artifacts"
        self._obs_profile: Dict[str, float] = {}
        self._profiler = None
        # Decorrelated-jitter draws; reseeded per worker name in connect()
        # so a seeded cluster run's retry timing is reproducible per node.
        self._retry_rng = random.Random(f"retry:{name}")
        # Wire-fault policy (None = clean wire) and the per-peer breaker it
        # exercises; the breaker exists unconditionally — real dead peers
        # trip it with no chaos installed.
        self.netchaos = netchaos
        # DoCrashMsg → throw (CellActor.scala:95-96): default is an abrupt
        # process death; in-thread harnesses override to simulate it.
        self.crash_hook = crash_hook or (lambda: os._exit(42))

        # Worker-side observability: the peer data plane and the retry/
        # escalation machinery are exactly the paths the reference's log
        # stream never surfaced (how many rings flowed, how many pulls went
        # stale); counters make them first-class.
        reg = registry if registry is not None else get_registry()
        self.registry = reg
        # Tracing: step/halo/retry spans parent themselves under the trace
        # context the frontend embeds in TICK/DEPLOY envelopes, so a
        # frontend epoch span links to every chunk this worker steps for it.
        self.tracer = tracer if tracer is not None else get_tracer()
        self._trace_ctx: Optional[dict] = None
        self._m_sends = reg.counter("gol_peer_sends_total")
        self._m_receives = reg.counter("gol_peer_receives_total")
        self._m_retries = reg.counter("gol_peer_retries_total")
        self._m_wakeups = reg.counter("gol_retry_wakeups_total")
        self._m_drops = reg.counter("gol_peer_drops_total")
        self._m_heartbeats = reg.counter("gol_heartbeats_total")
        self._m_gather_failures = reg.counter("gol_gather_failures_total")
        self._m_ring_bytes = reg.counter("gol_ring_bytes_total")
        self._m_backoff = reg.histogram("gol_retry_backoff_seconds")
        # Halo wire-plane accounting: actual encoded bytes enqueued for the
        # wire (vs gol_ring_bytes_total's dense cell bytes — the packed/raw
        # ratio IS the packing win), rings per coalesced frame, and the
        # per-peer async queue's live depth / overflow drops.
        from akka_game_of_life_tpu_torch.obs.catalog import RING_BATCH_BUCKETS

        self._m_packed_bytes = reg.counter("gol_ring_packed_bytes_total")
        self._m_batch_size = reg.histogram(
            "gol_ring_batch_size", buckets=RING_BATCH_BUCKETS
        )
        self._m_queue_depth = reg.gauge(
            "gol_peer_send_queue_depth",
            "Entries queued in a peer's async send lane",
            ("peer",),
        )
        self._m_queue_drops = reg.counter("gol_peer_send_queue_drops_total")
        # Quiescence-tier accounting: chunks this worker skipped outright,
        # O(1)-byte same-ring markers published in place of ring payloads,
        # and markers a receiver could not resolve (pruned ref — the
        # dependent pull re-asks and the real ring is served, so a miss is
        # latency, never corruption).
        self._m_skipped_chunks = reg.counter("gol_tile_chunks_skipped_total")
        self._m_same_markers = reg.counter("gol_ring_same_markers_total")
        self._m_same_misses = reg.counter("gol_ring_same_miss_total")
        self.breaker = CircuitBreaker(
            failures=breaker_failures,
            cooldown_s=breaker_cooldown_s,
            registry=reg,
            tracer=self.tracer,
            node=name or "backend",
        )

        self.tiles: Dict[TileId, _Tile] = {}
        self.rule: Optional[Rule] = None
        self.target = 0
        self.final_epoch = 0
        # Communication-avoiding exchange: rings/halos are this many cells
        # wide and one exchange buys this many local epochs (cluster-wide,
        # frontend-owned; arrives in WELCOME).
        self.exchange_width = 1
        self.render_every = 0
        self.checkpoint_every = 0
        self.metrics_every = 0
        self.render_strides: Tuple[int, int] = (1, 1)
        self.probe_window: Optional[Tuple[int, int, int, int]] = None
        self.origins: Dict[TileId, Tuple[int, int]] = {}
        self.paused = False
        self.channel: Optional[Channel] = None
        # Control frames read by _read_control, dispatched by run().
        self._inbox: "queue.SimpleQueue" = queue.SimpleQueue()
        # Cluster-sharded serving: constructed at WELCOME when the
        # frontend's serve plane is on; this worker then hosts session
        # shards in its own batch engine on its device (serve/worker.py).
        self.serve_plane = None
        # The federation's re-home targets (peer frontends' listeners):
        # from WELCOME, refreshed by FED_PEERS; empty outside a federation.
        self._federation_fallbacks: List[Tuple[str, int]] = []
        self._reader: Optional[threading.Thread] = None
        self._step_chunk: Optional[Callable[[np.ndarray, int, int], np.ndarray]] = None
        self._actor_engines: Dict[TileId, object] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self.stopped_reason: Optional[str] = None
        # Run-once hooks fired just before the control channel closes on
        # ANY orderly exit (SHUTDOWN, stop()) and on CRASH — the span
        # forwarder drains its pending batch here so the frontend's trace
        # file doesn't lose the run's final second.  Guarded by a dedicated
        # lock, NOT self._lock: the CRASH path runs these and must never
        # wait behind a compute step holding the worker lock.
        self._pre_stop_hooks: List[Callable[[], None]] = []
        self._pre_stop_lock = threading.Lock()
        self._pre_stop_done = False

        # -- peer-to-peer data plane -----------------------------------------
        self.layout: Optional[TileLayout] = None
        self.store: Optional[BoundaryStore] = None
        # tile → (owner name, host, port); OWNERS broadcasts keep it current
        self.owners: Dict[TileId, Tuple[str, str, int]] = {}
        self._peers: Dict[str, Channel] = {}  # dialed, by owner name
        self._peer_lock = threading.Lock()
        # One async outbound lane per peer (bounded queue + writer thread);
        # created on first send to an owner, closed on stop/rewiring.
        self._senders: Dict[str, _PeerSender] = {}
        # Serve-plane peer addresses (resident tiled halo exchange): the
        # frontend names each chunk owner's peer endpoint in the step op,
        # so serve workers can dial each other without any OWNERS wiring.
        self._serve_peer_addrs: Dict[str, Tuple[str, int]] = {}
        self._sender_lock = threading.Lock()
        # Publish-path cache, invariant between OWNERS/DEPLOY changes:
        # per local tile its remote owners, and per remote owner the set of
        # local tiles bordering it (the batch-seal expectation).  Rebuilt
        # lazily; None = stale.  Guarded by self._lock.
        self._owner_map: Optional[
            Tuple[Dict[TileId, List[str]], Dict[str, set]]
        ] = None
        self._peer_listener = socket.create_server((peer_host, 0))
        self.peer_port = self._peer_listener.getsockname()[1]
        threading.Thread(target=self._peer_accept_loop, daemon=True).start()

    # -- lifecycle -----------------------------------------------------------

    def connect(self) -> None:
        sock = socket.create_connection((self.host, self.port), timeout=10)
        sock.settimeout(None)
        self.channel = Channel(sock)
        if self.netchaos is not None and self.netchaos.config.wraps_control:
            # Control-plane chaos drops silently (fail_blocked=False): a
            # partitioned control link looks like a lossy wire, and the
            # heartbeat/eviction machinery — not an exception — judges it.
            self.channel = wrap_channel(
                self.channel, self.netchaos,
                src=self.name or "", dst="frontend",
            )
        self.channel.send(
            {
                "type": P.REGISTER,
                "name": self.name,
                "peer_port": self.peer_port,
                # The frontend rejects engines that can't honor the cluster's
                # exchange width (actor engines need per-epoch halos).
                "engine": self.engine,
                # Observability: the sweep pin, as the JAX workers send it.
                "pallas": self.pallas or "auto",
            }
        )
        welcome = self.channel.recv()
        if not welcome or welcome.get("type") != P.WELCOME:
            raise ConnectionError("frontend did not welcome us")
        self.name = welcome["name"]
        heartbeat_s = float(welcome.get("heartbeat_s", 0.5))
        # Retry/breaker/deadline policy is cluster config, owned by the
        # frontend (SimulationConfig); the constructor values are only the
        # standalone/test defaults — every worker of a cluster shares ONE
        # policy source of truth.
        if "max_pull_retries" in welcome:
            self.max_pull_retries = int(welcome["max_pull_retries"])
        if "retry_s" in welcome:
            self.retry_s = float(welcome["retry_s"])
        if "retry_max_s" in welcome:
            self.retry_max_s = max(self.retry_s, float(welcome["retry_max_s"]))
        if "breaker_failures" in welcome:
            self.breaker.failures = max(1, int(welcome["breaker_failures"]))
        if "breaker_cooldown_s" in welcome:
            self.breaker.cooldown_s = float(welcome["breaker_cooldown_s"])
        if "send_deadline_s" in welcome:
            self.send_deadline_s = float(welcome["send_deadline_s"])
        if "ring_pack" in welcome:
            self.ring_pack = bool(welcome["ring_pack"])
        if "ring_batch" in welcome:
            self.ring_batch = bool(welcome["ring_batch"])
        if "ring_queue_depth" in welcome:
            self.ring_queue_depth = max(1, int(welcome["ring_queue_depth"]))
        if "obs_digest" in welcome:
            self.obs_digest = bool(welcome["obs_digest"])
        if "sparse_cluster" in welcome:
            self.sparse_cluster = bool(welcome["sparse_cluster"])
        if "obs" in welcome:
            # Compile & cost observatory bundle: ledger on/off and COST
            # frame cadence — one policy source of truth (the frontend's
            # SimulationConfig), like the retry and wire bundles above.
            from akka_game_of_life_tpu_torch.obs.programs import get_programs

            _obs = welcome.get("obs") or {}
            self.cost_interval_s = float(
                _obs.get("cost_interval_s", self.cost_interval_s)
            )
            self._obs_profile = {
                k: float(_obs[k]) for k in ("max_s", "min_interval_s") if k in _obs
            }
            get_programs().configure(
                node=welcome.get("name") or self.name,
                enabled=bool(_obs.get("programs", True)),
            )
        self._federation_fallbacks = _fallbacks(welcome.get("federation"))
        if welcome.get("serve_cluster"):
            from akka_game_of_life_tpu_torch.serve.worker import ServeWorkerPlane

            # The serve knobs arrive in WELCOME like every other cluster
            # policy bundle; the plane owns a local SessionRouter on this
            # worker's device plus the op/shard wire glue.  It sends
            # through _control_send, which reads self.channel at call time.
            self.serve_plane = ServeWorkerPlane(
                welcome.get("serve", {}),
                self._control_send,
                name=self.name or "",
                registry=self.registry,
                tracer=self.tracer,
                peer_send=self.serve_peer_send,
                device=self._serve_device(),
            )
        self._retry_rng = random.Random(f"retry:{self.name}")
        self.breaker.node = self.name or "backend"
        if isinstance(self.channel, ChaosChannel):
            self.channel.src = self.name or ""
        if self.send_deadline_s:
            self.channel.set_send_deadline(self.send_deadline_s)
        self.exchange_width = int(welcome.get("exchange_width", 1))
        threading.Thread(
            target=self._heartbeat_loop, args=(heartbeat_s,), daemon=True
        ).start()
        threading.Thread(target=self._retry_loop, daemon=True).start()
        if self.cost_interval_s > 0:
            threading.Thread(
                target=self._cost_loop, args=(self.cost_interval_s,),
                daemon=True,
            ).start()

    def run(self) -> int:
        """Blocking serve loop; returns when shut down or disconnected.

        ``_stop`` is set on every NORMAL exit (shutdown, EOF, wire error)
        but deliberately NOT when an interrupt tears out of the loop: the
        CLI's SIGTERM drain re-enters ``run()`` to keep serving the
        migration protocol, and the worker must still be alive for that —
        heartbeats beating (or the frontend would auto-down a draining
        member) and the control channel readable."""
        if self.channel is None:
            self.connect()
        if self._reader is None:
            self._reader = threading.Thread(
                target=self._read_control, daemon=True, name="control-reader"
            )
            self._reader.start()
        try:
            # An interrupt is raised between frames, never inside one: a
            # frame taken from the inbox is always dispatched whole (its
            # ops are answered, so a SIGTERM drain can complete).
            with interrupts_as_messages(lambda: self._inbox.put(_INTERRUPT)):
                self._serve_frames()
            self._stop.set()
        except (OSError, ValueError) as e:
            # ValueError = a malformed frame from wire.recv (bad magic,
            # oversize claim, bad payload structure): same clean shutdown
            # as a connection error, with the reason on record.
            self.stopped_reason = self.stopped_reason or f"connection error ({e})"
            self._stop.set()
        except KeyboardInterrupt:
            # The SIGTERM drain path re-enters run(); the worker must stay
            # alive (heartbeats beating, control channel readable) or the
            # frontend would auto-down a draining member.
            raise
        except BaseException:
            # Any other escape (a dispatch handler bug, MemoryError, ...)
            # must still stop the heartbeat/retry daemons, or the frontend
            # keeps seeing a healthy member whose tiles never step again.
            self._stop.set()
            raise
        return 0 if self.stopped_reason in ("shutdown", "drained") else 1

    def _serve_frames(self) -> None:
        """run()'s dispatch loop: until stopped, EOF or an interrupt."""
        while not self._stop.is_set():
            msg = self._inbox.get()
            if msg is _INTERRUPT:
                raise KeyboardInterrupt
            if isinstance(msg, Exception):
                raise msg
            if msg is None:
                self.stopped_reason = self.stopped_reason or "disconnected"
                return
            if isinstance(msg, threading.Event):
                # A re-home's settle barrier (_settle): on to the serve
                # plane's FIFO, behind every frame dispatched before it.
                self.serve_plane.barrier(msg)
                continue
            self._dispatch(msg)

    def _serve_device(self):
        """The device the serve plane steps on: the torch engine's (the
        first card of a meshed worker), else the one the worker was given
        (``cuda`` unless the caller named the CPU)."""
        dev = self.device
        if isinstance(dev, (list, tuple)):
            dev = dev[0]
        return "cuda" if dev is None else dev

    def _control_send(self, msg: dict) -> None:
        """Late-bound control-channel send: reads ``self.channel`` at call
        time, so the serve plane's bound sender follows a re-home.  A frame
        that meets the dead channel of a federated worker was its dead
        frontend's (a result, a shard reply, a replication pass): it is
        dropped at once, so the serve plane's threads live on and never
        wait on the re-home.  Sent to the new frontend, a result would
        answer whatever op of its own bears the same rid."""
        try:
            self.channel.send(msg)
        except OSError:
            if not self._rehomable():
                raise

    def _rehomable(self) -> bool:
        return (
            not self._stop.is_set()
            and self.serve_plane is not None
            and bool(self._federation_fallbacks)
        )

    def _settle(self, timeout: float) -> bool:
        """Let every frame the lost frontend sent run before the worker
        announces its sessions: a barrier queued behind them through run()'s
        dispatch loop and on through the serve plane's FIFO, then the
        router jobs they queued.  The results they produce are the dead
        frontend's and are dropped.  True when all of it landed within
        ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        done = threading.Event()
        self._inbox.put(done)
        settled = done.wait(timeout) and self.serve_plane.settle(
            max(0.0, deadline - time.monotonic())
        )
        self.serve_plane.discard_results()
        return settled

    def _rehome(self) -> bool:
        """The control channel ended in a FEDERATED cluster: let the dead
        frontend's last ops land (:meth:`_settle`, its own bound), dial a
        peer frontend from the fallbacks, register under the SAME name
        (the sessions live in this process, nothing is lost), announce the
        hosted sessions with ``SHARD_HOME`` so the adopting frontend closes
        its failover windows, then swap the channel.  True when the worker
        is homed anew; False is an ordinary disconnect (not federated,
        stopping, or no fallback answered within ``REHOME_TIMEOUT_S``)."""
        if not self._rehomable():
            return False
        if not self._settle(REHOME_SETTLE_S):
            # Re-home all the same: a late op is missing from SHARD_HOME,
            # where giving up would lose every session this worker holds.
            print(
                f"worker {self.name}: the lost frontend's ops did not land "
                f"within {REHOME_SETTLE_S:g}s; announcing the sessions as "
                f"they stand",
                flush=True,
            )
        deadline = time.monotonic() + REHOME_TIMEOUT_S
        while time.monotonic() < deadline and not self._stop.is_set():
            for host, port in list(self._federation_fallbacks):
                if (host, port) == (self.host, self.port):
                    continue  # the frontend that just died
                try:
                    sock = socket.create_connection((host, port), timeout=3)
                    sock.settimeout(None)
                    channel = Channel(sock)
                    channel.send({
                        "type": P.REGISTER,
                        "name": self.name,
                        "peer_port": self.peer_port,
                        "engine": self.engine,
                        "pallas": self.pallas or "auto",
                    })
                    welcome = channel.recv()
                    if not welcome or welcome.get("type") != P.WELCOME:
                        channel.close()
                        continue
                    if self.send_deadline_s:
                        channel.set_send_deadline(self.send_deadline_s)
                    # Before the swap: the adopting frontend learns the
                    # session truth ahead of any result or replication
                    # frame of this worker's.
                    channel.send({
                        "type": P.SHARD_HOME,
                        **self.serve_plane.home_summary(),
                    })
                except (OSError, ValueError):
                    continue
                old, self.channel = self.channel, channel
                self.host, self.port = host, port
                self._federation_fallbacks = (
                    _fallbacks(welcome.get("federation"))
                    or self._federation_fallbacks
                )
                try:
                    old.close()
                except OSError:
                    pass
                print(
                    f"worker {self.name} re-homed control channel to "
                    f"{host}:{port}",
                    flush=True,
                )
                return True
            time.sleep(0.25)
        return False

    def _read_control(self) -> None:
        """The control channel's only reader: every frame goes to run()'s
        dispatch loop through ``_inbox``, and the reader goes straight back
        to the socket.  So the frontend's sends to this worker always drain,
        even while dispatch steps tiles or blocks in a send of its own.
        Reading on the dispatch thread lets the two ends wait on each other:
        the worker blocked sending a TILE_STATE the frontend does not read
        (its reader waits for the frontend lock), while the lock's holder
        waits to send a TICK behind a DEPLOY this worker does not read.
        EOF arrives as None, a wire error as the exception itself.

        Where the worker is federated, the end of the channel (EOF or a
        wire error) re-homes it first (:meth:`_rehome`) and the reader goes
        on with the new channel; only a failed re-home reaches run()."""
        while True:
            try:
                msg = self.channel.recv()
            except Exception as e:  # noqa: BLE001 — run() raises it
                if isinstance(e, (OSError, ValueError)) and self._rehome():
                    continue
                self._inbox.put(e)
                return
            if msg is None:
                if self._rehome():
                    continue
                self._inbox.put(None)
                return
            self._inbox.put(msg)

    def _run_pre_stop_hooks(self) -> None:
        with self._pre_stop_lock:
            if self._pre_stop_done:
                return
            self._pre_stop_done = True
            hooks = list(self._pre_stop_hooks)
        for hook in hooks:
            try:
                hook()
            except Exception:  # noqa: BLE001 — shutdown must complete
                pass

    def stop(self) -> None:
        self._stop.set()
        self._run_pre_stop_hooks()
        if self.serve_plane is not None:
            # Before the control channel closes: the plane's reply thread
            # writes there, and its router must stop ticking.
            self.serve_plane.close()
        if self.channel is not None:
            try:
                # Graceful leave (cluster down): distinguishable from a crash.
                self.channel.send({"type": P.GOODBYE})
            except OSError:
                pass
            self.channel.close()
        try:
            self._peer_listener.close()
        except OSError:
            pass
        with self._sender_lock:
            senders = list(self._senders.values())
            self._senders.clear()
        for s in senders:
            s.close()
        with self._peer_lock:
            for ch in self._peers.values():
                ch.close()
            self._peers.clear()

    # -- peer plumbing ---------------------------------------------------------

    def _peer_accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._peer_listener.accept()
            except OSError:
                return
            ch = Channel(sock, send_deadline_s=self.send_deadline_s)
            if self.netchaos is not None and self.netchaos.config.wraps_peer:
                # dst is learned from the PEER_HELLO (see _on_peer_msg);
                # until then the wrapper applies only the probabilistic
                # faults, not partition sides.
                ch = wrap_channel(
                    ch, self.netchaos,
                    src=self.name or "", fail_blocked=True,
                )
            threading.Thread(
                target=self._serve_peer, args=(ch,), daemon=True
            ).start()

    def _serve_peer(self, channel: Channel) -> None:
        try:
            while not self._stop.is_set():
                msg = channel.recv()
                if msg is None:
                    return
                self._on_peer_msg(msg, channel)
        except OSError:
            pass
        except ValueError as e:
            # Malformed frame or un-decodable ring entry (the mixed-version
            # case): the fail-LOUD contract — name the reason and kill the
            # link, so the far end sees a dropped peer (breaker, re-dial)
            # instead of a silently deaf socket nobody reads.
            print(
                f"{self.name or 'backend'}: dropping peer channel: {e}",
                flush=True,
            )
            with self._peer_lock:
                owner = next(
                    (k for k, v in self._peers.items() if v is channel), None
                )
            if owner is not None:
                self._drop_peer(owner)
            else:
                try:
                    channel.close()
                except OSError:
                    pass

    def _on_peer_msg(self, msg: dict, channel: Channel) -> None:
        kind = msg.get("type")
        if kind == P.PEER_HELLO:
            # Adopt the incoming channel for our own pushes to that peer —
            # peer links are symmetric, so one TCP connection per pair.
            name = msg.get("name")
            if name:
                if isinstance(channel, ChaosChannel):
                    # Now we know who the far end is: partition sides apply.
                    channel.dst = name
                    self.netchaos.register_node(name)
                with self._peer_lock:
                    self._peers.setdefault(name, channel)
        elif kind == P.PEER_RING:
            self._m_receives.inc()
            if self.store is not None:
                if "same_as" in msg:
                    # Quiescent peer: the ring repeats the one it published
                    # at same_as — resolve from the local store, zero
                    # payload bytes.  A miss (ref pruned here) is dropped;
                    # the dependent pull's retry re-asks and the owner
                    # serves the real ring from its own store.
                    ring = self.store.ring_at(
                        tuple(msg["tile"]), int(msg["same_as"])
                    )
                    if ring is None:
                        self._m_same_misses.inc()
                        return
                elif "ring" in msg:
                    ring = decode_ring(msg["ring"])
                else:
                    ring = _ring_of_msg(msg)
                # push_ring fires queued local pull callbacks (_apply_halo),
                # so the span also covers any tile chunks this ring unblocks.
                with self.tracer.span(
                    "halo.recv", parent=self._trace_ctx,
                    node=self.name or "backend", tile=str(tuple(msg["tile"])),
                    epoch=int(msg["epoch"]),
                ):
                    self.store.push_ring(
                        tuple(msg["tile"]), int(msg["epoch"]), ring
                    )
        elif kind == P.PEER_RING_BATCH:
            entries = msg.get("rings") or []
            if not entries or self.store is None:
                return  # an empty batch frame is a no-op, not an error
            self._m_receives.inc(len(entries))
            # Decode + store the WHOLE batch before any unblocked tile
            # steps (push_rings fires callbacks after the last store), so
            # dependent tiles step back-to-back and their outbound rings
            # coalesce in turn.  A malformed entry raises ValueError —
            # the serve loop drops the peer connection, loudly.  Quiescence
            # markers ("same_as") resolve against the local store; an
            # unresolvable one is dropped (miss counted) and recovered by
            # the dependent pull's re-ask.
            items = []
            for e in entries:
                if "same_as" in e:
                    ring = self.store.ring_at(
                        tuple(e["tile"]), int(e["same_as"])
                    )
                    if ring is None:
                        self._m_same_misses.inc()
                        continue
                else:
                    ring = decode_ring(e["ring"])
                items.append((tuple(e["tile"]), int(e["epoch"]), ring))
            if not items:
                return
            with self.tracer.span(
                "halo.recv", parent=self._trace_ctx,
                node=self.name or "backend", rings=len(items),
                epoch=items[0][1],
            ):
                self.store.push_rings(items)
        elif kind in (P.TILED_HALO, P.TILED_HALO_ACK):
            # Resident tiled-session halo exchange: the frame rides the
            # serve plane's op FIFO, so a strip orders against its
            # session's install/step/migration ops like any other op.
            if self.serve_plane is not None:
                self.serve_plane.handle(msg)
        elif kind == P.PEER_PULL:
            # Serve every ring we have from the asked epoch forward, for
            # EVERY tile the peer asks about (one frame asks a whole
            # neighborhood): a redeployed neighbor replaying from a
            # checkpoint streams its catch-up window in one exchange
            # instead of one round-trip per tile per epoch.
            epoch = int(msg["epoch"])
            tiles = [tuple(t) for t in (msg.get("tiles") or [msg["tile"]])]
            if self.store is None:
                return
            served: List[Tuple[TileId, int, Ring]] = []
            for tile in tiles:
                served.extend(
                    (tile, e, ring) for e, ring in self.store.rings_from(tile, epoch)
                )
            if not served:
                return
            pack = (
                self.ring_pack and self.rule is not None and self.rule.is_binary
            )
            with self.tracer.span(
                "halo.serve", parent=self._trace_ctx,
                node=self.name or "backend", tiles=len(tiles), epoch=epoch,
                rings=len(served),
            ):
                try:
                    if self.ring_batch:
                        entries = [
                            {
                                "tile": list(tile),
                                "epoch": e,
                                "ring": encode_ring(ring, pack),
                            }
                            for tile, e, ring in served
                        ]
                        for frame in split_ring_batches(entries):
                            channel.send(
                                {"type": P.PEER_RING_BATCH, "rings": frame}
                            )
                            self._m_batch_size.observe(len(frame))
                            self._m_sends.inc()
                    else:
                        for tile, e, ring in served:
                            channel.send(
                                {
                                    "type": P.PEER_RING,
                                    "tile": list(tile),
                                    "epoch": e,
                                    "ring": encode_ring(ring, pack),
                                }
                                if pack
                                else _ring_msg(tile, e, ring)
                            )
                            self._m_sends.inc()
                except OSError:
                    return

    def _peer_channel(self, owner: str) -> Optional[Channel]:
        """The dialed channel to a peer worker, connecting on first use."""
        entry = self.owners_by_name().get(owner)
        if entry is None:
            return None
        host, port = entry
        with self._peer_lock:
            ch = self._peers.get(owner)
            if ch is not None:
                return ch
            try:
                sock = socket.create_connection((host, port), timeout=5)
                sock.settimeout(None)
            except OSError:
                return None
            ch = Channel(sock, send_deadline_s=self.send_deadline_s)
            if self.netchaos is not None and self.netchaos.config.wraps_peer:
                ch = wrap_channel(
                    ch, self.netchaos,
                    src=self.name or "", dst=owner, fail_blocked=True,
                )
            self._peers[owner] = ch
        # Peer channels are bidirectional: the accepting side serves our
        # PEER_PULLs and may push rings back on the same socket.
        threading.Thread(target=self._serve_peer, args=(ch,), daemon=True).start()
        try:
            ch.send({"type": P.PEER_HELLO, "name": self.name})
        except OSError:
            self._drop_peer(owner)
            return None
        return ch

    def _drop_peer(self, owner: str) -> None:
        with self._peer_lock:
            ch = self._peers.pop(owner, None)
        if ch is not None:
            ch.close()
            self._m_drops.inc()

    def owners_by_name(self) -> Dict[str, Tuple[str, int]]:
        with self._lock:
            out = dict(self._serve_peer_addrs)
            out.update(
                (name, (host, port))
                for name, host, port in self.owners.values()
            )
            return out

    def serve_peer_send(self, name: str, host: str, port: int, msg: dict) -> None:
        """Queue a serve-plane frame (TILED_HALO / ..._ACK) toward a peer
        worker named by the frontend: the same async per-peer lane as ring
        traffic, with the address learned from the op instead of OWNERS."""
        with self._lock:
            self._serve_peer_addrs[name] = (host, int(port))
        self._send_peer(name, msg)

    def _sender(self, owner: str) -> Optional[_PeerSender]:
        """The async outbound lane to a peer, created on first use — or
        None for an owner no longer in the wiring.  The membership check
        runs INSIDE the creation critical section: a publish that
        snapshotted its owner set just before an OWNERS rewiring must not
        resurrect the departed peer's lane after the rewiring reaped it
        (leaked writer thread + gauge series dialing a stale address).
        Lock order _sender_lock → worker lock is acyclic: no path holds
        the worker lock while taking _sender_lock."""
        with self._sender_lock:
            s = self._senders.get(owner)
            if s is None:
                with self._lock:
                    known = {name for name, _, _ in self.owners.values()}
                    known |= set(self._serve_peer_addrs)
                if known and owner not in known:
                    return None
                s = self._senders[owner] = _PeerSender(self, owner)
            return s

    def _send_peer(self, owner: str, msg: dict) -> None:
        """Queue a control message for ``owner``'s writer thread.  Never
        touches the socket: dialing, the circuit breaker, and failure
        handling all run on the peer's writer (``_PeerSender._send``), so
        no compute or serve thread can block on a wedged link."""
        s = self._sender(owner)
        if s is not None:
            s.enqueue_msg(msg)

    # -- helper threads ------------------------------------------------------

    def _heartbeat_loop(self, interval: float) -> None:
        while not self._stop.is_set():
            time.sleep(interval)
            try:
                self.channel.send({"type": P.HEARTBEAT})
                self._m_heartbeats.inc()
            except OSError:
                # A federated worker may be mid-re-home: this one loop
                # lives on (it reads self.channel at every send, so it
                # follows the swap).
                if self._rehomable():
                    continue
                return

    def _cost_loop(self, interval: float) -> None:
        """Low-cadence P.COST shipping: this worker's program-ledger
        summary (compile counts, per-family throughput, device memory
        watermarks) rides to the frontend, which merges every member into
        one cluster ``/cost`` view.  The local device gauges refresh here
        too, so the worker's own /metrics exposition carries live
        watermarks between metric dumps."""
        from akka_game_of_life_tpu_torch.obs.programs import get_programs

        while not self._stop.wait(interval):
            programs = get_programs()
            try:
                programs.refresh_device_gauges()
            except Exception:
                pass
            try:
                self.channel.send({"type": P.COST, **programs.summary()})
            except OSError:
                return

    def _retry_loop(self) -> None:
        """The gatherer's Retry timer: re-ask the owners of missing rings.

        Hardened pacing: the first re-ask fires ``retry_s`` after the pull
        queued; each further consecutive re-ask of the same tile backs off
        with decorrelated jitter — ``delay = min(retry_max_s,
        uniform(retry_s, 3 * last_delay))`` — so a partitioned or lossy
        neighborhood sees a handful of desynchronized probes per cooling
        window instead of every stale tile re-asking in lockstep each
        ``retry_s`` (the retry-storm that makes heal moments worse than the
        fault).  A successful pull resets the tile's delay to the base.

        After ``max_pull_retries`` unanswered re-asks the worker escalates
        with GATHER_FAILED — the reference's gatherer gives up after 2 ask
        rounds and fires ``FailedToGatherInfoMsg`` so its parent repairs the
        neighborhood (``NextStateCellGathererActor.scala:49-58``,
        ``CellActor.scala:92-94``).  The tile keeps its state and keeps
        retrying; the frontend decides whether a blocking neighbor is
        genuinely stuck."""
        while not self._stop.wait(max(0.01, self.retry_s / 4)):
            now = time.monotonic()
            failed: List[Tuple[TileId, int]] = []
            stale: List[Tuple[TileId, int]] = []
            thawed: List[TileId] = []
            delays: List[float] = []
            with self._lock:
                if self.paused:
                    continue
                for tid, t in self.tiles.items():
                    if t.frozen_until:
                        # Migration freeze: no re-asks, no escalation — the
                        # tile is deliberately still.  Past the deadline the
                        # move evidently failed mid-protocol; unfreeze and
                        # resume (the frontend's abort already cooled the
                        # tile down on its side).
                        if now < t.frozen_until:
                            continue
                        t.frozen_until = 0.0
                        thawed.append(tid)
                        continue
                    if t.awaiting_since is None or now < t.next_retry_at:
                        continue
                    t.retries += 1
                    if t.retries > self.max_pull_retries:
                        t.retries = 0  # re-arm: escalate again if still stuck
                        failed.append((tid, t.epoch))
                    t.retry_delay = min(
                        self.retry_max_s,
                        self._retry_rng.uniform(self.retry_s, 3 * t.retry_delay),
                    )
                    t.next_retry_at = now + t.retry_delay
                    delays.append(t.retry_delay)
                    stale.append((tid, t.epoch))
            for tid in thawed:
                # Resume a tile whose migration never concluded: re-drive so
                # it re-pulls its halo (rings are still in the local store —
                # the prune floor could not pass a tile that stopped moving).
                self._drive(tid)
            for d in delays:
                self._m_backoff.observe(d)
            if stale:
                # One wakeup that found work; one retry per stale tile.
                self._m_wakeups.inc()
                self._m_retries.inc(len(stale))
                with self.tracer.span(
                    "halo.retry", parent=self._trace_ctx,
                    node=self.name or "backend", tiles=len(stale),
                    epochs=str([e for _, e in stale]),
                ):
                    for tid, epoch in stale:
                        self._ask_missing(tid, epoch)
            for tid, epoch in failed:
                with self.tracer.span(
                    "gather.escalate", parent=self._trace_ctx,
                    node=self.name or "backend", tile=str(tid), epoch=epoch,
                ):
                    try:
                        self.channel.send(
                            {
                                "type": P.GATHER_FAILED,
                                "tile": list(tid),
                                "epoch": epoch,
                            }
                        )
                        self._m_gather_failures.inc()
                    except OSError:
                        pass

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, msg: dict) -> None:
        kind = msg.get("type")
        if kind in (P.DEPLOY, P.TICK, P.CRASH, P.CRASH_TILE):
            # Adopt the frontend's span context: everything this worker does
            # from here until the next announcement is caused by it.  Plain
            # attribute store, NO worker lock: a compute step holds that
            # lock for whole chunks, and the CRASH path below must stay
            # abrupt — it cannot queue behind a multi-second step.
            ctx = extract_trace(msg)
            if ctx is not None:
                self._trace_ctx = ctx
        if kind == P.DEPLOY:
            self._on_deploy(msg)
        elif kind == P.OWNERS:
            self._on_owners(msg)
        elif kind == P.TICK:
            with self._lock:
                self.target = int(msg["target"])
            self._kick()
        elif kind == P.PRUNE:
            if self.store is not None:
                self.store.prune_below(int(msg["floor"]))
        elif kind == P.PAUSE:
            with self._lock:
                self.paused = True
        elif kind == P.RESUME:
            with self._lock:
                self.paused = False
            self._kick()
        elif kind == P.CRASH:
            # The post-mortem artifact BEFORE dying: the default crash_hook
            # is os._exit, so this dump is the node's last act.
            with self.tracer.span(
                "backend.crash", parent=self._trace_ctx, node=self.name or "backend",
                mode="node",
            ):
                self.tracer.flight.dump("crash", node=self.name or "backend")
            # Drain pending forwarded spans (including the backend.crash one
            # just finished) while the socket is still open — the default
            # crash_hook is os._exit, which would strand the 1 s flush batch
            # and leave the frontend trace without the victim's last second.
            self._run_pre_stop_hooks()
            self.crash_hook()
        elif kind == P.CRASH_TILE:
            with self.tracer.span(
                "backend.crash", parent=self._trace_ctx, node=self.name or "backend",
                mode="tile", tile=str(tuple(msg["tile"])),
            ):
                self.tracer.flight.dump("tile_crash", node=self.name or "backend")
                self._on_crash_tile(tuple(msg["tile"]))
        elif kind == P.MIGRATE_PREPARE:
            self._on_migrate_prepare(msg)
        elif kind == P.MIGRATE_ABORT:
            self._on_migrate_abort(tuple(msg["tile"]))
        elif kind in (
            P.SERVE_OPS, P.SHARD_PREPARE, P.SHARD_COMMIT, P.SHARD_ABORT,
            P.SHARD_REPLICATE_ACK,
        ):
            # Serve-plane frames enqueue to the plane's executor and never
            # block this dispatch: a step op's batch tick must not stall
            # heartbeat-adjacent control traffic.
            if self.serve_plane is not None:
                self.serve_plane.handle(msg)
        elif kind == P.FED_PEERS:
            # The federation's peer set changed: the re-home fallbacks.
            self._federation_fallbacks = _fallbacks(msg.get("peers"))
        elif kind == P.PROFILE:
            # The frontend's fan-out: capture on a daemon thread, so a
            # multi-second window never blocks this control reader.
            if self._profiler is None:
                from akka_game_of_life_tpu_torch.runtime.profiling import (
                    ProfilerCapture,
                )

                self._profiler = ProfilerCapture(
                    self.profile_dir,
                    node=self.name or "backend",
                    max_seconds=float(self._obs_profile.get("max_s", 30.0)),
                    min_interval_s=float(self._obs_profile.get("min_interval_s", 60.0)),
                )
            threading.Thread(
                target=self._profile_capture,
                args=(self._profiler, msg.get("seconds")),
                daemon=True,
            ).start()
        elif kind == P.DRAIN_COMPLETE:
            # The frontend released us: either every tile migrated off
            # (drained=True → rc 0) or the drain was refused (no placeable
            # destination → the caller falls back to the abrupt-leave path).
            drained = bool(msg.get("drained", True))
            self.stopped_reason = "drained" if drained else "drain_refused"
            self._stop.set()
            self._run_pre_stop_hooks()
            if self.serve_plane is not None:
                self.serve_plane.close()
            try:
                # Deliberate leave, distinguishable from a crash — by now we
                # own nothing, so the frontend evicts without redeploying.
                self.channel.send({"type": P.GOODBYE})
            except OSError:
                pass
            self.channel.close()
        elif kind == P.SHUTDOWN:
            self.stopped_reason = "shutdown"
            self._stop.set()
            # Last words while the socket is still open (span-batch drain).
            self._run_pre_stop_hooks()
            if self.serve_plane is not None:
                self.serve_plane.close()
            self.channel.close()

    def _on_owners(self, msg: dict) -> None:
        """Ownership/wiring update — the reference's NeighboursRefs re-send
        (``BoardCreator.scala:149-151``)."""
        grid = tuple(msg["grid"])
        shape = tuple(msg["shape"])
        dropped: List[TileId] = []
        with self._lock:
            if self.layout is None or self.layout.grid != grid:
                self.layout = TileLayout(shape, grid)
                self.store = BoundaryStore(self.layout, self.exchange_width)
            self.owners = {
                tuple(t): (name, host, int(port))
                for t, name, host, port in msg["tiles"]
            }
            # Tiles moved away from us (e.g. judged stuck and re-placed):
            # stop stepping them; the new owner replays from the checkpoint.
            for tid in [t for t in self.tiles if self.owners.get(t, ("",))[0] != self.name]:
                del self.tiles[tid]
                self._actor_engines.pop(tid, None)
                dropped.append(tid)
            self._owner_map = None  # wiring changed: publish cache is stale
        if dropped and self.store is not None:
            for tid in dropped:
                self.store.drop_pending_for_owner([tid])
        # Breaker hygiene: a peer that left the cluster (evicted, renamed)
        # must not leave an open breaker behind — its gauge would read open
        # forever and its breaker.open span would never finish.  Names still
        # in the wiring keep their state (an open breaker on a live-but-dead
        # link is exactly what the half-open probes are for).
        with self._lock:
            owner_names = {name for name, _, _ in self.owners.values()}
        for peer in set(self.breaker.peers()) - owner_names:
            self.breaker.reset(peer)
        # Same hygiene for the async send lanes: a departed peer's writer
        # thread (and anything still queued for it) must not outlive the
        # wiring that named it.
        with self._sender_lock:
            gone = [o for o in self._senders if o not in owner_names]
            senders = [self._senders.pop(o) for o in gone]
        for s in senders:
            s.close()

    def _on_deploy(self, msg: dict) -> None:
        outbound: List[Tuple[TileId, np.ndarray, int]] = []
        seed_rings: List[Tuple[TileId, int, Ring]] = []
        with self._lock:
            rule = resolve_rule(msg["rule"])
            if rule.radius != 1:
                # The invariant lives here, not only at the Frontend: every
                # chunk engine below (np peel, torch toroidal steps) assumes a
                # one-cell-per-step garbage front; a radius-R rule reaching
                # them would be silently wrong, not slow.
                raise ValueError(
                    f"cluster workers exchange radius-1 rings; cannot host "
                    f"{rule}"
                )
            if self.rule != rule:
                self.rule = rule
                if self.engine == "torch":
                    self._step_chunk = _torch_engine(
                        rule, pallas=self.pallas, device=self.device
                    )
                elif self.engine == "swar":
                    self._step_chunk = _swar_engine(rule)
                elif self.engine == "numpy":
                    self._step_chunk = (
                        lambda padded, steps, halo: _np_chunk(padded, steps, halo, rule)
                    )
                # engine == "actor*": stateful per-tile engines, built below
            self.target = int(msg["target"])
            self.final_epoch = int(msg["final_epoch"])
            self.render_every = int(msg.get("render_every", 0))
            self.checkpoint_every = int(msg.get("checkpoint_every", 0))
            self.metrics_every = int(msg.get("metrics_every", 0))
            self.render_strides = tuple(msg.get("render_strides", (1, 1)))
            pw = msg.get("probe_window")
            self.probe_window = tuple(pw) if pw is not None else None
            for spec in msg["tiles"]:
                tid: TileId = tuple(spec["id"])
                tile = _Tile(
                    unpack_tile(spec["state"]), int(spec["epoch"]),
                    retry_s=self.retry_s,
                )
                self.tiles[tid] = tile
                self.origins[tid] = tuple(spec.get("origin", (0, 0)))
                if self.engine == "actor":
                    # A (re)deploy is a supervision restart: fresh actors,
                    # histories reseeded from the deployed array.
                    from akka_game_of_life_tpu_torch.runtime.actor_engine import (
                        ActorTileEngine,
                    )

                    self._actor_engines[tid] = ActorTileEngine(rule)
                elif self.engine == "actor-native":
                    from akka_game_of_life_tpu_torch.native.engine import (
                        NativeActorTileEngine,
                    )

                    self._actor_engines[tid] = NativeActorTileEngine(rule)
                outbound.append((tid, tile.arr, tile.epoch))
                for e in spec.get("rings") or []:
                    seed_rings.append(
                        (tuple(e["tile"]), int(e["epoch"]), decode_ring(e["ring"]))
                    )
            self._owner_map = None  # tiles (re)deployed: publish cache is stale
        if seed_rings and self.store is not None:
            # A migrated tile arrives at its LIVE epoch; neighbors replaying
            # older epochs ask US (the new owner) for rings we never
            # computed.  The previous owner's retained ring history rode the
            # certified payload (it may already be out of the wiring — or
            # gone entirely, on a drain's final move — so a pull could never
            # be addressed); seeding it here also answers any local pulls
            # already queued on those epochs.
            self.store.push_rings(seed_rings)
        for tid, arr, epoch in outbound:
            # Announce our boundary at the deployed epoch so neighbors can
            # assemble their halos (History seeding, CellActor.scala:34).
            self._publish_ring(tid, arr, epoch)
            self._report_state(tid, arr, epoch)
        self._kick()

    def _profile_capture(self, prof, seconds) -> None:
        try:
            want = float(seconds) if seconds is not None else None
        except (TypeError, ValueError):
            want = None
        result = prof.capture(want)
        if result.get("ok"):
            print(
                f"profiler capture: {result.get('artifact')} "
                f"({result.get('seconds')}s)",
                flush=True,
            )
        else:
            # A fanned capture has no HTTP response to carry the error: the
            # worker's log is where the operator sees it.
            print(
                f"profiler capture failed: {result.get('error')} "
                f"(status {result.get('status')})",
                flush=True,
            )

    def _on_crash_tile(self, tid: TileId) -> None:
        """Supervision-restart analog: the tile's in-memory state is lost;
        ask the parent to redeploy (postRestart → SendMeMyNeighbours,
        CellActor.scala:21-25)."""
        with self._lock:
            if tid in self.tiles:
                del self.tiles[tid]
            self._actor_engines.pop(tid, None)
            self._owner_map = None  # tile dropped: publish cache is stale
        try:
            self.channel.send({"type": P.REDEPLOY_REQUEST, "tile": list(tid)})
        except OSError:
            pass

    # -- live migration / drain (the elastic plane) --------------------------

    def _migrate_payload(self, tid: TileId, arr: np.ndarray, epoch: int) -> dict:
        """The MIGRATE_STATE body for one frozen tile: its bit-packed state
        (the wire codec — 8 cells/byte for binary rules), the
        source-side digest lanes the frontend certifies the payload
        against, and the tile's retained ring history.  The history rides
        IN-BAND because the destination cannot reliably pull it later: a
        drain's final move removes the source from the OWNERS wiring (and
        the source may exit) before any pull could be addressed, yet
        lagging neighbors still re-ask the NEW owner for rings the new
        owner never computed.  Factored out so failure-path tests can
        corrupt it."""
        from akka_game_of_life_tpu_torch.ops import digest as odigest

        with self._lock:
            origin = self.origins.get(tid, (0, 0))
            width = (
                self.layout.board_shape[1]
                if self.layout is not None
                else arr.shape[1]
            )
            store = self.store
        lanes = odigest.digest_dense_np(arr, origin, width)
        pack = self.ring_pack and self.rule is not None and self.rule.is_binary
        rings = (
            [
                {"tile": list(tid), "epoch": e, "ring": encode_ring(ring, pack)}
                for e, ring in store.rings_from(tid, 0)
            ]
            if store is not None
            else []
        )
        return {
            "type": P.MIGRATE_STATE,
            "tile": list(tid),
            "epoch": epoch,
            "state": pack_tile(arr),
            "digest": [int(lanes[0]), int(lanes[1])],
            "rings": rings,
        }

    def _on_migrate_prepare(self, msg: dict) -> None:
        """PREPARE: freeze the tile at its current chunk boundary and ship
        its state.  Compute runs under the worker lock, so the (arr, epoch)
        snapshot below is always a consistent chunk-boundary state; setting
        ``frozen_until`` under the same lock guarantees no later chunk
        starts.  A tile we no longer host is simply not answered — the
        frontend's migration deadline aborts the move."""
        tid: TileId = tuple(msg["tile"])
        seq = int(msg["seq"])
        deadline_s = float(msg.get("deadline_s", 10.0))
        with self._lock:
            tile = self.tiles.get(tid)
            if tile is None:
                return
            # 2× the frontend deadline: the frontend always decides first
            # (commit or abort); this is only the lost-message backstop.
            tile.frozen_until = time.monotonic() + 2.0 * deadline_s
            arr, epoch = tile.arr, tile.epoch
        out = self._migrate_payload(tid, arr, epoch)
        out["seq"] = seq
        try:
            self.channel.send(out)
        except OSError:
            pass
        except ValueError as e:
            # An oversize MIGRATE_STATE frame (tile state + ring history
            # past MAX_FRAME) must not escape into run()'s wire-error
            # handling and kill the whole worker — that would turn a
            # graceful drain of a healthy worker into node loss.  The
            # transfer can never happen, so unfreeze now instead of
            # waiting out the 2x-deadline thaw; the frontend's deadline
            # aborts the move on its side.
            print(
                f"tile {tid}: migration payload unsendable ({e}); "
                f"resuming",
                flush=True,
            )
            with self._lock:
                tile = self.tiles.get(tid)
                if tile is not None:
                    tile.frozen_until = 0.0
            self._drive(tid)

    def _on_migrate_abort(self, tid: TileId) -> None:
        """Rollback: unfreeze and resume stepping — the tile never left."""
        with self._lock:
            tile = self.tiles.get(tid)
            if tile is None:
                return
            tile.frozen_until = 0.0
        self._drive(tid)

    def request_drain(self) -> bool:
        """Ask the frontend to migrate every tile off this worker so it can
        leave without tripping node-loss recovery.  Returns False when a
        drain is pointless (no tiles, not connected, already stopping) —
        callers then take the abrupt-leave path.  The caller keeps serving
        the control channel; the frontend answers with MIGRATE_PREPAREs and
        finally DRAIN_COMPLETE."""
        with self._lock:
            has_tiles = bool(self.tiles)
        # A serve-shard host with no tiles still drains: its sessions must
        # migrate off before it may leave without losing tenant boards.
        serving = self.serve_plane is not None
        if (
            (not has_tiles and not serving)
            or self.channel is None
            or self._stop.is_set()
        ):
            return False
        try:
            self.channel.send({"type": P.DRAIN_REQUEST})
        except OSError:
            return False
        return True

    # -- stepping plumbing ---------------------------------------------------

    def _kick(self) -> None:
        """Start the drive loop for every tile that is behind and not
        already waiting (scheduleTransitionToNextepochIfNeeded,
        CellActor.scala:41-47).  Must be called WITHOUT the lock held — the
        drive loop sends to peer sockets, and no thread may hold its worker
        lock while writing into another worker (deadlock discipline)."""
        with self._lock:
            tids = list(self.tiles)
        for tid in tids:
            self._drive(tid)

    def _drive(self, tid: TileId) -> None:
        """Advance a tile while halos are immediately available, registering
        one queued pull when they are not.  Iterative on purpose: a tile
        replaying thousands of epochs against already-present rings must not
        recurse once per epoch."""
        while True:
            with self._lock:
                tile = self.tiles.get(tid)
                if (
                    tile is None
                    or self.store is None
                    or self.paused
                    or tile.awaiting_since is not None  # pull already in flight
                ):
                    return
                if tile.frozen_until:
                    if time.monotonic() < tile.frozen_until:
                        return  # migration in flight: state must not move
                    tile.frozen_until = 0.0  # deadline passed: self-heal
                # Chunked advance: one width-k halo exchange licenses the
                # next c = min(k, final-epoch) epochs; the tile waits until
                # the target covers the WHOLE chunk so every tile visits the
                # same epoch grid {0, k, 2k, ..., final} regardless of TICK
                # arrival order (mixed chunk boundaries would ask neighbors
                # for rings at epochs they never computed).
                c = self._chunk_for(tile.epoch)
                if c <= 0 or self.target < tile.epoch + c:
                    return
                epoch = tile.epoch
                # The waitingForNewState latch (CellActor.scala:32): set
                # before the pull so concurrent kicks don't double-drive.
                tile.awaiting_since = time.monotonic()
                tile.next_retry_at = tile.awaiting_since + self.retry_s
            halo = self.store.pull_halo_now(
                tid, epoch, lambda h, e=epoch: self._on_halo_ready(tid, e, h)
            )
            if halo is None:
                # Queued: the last PEER_RING's push will resume us.  Ask the
                # missing rings' owners right away (first-pull latency; the
                # retry loop is only the loss backstop).
                self._ask_missing(tid, epoch)
                return
            if not self._step_tile(tid, epoch, halo):
                return

    def _ask_missing(self, tid: TileId, epoch: int) -> None:
        # One PEER_PULL frame per owner, carrying EVERY missing tile of
        # that owner — the ask side of the coalescing contract (replies
        # batch the same way), so a stale neighborhood costs O(peers)
        # frames, not O(missing rings).
        asks: Dict[str, List[list]] = {}
        with self._lock:
            if self.store is None:
                return
            for ntile in self.store.missing_neighbor_rings(tid, epoch):
                entry = self.owners.get(ntile)
                if entry is not None and entry[0] != self.name:
                    asks.setdefault(entry[0], []).append(list(ntile))
        for owner, tiles in asks.items():
            self._send_peer(
                owner, {"type": P.PEER_PULL, "tiles": tiles, "epoch": epoch}
            )

    def _on_halo_ready(self, tid: TileId, epoch: int, halo: Halo) -> None:
        """Queued-pull completion, on whichever thread pushed the last ring."""
        if self._step_tile(tid, epoch, halo):
            self._drive(tid)

    def _chunk_for(self, epoch: int) -> int:
        """Epochs the next exchange buys from ``epoch``: the full exchange
        width, or the remainder to final_epoch (the one partial chunk)."""
        k = self.exchange_width
        return min(k, self.final_epoch - epoch) if self.final_epoch else k

    def _quiescent_period_locked(self, tile: _Tile, halo: Halo, c: int) -> int:
        """0 (active) or the period (1/2) at which the chunk about to run
        repeats a recorded input.  Determinism is the whole proof: the
        chunk output is a pure function of (state, halo, chunk length), so
        an input seen before has an output already in hand.  Halo equality
        is checked FIRST (O(perimeter)) so active tiles — whose boundary
        almost surely moved — never pay the O(tile) state compare.  Caller
        holds the lock."""
        if not self.sparse_cluster or self.engine in ("actor", "actor-native"):
            # Actor engines are stateful (per-cell histories advance with
            # every step); skipping their drive would desynchronize them.
            return 0
        ins = tile.inputs
        p1 = (
            len(ins) >= 1
            and tile.last_ring is not None
            and c == ins[0][2]
            and halos_equal(halo, ins[0][1])
        )
        p2 = (
            len(ins) >= 2
            and tile.prev_ring is not None
            and c == ins[1][2]
            and halos_equal(halo, ins[1][1])
        )
        if not (p1 or p2):
            # The boundary moved: the common active case, and free — no
            # state compare, and any probe backoff is moot.
            tile.q_probe_wait = 0
            return 0
        # Identity fast paths: a tile already quiescent holds the SAME
        # array object its matching input recorded, so steady-state skips
        # cost O(perimeter) only.
        if p1 and tile.arr is ins[0][0]:
            return 1
        if p2 and tile.arr is ins[1][0]:
            return 2
        # The O(tile) probes, under adaptive backoff: a tile whose halo is
        # static but whose INTERIOR is active would otherwise pay up to two
        # full memcmps per chunk — exactly the dilute pattern this tier
        # targets.  A failed probe doubles the wait (capped); the only cost
        # of waiting is entering quiescence a few chunks late.
        if tile.q_probe_wait > 0:
            tile.q_probe_wait -= 1
            return 0
        if p1 and np.array_equal(tile.arr, ins[0][0]):
            tile.q_probe_backoff = 0
            return 1
        if p2 and np.array_equal(tile.arr, ins[1][0]):
            tile.q_probe_backoff = 0
            return 2
        tile.q_probe_backoff = min(8, max(1, 2 * tile.q_probe_backoff))
        tile.q_probe_wait = tile.q_probe_backoff
        return 0

    def _step_tile(self, tid: TileId, epoch: int, halo: Halo) -> bool:
        """One chunk (1..exchange_width epochs) of one tile.  Compute happens
        under the lock; ring and state sends happen after releasing it so two
        workers never hold their locks while writing into each other's
        sockets.

        Quiescence tier (sparse_cluster): a chunk whose (state, halo, len)
        input matches the previous chunk's is a fixed point — its output IS
        the current state; one matching the chunk before that is period-2 —
        its output IS the previous state.  Either way the compute is
        skipped, the ring publish collapses to an O(1)-byte same-ring
        marker, and the PROGRESS ping is suppressed except at cadence/
        digest-due epochs and on the quiesce transition itself.  Epochs
        still advance through the normal epoch-tagged protocol, so a
        changed neighboring ring simply fails the halo-equality test on
        the next chunk and the tile computes again — the wake needs no
        message of its own and can never run a wrong-state epoch."""
        with self._lock:
            tile = self.tiles.get(tid)
            c = self._chunk_for(epoch)
            if (
                tile is None
                or epoch != tile.epoch  # stale/duplicate completion: drop
                or self.paused
                or c <= 0
                or self.target < epoch + c
                # Frozen for migration: refuse the chunk; an abort/expiry
                # re-drives and the halo reassembles from stored rings.
                or (
                    tile.frozen_until
                    and time.monotonic() < tile.frozen_until
                )
            ):
                if tile is not None and epoch == tile.epoch:
                    tile.awaiting_since = None  # paused/short target: clear latch
                return False
            period = self._quiescent_period_locked(tile, halo, c)
            if period:
                prev_state = tile.arr
                new_arr = tile.arr if period == 1 else tile.inputs[0][0]
                reuse = tile.last_ring if period == 1 else tile.prev_ring
                ring, same_as = reuse
                entered = tile.q_period == 0
                tile.q_period = period
                tile.q_skipped += 1
                tile.arr = new_arr
            else:
                prev_state = tile.arr
                padded = halo.pad(prev_state)
                with self.tracer.span(
                    "backend.step", parent=self._trace_ctx,
                    node=self.name or "backend", tile=str(tid), epoch=epoch,
                    chunk=c,
                ):
                    if self.engine in ("actor", "actor-native"):
                        # Actor engines exchange per-epoch (the frontend
                        # rejects them when exchange_width > 1), so c == 1.
                        tile.arr = self._actor_engines[tid].step(padded)
                    else:
                        tile.arr = self._step_chunk(padded, c, self.exchange_width)
                tile.q_period = 0
                ring, same_as = Ring.of(tile.arr, self.exchange_width), None
            if self.sparse_cluster:
                # Record the chunk input for the next quiescence test —
                # references only; compute allocated a fresh array, so the
                # old ones stay valid.  Off, nothing is retained (holding
                # two extra boards per tile is the feature's cost, not a
                # default tax).
                tile.inputs.appendleft((prev_state, halo, c))
            tile.epoch += c
            tile.awaiting_since = None
            tile.retries = 0
            tile.retry_delay = self.retry_s  # backoff resets on success
            # Ring history rotation HERE, under the same lock that orders
            # chunk completion: rotating in _publish_ring (outside the
            # lock) would let two threads publishing consecutive chunks
            # swap last/prev — and a later period-2 skip would then marker
            # the wrong phase's ring.
            tile.prev_ring = tile.last_ring
            tile.last_ring = (ring, tile.epoch)
            # Snapshot (arr, epoch) while still holding the lock: the sends
            # below run unlocked, and a concurrent kick may step the tile
            # again in between — publishing from the live tile there would
            # pair one chunk's data with another's epoch label.
            arr, epoch_now = tile.arr, tile.epoch
        if period:
            self._m_skipped_chunks.inc()
            if entered:
                with self.tracer.span(
                    "tile.quiesce", parent=self._trace_ctx,
                    node=self.name or "backend", tile=str(tid),
                    epoch=epoch_now, period=period,
                ):
                    pass
            self._publish_ring(
                tid, arr, epoch_now, ring=ring, same_as=same_as,
                ping=entered or self._quiescent_ping_due(epoch_now),
            )
        else:
            self._publish_ring(tid, arr, epoch_now, ring=ring)
        self._report_state(tid, arr, epoch_now)
        return True

    def _quiescent_ping_due(self, epoch: int) -> bool:
        """Epochs at which even a quiescent tile must ping: every cadence
        the frontend keys bookkeeping to (checkpoint completion gates,
        prune floor advance, render/metrics lag accounting, the final
        epoch) plus digest-due certificates."""
        if epoch == self.final_epoch:
            return True
        for every in (
            self.checkpoint_every, self.metrics_every, self.render_every
        ):
            if every and epoch % every == 0:
                return True
        return self._digest_due(epoch)

    def _owner_rings_locked(self, tid: TileId) -> Tuple[List[str], Dict[str, set]]:
        """For one publishing tile: the distinct remote owners of its 8
        neighbors, plus — per remote owner — the set of ALL local tiles
        bordering that owner (the batch-seal expectation).  Served from a
        cache invalidated on OWNERS/DEPLOY/tile changes — the map is
        invariant between rewirings, and the publish path runs once per
        tile per chunk under the worker lock.  Caller holds the lock."""
        if self.layout is None:
            return [], {}
        if self._owner_map is None:
            by_tile: Dict[TileId, List[str]] = {}
            expect: Dict[str, set] = {}
            for t in self.tiles:
                remote = {
                    self.owners[ntile][0]
                    for ntile in self.layout.neighbors(t).values()
                    if ntile in self.owners
                    and self.owners[ntile][0] != self.name
                }
                by_tile[t] = sorted(remote)
                for owner in remote:
                    expect.setdefault(owner, set()).add(t)
            self._owner_map = (by_tile, expect)
        by_tile, expect = self._owner_map
        return by_tile.get(tid, []), expect

    def _publish_ring(
        self,
        tid: TileId,
        arr: np.ndarray,
        epoch: int,
        *,
        ring: Optional[Ring] = None,
        same_as: Optional[int] = None,
        ping: bool = True,
    ) -> None:
        """Store our ring locally (answers our own and co-located pulls) and
        queue it for each distinct remote owner among the tile's 8 neighbors
        — the direct neighbor-to-neighbor data plane.  Takes an (arr, epoch)
        snapshot captured under the worker lock, never the live tile.

        Hot-path shape: the ring is encoded ONCE (bit-packed for binary
        rules when ring_pack is on), the owner set and payload accounting
        are computed once per publish, and the per-owner loop only enqueues
        onto async sender lanes — no socket work, no re-encoding, no
        blocking on a slow peer.

        Quiescent publish (``same_as`` set): ``ring`` is the reused ring
        object published at epoch ``same_as``, re-stored locally (a shared
        reference, no copy) while remote owners receive an O(1)-byte
        ``same_as`` marker instead of payload — the receiver resolves it
        against its own store.  ``ping=False`` additionally suppresses the
        per-chunk PROGRESS ping (cadence/digest epochs keep it).

        ``ring=None`` is the deploy-time announce: the tile is not yet
        being driven (single-threaded for it), so the ring is computed —
        and the last/prev ring history rotated — right here.  Step-loop
        publishes instead pass the ring rotated inside ``_step_tile``'s
        locked section, where chunk completion order is serialized; a
        rotation here would race a concurrent publish of the next chunk
        and could invert last/prev under a later period-2 skip."""
        marker = same_as is not None
        if ring is None:
            ring = Ring.of(arr, self.exchange_width)
            with self._lock:
                tile = self.tiles.get(tid)
                if tile is not None:
                    tile.prev_ring = tile.last_ring
                    tile.last_ring = (ring, epoch)
        if self.store is not None:
            self.store.push_ring(tid, epoch, ring)
        with self._lock:
            remote_owners, expect = self._owner_rings_locked(tid)
        if not remote_owners:
            if ping:
                self._progress_ping(tid, epoch, arr)
            return
        pack = self.ring_pack and self.rule is not None and self.rule.is_binary
        # Wire-cost accounting (the Casper data-movement signal at the
        # cluster layer): dense cell bytes AND actual encoded wire bytes
        # per remote copy — their ratio is the packing win.  The raw
        # unbatched baseline ships the legacy per-field message, so its
        # wire bytes ARE the dense bytes and nothing needs encoding — the
        # A/B baseline must not pay a concatenate+copy it never sends.
        # A quiescence marker ships no payload at all: dense bytes still
        # count (the logical exchange happened), wire bytes count zero.
        if marker:
            enc, wire = None, 0
            self._m_same_markers.inc(len(remote_owners))
        elif pack or self.ring_batch:
            enc = encode_ring(ring, pack)
            wire = ring_entry_nbytes(enc)
        else:
            enc, wire = None, ring.nbytes
        self._m_ring_bytes.inc(ring.nbytes * len(remote_owners))
        self._m_packed_bytes.inc(wire * len(remote_owners))
        with self.tracer.span(
            "halo.send", parent=self._trace_ctx,
            node=self.name or "backend", tile=str(tid), epoch=epoch,
            peers=len(remote_owners), bytes=wire * len(remote_owners),
        ):
            if self.ring_batch:
                entry = (
                    {"tile": list(tid), "epoch": epoch, "same_as": same_as}
                    if marker
                    else {"tile": list(tid), "epoch": epoch, "ring": enc}
                )
                for owner in remote_owners:
                    s = self._sender(owner)
                    if s is not None:  # departed between snapshot and here
                        s.enqueue_ring(entry, expect.get(owner, ()))
            else:
                # Frame-per-ring mode (the reference's wire shape, kept for
                # A/B measurement): still async, still encoded at most once.
                if marker:
                    msg = {
                        "type": P.PEER_RING, "tile": list(tid),
                        "epoch": epoch, "same_as": same_as,
                    }
                elif pack:
                    msg = {
                        "type": P.PEER_RING, "tile": list(tid),
                        "epoch": epoch, "ring": enc,
                    }
                else:
                    msg = _ring_msg(tid, epoch, ring)
                for owner in remote_owners:
                    self._send_peer(owner, msg)
        if ping:
            self._progress_ping(tid, epoch, arr)

    def _digest_due(self, epoch: int) -> bool:
        """Epochs whose PROGRESS ping carries the tile's digest lanes:
        metrics and checkpoint cadence crossings plus the final epoch —
        exactly the points the frontend certifies or makes durable."""
        if not self.obs_digest or epoch <= 0:
            return False
        if epoch == self.final_epoch:
            return True
        if self.checkpoint_every and epoch % self.checkpoint_every == 0:
            return True
        return bool(self.metrics_every and epoch % self.metrics_every == 0)

    def _progress_ping(
        self, tid: TileId, epoch: int, arr: Optional[np.ndarray] = None
    ) -> None:
        """Control-plane progress ping (no arrays): feeds the frontend's
        prune floor, stuck detection, and lag accounting.  At digest-due
        epochs it additionally carries the tile's 64-bit fingerprint lanes
        (~8 bytes — the mergeable per-tile form of the digest plane), so
        the frontend certifies whole-cluster state in O(tiles) bytes.

        Quiescence tier: the ping additionally reports the tile's live
        period (``q``) and the chunks skipped since the last ping
        (``skipped``) — the frontend folds the deltas into
        ``gol_tiles_skipped_total`` and tracks the quiescent set for
        ``/healthz``."""
        msg = {"type": P.PROGRESS, "tile": list(tid), "epoch": epoch}
        if self.sparse_cluster:
            with self._lock:
                tile = self.tiles.get(tid)
                if tile is not None:
                    msg["q"] = tile.q_period
                    if tile.q_skipped:
                        msg["skipped"] = tile.q_skipped
                        tile.q_skipped = 0
        if arr is not None and self._digest_due(epoch):
            from akka_game_of_life_tpu_torch.ops import digest as odigest

            with self._lock:
                origin = self.origins.get(tid, (0, 0))
                width = (
                    self.layout.board_shape[1] if self.layout is not None
                    else arr.shape[1]
                )
            lanes = odigest.digest_dense_np(arr, origin, width)
            msg["digest"] = [int(lanes[0]), int(lanes[1])]
        try:
            self.channel.send(msg)
        except OSError:
            pass

    def _report_state(self, tid: TileId, arr: np.ndarray, epoch: int) -> None:
        """Report tile state at cadence boundaries, shipping only what each
        reason needs — never the raw full tile (VERDICT.md weak #5):
        checkpoint/final ride bit-packed (8 cells/byte), render ships the
        frontend's strided sample, metrics ships a single population count.
        Takes an (arr, epoch) snapshot captured under the worker lock."""
        reasons = []
        e = epoch
        if e == self.final_epoch:
            reasons.append("final")
        if self.checkpoint_every and e > 0 and e % self.checkpoint_every == 0:
            reasons.append("checkpoint")
        if self.render_every and e % self.render_every == 0:
            reasons.append("render")
        if self.metrics_every and e % self.metrics_every == 0:
            reasons.append("metrics")
        if not reasons:
            return
        msg = {
            "type": P.TILE_STATE,
            "tile": list(tid),
            "epoch": e,
            "reasons": reasons,
        }
        if "final" in reasons or "checkpoint" in reasons:
            msg["state"] = pack_tile(arr)
        if "render" in reasons:
            sy, sx = self.render_strides
            with self._lock:
                oy, ox = self.origins.get(tid, (0, 0))
            # Phase-align to the tile origin so the union over tiles is the
            # canonical full-board strided probe (cell (0,0) always shown).
            msg["sample"] = arr[(-oy) % sy :: sy, (-ox) % sx :: sx]
            msg["scaled_origin"] = [
                (oy + sy - 1) // sy,
                (ox + sx - 1) // sx,
            ]
            if self.probe_window is not None:
                # Exact cells of this tile's intersection with the probe
                # window, origin given window-relative; the intersections
                # over all reporting tiles tile the window exactly.
                y0, y1, x0, x1 = self.probe_window
                h, w = arr.shape
                gy0, gy1 = max(y0, oy), min(y1, oy + h)
                gx0, gx1 = max(x0, ox), min(x1, ox + w)
                if gy0 < gy1 and gx0 < gx1:
                    msg["window"] = arr[
                        gy0 - oy : gy1 - oy, gx0 - ox : gx1 - ox
                    ]
                    msg["window_origin"] = [gy0 - y0, gx0 - x0]
        if "metrics" in reasons:
            msg["population"] = int((arr == 1).sum())
        try:
            self.channel.send(msg)
        except OSError:
            pass


_SPAN_FORWARD_INTERVAL_S = 1.0
_SPAN_FORWARD_PENDING_CAP = 8192

# How long a SIGTERM'd CLI worker keeps serving the migration protocol
# waiting for its drain to complete before leaving abruptly anyway.
_DRAIN_TIMEOUT_S = 30.0


def _start_span_forwarding(worker: BackendWorker, tracer) -> None:
    """Batch this process's finished spans to the frontend (P.SPANS) so its
    --trace-file / /trace is the cluster-wide causal document.

    Only the multi-process CLI role forwards — the in-process harness
    shares one tracer with the frontend, and forwarding there would
    duplicate every span.  The pending queue is bounded (drop-oldest): a
    frontend that stops draining must not grow worker memory, and trace
    loss under backpressure is the same drop-oldest contract the tracer's
    own ring has."""
    from collections import deque

    # Same drop-oldest idiom as the tracer ring and the flight recorder.
    pending: deque = deque(maxlen=_SPAN_FORWARD_PENDING_CAP)
    lock = threading.Lock()

    def sink(d: dict) -> None:
        with lock:
            pending.append(d)

    tracer.add_sink(sink)

    def flush() -> None:
        with lock:
            batch = list(pending)
            pending.clear()
        if batch:
            worker.channel.send({"type": P.SPANS, "spans": batch})

    def flush_loop() -> None:
        while not worker._stop.wait(_SPAN_FORWARD_INTERVAL_S):
            try:
                flush()
            except OSError:
                return

    # Final drain before the control channel closes on an orderly exit, so
    # the frontend's trace file carries this worker's last spans (the tail
    # of the run, and — on a SHUTDOWN right after a fault — the recovery).
    worker._pre_stop_hooks.append(flush)
    threading.Thread(
        target=flush_loop, daemon=True, name="span-forward"
    ).start()


def run_backend(
    host: str,
    port: int,
    name: Optional[str] = None,
    engine: str = "torch",
    pallas: Optional[str] = None,
    device=None,
    metrics_file: Optional[str] = None,
    metrics_port: int = 0,
    log_events: Optional[str] = None,
    trace_file: Optional[str] = None,
    flight_dir: str = "artifacts",
    net_chaos=None,
) -> int:
    """CLI worker entry.  The worker's data-plane counters (peer sends/
    receives/retries, heartbeats, ring bytes) live in THIS process's
    registry — the frontend's /metrics is a different process — so the
    backend role carries its own exposition: ``metrics_file`` is rewritten
    every few seconds and on exit (the shared MetricsDumper policy),
    ``metrics_port`` serves live /metrics + /healthz + /trace,
    ``log_events`` appends worker-labeled JSONL, ``trace_file`` exports the
    worker's span buffer on exit (same trace ids as the frontend's —
    mergeable), and ``flight_dir`` receives the crash dumps.  ``net_chaos``
    (a :class:`runtime.config.NetworkChaosConfig`) arms this worker's wire
    chaos — same seed/schedule on every role for a coherent drill."""
    from akka_game_of_life_tpu_torch.obs import (
        EventLog,
        MetricsDumper,
        MetricsServer,
        get_registry,
        get_tracer,
    )

    registry = get_registry()
    tracer = get_tracer()
    chaos = (
        NetworkChaos(net_chaos, registry=registry, tracer=tracer)
        if net_chaos is not None and net_chaos.enabled
        else None
    )
    worker = BackendWorker(
        host, port, name=name, engine=engine, pallas=pallas, device=device,
        registry=registry, tracer=tracer, netchaos=chaos,
    )
    worker.connect()
    node = worker.name or "backend"
    tracer.node = node  # nodeless spans attribute to this worker
    tracer.flight.configure(directory=flight_dir, node=node)
    worker.profile_dir = flight_dir or "artifacts"
    events = EventLog(log_events, node=node, recorder=tracer.flight)
    events.emit("backend_joined", frontend=f"{host}:{port}", engine=engine)
    # Program ledger: storm alerts fire through this worker's event log and
    # flight recorder.
    from akka_game_of_life_tpu_torch.obs.programs import get_programs

    get_programs().configure(
        node=node, events=events, flight=tracer.flight, metrics=registry
    )
    server = None
    if metrics_port:
        server = MetricsServer(
            registry,
            port=metrics_port,
            health=lambda: {
                "ok": not worker._stop.is_set(),
                "tiles": len(worker.tiles),
                "target_epoch": worker.target,
            },
            tracer=tracer,
        )
        print(f"metrics on :{server.port}/metrics (+/healthz,/trace)", flush=True)
    dumper = MetricsDumper(registry, metrics_file) if metrics_file else None
    if dumper is not None:
        dumper.start_thread(worker._stop)
    _start_span_forwarding(worker, tracer)
    print(f"backend {worker.name} joined {host}:{port}", flush=True)
    try:
        return worker.run()
    except KeyboardInterrupt:
        # Graceful operator stop, in two tiers.  First choice: DRAIN — ask
        # the frontend to live-migrate every hosted tile off this worker
        # (digest-certified, zero lost epochs, no node-loss redeploy), keep
        # serving the migration protocol until DRAIN_COMPLETE releases us,
        # and leave rc=0.  The wait is bounded (stop_after) and a second
        # signal skips straight to the abrupt tier.  Fallback (no tiles,
        # refused drain, or timeout): GOODBYE — a deliberate leave the
        # frontend recovers with an immediate checkpoint redeploy instead
        # of waiting out the heartbeat timeout.  Masked so a second signal
        # cannot abort the GOODBYE/close half-way.
        from akka_game_of_life_tpu_torch.runtime.signals import (
            mask_interrupts,
            stop_after,
        )

        t_drain = time.monotonic()
        past_bound = threading.Event()

        def give_up() -> None:
            past_bound.set()
            worker.stop()

        requested = worker.request_drain()
        if requested:
            print(
                f"backend {worker.name} draining: handing "
                f"{len(worker.tiles)} tile(s) back",
                flush=True,
            )
            try:
                with stop_after(_DRAIN_TIMEOUT_S, give_up):
                    worker.run()
            except KeyboardInterrupt:
                pass  # second signal: give up on the drain, leave now
        with mask_interrupts():
            worker.stop()
        if worker.stopped_reason == "drained":
            print(f"backend {worker.name} drained; leaving", flush=True)
            return 0
        if worker.stopped_reason == "shutdown":
            # The run finished while we were draining: the frontend's
            # clean cluster SHUTDOWN reached us before DRAIN_COMPLETE
            # could (the planner stops once the run is done).  Nothing
            # was lost and nothing redeployed — a clean exit, same as
            # every other worker's.
            print(f"backend {worker.name} shut down mid-drain; leaving", flush=True)
            return 0
        # Port-only: say why the drain failed and how long it ran.
        why = (
            f"past the {_DRAIN_TIMEOUT_S:g} s drain bound" if past_bound.is_set()
            else "no drain requested" if not requested
            else "stopped before DRAIN_COMPLETE"
        )
        print(
            f"backend {worker.name} drain failed: stopped_reason="
            f"{worker.stopped_reason} ({why}) after "
            f"{time.monotonic() - t_drain:.3f} s draining; exit 130",
            flush=True,
        )
        return 130
    finally:
        if dumper is not None:
            dumper.final()
        if trace_file:
            try:
                tracer.write(trace_file)
            except OSError as e:
                print(f"trace-file write failed: {e}", flush=True)
        if server is not None:
            server.close()
        events.emit("backend_stopped", reason=worker.stopped_reason)
        events.close()
