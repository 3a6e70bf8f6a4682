"""Standalone simulation driver: config → board → stepper → observer.

Counterpart of ``akka_game_of_life_tpu/runtime/simulation.py`` for one
device or a device mesh driven by one process.  The board lives on the
device in one of three layouts, as in the JAX package:

- ``words``: a binary radius-1 rule on a width that is a multiple of 32,
  (H, W/32) int32 words;
- ``planes``: a Generations or WireWorld rule on such a width, (m, H, W/32)
  int32 bit planes, m = ceil(log2 S);
- ``dense``: everything else — Larger-than-Life, odd widths, an explicit
  ``kernel=dense`` or ``kernel=matmul`` — one uint8 per cell;
- ``sparse_kernel``: the dense cells as a host numpy array, which the
  activity-gated engine (``ops/sparse.py``) updates in place; only the
  active blocks' slabs (or, on a boiling board, the whole board) step on
  the device;
- ``backend = "actor"`` / ``"actor-native"``: the dense cells as a host
  numpy array stepped by the per-cell actor engine
  (``runtime/actor_engine.py``, or its C++ twin in ``native/``, built with
  g++), the reference's own architecture (BASELINE config 1).  It is a host
  engine by definition, as in the JAX package: it builds no device state,
  observes on the CPU and ignores ``device``; a mesh, several processes,
  ``sparse_kernel``, a kernel other than ``auto`` and the fast-forward are
  refused by name.

Every ``steps_per_call`` generations the run observes on the device
(population of state 1, strided sample, probe window, digest) and
checkpoints the layout it holds (words as layout 2, planes as layout 3,
dense boards as layout 1/0) at ``checkpoint_every``.  A run resumes from
the newest checkpoint in ``checkpoint_dir``, whichever package wrote it.

Kernel choice (:meth:`Simulation._resolve_kernel`):

=====================================  ===============  =====================
rule                                   auto / pallas    explicit plain opt-in
=====================================  ===============  =====================
binary, width % 32 == 0                packed sweep     ``bitpack``
Generations / WireWorld, width % 32    plane sweep      ``bitpack``
LtL box                                LtL step         ``dense``
LtL diamond                            plain dense (``auto``/``dense``; ``pallas`` raises)
any rule, width not a multiple of 32   plain dense (``auto``; ``bitpack``/``pallas`` raise)
=====================================  ===============  =====================

``kernel=dense`` runs any rule on the dense layout; ``bitpack`` raises for
LtL.  ``kernel=matmul`` runs any box-neighbourhood rule on one device
through the banded matrix products (``ops/matmul_stencil.py``; the plan is
priced through the guard when the run is built, so a diamond rule, a window
that wraps onto itself or an over-cap board raises there).
``sparse_kernel`` takes radius-1 rules under ``auto`` or ``dense`` on one
device.  This differs from the JAX package's ``auto`` on a TPU, which keeps
Generations on the XLA plane scan and LtL on XLA: the results are equal bit
for bit, and on the card the plain versions are no path at all, so ``auto``
takes the kernels.

:meth:`Simulation.fast_forward` jumps an XOR-linear rule's board T epochs in
O(log T) roll passes on its device (``ops/fastforward.py``), after
certifying ``ff_certify_steps`` of them against the dense stepper; packed
boards are unpacked, jumped and repacked, the sparse host board is copied
to the device and back.

The devices are the caller's choice: every visible card unless a device
(``"cpu"``, ``"cuda:1"``) or a sequence of devices is passed; a sequence may
repeat a device.  On a CUDA device the kernels step the board; one that
fails to build or launch raises.  On the CPU the same wrappers run their
plain versions.  Nothing falls back.

**The mesh** (the JAX package's rule): the board is sharded over a
(rows, cols) :class:`~..parallel.mesh.GridMesh` when ``mesh_shape`` is set,
or when there are several devices and the kernel has a sharded form (every
kernel but ``pallas`` with LtL).  Packed boards auto-mesh as rows (n, 1),
dense boards as square as the device count allows.  The board is then a
list of tiles, one per mesh slot, stepped by

=================  ===============================  ============================
layout             auto / pallas                    bitpack / dense
=================  ===============================  ============================
words              ``sharded_sweep_step_fn``        ``sharded_packed2d_step_fn``
planes             ``sharded_gen_sweep_step_fn``    ``sharded_gen_step_fn``
dense              ``halo.sharded_step_fn`` (LtL, odd widths, ``kernel=dense``)
=================  ===============================  ============================

``auto`` takes the dense layout on a mesh that does not divide the packed
board; LtL on a mesh steps dense (the LtL kernel has no sharded form, as in
the JAX package), and ``kernel=pallas`` with LtL and a ``mesh_shape``
raises.  Population, samples and probe windows are cut from the tiles that
hold them, the digest folds per-tile lanes (``parallel/digest.py``), and a
checkpoint gathers the layout to the host and saves what a single-device
run saves, so any run resumes any other, meshed or not, in either package.

**Several processes** (``distributed``, the JAX package's ``run
--distributed``): the process group is joined before any device query and
before the store is built (``parallel/distributed.py``), and the mesh's
slots are every process's devices, rank-major; each process places, steps,
observes and saves only its own tiles, and the halo strips that cross
processes travel through ``parallel/halo.py:ring_shift``.  Every rank posts
the same collectives in the same order: the digest lanes, the populations
and the sampled cells are all-gathered at each cadence point, so every rank
folds the same numbers, and rank 0 alone prints them, writes the metrics
file, the trace file and the summary.  The npz checkpoint digests the board
first (a collective), then rank 0 gathers the layout from the others and
writes it while they wait at a ``ckpt-E`` barrier, synchronously (the
writer thread is for one process); the ``orbax`` store saves each rank's
tiles itself, with no gather.  Fault injection runs on the epoch-indexed
schedule only, in lockstep: every rank crashes at the same epoch, restores
from the shared store and replays; the wall-clock schedule and the
fast-forward are refused, as in the JAX package.

**The tile.** Under ``kernel=pallas`` the CUDA kernels run the
``pallas_block_rows`` variant of their tile (``tune``'s answer, one library
per tile); ``kernel=auto`` and an unset ``pallas_block_rows`` run the
kernels' own tiles.  A tile whose strips would pass the grid's 65535 rows of
blocks raises when the run is built.

**The run's machinery** is the JAX package's: the metrics registry, the span
tracer and its flight recorder, the JSONL event log and the metrics-file
dump (``registry=`` / ``tracer=`` for embedders), its spans on a running
``torch.profiler``'s timeline, each part of a cadence observation also in
``gol_span_seconds``; ``tick_s`` pacing; fault
injection with deterministic replay from the newest checkpoint
(``crash_log``); deferred observation (``obs_defer``: each cadence record's
device results are copied into pinned host buffers without blocking and read
one chunk later, after the next chunk's launches are queued); and
checkpoints written on one writer thread, at most one in flight
(``checkpoint_async``; ``flush()`` makes them durable, a write error surfaces
at the next wait).  A single device hands the writer the board tensor, which
no later chunk writes (every stepper returns a fresh tensor), so the copy to
the host runs on the writer thread too; a mesh gathers its tiles on the host
first.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.models.registry import get_model
from akka_game_of_life_tpu_torch.obs import (
    EventLog,
    MetricsDumper,
    get_registry,
    get_tracer,
)
from akka_game_of_life_tpu_torch.obs.programs import get_programs
from akka_game_of_life_tpu_torch.ops import (
    bitpack,
    bitpack_gen,
    digest as odigest,
    gen_sweep,
    ltl_sweep,
    packed_sweep,
)
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
from akka_game_of_life_tpu_torch.parallel import digest as pdigest
from akka_game_of_life_tpu_torch.parallel import distributed as pdist
from akka_game_of_life_tpu_torch.parallel import halo, mesh as pmesh
from akka_game_of_life_tpu_torch.parallel.packed_halo2d import (
    sharded_gen_step_fn,
    sharded_packed2d_step_fn,
    word_halo_width,
)
from akka_game_of_life_tpu_torch.parallel.sweep_halo import (
    sharded_gen_sweep_step_fn,
    sharded_sweep_step_fn,
)
from akka_game_of_life_tpu_torch.runtime import profiling
from akka_game_of_life_tpu_torch.runtime.chaos import CrashInjector
from akka_game_of_life_tpu_torch.runtime.checkpoint import make_store
from akka_game_of_life_tpu_torch.runtime.config import (
    SimulationConfig,
    cluster_keys_set,
)
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver, sample_strides
from akka_game_of_life_tpu_torch.utils.patterns import (
    place,
    random_grid,
    resolve_pattern,
)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    wanted and absent (the run never moves to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch version on the CPU"
        )
    return dev


def resolve_devices(device=None) -> List[torch.device]:
    """The devices a run may use: every visible card for ``None`` or
    ``"cuda"``, the one device named otherwise, or each of a sequence
    (repeats allowed).  Raises where CUDA is wanted and absent."""
    if device is None or str(device) == "cuda":
        resolve_device("cuda")
        return pmesh.visible_devices()
    if isinstance(device, (str, torch.device)):
        return [resolve_device(device)]
    devices = [resolve_device(d) for d in device]
    if not devices:
        raise ValueError("no devices given")
    return devices


def _cuda_ordinals(device) -> Optional[List[int]]:
    """The CUDA ordinals a ``device`` argument names, read from its spelling
    alone (no device query): None for every visible card, [] for none."""
    if device is None or str(device) == "cuda":
        return None
    names = [device] if isinstance(device, (str, torch.device)) else list(device)
    devs = [torch.device(d) for d in names]
    return sorted({d.index or 0 for d in devs if d.type == "cuda"})


def _pattern(config: SimulationConfig) -> np.ndarray:
    pattern, declared = resolve_pattern(config.pattern)
    if declared is not None:
        try:
            mismatch = (
                resolve_rule(declared).rulestring()
                != resolve_rule(config.rule).rulestring()
            )
        except ValueError:
            mismatch = True
        if mismatch:
            logging.getLogger(__name__).warning(
                "pattern %s declares rule %r but this run uses %r",
                config.pattern,
                declared,
                config.rule,
            )
    return pattern


def initial_board(config: SimulationConfig) -> np.ndarray:
    """The dense (H, W) uint8 start board: the pattern at ``pattern_offset``
    on an empty torus, else a seeded random board."""
    if config.pattern is not None:
        board = np.zeros(config.shape, dtype=np.uint8)
        return place(board, _pattern(config), config.pattern_offset)
    return random_grid(config.shape, density=config.density, seed=config.seed)


def _packed_start(config: SimulationConfig, pack: Callable) -> np.ndarray:
    """The start board packed by ``pack`` (words or planes).  A pattern
    board packs only the rows the pattern touches, so a 65536² start costs
    its packed size, not a 4 GiB dense board."""
    if config.pattern is None:
        return pack(initial_board(config))
    pattern = _pattern(config)
    h, w = config.shape
    if pattern.shape[0] > h or pattern.shape[1] > w:
        raise ValueError(
            f"pattern {pattern.shape} does not fit board {config.shape}"
        )
    y0, x0 = config.pattern_offset
    strip = pack(place(np.zeros((pattern.shape[0], w), np.uint8), pattern, (0, x0)))
    out = np.zeros(strip.shape[:-2] + (h, w // bitpack.LANE_BITS), dtype=np.uint32)
    out[..., (np.arange(pattern.shape[0]) + y0) % h, :] = strip
    return out


def initial_words(config: SimulationConfig) -> np.ndarray:
    """The start board packed as (H, W/32) uint32 words."""
    return _packed_start(config, bitpack.pack_np)


def initial_planes(config: SimulationConfig, states: int) -> np.ndarray:
    """The start board packed as (m, H, W/32) uint32 bit planes."""
    return _packed_start(config, lambda b: bitpack_gen.pack_gen_np(b, states))


def _crosses(prev_epoch: int, epoch: int, every: int) -> bool:
    """Did the cadence boundary get crossed in (prev_epoch, epoch]?"""
    return every > 0 and (epoch // every) > (prev_epoch // every)


@contextlib.contextmanager
def _shield_sigint():
    """Defer ^C / SIGTERM across a critical section so (board, epoch) never
    tears: an interrupt between the two updates would leave a stepped board
    labelled with the previous epoch, and the interrupt checkpoint would
    save that.  The signals are recorded and re-raised as
    ``KeyboardInterrupt`` at the section's end.  No-op off the main thread;
    C-installed handlers are left alone."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    received = []
    shielded = []
    try:
        for sig in (signal.SIGINT, signal.SIGTERM):
            if signal.getsignal(sig) is None:
                continue
            shielded.append(
                (sig, signal.signal(sig, lambda s, f: received.append(s)))
            )
    except BaseException as e:
        for sig, old_h in shielded:
            signal.signal(sig, old_h)
        if isinstance(e, ValueError):  # no signal support in this context
            yield
            return
        raise
    try:
        yield
    finally:
        for sig, old_h in shielded:
            signal.signal(sig, old_h)
    if received:
        raise KeyboardInterrupt


def _tree_map(fn: Callable, obj):
    """``fn`` on every tensor of nested lists/dicts (None kept)."""
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_tree_map(fn, v) for v in obj]
    return obj if obj is None else fn(obj)


class _HostFetch:
    """Copies of device results into host memory, started without blocking
    (pinned buffers, one CUDA event per device) and read later; CPU
    tensors pass through."""

    def __init__(self, tree) -> None:
        devices = set()

        def start(t: torch.Tensor) -> torch.Tensor:
            if t.device.type != "cuda":
                return t
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            devices.add(t.device)
            return host

        self._tree = _tree_map(start, tree)
        self._events = []
        for dev in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            self._events.append(event)

    def result(self):
        """The copies as numpy arrays, once every copy has landed."""
        for event in self._events:
            event.synchronize()
        return _tree_map(lambda t: t.numpy(), self._tree)


class Simulation:
    """One simulation run on one device or a mesh of them, resumable from
    checkpoints.  ``board`` is a tensor on one device, a list of tiles (one
    per mesh slot, row-major) on a mesh."""

    def __init__(
        self,
        config: SimulationConfig,
        observer: Optional[BoardObserver] = None,
        device=None,
        registry=None,
        tracer=None,
    ) -> None:
        cluster_only = cluster_keys_set(config)
        if cluster_only:
            raise ValueError(
                f"config keys {cluster_only} belong to the cluster and serve "
                f"roles (frontend/backend/serve); the standalone run does not "
                f"honour them"
            )
        self.config = config
        if config.distributed:
            # Before any device query and before the store is built: the
            # ranks exchange their cards' UUIDs here to pick the transport.
            pdist.initialize(
                config.coordinator_address,
                config.num_processes,
                config.process_id,
                local_device_ids=_cuda_ordinals(device),
            )
            if config.fault_injection.enabled and not config.fault_injection.epoch_indexed:
                raise ValueError(
                    "wall-clock fault_injection with distributed=True is "
                    "unsupported: crash points are per-process wall-clock, so "
                    "ranks would replay different epochs and desynchronize "
                    "cross-host collectives.  Use the epoch-indexed schedule "
                    "(fault_injection.first_after_epochs / every_epochs) — "
                    "deterministic in simulation time, so every rank injects "
                    "at the same epoch — or the cluster control plane's "
                    "injector for per-worker chaos."
                )
        self.rank, self.world = pdist.process_info()
        self._actor_cls = self._actor_engine_for(config)
        self._actor = None
        self.devices = (
            [torch.device("cpu")] if self._actor_cls is not None
            else resolve_devices(device)
        )
        # The mesh's slots: every process's devices, rank-major (a
        # collective when there are several processes).
        self._slots, self._owners = pmesh.global_slots(self.devices)
        self.rule = resolve_rule(config.rule)
        self._sparse = None
        if config.sparse_kernel:
            self._sparse = self._sparse_stepper_for(config)
        # The LtL kernel, the banded products and the gated engine have no
        # sharded form: an explicit kernel=pallas for LtL or kernel=matmul
        # pins one device, and with a mesh_shape _resolve_kernel raises.
        unsharded = (
            (config.kernel == "pallas" and self.rule.kind == "ltl")
            or config.kernel == "matmul"
            or self._sparse is not None
        )
        self._use_mesh = (
            config.mesh_shape is not None
            or self.world > 1
            or (len(self.devices) > 1 and not unsharded)
        )
        if self._actor_cls is not None:
            self.kernel = config.backend
        elif self._sparse is not None:
            # The gated engine owns the layout (dense cells on the host).
            if config.kernel not in ("auto", "dense"):
                raise ValueError(
                    f"sparse_kernel steps the dense-layout gated engine; "
                    f"kernel={config.kernel!r} conflicts (use auto or dense)"
                )
            self.kernel = "sparse"
        else:
            self.kernel = self._resolve_kernel()
        if self.kernel in ("dense", "ltl_sweep", "matmul", "sparse", "actor", "actor-native"):
            self.layout = "dense"
        else:
            self.layout = "words" if self.rule.is_binary else "planes"
        # kernel=pallas runs the configured tile variant; auto the kernels'
        # own tiles (MEASURED_TILE_ROWS).
        self.tile_rows = (
            config.pallas_block_rows
            if config.kernel == "pallas" and self.kernel.endswith("sweep")
            else None
        )
        self._check_tile()
        self.mesh: Optional[pmesh.GridMesh] = None
        if self._use_mesh:
            if self.layout == "dense":
                self.mesh = self._make_mesh(config.mesh_shape)
                pmesh.tile_shape(config.shape, self.mesh)
                halo.validate_tile_shape(
                    self.mesh, config.shape, config.halo_width, self.rule.radius
                )
            else:
                self.mesh = self._make_mesh(self._packed_mesh_shape())
                if self.kernel == "bitpack":
                    self._validate_packed_mesh()
        # Observability, once the run is known to be valid: the process-wide
        # registry and tracer unless the embedder passes its own; events
        # append to the JSONL log; the flight ring dumps on injected crashes.
        self.metrics = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self._m_obs_seconds = self.metrics.histogram("gol_obs_seconds")
        self._m_digest_checks = self.metrics.counter("gol_digest_checks_total")
        self._m_digest_seconds = self.metrics.histogram("gol_digest_seconds")
        self._m_spans = self.metrics.histogram("gol_span_seconds", labelnames=("span",))
        self._node = f"{config.role}:{self.rank}"
        if tracer is None:
            # Nodeless spans (checkpoint IO on the writer thread) carry
            # this run's label, and across processes the transport.
            self.tracer.node = (
                self._node if self.world == 1
                else f"{self._node}/{pdist.transport()}"
            )
        self.tracer.flight.configure(directory=config.flight_dir, node=self._node)
        self.events = EventLog(
            config.log_events, node=self._node, recorder=self.tracer.flight
        )
        self._metrics_dumper = (
            MetricsDumper(self.metrics, config.metrics_file)
            if config.metrics_file
            else None
        )
        self.device = self.devices[0]
        self.observer = observer or BoardObserver(
            render_every=config.render_every,
            render_max_cells=config.render_max_cells,
            metrics_every=config.metrics_every,
            log_file=config.log_file,
            registry=self.metrics,
        )
        if self.world > 1 and self.rank == 0:
            print(
                f"distributed: {pdist.describe()}, mesh {self.mesh.shape} "
                f"of {self.mesh.size} slots",
                file=self.observer.out,
                flush=True,
            )
        self.store = (
            make_store(
                config.checkpoint_dir,
                config.checkpoint_format,
                registry=self.metrics,
                tracer=self.tracer,
            )
            if config.checkpoint_dir is not None
            else None
        )
        # Async saves: at most one in flight on one writer thread; the
        # pending entry is (future, epoch), drained by _ckpt_wait().
        self._ckpt_executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._ckpt_pending = None
        if config.fault_injection.enabled and self.store is None:
            raise ValueError(
                "fault injection requires checkpoint_dir: a crash with no "
                "checkpoint to recover from would only restart from epoch 0"
            )
        self.injector = (
            CrashInjector(
                config.fault_injection,
                registry=self.metrics,
                flight=self.tracer.flight,
            )
            if config.fault_injection.enabled
            else None
        )
        self.crash_log: List[int] = []  # epochs at which injected crashes hit
        # obs_defer: cadence records dispatched, not yet read.
        self._pending_obs: List[dict] = []
        self._steppers: Dict[int, Callable] = {}
        self._digest = None
        self.epoch = 0
        self.board = self._place(self._start_payload())

    @property
    def _host(self) -> bool:
        """The board is a host numpy array (the gated or an actor engine)."""
        return self._sparse is not None or self._actor_cls is not None

    def _actor_engine_for(self, config: SimulationConfig):
        """The per-cell actor board class for ``backend`` (None for the
        stencil kernels), after the JAX package's checks; what it would
        silently ignore is refused by name."""
        if config.backend == "tpu":
            return None
        if config.sparse_kernel:
            raise ValueError(
                "sparse_kernel gates the stencil kernels; the per-cell "
                "actor backends have no block structure to gate"
            )
        if config.mesh_shape is not None or config.distributed or self.world > 1:
            raise ValueError(
                f"backend={config.backend!r} is one host engine: unset "
                f"mesh_shape/distributed (a mesh shards the stencil kernels)"
            )
        if config.kernel != "auto":
            raise ValueError(
                f"kernel={config.kernel!r} selects a stencil kernel; "
                f"backend={config.backend!r} steps the per-cell actor engine"
            )
        if config.backend == "actor-native":
            from akka_game_of_life_tpu_torch.native.engine import NativeActorBoard

            return NativeActorBoard
        from akka_game_of_life_tpu_torch.runtime.actor_engine import ActorBoard

        return ActorBoard

    def _sparse_stepper_for(self, config: SimulationConfig):
        """The gated engine for ``sparse_kernel``, after the JAX package's
        checks, in its order: a bad combination fails here, naming the
        knob, never mid-advance."""
        from akka_game_of_life_tpu_torch.ops.sparse import SparseStepper, pick_block

        if self.rule.radius != 1:
            raise ValueError(
                f"sparse_kernel gates radius-1 rules; {self.rule} "
                f"(radius {self.rule.radius}) runs dense"
            )
        if config.mesh_shape is not None or config.distributed or self.world > 1:
            raise ValueError(
                "sparse_kernel is a single-host engine (the gather/"
                "scatter runs on the host board); unset mesh_shape/"
                "distributed or disable sparse_kernel"
            )
        if config.obs_defer:
            raise ValueError(
                "sparse_kernel updates its host board in place between "
                "chunks, so a deferred observation's handles could "
                "alias mutated memory; obs_defer is a device-fetch "
                "optimization the host engine does not need — disable "
                "one of the two"
            )
        eff_block = pick_block(config.height, config.width, config.sparse_block)
        if config.steps_per_call > eff_block:
            raise ValueError(
                f"steps_per_call={config.steps_per_call} exceeds the "
                f"effective sparse block ({eff_block} cells for "
                f"{config.height}x{config.width} with sparse_block="
                f"{config.sparse_block}): the one-ring block dilation "
                f"would miss influence"
            )
        return SparseStepper(
            self.rule,
            config.shape,
            block=config.sparse_block,
            threshold=config.sparse_threshold,
            device=self.devices[0],
        )

    def _resolve_kernel(self) -> str:
        """The stepper for this rule and width (module docstring tables):
        ``sweep``, ``gen_sweep`` or ``ltl_sweep`` (the CUDA kernels on a
        CUDA device), ``matmul`` (the banded products), or the plain
        ``bitpack`` and ``dense`` steppers."""
        cfg, rule = self.config, self.rule
        kernel = cfg.kernel
        if kernel == "matmul":
            from akka_game_of_life_tpu_torch.ops import matmul_stencil

            if self._use_mesh:
                raise ValueError(
                    "kernel=matmul is single-device (no sharded form); "
                    "use kernel=dense on a mesh"
                )
            # Planned and priced here, so an infeasible run fails when it
            # is built, naming the knob.
            matmul_stencil.plan_matmul(
                cfg.shape, rule.radius, "auto", rule.neighborhood,
                self.devices[0].type,
            )
            return kernel
        if rule.kind == "ltl":
            if kernel == "bitpack":
                raise ValueError(
                    f"kernel=bitpack supports totalistic and wireworld rules "
                    f"only; {rule} runs on kernel=dense (or kernel=pallas "
                    f"for box neighborhoods)"
                )
            if rule.neighborhood != "box":
                if kernel == "pallas":
                    raise ValueError(
                        "kernel=pallas for ltl supports box neighborhoods only "
                        "(the diamond runs the cumsum path on kernel=dense)"
                    )
                return "dense"
            if kernel == "pallas" and self._use_mesh:
                raise ValueError(
                    "kernel=pallas for ltl is single-device (no sharded "
                    "form); use kernel=dense on a mesh"
                )
            return "dense" if kernel == "dense" or self._use_mesh else "ltl_sweep"
        if kernel == "dense":
            return "dense"
        if cfg.width % bitpack.LANE_BITS:
            if kernel == "auto":
                return "dense"
            raise ValueError(
                f"kernel={kernel} requires width % 32 == 0, got {cfg.width}"
            )
        if kernel == "bitpack":
            return "bitpack"
        if self._use_mesh and not self._packed_mesh_divides():
            if kernel == "auto":
                return "dense"
            if cfg.mesh_shape is not None or self.world > 1:
                raise ValueError(
                    f"kernel=pallas on a {self._packed_mesh_shape()} mesh: the "
                    f"packed grid ({cfg.height} rows x {cfg.width // 32} "
                    f"words) does not divide evenly into its tiles"
                )
            # No mesh was asked for: the sweep runs on one device.
            self._use_mesh = False
        return "sweep" if rule.is_binary else "gen_sweep"

    def _check_tile(self) -> None:
        """Refuse a ``pallas_block_rows`` tile the kernel cannot take (the
        grid's rows of tiles), before any board is placed."""
        if self.tile_rows is None:
            return
        cfg = self.config
        k = min(cfg.steps_per_call, packed_sweep.DEFAULT_STEPS_PER_SWEEP)
        if self.kernel == "sweep":
            packed_sweep.check_tile(self.tile_rows, k, cfg.height)
        elif self.kernel == "gen_sweep":
            gen_sweep.check_tile(self.tile_rows, k, cfg.height)
        else:
            ltl_sweep.check_tile(self.tile_rows, self.rule.radius, cfg.height)

    def _packed_mesh_shape(self) -> Tuple[int, int]:
        return self.config.mesh_shape or (len(self._slots), 1)

    def _make_mesh(self, shape: Optional[Tuple[int, int]]) -> pmesh.GridMesh:
        """The mesh over every process's slots; ``None`` factors their
        count as square as possible."""
        shape = shape or pmesh.factor_2d(len(self._slots))
        return pmesh.GridMesh(shape, self._slots, self._owners)

    def _packed_mesh_divides(self) -> bool:
        cfg = self.config
        rows, cols = self._packed_mesh_shape()
        return not (cfg.height % rows or (cfg.width // bitpack.LANE_BITS) % cols)

    def _validate_packed_mesh(self) -> None:
        """The plain sharded packed step needs tiles at least as deep as
        its halo (``halo_width`` rows, ``word_halo_width`` words)."""
        cfg = self.config
        rows, cols = self._packed_mesh_shape()
        s = self._halo_for(cfg.steps_per_call)
        if not self._packed_mesh_divides() or (
            cfg.height // rows < s
            or (cfg.width // bitpack.LANE_BITS) // cols < word_halo_width(s)
        ):
            raise ValueError(
                f"packed grid ({cfg.height} rows x {cfg.width // 32} words) "
                f"cannot shard over mesh {(rows, cols)} with {s} steps per "
                f"exchange; use kernel=dense or a different mesh"
            )

    def _halo_for(self, k: int) -> int:
        """Steps per exchange of a k-step chunk on the plain sharded paths:
        ``halo_width``, lowered to a divisor of k."""
        halo_w = min(self.config.halo_width, k)
        while k % halo_w:
            halo_w -= 1
        return halo_w

    def _pack(self, board: np.ndarray) -> np.ndarray:
        """A dense host board in this run's layout."""
        if self.layout == "words":
            return bitpack.pack_np(board)
        if self.layout == "planes":
            return bitpack_gen.pack_gen_np(board, self.rule.states)
        return board

    def _start_payload(self) -> np.ndarray:
        """The host board in this run's layout: the newest checkpoint's
        (setting ``epoch``), else the configured start."""
        cfg = self.config
        if self.store is not None and self.store.latest_epoch() is not None:
            return self._restore()
        if self.layout == "words":
            return initial_words(cfg)
        if self.layout == "planes":
            return initial_planes(cfg, self.rule.states)
        return initial_board(cfg)

    def _restore(self) -> np.ndarray:
        """The newest checkpoint in this run's layout; sets ``epoch``."""
        cfg = self.config
        h, w = cfg.shape
        expect = {
            "words": (h, w // bitpack.LANE_BITS),
            "planes": (bitpack_gen.n_planes(self.rule.states), h, w // bitpack.LANE_BITS),
            "dense": (h, w),
        }[self.layout]
        ckpt = self.store.load(keep_packed=self.layout != "dense")
        if ckpt.packed32 is not None:
            payload = ckpt.packed32
        else:
            if ckpt.board.shape != cfg.shape:
                raise ValueError(
                    f"checkpoint shape {ckpt.board.shape} != config {cfg.shape}"
                )
            payload = self._pack(ckpt.board)
        if payload.shape != expect:
            raise ValueError(
                f"checkpoint {self.layout} shape {payload.shape} != config {expect}"
            )
        self.epoch = ckpt.epoch
        return payload

    def _place(self, payload: np.ndarray):
        """A host payload on the run's device(s); the gated and the actor
        engines' boards stay on the host.  An actor board is built afresh
        from the payload at the current epoch (a supervision restart)."""
        if self._actor_cls is not None:
            self._actor = self._actor_cls(payload, self.rule)
            self._actor_epoch0 = self.epoch  # the actor engine counts from 0
        if self._host:
            return np.ascontiguousarray(payload, dtype=np.uint8)
        if self.mesh is not None:
            # Every rank holds the whole host payload; each places its own
            # tiles.
            return pdist.make_global_array(payload, self.mesh)
        if self.layout == "dense":
            return torch.from_numpy(np.ascontiguousarray(payload, np.uint8)).to(self.device)
        return bitpack.words_from_numpy(payload, self.device)

    def _stepper(self, k: int) -> Callable:
        if k not in self._steppers:
            if self._actor_cls is not None:
                self._steppers[k] = self._actor_advance(k)
            elif self._sparse is not None:
                self._steppers[k] = self._sparse_advance(k)
            elif self.mesh is None:
                self._steppers[k] = self._single_stepper(k)
            else:
                self._steppers[k] = self._mesh_stepper(k)
        return self._steppers[k]

    def _actor_advance(self, k: int) -> Callable:
        """A k-epoch chunk of the actor engine's event loop; its history
        below the new epoch is pruned (recovery rebuilds the engine from a
        checkpoint and never replays in place)."""

        def advance(_board: np.ndarray) -> np.ndarray:
            target = self.epoch - self._actor_epoch0 + k
            self._actor.advance_to(target)
            self._actor.prune_histories_below(target - 1)
            return self._actor.board_at_current()

        return advance

    def _sparse_advance(self, k: int) -> Callable:
        """A k-epoch chunk of the gated engine, with its gauges after
        every chunk: the active blocks, and the stepped and skipped
        block-chunks (the skips are the engine's whole point)."""
        sp = self._sparse
        active_g = self.metrics.gauge("gol_sparse_active_blocks")
        stepped_c = self.metrics.counter("gol_sparse_blocks_stepped_total")
        skipped_c = self.metrics.counter("gol_sparse_blocks_skipped_total")
        dense_c = self.metrics.counter("gol_sparse_dense_chunks_total")

        def advance(board: np.ndarray) -> np.ndarray:
            dense_before = sp.dense_chunks
            out = sp.step(board, k)
            active_g.set(sp.last_active_blocks)
            stepped_c.inc(sp.last_stepped_blocks)
            skipped_c.inc(sp.total_blocks - sp.last_stepped_blocks)
            if sp.dense_chunks > dense_before:
                dense_c.inc()
            return out

        return advance

    def _single_stepper(self, k: int) -> Callable:
        rule, tile = self.rule, self.tile_rows
        if self.kernel == "matmul":
            from akka_game_of_life_tpu_torch.ops import matmul_stencil

            return matmul_stencil.matmul_multi_step_fn(rule, k, "auto", self.device)
        if self.kernel == "sweep":
            return packed_sweep.packed_multi_step_fn(rule, k, tile_rows=tile)
        if self.kernel == "gen_sweep":
            return gen_sweep.gen_multi_step_fn(rule, k, tile_rows=tile)
        if self.kernel == "ltl_sweep":
            return ltl_sweep.ltl_multi_step_fn(rule, k, tile_rows=tile)
        if self.kernel == "bitpack" and self.layout == "words":
            return bitpack.packed_multi_step_fn(rule, k)
        if self.kernel == "bitpack":
            return bitpack_gen.gen_multi_step_fn(rule, k)
        return get_model(rule).run(k)

    def _mesh_stepper(self, k: int) -> Callable:
        mesh, rule, tile = self.mesh, self.rule, self.tile_rows
        if self.kernel == "sweep":
            return sharded_sweep_step_fn(mesh, rule, steps_per_call=k, tile_rows=tile)
        if self.kernel == "gen_sweep":
            return sharded_gen_sweep_step_fn(mesh, rule, steps_per_call=k, tile_rows=tile)
        if self.kernel == "bitpack" and self.layout == "words":
            return sharded_packed2d_step_fn(
                mesh, rule, steps_per_call=k, halo_rows=self._halo_for(k)
            )
        if self.kernel == "bitpack":
            return sharded_gen_step_fn(
                mesh, rule, steps_per_call=k, halo_rows=self._halo_for(k)
            )
        return halo.sharded_step_fn(
            mesh, rule, steps_per_call=k, halo_width=self._halo_for(k)
        )

    # -- core loop -----------------------------------------------------------

    def advance(self, epochs: Optional[int] = None) -> int:
        """Advance by exactly ``epochs`` generations (default:
        config.max_epochs), in chunks of ``steps_per_call``; pacing, fault
        injection, observation and checkpoints happen between chunks."""
        cfg = self.config
        target = self.epoch + (epochs if epochs is not None else (cfg.max_epochs or 0))
        self.observer.start_clock(self.epoch)
        epochs_c = self.metrics.counter("gol_epochs_advanced_total")
        chunks_c = self.metrics.counter("gol_chunks_total")
        step_h = self.metrics.histogram("gol_step_seconds")
        epoch_g = self.metrics.gauge("gol_epoch")
        next_tick = time.monotonic()
        advance_span = self.tracer.span(
            "sim.advance", node=self._node,
            from_epoch=self.epoch, epochs=target - self.epoch,
        )
        advance_span.__enter__()
        try:
            while self.epoch < target:
                if cfg.tick_s > 0:
                    now = time.monotonic()
                    if now < next_tick:
                        time.sleep(next_tick - now)
                    next_tick = max(next_tick + cfg.tick_s, now)
                if self.injector is not None and (
                    self.injector.should_crash()
                    or self.injector.should_crash_at_epoch(self.epoch)
                ):
                    self._crash_and_recover()
                chunk = min(cfg.steps_per_call, target - self.epoch)
                prev = self.epoch
                chunk_t0 = time.perf_counter()
                with self.tracer.span(
                    "sim.chunk", node=self._node, epoch=prev, chunk=chunk
                ):
                    if self._sparse is not None:
                        # The gated engine writes the host board in place:
                        # shield the whole chunk, or an interrupt mid-scatter
                        # would checkpoint a half-stepped board.
                        with _shield_sigint():
                            self.board = self._stepper(chunk)(self.board)
                            self.epoch += chunk
                    else:
                        new_board = self._stepper(chunk)(self.board)
                        with _shield_sigint():
                            # Atomic with respect to ^C: an interrupt
                            # checkpoint never sees a stepped board labelled
                            # with the previous epoch.
                            self.board = new_board
                            self.epoch += chunk
                step_h.observe(time.perf_counter() - chunk_t0)
                epochs_c.inc(chunk)
                chunks_c.inc()
                epoch_g.set(self.epoch)
                # Deferred records of earlier cadence points are read now,
                # with this chunk's launches already queued on the card.
                self._obs_resolve()
                render = _crosses(prev, self.epoch, cfg.render_every)
                if render or _crosses(prev, self.epoch, cfg.metrics_every):
                    self._observe(render=render)
                if _crosses(prev, self.epoch, cfg.metrics_every):
                    self._dump_metrics()
                if self.store is not None and _crosses(
                    prev, self.epoch, cfg.checkpoint_every
                ):
                    self.checkpoint()
        except BaseException:
            # Best effort on the way out: a failed read must not replace the
            # real exception (or swallow a KeyboardInterrupt on its way to
            # the interrupt checkpoint).
            with contextlib.suppress(Exception):
                self._obs_resolve()
            raise
        finally:
            advance_span.set(reached=self.epoch).__exit__(None, None, None)
        # A cadence point on the last chunk has no next chunk to ride under.
        self._obs_resolve()
        return self.epoch

    def fast_forward(self, epochs: int) -> int:
        """Jump ``epochs`` generations in O(log epochs) roll passes on the
        board's device: XOR-linear (odd-rule) rules only
        (``ops/fastforward.py``).  Before the jump commits,
        ``ff_certify_steps`` epochs are certified jump against iterate by
        digest.  The checks run in the JAX package's order: the span, then
        ``ff_enabled``, then linearity, each a ``ValueError``."""
        from akka_game_of_life_tpu_torch.ops import fastforward

        cfg = self.config
        # The span first: refuse before the relayout and the certification
        # do any work.
        epochs = fastforward._require_span(epochs)
        if epochs == 0:
            return self.epoch
        if not cfg.ff_enabled:
            raise ValueError(
                "fast_forward is disabled (ff_enabled=False / --ff-enabled "
                "off); advance() iterates as usual"
            )
        fastforward.kernel_offsets(self.rule)  # the linearity refusal
        if self._actor_cls is not None:
            raise ValueError(
                "fast_forward needs the tpu backend's dense planes; the "
                "per-cell actor backends iterate"
            )
        if self.world > 1:
            raise ValueError(
                "fast_forward is single-host (a meshed jump gathers the "
                "board through this host and re-shards; a cross-host "
                "gather has no collective form yet) — run single-host or "
                "iterate"
            )
        t0 = time.perf_counter()
        with self.tracer.span(
            "sim.fastforward", node=self._node, epoch=self.epoch, epochs=epochs
        ) as span:
            board = self._dense_board()
            cert = min(epochs, cfg.ff_certify_steps)
            if cert:
                dig_t0 = time.perf_counter()
                try:
                    digest = fastforward.certify_jump(board, self.rule, cert)
                except RuntimeError:
                    self.metrics.counter("gol_digest_mismatches_total").inc()
                    raise
                self._m_digest_seconds.observe(time.perf_counter() - dig_t0)
                self._m_digest_checks.inc()
                span.set(certified_steps=cert, digest=odigest.format_digest(digest))
            jumped = self._from_dense(fastforward.fast_forward(board, self.rule, epochs))
            # The recorded seconds cover the jump, not its enqueue.
            self._sync()
            with _shield_sigint():
                # Atomic with respect to ^C, as in advance().
                self.board = jumped
                self.epoch += epochs
        self.metrics.counter("gol_ff_jumps_total").inc()
        self.metrics.counter("gol_ff_epochs_total").inc(epochs)
        self.metrics.histogram("gol_ff_seconds").observe(time.perf_counter() - t0)
        self.metrics.gauge("gol_epoch").set(self.epoch)
        self.events.emit("fast_forward", epoch=self.epoch, epochs=epochs)
        return self.epoch

    def _dense_board(self) -> torch.Tensor:
        """The board of a linear (binary) rule as one dense (H, W) uint8
        tensor on the run's device: unpacked there from words, gathered from
        a mesh, copied from the gated engine's host board."""
        if self.mesh is not None or self._host:
            return torch.from_numpy(self.board_host()).to(self.device)
        if self.layout == "words":
            return bitpack.unpack(self.board)
        return self.board

    def _from_dense(self, dense: torch.Tensor):
        """Inverse of :meth:`_dense_board`: the board in this run's
        layout and placement."""
        if self.mesh is not None or self._host:
            return self._place(self._pack(dense.cpu().numpy()))
        if self.layout == "words":
            return bitpack.pack(dense)
        return dense

    def _span(self, name: str, **attrs):
        """A tracer span of this run whose wall seconds also land in
        ``gol_span_seconds{span=name}``."""
        return self.tracer.span(
            name, node=self._node, histogram=self._m_spans.labels(span=name), **attrs
        )

    def _sync(self) -> None:
        devices = self.mesh.distinct_devices() if self.mesh is not None else [self.device]
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _dump_metrics(self) -> None:
        """Refresh the ``--metrics-file`` exposition (atomic, failure
        contained), with the device-memory gauges; rank 0 only."""
        if self._metrics_dumper is None or self.rank != 0:
            return
        with contextlib.suppress(Exception):
            get_programs().refresh_device_gauges()
        self._metrics_dumper.dump()

    def _probe_due(self, render: bool) -> bool:
        cfg = self.config
        return (
            render
            and cfg.probe_window is not None
            and cfg.render_every > 0
            and self.epoch % cfg.render_every == 0
        )

    # -- the board, one tile or a mesh of them ---------------------------------

    def _tiles(self) -> List[torch.Tensor]:
        """The board as device tensors, one per mesh slot.  The gated
        engine's host board is copied to the device (its next chunk writes
        it in place)."""
        if self._host:
            return [torch.from_numpy(self.board).to(self.device, copy=True)]
        return [self.board] if self.mesh is None else list(self.board)

    def _cells_request(
        self, ys: np.ndarray, xs: np.ndarray, tiles: List[Optional[torch.Tensor]]
    ) -> Dict[int, torch.Tensor]:
        """The cells at the global rows ``ys`` × cell columns ``xs`` (sorted
        int arrays), cut on the device from the local tiles that hold them,
        keyed by slot: O(len(ys)·len(xs)) to fetch."""
        rows, cols = self.mesh.shape if self.mesh is not None else (1, 1)
        th, tw = self.config.height // rows, self.config.width // cols
        parts = {}
        for r in range(rows):
            ly = ys[(ys >= r * th) & (ys < (r + 1) * th)] - r * th
            if not len(ly):
                continue
            for c in range(cols):
                lx = xs[(xs >= c * tw) & (xs < (c + 1) * tw)] - c * tw
                tile = tiles[r * cols + c]
                if len(lx) and tile is not None:
                    parts[r * cols + c] = self._tile_cells(tile, ly, lx)
        return parts

    def _join(self, parts: Dict[int, np.ndarray]) -> np.ndarray:
        """Per-slot cell parts (every slot's, after :meth:`_all_ranks`)
        in their mesh places."""
        cols = self.mesh.cols if self.mesh is not None else 1
        bands: Dict[int, List[np.ndarray]] = {}
        for i in sorted(parts):
            bands.setdefault(i // cols, []).append(parts[i])
        return np.concatenate(
            [np.concatenate(bands[r], axis=1) for r in sorted(bands)], axis=0
        )

    def _all_ranks(self, got: dict) -> dict:
        """An observation of this rank's tiles made whole: per-tile
        populations, cell parts (by slot) and digest lanes of every rank,
        in one all-gather of a few kilobytes; unchanged in one process."""
        if self.world == 1:
            return got
        every = pdist.all_gather_object(got)
        out = {}
        for key, value in got.items():
            if value is None:
                out[key] = None
            elif isinstance(value, dict):
                out[key] = {i: v for g in every for i, v in g[key].items()}
            else:
                out[key] = [v for g in every for v in g[key]]
        return out

    def _cells(self, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
        """Host uint8 cells at the global rows ``ys`` × columns ``xs``."""
        if self._host:
            return self.board[np.ix_(ys, xs)]
        got = _HostFetch({"cells": self._cells_request(ys, xs, self._tiles())}).result()
        return self._join(self._all_ranks(got)["cells"])

    def _tile_cells(self, tile: torch.Tensor, ly: np.ndarray, lx: np.ndarray) -> torch.Tensor:
        rows = torch.from_numpy(ly).to(tile.device)
        if self.layout == "dense":
            return tile[rows][:, torch.from_numpy(lx).to(tile.device)]
        if self.layout == "words":
            return bitpack.cells_at(tile, rows, lx)
        view = bitpack.cells_at(tile[0], rows, lx)
        for k in range(1, tile.shape[0]):
            view = view | (bitpack.cells_at(tile[k], rows, lx) << k)
        return view

    def _host_layout(self, dst: Optional[int] = None) -> Optional[np.ndarray]:
        """The board in its layout on the host (packed words and planes as
        uint32), gathered from the tiles on a mesh — O(board).  Across
        processes a collective: on every rank, or on rank ``dst`` only
        (None elsewhere)."""
        if self._host:
            return self.board.copy()
        if self.mesh is not None:
            return pmesh.gather(self.board, self.mesh, dst=dst)
        if self.layout == "dense":
            return self.board.cpu().numpy()
        return bitpack.words_to_numpy(self.board)

    def _populations(self, tiles: List[torch.Tensor]) -> List[torch.Tensor]:
        """Cells in state 1 (alive, or WireWorld's electron heads), one
        device scalar per tile."""
        out = []
        for tile in tiles:
            if tile is None:
                continue
            if self.layout == "dense":
                out.append((tile == 1).sum(dtype=torch.int64))
            else:
                words = tile if self.layout == "words" else bitpack_gen.alive_plane(tile)
                out.append(bitpack.population_rows(words).sum())
        return out

    def _digest_parts(self, tiles: List[torch.Tensor]) -> List[torch.Tensor]:
        """The board digest's (2,) lanes, one part per local tile (their sum
        mod 2³² over every rank's tiles is the digest:
        ``digest.merge_lanes``)."""
        cfg = self.config
        if self.mesh is not None:
            if self._digest is None:
                self._digest = {
                    "words": lambda: pdigest.sharded_packed2d_digest_fn(self.mesh, cfg.shape),
                    "planes": lambda: pdigest.sharded_gen_digest_fn(
                        self.mesh, cfg.shape, self.rule.states
                    ),
                    "dense": lambda: pdigest.sharded_dense_digest_fn(self.mesh, cfg.shape),
                }[self.layout]()
            return self._digest.parts(self.board)
        if self.layout == "words":
            return [odigest.digest_packed(tiles[0], cfg.width)]
        if self.layout == "planes":
            return [odigest.digest_planes(tiles[0], cfg.width)]
        return [odigest.digest_dense(tiles[0])]

    # -- observation -----------------------------------------------------------

    def _observe(self, *, render: bool) -> None:
        """Population (always), a strided sample (at render cadence), the
        probe window and the digest, all computed on the device.  In sync
        mode the clock starts after the stepper's work has finished, so
        ``obs`` on the metrics line is the observation's own cost; under
        ``obs_defer`` the record is only dispatched here."""
        with self._span("sim.observe", epoch=self.epoch):
            if self.config.obs_defer:
                with self._span("obs.dispatch"):
                    self._pending_obs.append(self._obs_dispatch(render))
                return
            with self._span("obs.sync"):
                self._sync()
            t0 = time.perf_counter()
            with self._span("obs.dispatch"):
                rec = self._obs_dispatch(render)
            self._obs_emit(rec, t0)

    def _obs_dispatch(self, render: bool) -> dict:
        """Dispatch the cadence observation on the device and start its
        copies to the host; nothing here reads them.  The digest's row-block
        checks and the pageable uploads of the view's and the probe's
        indices still wait for the card's queue (``obs.dispatch`` holds
        that wait)."""
        cfg = self.config
        strides = sample_strides(cfg.shape, cfg.render_max_cells)
        h, w = cfg.shape
        tiles = self._tiles()
        tree = {
            "pops": self._populations(tiles),
            "view": (
                self._cells_request(
                    np.arange(0, h, strides[0]), np.arange(0, w, strides[1]), tiles
                )
                if render else None
            ),
            "win": None,
            "digest": None,
        }
        if cfg.obs_digest:
            with self.tracer.span(
                "obs.digest", node=self._node, epoch=self.epoch,
                histogram=self._m_digest_seconds,
            ):
                tree["digest"] = self._digest_parts(tiles)
        if self._probe_due(render):
            y0, y1, x0, x1 = cfg.probe_window
            tree["win"] = self._cells_request(np.arange(y0, y1), np.arange(x0, x1), tiles)
        return {"epoch": self.epoch, "strides": strides, "fetch": _HostFetch(tree)}

    def _obs_emit(self, rec: dict, t0: float, on_fetched=None) -> None:
        """Read a dispatched record and emit its observer lines.  ``t0`` is
        where the obs clock started (dispatch in sync mode, the read in
        deferred mode).  ``on_fetched`` runs once the copies have landed,
        before any line is written, so a failed write consumes the record
        rather than repeating it."""
        cfg = self.config
        with self._span("obs.fetch"):
            got = self._all_ranks(rec["fetch"].result())
        if on_fetched is not None:
            on_fetched()
        with self._span("obs.emit") as span:
            digest = None
            if got["digest"] is not None:
                digest = odigest.value(odigest.merge_lanes(got["digest"]))
                span.set(digest=odigest.format_digest(digest))
                self._m_digest_checks.inc()
            population = int(sum(int(p) for p in got["pops"]))
            view = self._join(got["view"]) if got["view"] is not None else None
            win = self._join(got["win"]) if got["win"] is not None else None
            obs_seconds = time.perf_counter() - t0
            self._m_obs_seconds.observe(obs_seconds)
            if self.rank != 0:
                return
            self.observer.observe_summary(
                rec["epoch"],
                population,
                cfg.shape,
                view,
                rec["strides"],
                obs_seconds=obs_seconds,
                digest=digest,
            )
            if win is not None:
                self.observer.observe_window(rec["epoch"], win, cfg.probe_window)

    def _obs_resolve(self) -> None:
        """Emit every pending deferred record, oldest first (a no-op in sync
        mode), each in a ``sim.observe`` of its own."""
        while self._pending_obs:
            with self._span("sim.observe", epoch=self._pending_obs[0]["epoch"]):
                self._obs_emit(
                    self._pending_obs[0],
                    time.perf_counter(),
                    on_fetched=lambda: self._pending_obs.pop(0),
                )

    def board_digest(self) -> int:
        """The 64-bit digest of the current board (~8 fetched bytes per
        tile); a collective across processes."""
        got = _HostFetch({"digest": self._digest_parts(self._tiles())}).result()
        return odigest.value(odigest.merge_lanes(self._all_ranks(got)["digest"]))

    # -- failure and recovery --------------------------------------------------

    def _crash_and_recover(self) -> None:
        """An injected crash: the device board is lost; restore the newest
        checkpoint and replay the missed epochs through the same steppers
        (the rule is deterministic, so the trajectory is the same)."""
        # Deferred records hold copies of the pre-crash board's results,
        # which replay reproduces: emit them before the epoch rewinds.
        self._obs_resolve()
        # A save in flight must land before the restore reads the store.
        self._ckpt_wait()
        target = self.epoch
        self.crash_log.append(target)
        with self.tracer.span("chaos.crash", node=self._node, epoch=target):
            self.events.emit("crash_injected", epoch=target)
            self.board = None  # the crash: live state gone
            self.tracer.flight.dump("crash_injected", node=self._node)
        recover_span = self.tracer.span("chaos.recover", node=self._node, epoch=target)
        recover_span.__enter__()
        restored_epoch = None
        try:
            if self.store.latest_epoch() is not None:
                payload = self._restore()
            else:
                self.epoch = 0
                payload = self._start_payload()
            self.board = self._place(payload)
            restored_epoch = self.epoch
            while self.epoch < target:
                chunk = min(self.config.steps_per_call, target - self.epoch)
                # The gated engine's in-place chunks get the main loop's
                # shield (a torn board must never be checkpointed).
                with _shield_sigint() if self._sparse is not None else contextlib.nullcontext():
                    self.board = self._stepper(chunk)(self.board)
                    self.epoch += chunk
        finally:
            if restored_epoch is not None:
                recover_span.set(
                    restored_from=restored_epoch, replayed=target - restored_epoch
                )
            recover_span.__exit__(None, None, None)
        self.metrics.counter("gol_chaos_recovered_total").inc()
        self.metrics.counter("gol_chaos_replay_epochs_total").inc(target - restored_epoch)
        self.events.emit(
            "crash_recovered",
            epoch=target,
            restored_from=restored_epoch,
            replayed=target - restored_epoch,
        )

    # -- durability ------------------------------------------------------------

    def checkpoint(self) -> None:
        """Save the board of the current epoch in its layout.

        npz: on the writer thread (``checkpoint_async``, at most one save in
        flight, one process only) or before returning; a mesh's tiles are
        gathered on the host first, so the file is the same as a
        single-device run's.  Across processes rank 0 gathers and writes
        while the others send their tiles and wait at the ``ckpt-E``
        barrier.  orbax: the store's async save of this rank's tiles (the
        dispatch is timed), every rank for itself."""
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        cfg = self.config
        meta = {"height": cfg.height, "width": cfg.width}
        if cfg.obs_digest:
            # A collective across processes: before the rank gate.
            meta["digest"] = odigest.format_digest(self.board_digest())
        rule = self.rule.rulestring()
        epoch = self.epoch
        layout = self.layout
        npz = cfg.checkpoint_format == "npz"
        if npz and self.world > 1:
            # One host-side writer owns the file: rank 0 receives the other
            # ranks' tiles.  No rank may run past the epoch before the file
            # is durable: a lockstep crash right after it makes every rank
            # load the store.
            board = self._host_layout(dst=0)
            if self.rank != 0:
                pdist.barrier(f"ckpt-{epoch}")
                return
        elif npz or self._host:
            # Bind the snapshot now: the loop replaces self.board while an
            # async save runs, and no stepper writes the tensor it was
            # given.  The gated engine's host board is the one that is
            # written in place: it is copied (as a mesh is gathered) before
            # the writer sees it.
            board = (
                self._host_layout()
                if self.mesh is not None or self._host
                else self.board
            )
        else:
            board = self.board
        self.events.emit(
            "checkpoint_requested", epoch=epoch, format=cfg.checkpoint_format
        )

        if npz:

            def save() -> None:
                if isinstance(board, np.ndarray):
                    host = board
                elif layout == "dense":
                    host = board.cpu().numpy()
                else:
                    host = bitpack.words_to_numpy(board)
                if layout == "dense":
                    self.store.save(epoch, host, rule, meta=meta)
                else:
                    self.store.save_packed32(epoch, host, cfg.shape, rule, meta=meta)

        else:
            tagged = meta if layout == "dense" else {**meta, "layout": "packed32"}
            mesh = self.mesh if isinstance(board, list) else None

            def save() -> None:
                self.store.save(epoch, board, rule, meta=tagged, mesh=mesh)

        if npz and cfg.checkpoint_async and self.world == 1:
            self._ckpt_wait()
            if self._ckpt_executor is None:
                self._ckpt_executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="ckpt"
                )

            def timed_save() -> float:
                t0 = time.perf_counter()
                save()
                return (time.perf_counter() - t0) * 1e3

            self._ckpt_pending = (self._ckpt_executor.submit(timed_save), epoch)
        elif cfg.metrics_every and self.rank == 0:
            with profiling.timed(
                f"checkpoint@{epoch}",
                out=self.observer.out,
                registry=self.metrics,
                span="checkpoint",
            ):
                save()
        else:
            save()
        if npz and self.world > 1:
            # Rank 0's side of the durability barrier.
            pdist.barrier(f"ckpt-{epoch}")

    def flush(self) -> None:
        """Block until the save in flight (if any) is on disk; raises the
        writer's error here."""
        self._ckpt_wait()
        if self.store is not None:
            self.store.wait()

    def _ckpt_wait(self) -> None:
        """Drain the in-flight save (no-op if none), raising its error on
        the thread that asked for durability."""
        if self._ckpt_pending is None:
            return
        future, epoch = self._ckpt_pending
        self._ckpt_pending = None
        ms = future.result()
        if self.config.metrics_every:
            print(
                f"[profile] checkpoint@{epoch} (async write): {ms:.2f} ms",
                file=self.observer.out,
                flush=True,
            )

    # -- reads -----------------------------------------------------------------

    def board_window(self, y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
        """A (y1-y0, x1-x0) uint8 window of the board, fetched O(window)."""
        if not (0 <= y0 < y1 <= self.config.height):
            raise ValueError(f"bad row window [{y0}, {y1})")
        if not (0 <= x0 < x1 <= self.config.width):
            raise ValueError(f"bad col window [{x0}, {x1})")
        return self._cells(np.arange(y0, y1), np.arange(x0, x1))

    def board_host(self) -> np.ndarray:
        """The full board as host uint8 — O(board); for tests and small
        boards.  Always the caller's own array."""
        board = self._host_layout()
        if self.layout == "words":
            return bitpack.unpack_np(board)
        if self.layout == "planes":
            return bitpack_gen.unpack_gen_np(board)
        return board

    def close(self) -> None:
        """Make the last save durable, then release the writer and write
        the run's final metrics, trace and events."""
        try:
            self._ckpt_wait()
        finally:
            if self._ckpt_executor is not None:
                self._ckpt_executor.shutdown(wait=True)
                self._ckpt_executor = None
            if self.store is not None:
                self.store.close()
            try:
                self._dump_metrics()
                if self.config.trace_file and self.rank == 0:
                    try:
                        self.tracer.write(self.config.trace_file)
                    except OSError as e:
                        print(f"trace-file write failed: {e}", flush=True)
            finally:
                self.events.emit("sim_closed", epoch=self.epoch)
                self.events.close()
                self.observer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
