"""Layered configuration: defaults < file < overrides.

Counterpart of ``akka_game_of_life_tpu/runtime/config.py`` restricted to the
fields the PyTorch port honours: the standalone run's knobs (the device
mesh of one process, the kernels' tile, pacing, fault injection, deferred
observation, the async checkpoint writer and the observability surface) and
the cluster's (the ``frontend`` and ``backend`` roles, the in-process
harness), with the JAX package's names, defaults and checks.  The run spans
processes with ``distributed`` (``coordinator_address``, ``num_processes``,
``process_id``, over ``torch.distributed``), and ``checkpoint_format =
"orbax"`` selects the async per-shard store (``runtime/orbax_store.py``, on
``torch.distributed.checkpoint``; the cluster frontend refuses it, as in
the JAX package).  The standalone
run also takes the linear-rule fast-forward (``ff_enabled``,
``ff_certify_steps``) and activity-gated stepping (``sparse_kernel``,
``sparse_block``, ``sparse_threshold``), and ``backend`` picks the engine
under the standalone run: ``"tpu"`` (the JAX package's name for the
stencil kernels, kept so config files load unchanged) or the per-cell
actor engines ``"actor"`` / ``"actor-native"`` (host engines).  The
single-process serving plane (``role = "serve"``) takes every ``serve_*``
key with the JAX package's defaults and checks; ``serve_cluster = true``
runs the serving cluster (``serve/cluster.py``), and its keys
(``serve_shards``, ``serve_tile_chunk``, ``serve_tiled_resident*``,
``serve_replicate*``) parse and validate as in the JAX package, inert while
it is off; the ``frontend_*`` keys federate several such frontends
(``serve/federation.py``).  ``load_config`` reads the same TOML or JSON
files (``examples/headline-65536.toml`` loads unchanged) and accepts the
same duration spellings ("5s", "3000ms").  A key the port does not
support raises a ``ValueError`` that names it, never a silent default.  A
non-zero ``pallas_vmem_limit_mb`` is refused by name too: the card has no Mosaic VMEM budget (the kernels keep
their tiles in registers and small shared-memory rings).

One default differs from the JAX package on purpose: ``pallas_block_rows``
is ``None``, "the kernel's own tile" (``ops/*_sweep.py:DEFAULT_TILE_ROWS``),
where the JAX package's 64 is a TPU VMEM choice.  A file that sets the key
means the same in both packages: the rows of a kernel block under
``kernel = "pallas"``.  The CUDA kernels wrap every index modulo the torus,
so any positive row count is taken (no multiple-of-8 rule); a tile whose
strips would pass the grid's 65535 rows of blocks raises when the run is
built.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

def parse_size_classes(spec) -> Tuple[int, ...]:
    """``"32,64,256"`` → (32, 64, 256): the serving plane's padded board
    size classes, strictly ascending positive square sides.  Lives here
    (not serve/) so config validation stays import-light —
    :mod:`serve.batch` re-exports it."""
    try:
        classes = tuple(int(v) for v in str(spec).split(","))
    except ValueError:
        raise ValueError(f"unparseable serve size classes: {spec!r}") from None
    if not classes or any(c <= 0 for c in classes) or any(
        b <= a for a, b in zip(classes, classes[1:])
    ):
        raise ValueError(
            f"serve size classes must be strictly ascending positive "
            f"ints, got {spec!r}"
        )
    return classes


# The standalone run's engines: "tpu" (the JAX package's name for the
# stencil kernels, whatever the device) or the per-cell actor engines.
BACKEND_CHOICES = ("tpu", "actor", "actor-native")

# The JAX package's kernel names.  auto/pallas step through the CUDA kernels
# (the packed sweep, the plane sweep, the LtL step; auto runs the dense
# stencil on widths that are not a multiple of 32 and for the LtL diamond),
# bitpack through the plain packed/plane step, dense through the plain dense
# stencil, matmul through the banded matrix products (ops/matmul_stencil.py,
# one device, box neighbourhoods).
KERNEL_CHOICES = ("auto", "dense", "bitpack", "pallas", "matmul")

_DURATION_RE = re.compile(
    r"^\s*(?P<num>\d+(?:\.\d+)?)\s*(?P<unit>ms|milliseconds?|s|seconds?|m|minutes?|h|hours?)?\s*$",
    re.IGNORECASE,
)
_UNIT_SECONDS = {
    "ms": 1e-3, "millisecond": 1e-3, "milliseconds": 1e-3,
    "s": 1.0, "second": 1.0, "seconds": 1.0,
    "m": 60.0, "minute": 60.0, "minutes": 60.0,
    "h": 3600.0, "hour": 3600.0, "hours": 3600.0,
}


def parse_duration(value) -> float:
    """Parse a duration into seconds: 5, 5.0, "5s", "3000ms", "1 second"."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _DURATION_RE.match(str(value))
    if not m:
        raise ValueError(f"unparseable duration: {value!r}")
    unit = (m.group("unit") or "s").lower()
    return float(m.group("num")) * _UNIT_SECONDS[unit]


@dataclasses.dataclass
class FaultInjectionConfig:
    """The scheduled crash injector (the JAX package's knobs): a wall-clock
    schedule (``first_after_s`` then every ``every_s``) or an epoch-indexed
    one (``first_after_epochs`` then every ``every_epochs``), at most
    ``max_crashes`` crashes of one tile (``mode="tile"``) or one whole
    worker (``mode="node"``)."""

    enabled: bool = False
    first_after_s: float = 10.0
    every_s: float = 15.0
    max_crashes: int = 100
    seed: int = 0
    mode: str = "tile"
    first_after_epochs: Optional[int] = None
    every_epochs: Optional[int] = None

    def __post_init__(self) -> None:
        if self.mode not in ("tile", "node"):
            raise ValueError(f"unknown fault injection mode {self.mode!r}")
        if (self.first_after_epochs is None) != (self.every_epochs is None):
            raise ValueError(
                "epoch-indexed injection needs both first_after_epochs and "
                "every_epochs (or neither, for the wall-clock schedule)"
            )
        if self.every_epochs is not None and (
            self.first_after_epochs < 0 or self.every_epochs < 1
        ):
            raise ValueError(
                f"bad epoch schedule: first_after_epochs="
                f"{self.first_after_epochs}, every_epochs={self.every_epochs}"
            )

    @property
    def epoch_indexed(self) -> bool:
        return self.every_epochs is not None


@dataclasses.dataclass
class NetworkChaosConfig:
    """Wire-layer fault injection (the JAX package's knobs): seeded drops,
    delays, duplicates and reorders per message, plus scheduled partitions
    with heal times, on the peer plane, the control plane or both."""

    enabled: bool = False
    seed: int = 0
    drop_p: float = 0.0
    delay_p: float = 0.0
    delay_s: float = 0.02
    duplicate_p: float = 0.0
    reorder_p: float = 0.0
    partition_after_s: float = 10.0
    partition_every_s: float = 30.0
    partition_heal_s: float = 5.0
    max_partitions: int = 0
    scope: str = "peer"

    def __post_init__(self) -> None:
        for name in ("drop_p", "delay_p", "duplicate_p", "reorder_p"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"net chaos {name}={p} must be in [0, 1]")
        if self.delay_s < 0 or self.partition_heal_s < 0:
            raise ValueError("net chaos durations must be >= 0")
        if self.max_partitions < 0:
            raise ValueError(
                f"max_partitions={self.max_partitions} must be >= 0"
            )
        if self.scope not in ("peer", "control", "all"):
            raise ValueError(
                f"unknown net chaos scope {self.scope!r}; use peer, "
                f"control, or all"
            )

    @property
    def wraps_peer(self) -> bool:
        return self.enabled and self.scope in ("peer", "all")

    @property
    def wraps_control(self) -> bool:
        return self.enabled and self.scope in ("control", "all")


@dataclasses.dataclass
class SimulationConfig:
    """The knobs the port honours, with the JAX package's names and
    defaults.  The first block is the standalone run's; the rest belong to
    the cluster (:data:`CLUSTER_FIELDS`), which the standalone run refuses
    when they are set."""

    height: int = 64
    width: int = 64
    rule: str = "conway"
    density: float = 0.5
    seed: int = 0
    pattern: Optional[str] = None
    pattern_offset: Tuple[int, int] = (2, 2)
    max_epochs: Optional[int] = None
    # "tpu" (stencil kernels) | "actor" / "actor-native" (per-cell parity
    # engines on the host).
    backend: str = "tpu"
    kernel: str = "auto"
    # Output rows per block of the CUDA kernels under kernel="pallas" (a
    # compile-time tile variant, ``tune``'s answer); None = the kernel's own
    # tile, which kernel="auto" always uses.
    pallas_block_rows: Optional[int] = None
    # Accepted at 0 only (the JAX package's Mosaic VMEM budget override).
    pallas_vmem_limit_mb: int = 0
    steps_per_call: int = 1
    # Steps per halo exchange of the sharded dense and plain packed paths
    # (the sharded sweeps plan their own exchange depth).
    halo_width: int = 1
    # (rows, cols) of the device mesh; None = one device, or every given
    # device when there are several (packed boards: (n, 1); dense: as
    # square as possible).
    mesh_shape: Optional[Tuple[int, int]] = None
    # Multi-process: join a torch.distributed process group so the mesh
    # spans every process's devices.  Set the three None fields, or the
    # GOL_COORDINATOR / GOL_NUM_PROCESSES / GOL_PROCESS_ID variables (or
    # torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK).
    distributed: bool = False
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # epochs between checkpoints; 0 = disabled
    checkpoint_format: str = "npz"  # "npz" (host) | "orbax" (async, per shard)
    render_every: int = 0  # epochs between rendered frames; 0 = never
    render_max_cells: int = 128  # stride-sample larger boards down to this
    # Exact-cell window (y0, y1, x0, x1) printed at render cadence.
    probe_window: Optional[Tuple[int, int, int, int]] = None
    log_file: Optional[str] = None
    metrics_every: int = 0
    # The 64-bit board digest on every metrics line; in the cluster, the
    # workers' per-tile digest lanes merged by the frontend.
    obs_digest: bool = False
    # Cadence observations dispatched on the device and fetched one chunk
    # later, while the next chunk runs (lines one chunk late, values equal).
    obs_defer: bool = False
    # npz saves on one writer thread, at most one in flight; False = every
    # save durable when checkpoint() returns.
    checkpoint_async: bool = True
    tick_s: float = 0.0  # wall-clock pacing per chunk; 0 = free-running
    # -- linear-rule fast-forward (ops/fastforward.py) -----------------------
    # Master switch: Simulation.fast_forward refuses when off.
    ff_enabled: bool = True
    # Jump-vs-iterate certification: before a jump commits, min(T, this)
    # epochs are also iterated through the dense stepper and the two digests
    # must agree.  0 = skip.
    ff_certify_steps: int = 8
    # -- activity-gated sparse stepping (ops/sparse.py) ----------------------
    # A block steps only if it or a block-ring neighbour changed last chunk
    # (exact for radius-1 rules with steps_per_call <= the block).
    sparse_kernel: bool = False
    # Gating block side in cells (clamped to the largest common divisor of
    # the board sides <= this, so blocks tile the torus).
    sparse_block: int = 128
    # Above this dilated active-block fraction the chunk steps the whole
    # board and only recomputes the changed-block bitmap.
    sparse_threshold: float = 0.5
    # -- observability (every role) ------------------------------------------
    metrics_file: Optional[str] = None
    metrics_port: int = 0
    log_events: Optional[str] = None
    trace_file: Optional[str] = None
    flight_dir: str = "artifacts"
    obs_programs: bool = True
    # POST /profile guard rails: the longest capture, the least gap between
    # two (429 inside it).
    obs_profile_max_s: float = 30.0
    obs_profile_min_interval_s: float = 60.0

    # -- cluster: timing and membership ------------------------------------
    wait_for_backends_s: float = 5.0
    start_delay_s: float = 1.0
    role: str = "standalone"  # standalone | frontend | backend
    host: str = "127.0.0.1"
    port: int = 2551
    heartbeat_s: float = 0.5
    failure_timeout_s: float = 1.0
    restart_max: int = 10
    restart_window_s: float = 60.0
    # Ring width k: one peer exchange licenses k local epochs per tile.
    exchange_width: int = 1
    tiles_per_worker: int = 1
    # -- cluster: halo data plane ------------------------------------------
    ring_pack: bool = True
    ring_batch: bool = True
    ring_queue_depth: int = 1024
    max_pull_retries: int = 10
    stuck_timeout_s: float = 60.0
    retry_s: float = 0.5
    retry_max_s: float = 8.0
    breaker_failures: int = 3
    breaker_cooldown_s: float = 2.0
    send_deadline_s: float = 0.0
    # -- cluster: elastic rebalancing --------------------------------------
    rebalance_enabled: bool = False
    rebalance_interval_s: float = 1.0
    rebalance_min_gap: int = 2
    rebalance_max_inflight: int = 1
    rebalance_deadline_s: float = 10.0
    # Quiescence tier: workers skip chunks whose (state, halo) repeats.
    sparse_cluster: bool = False
    # -- cluster: observability --------------------------------------------
    obs_cost_interval_s: float = 5.0
    # -- the serving plane (role = "serve"), the JAX package's knobs ---------
    # Session-count cap per process.
    serve_max_sessions: int = 1024
    # Aggregate live-cell budget across every session.
    serve_max_cells: int = 16_777_216
    # Pending step-job bound; a full queue rejects new jobs (HTTP 429).
    serve_queue_depth: int = 4096
    # Per-request epoch bound (the scan length buckets to powers of two up
    # to it; XOR-linear rules fast-forward past it).
    serve_max_steps: int = 1024
    # At most one batched program per serve_tick_s (0 = free-running).
    serve_tick_s: float = 0.0
    # Idle-session TTL (0 = never evict).
    serve_ttl_s: float = 300.0
    # Padded size classes (square sides, strictly ascending).
    serve_size_classes: str = "32,64,128,256"
    # The serving cluster: sessions sharded over backend workers.
    serve_cluster: bool = False
    # Cluster-only knobs: parsed and validated, inert while serve_cluster
    # is off (as in the JAX package).
    serve_shards: int = 64
    serve_tile_chunk: int = 8
    serve_tiled_resident: bool = True
    serve_tiled_resident_snapshot: int = 4
    serve_tiled_resident_halo_timeout_s: float = 1.0
    serve_replicate: bool = True
    serve_replicate_every: int = 8
    serve_replicate_interval_s: float = 0.25
    serve_replicate_max_lag_s: float = 30.0
    # Serve observability: per-request trace spans, the JSONL access log
    # ("" = none), the SLO objectives and burn windows, the tenant cap.
    serve_trace: bool = True
    serve_slo_log: str = ""
    serve_slo_availability: float = 0.999
    serve_slo_latency_ms: float = 250.0
    serve_slo_fast_window_s: float = 300.0
    serve_slo_slow_window_s: float = 3600.0
    serve_slo_max_tenants: int = 64
    # The canary prober (serve/canary.py).
    serve_canary: bool = False
    serve_canary_interval_s: float = 2.0
    serve_canary_side: int = 32
    # Cross-tenant memoized macro-stepping (serve/memo.py).
    serve_memo: bool = False
    serve_memo_block: int = 64
    serve_memo_max_mb: int = 256
    serve_memo_hit_floor: float = 0.25
    serve_memo_warmup: int = 16
    serve_memo_disable_after: int = 3
    serve_memo_certify_every: int = 64
    # The frontend federation (serve/federation.py): N serving-cluster
    # frontends, each owning a rendezvous-hashed slice of the serve shard
    # space, with no coordinator.  frontend_seeds is the master switch:
    # comma-separated host:port cluster addresses of any live frontends (a
    # node seeds itself harmlessly); "" = one frontend.  frontend_advertise
    # is this frontend's own host:port ("" = the bound host and port).
    # Gossip ticks every frontend_gossip_interval_s; a peer silent past
    # frontend_gossip_timeout_s is SUSPECT (its slices park writes with a
    # retryable 429), never promoted on silence alone.  Control rows
    # stream to the standby peer in frames of frontend_replicate_every
    # rows, a pass every frontend_replicate_interval_s.
    frontend_seeds: str = ""
    frontend_advertise: str = ""
    frontend_gossip_interval_s: float = 0.5
    frontend_gossip_timeout_s: float = 3.0
    frontend_replicate_every: int = 16
    frontend_replicate_interval_s: float = 0.25

    fault_injection: FaultInjectionConfig = dataclasses.field(
        default_factory=FaultInjectionConfig
    )
    net_chaos: NetworkChaosConfig = dataclasses.field(
        default_factory=NetworkChaosConfig
    )

    def __post_init__(self) -> None:
        if self.height <= 0 or self.width <= 0:
            raise ValueError(f"board must be positive, got {self.height}x{self.width}")
        if self.backend not in BACKEND_CHOICES:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.kernel not in KERNEL_CHOICES:
            raise ValueError(
                f"unknown kernel {self.kernel!r}; choose from {KERNEL_CHOICES}"
            )
        if self.checkpoint_format not in ("npz", "orbax"):
            raise ValueError(f"unknown checkpoint format {self.checkpoint_format!r}")
        if self.pallas_block_rows is not None and self.pallas_block_rows < 1:
            raise ValueError(
                f"pallas_block_rows={self.pallas_block_rows} must be a "
                f"positive row count (or unset: the kernel's own tile)"
            )
        if self.pallas_vmem_limit_mb < 0:
            raise ValueError(
                f"pallas_vmem_limit_mb={self.pallas_vmem_limit_mb} must be >= 0"
            )
        if self.pallas_vmem_limit_mb:
            raise ValueError(
                f"pallas_vmem_limit_mb={self.pallas_vmem_limit_mb} is not "
                f"supported by the PyTorch port: there is no Mosaic VMEM "
                f"budget on the card (the kernels keep their tiles in "
                f"registers and small shared-memory rings); leave it 0"
            )
        if self.steps_per_call < 1:
            raise ValueError(f"steps_per_call={self.steps_per_call} must be >= 1")
        if self.halo_width < 1:
            raise ValueError(f"halo_width={self.halo_width} must be >= 1")
        if self.steps_per_call % self.halo_width:
            raise ValueError("steps_per_call must be a multiple of halo_width")
        if self.mesh_shape is not None:
            self.mesh_shape = tuple(self.mesh_shape)
            if len(self.mesh_shape) != 2 or min(self.mesh_shape) < 1:
                raise ValueError(
                    f"mesh_shape={self.mesh_shape} must be (rows, cols) >= 1"
                )
        for name in ("checkpoint_every", "render_every", "metrics_every"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 0")
        if self.render_max_cells < 1:
            raise ValueError(
                f"render_max_cells={self.render_max_cells} must be >= 1"
            )
        if self.probe_window is not None:
            y0, y1, x0, x1 = self.probe_window
            if not (0 <= y0 < y1 <= self.height and 0 <= x0 < x1 <= self.width):
                raise ValueError(
                    f"probe_window {self.probe_window} out of bounds for "
                    f"{self.height}x{self.width}"
                )
        if self.role not in ("standalone", "frontend", "backend", "serve"):
            raise ValueError(f"unknown role {self.role!r}")
        if not (0 <= self.metrics_port < 65536):
            raise ValueError(
                f"metrics_port={self.metrics_port} must be 0 (off) or a "
                f"valid TCP port"
            )
        if self.obs_cost_interval_s <= 0:
            raise ValueError(
                f"obs_cost_interval_s={self.obs_cost_interval_s} must be > 0"
            )
        if self.obs_profile_max_s <= 0:
            raise ValueError(
                f"obs_profile_max_s={self.obs_profile_max_s} must be > 0"
            )
        if self.obs_profile_min_interval_s < 0:
            raise ValueError(
                f"obs_profile_min_interval_s="
                f"{self.obs_profile_min_interval_s} must be >= 0 (0 = no "
                f"rate limit)"
            )
        if self.tick_s < 0:
            raise ValueError(f"tick_s={self.tick_s} must be >= 0")
        if self.ff_certify_steps < 0:
            raise ValueError(
                f"ff_certify_steps={self.ff_certify_steps} must be >= 0 "
                f"(0 = skip jump-vs-iterate certification)"
            )
        if self.sparse_block < 1:
            raise ValueError(
                f"sparse_block={self.sparse_block} must be >= 1"
            )
        if not 0.0 <= self.sparse_threshold <= 1.0:
            raise ValueError(
                f"sparse_threshold={self.sparse_threshold} must be in [0, 1]"
            )
        if self.retry_s <= 0:
            raise ValueError(f"retry_s={self.retry_s} must be > 0")
        if self.retry_max_s < self.retry_s:
            raise ValueError(
                f"retry_max_s={self.retry_max_s} must be >= retry_s="
                f"{self.retry_s} (it is the backoff cap)"
            )
        if self.breaker_failures < 1:
            raise ValueError(
                f"breaker_failures={self.breaker_failures} must be >= 1"
            )
        if self.breaker_cooldown_s <= 0:
            raise ValueError(
                f"breaker_cooldown_s={self.breaker_cooldown_s} must be > 0"
            )
        if self.send_deadline_s < 0:
            raise ValueError(
                f"send_deadline_s={self.send_deadline_s} must be >= 0 (0 = off)"
            )
        if self.rebalance_interval_s <= 0:
            raise ValueError(
                f"rebalance_interval_s={self.rebalance_interval_s} must be > 0"
            )
        if self.rebalance_min_gap < 1:
            raise ValueError(
                f"rebalance_min_gap={self.rebalance_min_gap} must be >= 1"
            )
        if self.rebalance_max_inflight < 1:
            raise ValueError(
                f"rebalance_max_inflight={self.rebalance_max_inflight} "
                f"must be >= 1"
            )
        if self.rebalance_deadline_s <= 0:
            raise ValueError(
                f"rebalance_deadline_s={self.rebalance_deadline_s} must be > 0"
            )
        if self.tiles_per_worker < 1:
            raise ValueError(
                f"tiles_per_worker must be >= 1, got {self.tiles_per_worker}"
            )
        if self.ring_queue_depth < 1:
            raise ValueError(
                f"ring_queue_depth must be >= 1, got {self.ring_queue_depth}"
            )
        self._check_serve()
        if self.exchange_width < 1:
            raise ValueError(f"exchange_width must be >= 1, got {self.exchange_width}")
        if self.exchange_width > 1:
            for name in ("render_every", "metrics_every", "checkpoint_every"):
                cadence = getattr(self, name)
                if cadence and cadence % self.exchange_width:
                    raise ValueError(
                        f"{name}={cadence} must be a multiple of "
                        f"exchange_width={self.exchange_width}: cluster tiles "
                        f"advance in exchange_width-epoch chunks, so other "
                        f"epochs are never observable"
                    )

    def _check_serve(self) -> None:
        """The serving plane's checks, the JAX package's, in its order."""
        for name in (
            "serve_max_sessions",
            "serve_max_cells",
            "serve_queue_depth",
            "serve_max_steps",
            "serve_shards",
            "serve_tile_chunk",
            "serve_replicate_every",
            "serve_tiled_resident_snapshot",
        ):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 1")
        for name in (
            "serve_tiled_resident_halo_timeout_s",
            "serve_replicate_interval_s",
            "serve_replicate_max_lag_s",
        ):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name}={getattr(self, name)} must be > 0")
        if self.serve_tick_s < 0:
            raise ValueError(
                f"serve_tick_s={self.serve_tick_s} must be >= 0 (0 = "
                f"free-running)"
            )
        if self.serve_ttl_s < 0:
            raise ValueError(
                f"serve_ttl_s={self.serve_ttl_s} must be >= 0 (0 = never "
                f"evict)"
            )
        parse_size_classes(self.serve_size_classes)
        if not 0.0 < self.serve_slo_availability < 1.0:
            raise ValueError(
                f"serve_slo_availability={self.serve_slo_availability} "
                f"must be in (0, 1)"
            )
        if self.serve_slo_latency_ms <= 0:
            raise ValueError(
                f"serve_slo_latency_ms={self.serve_slo_latency_ms} must "
                f"be > 0"
            )
        if self.serve_slo_fast_window_s <= 0:
            raise ValueError(
                f"serve_slo_fast_window_s={self.serve_slo_fast_window_s} "
                f"must be > 0"
            )
        if self.serve_slo_slow_window_s < self.serve_slo_fast_window_s:
            raise ValueError(
                f"serve_slo_slow_window_s={self.serve_slo_slow_window_s} "
                f"must be >= serve_slo_fast_window_s="
                f"{self.serve_slo_fast_window_s}"
            )
        if self.serve_slo_max_tenants < 1:
            raise ValueError(
                f"serve_slo_max_tenants={self.serve_slo_max_tenants} "
                f"must be >= 1"
            )
        if self.serve_canary_interval_s <= 0:
            raise ValueError(
                f"serve_canary_interval_s={self.serve_canary_interval_s} "
                f"must be > 0"
            )
        if self.serve_canary_side < 1:
            raise ValueError(
                f"serve_canary_side={self.serve_canary_side} must be >= 1"
            )
        from akka_game_of_life_tpu_torch.ops.macroblock import MIN_BLOCK

        if (
            self.serve_memo_block < MIN_BLOCK
            or self.serve_memo_block & (self.serve_memo_block - 1) != 0
        ):
            raise ValueError(
                f"serve_memo_block={self.serve_memo_block} must be a "
                f"power of two >= {MIN_BLOCK} (the macro-cell theorem "
                f"needs B/4 halo epochs)"
            )
        if self.serve_memo_max_mb < 1:
            raise ValueError(
                f"serve_memo_max_mb={self.serve_memo_max_mb} must be >= 1"
            )
        if not 0.0 <= self.serve_memo_hit_floor <= 1.0:
            raise ValueError(
                f"serve_memo_hit_floor={self.serve_memo_hit_floor} must "
                f"be in [0, 1]"
            )
        if self.serve_memo_warmup < 0:
            raise ValueError(
                f"serve_memo_warmup={self.serve_memo_warmup} must be >= 0"
            )
        if self.serve_memo_disable_after < 1:
            raise ValueError(
                f"serve_memo_disable_after={self.serve_memo_disable_after} "
                f"must be >= 1"
            )
        if self.serve_memo_certify_every < 0:
            raise ValueError(
                f"serve_memo_certify_every={self.serve_memo_certify_every} "
                f"must be >= 0 (0 = no sampled certification)"
            )
        for name in ("frontend_seeds", "frontend_advertise"):
            value = getattr(self, name)
            entries = [s for s in value.split(",") if s.strip()]
            if name == "frontend_advertise" and len(entries) > 1:
                raise ValueError(
                    f"frontend_advertise={value!r} must be one host:port"
                )
            for entry in entries:
                host, sep, port = entry.strip().rpartition(":")
                if not sep or not host or not port.isdigit():
                    raise ValueError(
                        f"{name} entry {entry.strip()!r} must be host:port"
                    )
        if self.frontend_gossip_interval_s <= 0:
            raise ValueError(
                f"frontend_gossip_interval_s="
                f"{self.frontend_gossip_interval_s} must be > 0"
            )
        if self.frontend_gossip_timeout_s <= self.frontend_gossip_interval_s:
            raise ValueError(
                f"frontend_gossip_timeout_s="
                f"{self.frontend_gossip_timeout_s} must exceed "
                f"frontend_gossip_interval_s="
                f"{self.frontend_gossip_interval_s} (a peer must miss "
                f"multiple gossip ticks before it is suspect)"
            )
        if self.frontend_replicate_every < 1:
            raise ValueError(
                f"frontend_replicate_every={self.frontend_replicate_every} "
                f"must be >= 1"
            )
        if self.frontend_replicate_interval_s <= 0:
            raise ValueError(
                f"frontend_replicate_interval_s="
                f"{self.frontend_replicate_interval_s} must be > 0"
            )

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


# Fields only the cluster roles read: the standalone run refuses a config
# that sets any of them away from its default (see ``cluster_keys_set``).
CLUSTER_FIELDS = tuple(
    f.name
    for f in dataclasses.fields(SimulationConfig)
    if f.name not in {
        "height", "width", "rule", "density", "seed", "pattern",
        "pattern_offset", "max_epochs", "backend", "kernel", "pallas_block_rows",
        "pallas_vmem_limit_mb", "steps_per_call", "halo_width", "mesh_shape",
        "distributed", "coordinator_address", "num_processes", "process_id",
        "checkpoint_dir", "checkpoint_every", "checkpoint_format",
        "checkpoint_async", "render_every", "render_max_cells",
        "probe_window", "log_file", "metrics_every", "obs_digest",
        "obs_defer", "tick_s", "metrics_file", "metrics_port", "log_events",
        "trace_file", "flight_dir", "obs_programs", "obs_profile_max_s",
        "obs_profile_min_interval_s", "fault_injection", "role",
        "ff_enabled", "ff_certify_steps", "sparse_kernel", "sparse_block",
        "sparse_threshold",
        # Read by the cluster only; ``run`` takes it as the JAX run does.
        "obs_cost_interval_s",
    }
)


def cluster_keys_set(config: SimulationConfig) -> list:
    """The cluster-only fields ``config`` sets away from their defaults."""
    default = SimulationConfig()
    return sorted(
        name for name in CLUSTER_FIELDS
        if getattr(config, name) != getattr(default, name)
    )


_DURATION_FIELDS = {
    "wait_for_backends_s", "start_delay_s", "tick_s", "heartbeat_s",
    "failure_timeout_s", "restart_window_s", "stuck_timeout_s", "first_after_s",
    "every_s", "retry_s", "retry_max_s", "rebalance_interval_s",
    "rebalance_deadline_s", "obs_cost_interval_s", "obs_profile_max_s",
    "obs_profile_min_interval_s", "breaker_cooldown_s",
    "send_deadline_s", "delay_s", "partition_after_s", "partition_every_s",
    "partition_heal_s", "serve_tick_s", "serve_ttl_s",
    "serve_replicate_interval_s", "serve_replicate_max_lag_s",
    "serve_tiled_resident_halo_timeout_s", "serve_slo_fast_window_s",
    "serve_slo_slow_window_s", "serve_canary_interval_s",
    "frontend_gossip_interval_s", "frontend_gossip_timeout_s",
    "frontend_replicate_interval_s",
}

# The reference's config spellings the JAX package also accepts.
_ALIASES = {
    "x": "width",
    "y": "height",
    "wait-for-backends": "wait_for_backends_s",
    "start-delay": "start_delay_s",
    "tick": "tick_s",
    "max-crashes": "max_crashes",
    "delay": "first_after_s",
    "every": "every_s",
}
_NESTED = ("fault_injection", "net_chaos")


def _normalize(data: Mapping[str, Any], *, nested: bool = False) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in data.items():
        key = _ALIASES.get(key, key.replace("-", "_"))
        if key == "max_crashes" and not nested:
            out.setdefault("fault_injection", {})["max_crashes"] = value
            continue
        if isinstance(value, Mapping) and key not in _NESTED:
            if key in ("board", "game_of_life"):
                out.update(_normalize(value))
                continue
            if key == "error":
                out.setdefault("fault_injection", {}).update(
                    _normalize(value, nested=True)
                )
                continue
        if key in _NESTED and isinstance(value, Mapping):
            out.setdefault(key, {}).update(_normalize(value, nested=True))
            continue
        if key in _DURATION_FIELDS and value is not None:
            value = parse_duration(value)
        out[key] = value
    return out


def _field_names(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Mapping[str, Any]] = None,
) -> SimulationConfig:
    """Build a config with layered precedence: defaults < file < overrides
    (``None`` overrides are ignored).  ``path`` may be TOML or JSON."""
    merged: Dict[str, Any] = {}
    if path is not None:
        p = Path(path)
        text = p.read_text()
        if p.suffix == ".json":
            data = json.loads(text)
        else:
            import tomllib

            data = tomllib.loads(text)
        merged.update(_normalize(data))
    if overrides:
        deep = _normalize({k: v for k, v in overrides.items() if v is not None})
        for key in _NESTED:
            both = {**merged.get(key, {}), **deep.pop(key, {})}
            if both:
                merged[key] = both
        merged.update(deep)
    fi_kwargs = merged.pop("fault_injection", {})
    nc_kwargs = merged.pop("net_chaos", {})
    unsupported = sorted(
        (set(merged) - _field_names(SimulationConfig))
        | (set(fi_kwargs) - _field_names(FaultInjectionConfig))
        | (set(nc_kwargs) - _field_names(NetworkChaosConfig))
    )
    if unsupported:
        raise ValueError(
            f"config keys {unsupported} are not supported by the PyTorch "
            f"port (it honours {sorted(_field_names(SimulationConfig))})"
        )
    for key in ("pattern_offset", "probe_window"):
        if merged.get(key) is not None:
            merged[key] = tuple(merged[key])
    return SimulationConfig(
        fault_injection=FaultInjectionConfig(**fi_kwargs),
        net_chaos=NetworkChaosConfig(**nc_kwargs),
        **merged,
    )
