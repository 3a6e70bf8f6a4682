"""Standalone simulation driver: config → board → stepper → observer.

Counterpart of ``akka_game_of_life_tpu/runtime/simulation.py`` for one
device or a device mesh driven by one process.  The board lives on the
device in one of three layouts, as in the JAX package:

- ``words``: a binary radius-1 rule on a width that is a multiple of 32,
  (H, W/32) int32 words;
- ``planes``: a Generations or WireWorld rule on such a width, (m, H, W/32)
  int32 bit planes, m = ceil(log2 S);
- ``dense``: everything else — Larger-than-Life, odd widths, or an explicit
  ``kernel=dense`` — one uint8 per cell.

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
LtL and ``matmul`` is not ported.  This differs from the JAX package's
``auto`` on a TPU, which keeps Generations on the XLA plane scan and LtL on
XLA: the results are equal bit for bit, and on the card the plain versions
are no path at all, so ``auto`` takes the kernels.

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
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.models.registry import get_model
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
from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore
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


class Simulation:
    """One simulation run on one device or a mesh of them, resumable from
    checkpoints.  ``board`` is a tensor on one device, a list of tiles (one
    per mesh slot, row-major) on a mesh."""

    def __init__(
        self,
        config: SimulationConfig,
        observer: Optional[BoardObserver] = None,
        device=None,
    ) -> None:
        cluster_only = cluster_keys_set(config)
        if cluster_only:
            raise ValueError(
                f"config keys {cluster_only} belong to the cluster roles "
                f"(frontend/backend); the standalone run does not honour them"
            )
        self.config = config
        self.devices = resolve_devices(device)
        self.rule = resolve_rule(config.rule)
        # The LtL kernel has no sharded form: an explicit kernel=pallas for
        # LtL pins one device, and with a mesh_shape _resolve_kernel raises.
        unsharded = config.kernel == "pallas" and self.rule.kind == "ltl"
        self._use_mesh = config.mesh_shape is not None or (
            len(self.devices) > 1 and not unsharded
        )
        self.kernel = self._resolve_kernel()
        if self.kernel in ("dense", "ltl_sweep"):
            self.layout = "dense"
        else:
            self.layout = "words" if self.rule.is_binary else "planes"
        self.mesh: Optional[pmesh.GridMesh] = None
        if self._use_mesh:
            if self.layout == "dense":
                self.mesh = pmesh.make_grid_mesh(config.mesh_shape, self.devices)
                pmesh.tile_shape(config.shape, self.mesh)
                halo.validate_tile_shape(
                    self.mesh, config.shape, config.halo_width, self.rule.radius
                )
            else:
                self.mesh = pmesh.make_grid_mesh(self._packed_mesh_shape(), self.devices)
                if self.kernel == "bitpack":
                    self._validate_packed_mesh()
        self.device = self.devices[0]
        self.observer = observer or BoardObserver(
            render_every=config.render_every,
            render_max_cells=config.render_max_cells,
            metrics_every=config.metrics_every,
            log_file=config.log_file,
        )
        self.store = (
            CheckpointStore(config.checkpoint_dir)
            if config.checkpoint_dir is not None
            else None
        )
        self._steppers: Dict[int, Callable] = {}
        self._digest = None
        self.epoch = 0
        h, w = config.shape
        expect = {
            "words": (h, w // bitpack.LANE_BITS),
            "planes": (bitpack_gen.n_planes(self.rule.states), h, w // bitpack.LANE_BITS),
            "dense": (h, w),
        }[self.layout]
        if self.store is not None and self.store.latest_epoch() is not None:
            ckpt = self.store.load(keep_packed=self.layout != "dense")
            if ckpt.packed32 is not None:
                payload = ckpt.packed32
            else:
                if ckpt.board.shape != config.shape:
                    raise ValueError(
                        f"checkpoint shape {ckpt.board.shape} != config {config.shape}"
                    )
                payload = self._pack(ckpt.board)
            if payload.shape != expect:
                raise ValueError(
                    f"checkpoint {self.layout} shape {payload.shape} != config {expect}"
                )
            self.epoch = ckpt.epoch
        elif self.layout == "words":
            payload = initial_words(config)
        elif self.layout == "planes":
            payload = initial_planes(config, self.rule.states)
        else:
            payload = initial_board(config)
        if self.mesh is not None:
            self.board = pmesh.shard_board(payload, self.mesh)
        elif self.layout == "dense":
            self.board = torch.from_numpy(np.ascontiguousarray(payload, np.uint8)).to(self.device)
        else:
            self.board = bitpack.words_from_numpy(payload, self.device)

    def _resolve_kernel(self) -> str:
        """The stepper for this rule and width (module docstring tables):
        ``sweep``, ``gen_sweep`` or ``ltl_sweep`` (the CUDA kernels on a
        CUDA device), or the plain ``bitpack`` and ``dense`` steppers."""
        cfg, rule = self.config, self.rule
        kernel = cfg.kernel
        if kernel == "matmul":
            raise ValueError(
                "kernel='matmul' (the banded matrix-multiply family) is not "
                "ported yet; use auto, pallas, bitpack or dense"
            )
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
            if cfg.mesh_shape is not None:
                raise ValueError(
                    f"kernel=pallas on a {self._packed_mesh_shape()} mesh: the "
                    f"packed grid ({cfg.height} rows x {cfg.width // 32} "
                    f"words) does not divide evenly into its tiles"
                )
            # No mesh was asked for: the sweep runs on one device.
            self._use_mesh = False
        return "sweep" if rule.is_binary else "gen_sweep"

    def _packed_mesh_shape(self) -> Tuple[int, int]:
        return self.config.mesh_shape or (len(self.devices), 1)

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

    def _stepper(self, k: int) -> Callable:
        if k not in self._steppers:
            self._steppers[k] = (
                self._single_stepper(k) if self.mesh is None else self._mesh_stepper(k)
            )
        return self._steppers[k]

    def _single_stepper(self, k: int) -> Callable:
        rule = self.rule
        if self.kernel == "sweep":
            return packed_sweep.packed_multi_step_fn(rule, k)
        if self.kernel == "gen_sweep":
            return gen_sweep.gen_multi_step_fn(rule, k)
        if self.kernel == "ltl_sweep":
            return ltl_sweep.ltl_multi_step_fn(rule, k)
        if self.kernel == "bitpack" and self.layout == "words":
            return bitpack.packed_multi_step_fn(rule, k)
        if self.kernel == "bitpack":
            return bitpack_gen.gen_multi_step_fn(rule, k)
        return get_model(rule).run(k)

    def _mesh_stepper(self, k: int) -> Callable:
        mesh, rule = self.mesh, self.rule
        if self.kernel == "sweep":
            return sharded_sweep_step_fn(mesh, rule, steps_per_call=k)
        if self.kernel == "gen_sweep":
            return sharded_gen_sweep_step_fn(mesh, rule, steps_per_call=k)
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
        config.max_epochs), in chunks of ``steps_per_call``; observation and
        checkpoints happen between chunks."""
        cfg = self.config
        target = self.epoch + (epochs if epochs is not None else (cfg.max_epochs or 0))
        self.observer.start_clock(self.epoch)
        while self.epoch < target:
            chunk = min(cfg.steps_per_call, target - self.epoch)
            prev = self.epoch
            self.board = self._stepper(chunk)(self.board)
            self.epoch += chunk
            render = _crosses(prev, self.epoch, cfg.render_every)
            if render or _crosses(prev, self.epoch, cfg.metrics_every):
                self._observe(render=render)
            if self.store is not None and _crosses(
                prev, self.epoch, cfg.checkpoint_every
            ):
                self.checkpoint()
        return self.epoch

    def _sync(self) -> None:
        devices = self.mesh.distinct_devices() if self.mesh is not None else [self.device]
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

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
        return [self.board] if self.mesh is None else list(self.board)

    def _cells(self, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
        """Host uint8 cells at the global rows ``ys`` × cell columns ``xs``
        (sorted int arrays), cut on the device from the tiles that hold
        them: O(len(ys)·len(xs)) fetched."""
        rows, cols = self.mesh.shape if self.mesh is not None else (1, 1)
        th, tw = self.config.height // rows, self.config.width // cols
        tiles = self._tiles()
        bands = []
        for r in range(rows):
            ly = ys[(ys >= r * th) & (ys < (r + 1) * th)] - r * th
            if not len(ly):
                continue
            parts = []
            for c in range(cols):
                lx = xs[(xs >= c * tw) & (xs < (c + 1) * tw)] - c * tw
                if len(lx):
                    parts.append(self._tile_cells(tiles[r * cols + c], ly, lx))
            bands.append(np.concatenate(parts, axis=1))
        return np.concatenate(bands, axis=0)

    def _tile_cells(self, tile: torch.Tensor, ly: np.ndarray, lx: np.ndarray) -> np.ndarray:
        rows = torch.from_numpy(ly).to(tile.device)
        if self.layout == "dense":
            return tile[rows][:, torch.from_numpy(lx).to(tile.device)].cpu().numpy()
        if self.layout == "words":
            return bitpack.cells_at(tile, rows, lx).cpu().numpy()
        view = bitpack.cells_at(tile[0], rows, lx)
        for k in range(1, tile.shape[0]):
            view = view | (bitpack.cells_at(tile[k], rows, lx) << k)
        return view.cpu().numpy()

    def _host_layout(self) -> np.ndarray:
        """The board in its layout on the host (packed words and planes as
        uint32), gathered from the tiles on a mesh — O(board)."""
        if self.mesh is not None:
            return pmesh.gather(self.board, self.mesh)
        if self.layout == "dense":
            return self.board.cpu().numpy()
        return bitpack.words_to_numpy(self.board)

    def _population(self) -> int:
        """Cells in state 1 (alive, or WireWorld's electron heads)."""
        total = 0
        for tile in self._tiles():
            if self.layout == "dense":
                total += int((tile == 1).sum())
            else:
                words = tile if self.layout == "words" else bitpack_gen.alive_plane(tile)
                total += int(bitpack.population_rows(words).sum())
        return total

    def _sample(self, sy: int, sx: int) -> np.ndarray:
        """Every sy-th row and sx-th column of the board, as host uint8."""
        h, w = self.config.shape
        return self._cells(np.arange(0, h, sy), np.arange(0, w, sx))

    def _observe(self, *, render: bool) -> None:
        """Population (always), a strided sample (at render cadence), the
        probe window and the digest, all computed on the device; the clock
        starts after the stepper's work has finished, so ``obs`` on the
        metrics line is the observation's own cost."""
        cfg = self.config
        self._sync()
        t0 = time.perf_counter()
        population = self._population()
        strides = sample_strides(cfg.shape, cfg.render_max_cells)
        view = self._sample(*strides) if render else None
        digest = self.board_digest() if cfg.obs_digest else None
        win = self.board_window(*cfg.probe_window) if self._probe_due(render) else None
        obs_seconds = time.perf_counter() - t0
        self.observer.observe_summary(
            self.epoch,
            population,
            cfg.shape,
            view,
            strides,
            obs_seconds=obs_seconds,
            digest=digest,
        )
        if win is not None:
            self.observer.observe_window(self.epoch, win, cfg.probe_window)

    def board_digest(self) -> int:
        """The 64-bit digest of the current board (~8 fetched bytes; on a
        mesh, the fold of each tile's lanes)."""
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
            return odigest.value(self._digest(self.board))
        if self.layout == "words":
            lanes = odigest.digest_packed(self.board, cfg.width)
        elif self.layout == "planes":
            lanes = odigest.digest_planes(self.board, cfg.width)
        else:
            lanes = odigest.digest_dense(self.board)
        return odigest.value(lanes)

    def checkpoint(self) -> None:
        """Save the board of the current epoch in its layout (synchronous;
        a mesh's tiles are gathered first, so the file is the same as a
        single-device run's)."""
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        cfg = self.config
        meta = {"height": cfg.height, "width": cfg.width}
        if cfg.obs_digest:
            meta["digest"] = odigest.format_digest(self.board_digest())
        rule = self.rule.rulestring()
        t0 = time.perf_counter()
        if self.layout == "dense":
            self.store.save(self.epoch, self._host_layout(), rule, meta=meta)
        else:
            self.store.save_packed32(
                self.epoch, self._host_layout(), cfg.shape, rule, meta=meta,
            )
        if cfg.metrics_every:
            print(
                f"[profile] checkpoint@{self.epoch}: "
                f"{(time.perf_counter() - t0) * 1e3:.2f} ms",
                file=self.observer.out,
                flush=True,
            )

    def board_window(self, y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
        """A (y1-y0, x1-x0) uint8 window of the board, fetched O(window)."""
        if not (0 <= y0 < y1 <= self.config.height):
            raise ValueError(f"bad row window [{y0}, {y1})")
        if not (0 <= x0 < x1 <= self.config.width):
            raise ValueError(f"bad col window [{x0}, {x1})")
        return self._cells(np.arange(y0, y1), np.arange(x0, x1))

    def board_host(self) -> np.ndarray:
        """The full board as host uint8 — O(board); for tests and small
        boards."""
        board = self._host_layout()
        if self.layout == "words":
            return bitpack.unpack_np(board)
        if self.layout == "planes":
            return bitpack_gen.unpack_gen_np(board)
        return board

    def close(self) -> None:
        self.observer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
