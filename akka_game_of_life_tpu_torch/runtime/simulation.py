"""Standalone simulation driver: config → board → stepper → observer.

Counterpart of ``akka_game_of_life_tpu/runtime/simulation.py`` for one
device.  The board lives on the device in one of three layouts, as in the
JAX package:

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

The device is the caller's choice: ``cuda`` unless ``device="cpu"`` is
passed.  On a CUDA device the kernels step the board; one that fails to
build or launch raises.  On the CPU the same wrappers run their plain
versions.  Nothing falls back.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

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
    """One simulation run on one device, resumable from checkpoints."""

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
        self.device = resolve_device(device)
        self.rule = resolve_rule(config.rule)
        self.kernel = self._resolve_kernel()
        if self.kernel in ("dense", "ltl_sweep"):
            self.layout = "dense"
        else:
            self.layout = "words" if self.rule.is_binary else "planes"
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
        if self.layout == "dense":
            self.board = torch.from_numpy(np.ascontiguousarray(payload, np.uint8)).to(self.device)
        else:
            self.board = bitpack.words_from_numpy(payload, self.device)

    def _resolve_kernel(self) -> str:
        """The stepper for this rule and width (module docstring table):
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
            return "dense" if kernel == "dense" else "ltl_sweep"
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
        return "sweep" if rule.is_binary else "gen_sweep"

    def _pack(self, board: np.ndarray) -> np.ndarray:
        """A dense host board in this run's layout."""
        if self.layout == "words":
            return bitpack.pack_np(board)
        if self.layout == "planes":
            return bitpack_gen.pack_gen_np(board, self.rule.states)
        return board

    def _stepper(self, k: int) -> Callable:
        if k not in self._steppers:
            rule = self.rule
            if self.kernel == "sweep":
                run = packed_sweep.packed_multi_step_fn(rule, k)
            elif self.kernel == "gen_sweep":
                run = gen_sweep.gen_multi_step_fn(rule, k)
            elif self.kernel == "ltl_sweep":
                run = ltl_sweep.ltl_multi_step_fn(rule, k)
            elif self.kernel == "bitpack" and self.layout == "words":
                run = bitpack.packed_multi_step_fn(rule, k)
            elif self.kernel == "bitpack":
                run = bitpack_gen.gen_multi_step_fn(rule, k)
            else:
                run = get_model(rule).run(k)
            self._steppers[k] = run
        return self._steppers[k]

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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _probe_due(self, render: bool) -> bool:
        cfg = self.config
        return (
            render
            and cfg.probe_window is not None
            and cfg.render_every > 0
            and self.epoch % cfg.render_every == 0
        )

    def _population(self) -> int:
        """Cells in state 1 (alive, or WireWorld's electron heads)."""
        if self.layout == "dense":
            return int((self.board == 1).sum())
        words = self.board if self.layout == "words" else bitpack_gen.alive_plane(self.board)
        return int(bitpack.population_rows(words).sum())

    def _sample(self, sy: int, sx: int) -> np.ndarray:
        """Every sy-th row and sx-th column of the board, as host uint8."""
        if self.layout == "dense":
            return self.board[::sy, ::sx].cpu().numpy()
        sample = bitpack.sample_packed_core(sy, sx, self.config.width)
        if self.layout == "words":
            return sample(self.board).cpu().numpy()
        view = sample(self.board[0])
        for k in range(1, self.board.shape[0]):
            view = view | (sample(self.board[k]) << k)
        return view.cpu().numpy()

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
        """The 64-bit digest of the current board (~8 fetched bytes)."""
        width = self.config.width
        if self.layout == "words":
            lanes = odigest.digest_packed(self.board, width)
        elif self.layout == "planes":
            lanes = odigest.digest_planes(self.board, width)
        else:
            lanes = odigest.digest_dense(self.board)
        return odigest.value(lanes)

    def checkpoint(self) -> None:
        """Save the board of the current epoch in its layout (synchronous)."""
        if self.store is None:
            raise RuntimeError("no checkpoint_dir configured")
        cfg = self.config
        meta = {"height": cfg.height, "width": cfg.width}
        if cfg.obs_digest:
            meta["digest"] = odigest.format_digest(self.board_digest())
        rule = self.rule.rulestring()
        t0 = time.perf_counter()
        if self.layout == "dense":
            self.store.save(self.epoch, self.board.cpu().numpy(), rule, meta=meta)
        else:
            self.store.save_packed32(
                self.epoch, bitpack.words_to_numpy(self.board), cfg.shape, rule,
                meta=meta,
            )
        if cfg.metrics_every:
            print(
                f"[profile] checkpoint@{self.epoch}: "
                f"{(time.perf_counter() - t0) * 1e3:.2f} ms",
                file=self.observer.out,
                flush=True,
            )

    def board_window(self, y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
        """A (y1-y0, x1-x0) uint8 window of the board, fetched O(window): on
        the packed layouts whole word columns are sliced on the device,
        unpacked and trimmed on the host."""
        if not (0 <= y0 < y1 <= self.config.height):
            raise ValueError(f"bad row window [{y0}, {y1})")
        if not (0 <= x0 < x1 <= self.config.width):
            raise ValueError(f"bad col window [{x0}, {x1})")
        if self.layout == "dense":
            return self.board[y0:y1, x0:x1].cpu().numpy()
        lane = bitpack.LANE_BITS
        w0, w1 = x0 // lane, -(-x1 // lane)
        off = x0 - w0 * lane
        if self.layout == "words":
            cells = bitpack.unpack_np(bitpack.words_to_numpy(self.board[y0:y1, w0:w1]))
        else:
            cells = bitpack_gen.unpack_gen_np(
                bitpack.words_to_numpy(self.board[:, y0:y1, w0:w1])
            )
        return cells[:, off : off + (x1 - x0)]

    def board_host(self) -> np.ndarray:
        """The full board as host uint8 — O(board); for tests and small
        boards."""
        if self.layout == "dense":
            return self.board.cpu().numpy()
        words = bitpack.words_to_numpy(self.board)
        if self.layout == "words":
            return bitpack.unpack_np(words)
        return bitpack_gen.unpack_gen_np(words)

    def close(self) -> None:
        self.observer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
