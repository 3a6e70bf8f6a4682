"""Rendering and metrics lines of the standalone run and the cluster.

Counterpart of ``akka_game_of_life_tpu/runtime/render.py``, copied with the
import paths changed: the metrics line has the JAX package's format,
``digest=%016x`` included, so the two packages' lines compare field by
field; the cluster's frontend stitches per-tile strided samples, probe
windows and population counts into the same lines once every tile of an
epoch has reported.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections import deque
from typing import Deque, Dict, IO, Optional, Tuple

import numpy as np

GLYPHS = ".#ox*+=%"  # state 0..7 glyphs; >7 rendered as '?'


def sample_strides(shape: Tuple[int, int], max_cells: int) -> Tuple[int, int]:
    """Strides that sample an (H, W) board down to <= max_cells per side."""
    return (
        max(1, -(-shape[0] // max_cells)),
        max(1, -(-shape[1] // max_cells)),
    )


def ascii_rows(board: np.ndarray) -> str:
    return "\n".join(
        "".join(GLYPHS[int(v)] if int(v) < len(GLYPHS) else "?" for v in row)
        for row in board
    )


def frame_header(shape: Tuple[int, int], strides: Tuple[int, int]) -> str:
    h, w = shape
    sy, sx = strides
    return f"[{h}x{w}" + (f", sampled /{sy}x{sx}" if (sy, sx) != (1, 1) else "") + "]"


def render_ascii(board: np.ndarray, max_cells: int = 128) -> str:
    """Render a board as ASCII rows, stride-sampling to <= max_cells/side.

    Sampling keeps the aspect and phase: cell (0,0) is always shown, matching
    how a strided probe of a torus should behave.
    """
    sy, sx = sample_strides(board.shape, max_cells)
    view = board[::sy, ::sx]
    return frame_header(board.shape, (sy, sx)) + "\n" + ascii_rows(view)


@dataclasses.dataclass
class StepMetrics:
    epoch: int
    seconds: float  # wall time since the previous observation
    epochs: int  # generations covered by that interval
    cells: int  # cell-updates in the interval (board.size * epochs)
    population: int
    # Wall time the observation itself spent (device obs dispatch + host
    # fetches) inside ``seconds`` — the product-vs-bench breakdown: the
    # stepper's own share of the interval is seconds - obs_seconds.
    obs_seconds: float = 0.0
    # 64-bit on-device board digest at this epoch (obs_digest mode), or
    # None — the O(1)-byte state certificate (ops/digest.py).
    digest: Optional[int] = None

    @property
    def updates_per_sec(self) -> float:
        return self.cells / self.seconds if self.seconds > 0 else float("inf")

    @property
    def seconds_per_epoch(self) -> float:
        return self.seconds / self.epochs if self.epochs else 0.0


class BoardObserver:
    """Epoch-synchronized frame sink + metrics counter.

    ``observe(epoch, board)`` renders complete boards; ``observe_tile`` lets
    the distributed control plane feed per-shard tiles and only renders once
    all tiles for an epoch have landed — the reference's complete-epoch
    barrier (``LoggerActor.scala:35``), with correct placement.
    """

    def __init__(
        self,
        *,
        render_every: int = 0,
        render_max_cells: int = 128,
        metrics_every: int = 0,
        out: Optional[IO[str]] = None,
        log_file: Optional[str] = None,
        registry=None,
    ) -> None:
        self.render_every = render_every
        self.render_max_cells = render_max_cells
        self.metrics_every = metrics_every
        # Progress gauges land in the metrics registry on every observed
        # interval (standalone AND cluster paths both funnel through
        # _note_progress) — "what is the steps/s right now" as a scrape
        # instead of a stdout grep.
        if registry is None:
            from akka_game_of_life_tpu_torch.obs import get_registry

            registry = get_registry()
        self._population_gauge = registry.gauge("gol_population")
        self._rate_gauge = registry.gauge("gol_steps_per_second")
        self._own_file = None
        if log_file is not None:
            self._own_file = open(log_file, "a")  # reference appends to info.log
            self.out = self._own_file
        else:
            self.out = out if out is not None else sys.stdout
        self._partial: Dict[int, Dict[Tuple[int, int], np.ndarray]] = {}
        # Epochs complete in increasing order (every tile reports its own
        # epochs in order, and an epoch completes only when the *last* tile
        # reports it), so a single floor suffices to recognize re-reports —
        # no matter how far back a replaying tile rolls.
        self._max_completed: Optional[int] = None
        self._expected_tiles: Optional[int] = None
        # Cluster-scale paths: per-epoch population sums (metrics without
        # shipping any array) and stride-sampled frames (render without
        # shipping whole tiles) — a 65536² board never crosses the wire.
        self._board_shape: Optional[Tuple[int, int]] = None
        self._render_strides: Tuple[int, int] = (1, 1)
        self._pop_partial: Dict[int, Dict[object, int]] = {}
        self._pop_floor: Optional[int] = None
        self._sample_partial: Dict[int, Dict[Tuple[int, int], np.ndarray]] = {}
        self._sample_floor: Optional[int] = None
        self._window_bbox: Optional[Tuple[int, int, int, int]] = None
        self._expected_window_tiles = 0
        self._window_partial: Dict[int, Dict] = {}
        self._window_floor: Optional[int] = None
        self._last_time: Optional[float] = None
        self._last_epoch: Optional[int] = None
        # Bounded, unlike the reference's forever-growing per-epoch map
        # (LoggerActor.scala:27,34).
        self.history: Deque[StepMetrics] = deque(maxlen=1024)
        # Running totals for summary() — the deque is a window, not the run.
        self._total_epochs = 0
        self._total_seconds = 0.0
        self._total_cells = 0
        self._total_obs_seconds = 0.0

    # -- complete-board path (standalone runner) -----------------------------

    def start_clock(self, epoch: int) -> None:
        """Anchor the metrics clock at ``epoch`` if it has not started yet.

        Without an anchor the first cadence crossing only *sets* the clock,
        so the first interval is invisible: totals miss it, and a resumed
        run whose remaining span contains a single crossing observes
        nothing at all (no metrics line, no run summary).  Anchoring at
        advance() entry makes totals span the whole run — including, on a
        TPU, the first chunk's jit compile in the first interval (the
        steady-state per-interval lines are unaffected)."""
        if self._last_time is None:
            self._last_time = time.perf_counter()
            self._last_epoch = epoch

    def _note_progress(
        self,
        epoch: int,
        population: int,
        total_cells: int,
        obs_seconds: float = 0.0,
        digest: Optional[int] = None,
    ) -> None:
        """Advance the metrics clock and emit a metrics line at cadence."""
        now = time.perf_counter()
        if self._last_time is not None and epoch > (self._last_epoch or 0):
            dt = now - self._last_time
            epochs = epoch - self._last_epoch
            m = StepMetrics(
                epoch=epoch,
                seconds=dt,
                epochs=epochs,
                cells=total_cells * epochs,
                population=population,
                obs_seconds=obs_seconds,
                digest=digest,
            )
            self.history.append(m)
            self._total_epochs += m.epochs
            self._total_seconds += m.seconds
            self._total_cells += m.cells
            self._total_obs_seconds += m.obs_seconds
            self._population_gauge.set(m.population)
            if m.seconds > 0:
                self._rate_gauge.set(m.epochs / m.seconds)
            if self.metrics_every and epoch % self.metrics_every == 0:
                # obs = the observation's own share of the interval (device
                # obs dispatch + host fetches): ms/epoch minus obs/epochs is
                # the stepper's true per-epoch cost — the measured breakdown
                # behind any product-vs-bench throughput gap.
                obs = (
                    f" (obs {m.obs_seconds * 1e3:.1f} ms)"
                    if m.obs_seconds > 0
                    else ""
                )
                # The state certificate rides the line it certifies: two
                # runs agree at this epoch iff these 16 hex digits match.
                dig = f" digest={m.digest:016x}" if m.digest is not None else ""
                print(
                    f"epoch {epoch}: pop={m.population} "
                    f"{m.updates_per_sec:.3e} cell-updates/s "
                    f"({m.seconds_per_epoch * 1e3:.2f} ms/epoch)" + obs + dig,
                    file=self.out,
                    flush=True,
                )
        self._last_time = now
        self._last_epoch = epoch

    def observe(
        self, epoch: int, board: np.ndarray, digest: Optional[int] = None
    ) -> None:
        self._note_progress(
            epoch, int((board == 1).sum()), board.size, digest=digest
        )
        if self.render_every and epoch % self.render_every == 0:
            print(f"epoch {epoch}:", file=self.out)
            print(render_ascii(board, self.render_max_cells), file=self.out, flush=True)

    def observe_summary(
        self,
        epoch: int,
        population: int,
        board_shape: Tuple[int, int],
        view: Optional[np.ndarray] = None,
        strides: Tuple[int, int] = (1, 1),
        obs_seconds: float = 0.0,
        digest: Optional[int] = None,
    ) -> None:
        """Device-side observation: the caller computed the population and
        (at render cadence) a stride-sampled view on the accelerator, so only
        a chunk-sum vector and a <=max_cells² probe ever reached the host —
        the standalone analog of the cluster's sampled TILE_STATE path
        (nothing here is O(board)).  ``obs_seconds`` is the caller-measured
        wall cost of that observation (dispatch + fetches), surfaced on the
        metrics line."""
        h, w = board_shape
        self._note_progress(
            epoch, population, h * w, obs_seconds=obs_seconds, digest=digest
        )
        if self.render_every and epoch % self.render_every == 0 and view is not None:
            print(f"epoch {epoch}:", file=self.out)
            print(
                frame_header(board_shape, strides) + "\n" + ascii_rows(view),
                file=self.out,
                flush=True,
            )

    def observe_window(
        self, epoch: int, window: np.ndarray, bbox: Tuple[int, int, int, int]
    ) -> None:
        """An exact-cell probe window (``Simulation.board_window``) at render
        cadence — the at-scale correctness view: e.g. the Gosper-gun region
        of a 65536² run, bytes on the wire where a frame would be 4 GiB."""
        y0, y1, x0, x1 = bbox
        print(
            f"epoch {epoch}: window [{y0}:{y1}, {x0}:{x1}] "
            f"pop={int(np.count_nonzero(window))}\n" + ascii_rows(window),
            file=self.out,
            flush=True,
        )

    # -- tiled path (distributed control plane) ------------------------------

    def expect_tiles(self, n: int) -> None:
        self._expected_tiles = n

    def set_cluster_layout(self, n_tiles: int, board_shape: Tuple[int, int]) -> None:
        """Configure the scale-safe cluster paths (sampled frames +
        population-only metrics)."""
        self._expected_tiles = n_tiles
        self._board_shape = tuple(board_shape)
        self._render_strides = sample_strides(self._board_shape, self.render_max_cells)

    @property
    def render_strides(self) -> Tuple[int, int]:
        """(sy, sx) every worker samples its render tiles with (phase-aligned
        to its origin so the union is the canonical strided probe)."""
        return self._render_strides

    def _complete_epoch(
        self, store: Dict, floor_name: str, expected: int, epoch: int, key, item
    ):
        """The shared per-tile accumulation mechanism behind populations,
        sampled frames, and probe windows: collect items per epoch, and once
        every expected tile reported, advance the monotone completion floor
        (re-reports from replaying tiles are recognized by it), prune stale
        epochs, and hand back the complete dict — else None."""
        floor = getattr(self, floor_name)
        if floor is not None and epoch <= floor:
            return None
        tiles = store.setdefault(epoch, {})
        tiles[key] = item
        if len(tiles) < expected:
            return None
        del store[epoch]
        setattr(self, floor_name, epoch)
        for e in [e for e in store if e <= epoch]:
            del store[e]
        return tiles

    def add_population(self, epoch: int, key, population: int) -> None:
        """One tile's population at a metrics-cadence epoch; emits the
        metrics line when every tile has reported."""
        d = self._complete_epoch(
            self._pop_partial,
            "_pop_floor",
            self._expected_tiles or 0,
            epoch,
            key,
            int(population),
        )
        if d is None:
            return
        h, w = self._board_shape
        self._note_progress(epoch, sum(d.values()), h * w)

    def expect_window(
        self, bbox: Tuple[int, int, int, int], n_tiles: int
    ) -> None:
        """Configure cluster window assembly: ``n_tiles`` workers' tiles
        intersect ``bbox`` and each attaches its exact intersection to its
        render-cadence report."""
        self._window_bbox = tuple(bbox)
        self._expected_window_tiles = n_tiles
        self._window_partial: Dict[int, Dict] = {}
        self._window_floor: Optional[int] = None

    def add_window(
        self, epoch: int, key, origin: Tuple[int, int], block: np.ndarray
    ) -> None:
        """One tile's window intersection (window-relative origin); stitches
        and prints the exact window once every intersecting tile reported."""
        if self._window_bbox is None:
            return
        tiles = self._complete_epoch(
            self._window_partial,
            "_window_floor",
            self._expected_window_tiles,
            epoch,
            key,
            (tuple(origin), np.asarray(block)),
        )
        if tiles is None:
            return
        from akka_game_of_life_tpu_torch.runtime.tiles import stitch

        self.observe_window(epoch, stitch(dict(tiles.values())), self._window_bbox)

    def add_sample(
        self,
        epoch: int,
        key,
        scaled_origin: Tuple[int, int],
        sample: np.ndarray,
    ) -> None:
        """One tile's stride-sampled view at a render-cadence epoch; stitches
        and prints the frame when every tile has reported.  ``key`` is the
        tile's identity (completion is counted by tile, since a tile smaller
        than the stride contributes an empty sample)."""
        tiles = self._complete_epoch(
            self._sample_partial,
            "_sample_floor",
            self._expected_tiles or 0,
            epoch,
            key,
            (tuple(scaled_origin), np.asarray(sample)),
        )
        if tiles is None:
            return
        from akka_game_of_life_tpu_torch.runtime.tiles import stitch

        view = stitch(
            {o: s for o, s in tiles.values() if s.size}  # drop empty slivers
        )
        print(f"epoch {epoch}:", file=self.out)
        print(
            frame_header(self._board_shape, self._render_strides) + "\n"
            + ascii_rows(view),
            file=self.out,
            flush=True,
        )

    def observe_tile(
        self, epoch: int, tile_origin: Tuple[int, int], tile: np.ndarray
    ) -> Optional[np.ndarray]:
        """Feed one shard's tile; returns the assembled board when the epoch
        is complete, else None."""
        if self._expected_tiles is None:
            raise RuntimeError("call expect_tiles(n) before observe_tile")
        if self._max_completed is not None and epoch <= self._max_completed:
            # A replaying tile re-reports epochs already rendered; recreating
            # a partial entry for them would leak (it can never complete).
            return None
        tiles = self._partial.setdefault(epoch, {})
        tiles[tile_origin] = np.asarray(tile)
        if len(tiles) < self._expected_tiles:
            return None
        del self._partial[epoch]
        self._max_completed = epoch
        # Anything still partial at or below the floor can never complete.
        for e in [e for e in self._partial if e <= epoch]:
            del self._partial[e]
        from akka_game_of_life_tpu_torch.runtime.tiles import stitch

        board = stitch(tiles)
        self.observe(epoch, board)
        return board

    def summary(self) -> Optional[dict]:
        """Aggregate run statistics over ALL observed intervals (running
        totals — the bounded history deque is only a window): epochs
        covered, wall seconds, mean rate, last population.  None if no
        intervals were observed."""
        if not self.history:
            return None
        out = {
            "epochs_observed": self._total_epochs,
            "seconds": round(self._total_seconds, 3),
            "cell_updates_per_sec": (
                self._total_cells / self._total_seconds
                if self._total_seconds > 0
                else None
            ),
            "final_population": self.history[-1].population,
        }
        if self._total_obs_seconds > 0:
            # The observation share of the whole run (the breakdown behind
            # any product-vs-bench throughput gap), and the rate the
            # stepper alone sustained outside observation windows.
            out["obs_seconds"] = round(self._total_obs_seconds, 3)
            compute = self._total_seconds - self._total_obs_seconds
            if compute > 0:
                out["stepper_cell_updates_per_sec"] = self._total_cells / compute
        return out

    def close(self) -> None:
        if self._own_file is not None:
            self._own_file.close()
            self._own_file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
