"""Sharded sweeps: the CUDA packed and plane sweeps on halo-padded tiles.

Counterpart of ``akka_game_of_life_tpu/parallel/pallas_halo.py``
(``sharded_pallas_step_fn`` and ``sharded_gen_pallas_step_fn``, TPU kernel
#6 of PERF.md).  No new kernel: each tile of the mesh is padded with halo
rows (and, when the mesh has more than one column, halo words), the halos
are exchanged by :mod:`.packed_halo2d`'s two-phase loop, and then sweeps of
``ops/packed_sweep.py`` (binary words) or ``ops/gen_sweep.py`` (bit planes),
back to back, advance the padded tile ``s`` generations.

The sweeps wrap every index modulo the padded tile's rows and words, so
they run the padded tile *as a torus*.  The wraps corrupt only the
outermost halo rows and words, cut edges whose true neighbours live off the
tile, and the garbage front moves one row, or one bit, per generation.  So
an exchange buys ``s`` generations when

- the row halo is p ≥ s rows (this module takes p = s),
- with more than one mesh column, hw halo words hold 32·hw − 1 ≥ s
  generations (:func:`.packed_halo2d.word_halo_width`),
- with one mesh column, hw = 0: the sweep's own word wrap is the true
  torus wrap.

The TPU version sized p to half a VMEM row block, needed tiles a whole
number of blocks tall and ran ``g`` sweeps of one depth ``k`` per exchange
(s = g·k).  The CUDA sweeps take any height, so the only limits are the
tile's own size (p ≤ tile rows, hw ≤ tile words) and each sweep's depth
(at most ``packed_sweep.MAX_STEPS_PER_SWEEP``); an exchange runs the sweeps
the single-device path would run for s generations, so a prime s costs a
few sweeps, not s one-generation ones.  On a CUDA tile every
sweep launches the kernel; on a CPU tile the wrappers run their plain
versions.  Nothing moves a tile or falls back.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from akka_game_of_life_tpu_torch.ops import bitpack, gen_sweep, packed_sweep
from akka_game_of_life_tpu_torch.ops.bitpack import LANE_BITS
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
from akka_game_of_life_tpu_torch.parallel.mesh import GridMesh
from akka_game_of_life_tpu_torch.parallel.packed_halo2d import (
    Tiles,
    _sharded_exchange_fn,
    word_halo_width,
)


class ExchangePlan(NamedTuple):
    """One exchange: sweeps of the given ``depths`` back to back, with
    ``halo_rows`` and ``halo_words`` of halo per side."""

    depths: Tuple[int, ...]
    halo_rows: int
    halo_words: int

    @property
    def steps_per_exchange(self) -> int:
        return sum(self.depths)


def max_steps_per_exchange(tile_rows: int, tile_words: int, mesh_cols: int) -> int:
    """The most generations one exchange can buy on a (rows, words) tile:
    the row halo must fit the tile (p ≤ rows), and with more than one mesh
    column so must the word halo (32·words − 1 generations)."""
    limit = tile_rows
    if mesh_cols > 1:
        limit = min(limit, LANE_BITS * tile_words - 1)
    return limit


def plan_exchange(steps_per_call: int, max_steps: int) -> List[int]:
    """The sweep depths of one exchange.

    An exchange buys s generations, the largest divisor of
    ``steps_per_call`` that is at most ``max_steps``, and runs them as the
    sweeps ``packed_sweep.plan_sweeps`` gives for s:
    ``DEFAULT_STEPS_PER_SWEEP`` deep with the remainder last.  At 65536² on
    four row tiles: s = 60, six sweeps of 10, one exchange per
    60-generation call, the single-device run's launches per tile.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call={steps_per_call} must be >= 1")
    s = max(
        d for d in range(1, min(steps_per_call, max_steps) + 1)
        if steps_per_call % d == 0
    )
    return packed_sweep.plan_sweeps(s)


def _wire_sharded_sweep(
    mesh: GridMesh,
    *,
    steps_per_call: int,
    sweep: Callable[[torch.Tensor, int], torch.Tensor],
    check: Callable[[torch.Tensor], None],
) -> Callable[[Tiles], Tiles]:
    """The shared body of the sharded sweeps: plan the exchange for the
    tiles' shape, wrap its sweeps as the local advance, and run them
    through the two-phase exchange loop.  ``fn.plan(tile_shape)`` gives the
    :class:`ExchangePlan` of a (rows, words) tile."""
    loops: Dict[Tuple[int, int], Callable[[Tiles], Tiles]] = {}

    def plan(tile_shape) -> ExchangePlan:
        rows, words = tile_shape[-2], tile_shape[-1]
        depths = tuple(plan_exchange(
            steps_per_call, max_steps_per_exchange(rows, words, mesh.cols)
        ))
        s = sum(depths)
        return ExchangePlan(depths, s, word_halo_width(s) if mesh.cols > 1 else 0)

    def fn(tiles: Tiles) -> Tiles:
        for t in tiles:
            check(t)
        key = tuple(tiles[0].shape[-2:])
        if key not in loops:
            p = plan(key)

            def advance(padded: torch.Tensor, depths=p.depths) -> torch.Tensor:
                for k in depths:
                    padded = sweep(padded, k)
                return padded

            loops[key] = _sharded_exchange_fn(
                mesh,
                None,
                steps_per_call=steps_per_call,
                halo_rows=p.halo_rows,
                check_tile=lambda t: None,
                steps_per_exchange=p.steps_per_exchange,
                local_advance=advance,
                halo_words=p.halo_words,
            )
        return loops[key](tiles)

    fn.plan = plan
    return fn


def sharded_sweep_step_fn(
    mesh: GridMesh,
    rule,
    *,
    steps_per_call: int = 1,
) -> Callable[[Tiles], Tiles]:
    """A ``steps_per_call``-generation advance of a packed board held as
    (h, w/32) int32 word tiles, one per slot, each padded tile stepped by
    the packed sweep (``csrc/packed_sweep.cu`` on a CUDA tile)."""
    rule = resolve_rule(rule)
    bitpack.require_packed_support(rule)

    def check(tile: torch.Tensor) -> None:
        if tile.dim() != 2:
            raise ValueError(f"packed tiles are (h, words), got {tuple(tile.shape)}")

    return _wire_sharded_sweep(
        mesh,
        steps_per_call=steps_per_call,
        sweep=lambda x, k: packed_sweep.packed_sweep(x, rule, k),
        check=check,
    )


def sharded_gen_sweep_step_fn(
    mesh: GridMesh,
    rule,
    *,
    steps_per_call: int = 1,
) -> Callable[[Tiles], Tiles]:
    """The sharded plane sweep for Generations/WireWorld: (m, h, w/32)
    int32 plane tiles, one per slot, each padded tile stepped by the plane
    sweep (``csrc/gen_sweep.cu`` on a CUDA tile).  The plane transition is
    cell-local, so the alive plane's 1-cell/step front bounds every plane
    and the plan is the binary sweep's."""
    rule = resolve_rule(rule)
    m = gen_sweep.require_sweep_support(rule)

    def check(planes: torch.Tensor) -> None:
        if planes.dim() != 3 or planes.shape[0] != m:
            raise ValueError(f"expected {m} planes for {rule.states} states")

    return _wire_sharded_sweep(
        mesh,
        steps_per_call=steps_per_call,
        sweep=lambda x, k: gen_sweep.gen_sweep(x, rule, k),
        check=check,
    )
