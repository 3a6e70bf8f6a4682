"""Halo exchange over the mesh for the dense (H, W) uint8 board.

Counterpart of ``akka_game_of_life_tpu/parallel/halo.py``.  Where the JAX
package ring-shifts boundary strips with ``lax.ppermute`` inside
``shard_map``, one process here looks up each slot's neighbour on the
:class:`~.mesh.GridMesh` and copies the strip to the slot's device.  The
exchange has the same two phases:

- phase 1 takes boundary *rows* from the mesh-row neighbours;
- phase 2 takes boundary *columns* of the already row-padded tile from the
  mesh-column neighbours, which carries the corner cells with them.

The wrap-around is the mesh-level torus, so the board is globally toroidal.
A halo of width k buys k local steps per exchange.  This path steps any rule
(Larger-than-Life included, R cells of halo per step) and any width; the
packed layouts shard through :mod:`.packed_halo2d` and :mod:`.sweep_halo`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule
from akka_game_of_life_tpu_torch.ops.stencil import step_padded
from akka_game_of_life_tpu_torch.parallel.mesh import COL_AXIS, ROW_AXIS, GridMesh


def ring_shift(
    parts: Sequence[torch.Tensor],
    mesh: GridMesh,
    axis: str,
    direction: int,
    out: Optional[Sequence[torch.Tensor]] = None,
) -> List[torch.Tensor]:
    """Cyclically send each slot's part to the next slot along ``axis``.

    direction=+1 sends to the higher-indexed neighbour (each slot receives
    from the lower-indexed one), and vice versa.  The received parts are
    copied to the receiving slot's device, or into ``out`` (one view per
    slot) with ``copy_``.  A cross-device ``copy_`` is ordered after the
    work queued on the source card's current stream and before the work
    queued after it on the destination's, so no further synchronisation is
    needed."""
    sources = [parts[mesh.neighbour(i, axis, -direction)] for i in range(mesh.size)]
    if out is None:
        return [src.to(dev) for src, dev in zip(sources, mesh.devices)]
    for dst, src in zip(out, sources):
        dst.copy_(src)
    return list(out)


def exchange_halo(
    tiles: Sequence[torch.Tensor], mesh: GridMesh, width: int = 1
) -> List[torch.Tensor]:
    """Pad each local (h, w) tile to (h+2k, w+2k) with its neighbours'
    cells."""
    k = width
    # Phase 1 — rows. My top halo is the bottom k rows of the tile above me.
    top = ring_shift([t[-k:, :] for t in tiles], mesh, ROW_AXIS, +1)
    bottom = ring_shift([t[:k, :] for t in tiles], mesh, ROW_AXIS, -1)
    padded = [torch.cat(p, dim=0) for p in zip(top, tiles, bottom)]
    # Phase 2 — columns of the row-padded tile: corners ride along.
    left = ring_shift([p[:, -k:] for p in padded], mesh, COL_AXIS, +1)
    right = ring_shift([p[:, :k] for p in padded], mesh, COL_AXIS, -1)
    return [torch.cat(p, dim=1) for p in zip(left, padded, right)]


def _local_steps(tile: torch.Tensor, rule: Rule, k: int) -> torch.Tensor:
    """k steps on a (k·R)-halo-padded tile, shrinking the halo by the rule's
    radius R per step: (h+2kR, w+2kR) → (h, w)."""
    for _ in range(k):
        tile = step_padded(tile, rule)
    return tile


def sharded_step_fn(
    mesh: GridMesh,
    rule,
    *,
    steps_per_call: int = 1,
    halo_width: int = 1,
) -> Callable[[List[torch.Tensor]], List[torch.Tensor]]:
    """A ``steps_per_call``-generation advance of a board held as one
    dense tile per slot: a ``halo_width``-step-deep halo exchange, then
    ``halo_width`` plain steps on each tile, ``steps_per_call / halo_width``
    times."""
    rule = resolve_rule(rule)
    if steps_per_call % halo_width:
        raise ValueError(
            f"steps_per_call={steps_per_call} must be a multiple of "
            f"halo_width={halo_width}"
        )
    n_exchanges = steps_per_call // halo_width
    # halo_width counts STEPS per exchange; the exchanged pad is deeper for
    # radius-R rules (each step consumes R halo cells per side).
    pad = halo_width * rule.radius

    def stepped(tiles: List[torch.Tensor]) -> List[torch.Tensor]:
        h, w = tiles[0].shape
        validate_tile_shape(
            mesh, (h * mesh.rows, w * mesh.cols), halo_width, rule.radius
        )
        for _ in range(n_exchanges):
            tiles = [
                _local_steps(p, rule, halo_width)
                for p in exchange_halo(tiles, mesh, pad)
            ]
        return tiles

    return stepped


def exchange_bytes(
    mesh_shape, tile_shape, pad: int, itemsize: int = 1
) -> int:
    """Bytes ONE width-``pad`` halo exchange moves across the whole mesh.

    Mirrors :func:`exchange_halo`'s two phases per tile: ``2·pad`` boundary
    rows of the (h, w) tile along the row axis, then ``2·pad`` boundary
    columns of the row-padded ``(h+2·pad, w)`` tile along the column axis.
    A 1-long mesh axis moves nothing between devices (the tile is its own
    neighbour).  ``itemsize`` prices the element (1 for dense uint8 boards,
    4 for packed words)."""
    mr, mc = mesh_shape
    h, w = tile_shape
    per_tile = 0
    if mr > 1:
        per_tile += 2 * pad * w
    if mc > 1:
        per_tile += 2 * pad * (h + 2 * pad)
    return mr * mc * per_tile * itemsize


def validate_tile_shape(
    mesh: GridMesh, board_shape, halo_width: int, radius: int = 1
) -> None:
    """Halo exchange needs tiles at least as tall/wide as the exchanged pad
    (``halo_width`` steps × the rule's radius in cells per side)."""
    pad = halo_width * radius
    h = board_shape[-2] // mesh.rows
    w = board_shape[-1] // mesh.cols
    if h < pad or w < pad:
        raise ValueError(
            f"tile {(h, w)} smaller than the {pad}-cell halo "
            f"({halo_width} steps x radius {radius}); "
            f"use a smaller mesh or halo"
        )
