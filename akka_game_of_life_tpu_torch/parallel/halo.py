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
On a mesh that spans processes each process pads and steps only its own
tiles; :func:`ring_shift` moves the strips that cross to another process.
A halo of width k buys k local steps per exchange.  This path steps any rule
(Larger-than-Life included, R cells of halo per step) and any width; the
packed layouts shard through :mod:`.packed_halo2d` and :mod:`.sweep_halo`.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule
from akka_game_of_life_tpu_torch.ops.stencil import step_padded
from akka_game_of_life_tpu_torch.parallel.mesh import (
    COL_AXIS,
    ROW_AXIS,
    GridMesh,
    first_local,
    local_map,
)


_AXIS_ID = {ROW_AXIS: 0, COL_AXIS: 1}


def ring_shift(
    parts: Sequence[Optional[torch.Tensor]],
    mesh: GridMesh,
    axis: str,
    direction: int,
    out: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> List[Optional[torch.Tensor]]:
    """Cyclically send each slot's part to the next slot along ``axis``.

    direction=+1 sends to the higher-indexed neighbour (each slot receives
    from the lower-indexed one), and vice versa.  The received parts are
    copied to the receiving slot's device, or into ``out`` (one view per
    slot) with ``copy_``.  A cross-device ``copy_`` is ordered after the
    work queued on the source card's current stream and before the work
    queued after it on the destination's, so no further synchronisation is
    needed.

    This is the mesh's one exchange primitive.  Only this process's slots
    take part (another rank's entries are ``None``): a pair of local slots
    copies as above, and the pairs that cross to another process travel in
    one ``batch_isend_irecv`` per call (:func:`.distributed.exchange`),
    tagged by axis, direction and receiving slot, posted by both ends in
    receiving-slot order."""
    n = mesh.size
    sources = [mesh.neighbour(i, axis, -direction) for i in range(n)]
    result: List[Optional[torch.Tensor]] = [None] * n
    sends, recvs, recv_slots = [], [], []
    base = (_AXIS_ID[axis] * 2 + (direction > 0)) * n
    for i, j in enumerate(sources):
        here, there = mesh.is_local(i), mesh.is_local(j)
        if here and there:
            if out is None:
                result[i] = parts[j].to(mesh.devices[i])
            else:
                out[i].copy_(parts[j])
                result[i] = out[i]
        elif here:
            recvs.append((mesh.owner(j), base + i, parts[i] if out is None else out[i]))
            recv_slots.append(i)
        elif there:
            sends.append((mesh.owner(i), base + i, parts[j]))
    if sends or recvs:
        from akka_game_of_life_tpu_torch.parallel import distributed

        for i, got in zip(recv_slots, distributed.exchange(sends, recvs)):
            if out is None:
                result[i] = got.to(mesh.devices[i])
            else:
                out[i].copy_(got)
                result[i] = out[i]
    return result


def exchange_halo(
    tiles: Sequence[Optional[torch.Tensor]], mesh: GridMesh, width: int = 1
) -> List[Optional[torch.Tensor]]:
    """Pad each local (h, w) tile to (h+2k, w+2k) with its neighbours'
    cells."""
    k = width
    # Phase 1 — rows. My top halo is the bottom k rows of the tile above me.
    top = ring_shift(local_map(lambda t: t[-k:, :], tiles), mesh, ROW_AXIS, +1)
    bottom = ring_shift(local_map(lambda t: t[:k, :], tiles), mesh, ROW_AXIS, -1)
    padded = [
        None if t is None else torch.cat(p, dim=0)
        for t, p in zip(tiles, zip(top, tiles, bottom))
    ]
    # Phase 2 — columns of the row-padded tile: corners ride along.
    left = ring_shift(local_map(lambda p: p[:, -k:], padded), mesh, COL_AXIS, +1)
    right = ring_shift(local_map(lambda p: p[:, :k], padded), mesh, COL_AXIS, -1)
    return [
        None if p is None else torch.cat(q, dim=1)
        for p, q in zip(padded, zip(left, padded, right))
    ]


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

    def stepped(tiles: List[Optional[torch.Tensor]]) -> List[Optional[torch.Tensor]]:
        h, w = first_local(tiles).shape
        validate_tile_shape(
            mesh, (h * mesh.rows, w * mesh.cols), halo_width, rule.radius
        )
        for _ in range(n_exchanges):
            tiles = local_map(
                lambda p: _local_steps(p, rule, halo_width),
                exchange_halo(tiles, mesh, pad),
            )
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
