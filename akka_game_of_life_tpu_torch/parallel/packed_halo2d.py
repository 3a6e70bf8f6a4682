"""2-D sharded bit-packed stepping: rows × word-columns over the mesh.

Counterpart of ``akka_game_of_life_tpu/parallel/packed_halo2d.py``.  The
packed (H, W/32) words, or the (m, H, W/32) bit planes, are tiled over a
("row", "col") :class:`~.mesh.GridMesh`: rows are exchanged along the row
axis and *whole 32-cell words* along the column axis.

The word halo is communication-avoiding at the bit level: a halo word's
outermost cell loses validity first (it lacks its own off-tile neighbour)
and the garbage front advances one bit per step, so ``hw`` halo words on
each side stay valid at the interior boundary for up to ``32*hw - 1`` local
steps.  The local stepping is *toroidal* on the halo-padded tile: its wraps
only ever corrupt the outermost halo rows and words, which are cut edges,
so the same step serves the torus and the tile.

Exchange order is two phases, word columns first and then rows of the
column-padded tile, so corner words ride along.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen
from akka_game_of_life_tpu_torch.ops.bitpack import LANE_BITS
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
from akka_game_of_life_tpu_torch.parallel.halo import ring_shift
from akka_game_of_life_tpu_torch.parallel.mesh import (
    COL_AXIS,
    ROW_AXIS,
    GridMesh,
    first_local,
    local_map,
    shard_board,
    tile_shape,
)

# One entry per mesh slot; None where another process owns the slot.
Tiles = List[Optional[torch.Tensor]]


def word_halo_width(steps: int) -> int:
    """Halo words per side needed for ``steps`` local steps: the garbage
    front moves 1 bit/step, so hw words survive 32*hw - 1 steps."""
    return (steps + LANE_BITS) // LANE_BITS


def refresh_halos(padded: Tiles, mesh: GridMesh, halo_rows: int, halo_words: int) -> None:
    """One two-phase exchange, in place: refresh the ``halo_rows`` and
    ``halo_words`` halo strips of every local padded tile from its
    neighbours' interiors (another rank's entries are ``None``)."""
    hr, hw = halo_rows, halo_words
    h_loc = first_local(padded).shape[-2] - 2 * hr
    w_loc = first_local(padded).shape[-1] - 2 * hw
    # Phase 1 — word columns; my west halo is my left neighbour's
    # easternmost INTERIOR words.
    if hw:
        rows = slice(hr, hr + h_loc)
        ring_shift(
            local_map(lambda p: p[..., rows, w_loc : w_loc + hw], padded),
            mesh, COL_AXIS, +1,
            out=local_map(lambda p: p[..., rows, :hw], padded),
        )
        ring_shift(
            local_map(lambda p: p[..., rows, hw : 2 * hw], padded),
            mesh, COL_AXIS, -1,
            out=local_map(lambda p: p[..., rows, hw + w_loc :], padded),
        )
    # Phase 2 — full-width rows (the column halos just refreshed on the
    # neighbour ride along, so corner words arrive valid).
    ring_shift(
        local_map(lambda p: p[..., h_loc : h_loc + hr, :], padded),
        mesh, ROW_AXIS, +1,
        out=local_map(lambda p: p[..., :hr, :], padded),
    )
    ring_shift(
        local_map(lambda p: p[..., hr : 2 * hr, :], padded),
        mesh, ROW_AXIS, -1,
        out=local_map(lambda p: p[..., hr + h_loc :, :], padded),
    )


def _sharded_exchange_fn(
    mesh: GridMesh,
    step_one: Optional[Callable[[torch.Tensor], torch.Tensor]],
    *,
    steps_per_call: int,
    halo_rows: int,
    check_tile: Callable[[torch.Tensor], None],
    steps_per_exchange: Optional[int] = None,
    local_advance: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    halo_words: Optional[int] = None,
) -> Callable[[Tiles], Tiles]:
    """The shared two-phase halo-exchange loop over a grid mesh.

    Works on tiles whose LAST TWO axes are (rows, word-cols): the binary
    packed board (h, w/32) and the plane stack (m, h, w/32) alike.  Per
    exchange: word columns first, then full-width rows of the
    column-padded tile (corner words ride along), then the local advance on
    the padded tile.  By default the advance is ``steps_per_exchange``
    applications of ``step_one`` and the halo is exactly as deep as the
    step count; the sweep path (:mod:`.sweep_halo`) passes whole sweeps as
    ``local_advance`` and its own ``halo_words`` (0 on a one-column mesh,
    where the sweep's word wrap is the true torus wrap).

    The loop carries the *padded* tiles and refreshes only their halo strips
    in place (``copy_`` into views).  Every strip is read from a
    neighbour's *interior* rows or words, which no copy of the same phase
    writes, so the order of the copies within a phase does not matter, and
    a tile that is its own neighbour (a 1-long mesh axis) copies between
    disjoint views of itself.  Phase 2 reads the column halos phase 1 wrote:
    on one device the stream orders them; across cards ``copy_`` does, and
    across processes the received strips are copied in before the call
    returns (:func:`.halo.ring_shift`).  An advance that writes a fresh buffer
    (the sweeps) is fine: the views are taken anew at every exchange.
    """
    s = steps_per_exchange if steps_per_exchange is not None else halo_rows
    if steps_per_call % s:
        raise ValueError(
            f"steps_per_call={steps_per_call} must be a multiple of the "
            f"{s} steps per exchange"
        )
    hr = halo_rows
    hw = word_halo_width(s) if halo_words is None else halo_words
    n_exchanges = steps_per_call // s
    if local_advance is None:

        def local_advance(padded: torch.Tensor) -> torch.Tensor:
            for _ in range(s):
                padded = step_one(padded)
            return padded

    def stepped(tiles: Tiles) -> Tiles:
        local_map(check_tile, tiles)
        h_loc, w_loc = first_local(tiles).shape[-2:]

        def pad(t: torch.Tensor) -> torch.Tensor:
            p = t.new_zeros(t.shape[:-2] + (h_loc + 2 * hr, w_loc + 2 * hw))
            p[..., hr : hr + h_loc, hw : hw + w_loc].copy_(t)
            return p

        padded = local_map(pad, tiles)
        for _ in range(n_exchanges):
            refresh_halos(padded, mesh, hr, hw)
            padded = local_map(local_advance, padded)
        return local_map(
            lambda p: p[..., hr : hr + h_loc, hw : hw + w_loc].contiguous(), padded
        )

    return stepped


def _check_halos(h_loc: int, w_loc: int, s: int, hw: int) -> None:
    if h_loc < s:
        raise ValueError(f"per-shard tile has {h_loc} rows < halo rows {s}")
    if w_loc < hw:
        raise ValueError(
            f"per-shard tile has {w_loc} words < word halo {hw}; "
            f"use fewer column shards or fewer steps per exchange"
        )


def sharded_packed2d_step_fn(
    mesh: GridMesh,
    rule,
    *,
    steps_per_call: int = 1,
    halo_rows: int = 1,
) -> Callable[[Tiles], Tiles]:
    """A multi-step advance of a 2-D-sharded packed board through the
    plain packed step.

    ``halo_rows`` is both the row-halo depth and the number of local steps
    per exchange; the word-column halo width follows from it
    (:func:`word_halo_width`).
    """
    rule = resolve_rule(rule)
    bitpack.require_packed_support(rule)
    s, hw = halo_rows, word_halo_width(halo_rows)

    def check(tile: torch.Tensor) -> None:
        if tile.dim() != 2:
            raise ValueError(f"packed tiles are (h, words), got {tuple(tile.shape)}")
        _check_halos(*tile.shape, s, hw)

    return _sharded_exchange_fn(
        mesh,
        lambda p: bitpack.step_packed(p, rule),
        steps_per_call=steps_per_call,
        halo_rows=halo_rows,
        check_tile=check,
    )


def sharded_gen_step_fn(
    mesh: GridMesh,
    rule,
    *,
    steps_per_call: int = 1,
    halo_rows: int = 1,
) -> Callable[[Tiles], Tiles]:
    """Width-k sharded stepping of Generations/WireWorld bit planes
    through the plain plane step: (m, h, w/32) tiles, rows × word-columns
    over the mesh, the plane dim whole in every tile.  The plane transition
    is cell-local, so the alive plane's 1-cell/step front bounds every
    plane."""
    rule = resolve_rule(rule)
    bitpack_gen.require_plane_support(rule)
    s, hw = halo_rows, word_halo_width(halo_rows)
    m = bitpack_gen.n_planes(rule.states)

    def check(planes: torch.Tensor) -> None:
        if planes.dim() != 3 or planes.shape[0] != m:
            raise ValueError(f"expected {m} planes for {rule.states} states")
        _check_halos(*planes.shape[1:], s, hw)

    return _sharded_exchange_fn(
        mesh,
        lambda p: bitpack_gen.step_gen(p, rule),
        steps_per_call=steps_per_call,
        halo_rows=halo_rows,
        check_tile=check,
    )


def shard_packed2d(packed, mesh: GridMesh) -> Tiles:
    """Packed (H, W/32) words or (m, H, W/32) planes as one tile per slot;
    raises unless the mesh divides rows and words evenly."""
    try:
        tile_shape(packed.shape, mesh)
    except ValueError:
        raise ValueError(
            f"packed grid {tuple(packed.shape[-2:])} not divisible by mesh "
            f"{mesh.shape}"
        ) from None
    return shard_board(packed, mesh)
