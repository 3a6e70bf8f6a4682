"""Tile layout: partitioning the global torus into coarse per-worker shards.

The reference's placement is one actor per *cell*, scattered uniformly at
random with zero locality (``BoardCreator.scala:33-36,65-70``) — ~18 network
messages per cell per epoch.  The TPU build's unit of placement is a
contiguous rectangular tile (a whole sub-grid per worker, held in HBM), so a
worker's per-epoch communication is its 1-cell boundary ring, and the Moore
neighborhood of a *tile* is the 8 surrounding tiles on the tile torus —
the same geometry as ``generateNeighbourAddresses`` (``package.scala:17-28``),
lifted from cells to tiles and made properly toroidal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from akka_game_of_life_tpu_torch.parallel.mesh import factor_2d

TileId = Tuple[int, int]  # (tile_row, tile_col)


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """An R×C tiling of an (H, W) torus."""

    board_shape: Tuple[int, int]
    grid: Tuple[int, int]  # (R, C) tiles

    def __post_init__(self) -> None:
        h, w = self.board_shape
        r, c = self.grid
        if h % r or w % c:
            raise ValueError(f"board {self.board_shape} not divisible by tiles {self.grid}")

    @property
    def tile_shape(self) -> Tuple[int, int]:
        return (self.board_shape[0] // self.grid[0], self.board_shape[1] // self.grid[1])

    @property
    def tile_ids(self) -> List[TileId]:
        r, c = self.grid
        return [(i, j) for i in range(r) for j in range(c)]

    def origin(self, tile: TileId) -> Tuple[int, int]:
        th, tw = self.tile_shape
        return (tile[0] * th, tile[1] * tw)

    def extract(self, board, tile: TileId):
        y, x = self.origin(tile)
        th, tw = self.tile_shape
        return board[y : y + th, x : x + tw]

    def neighbors(self, tile: TileId) -> Dict[str, TileId]:
        """The 8 Moore neighbors on the tile torus, keyed by direction."""
        r, c = self.grid
        i, j = tile
        return {
            "nw": ((i - 1) % r, (j - 1) % c),
            "n": ((i - 1) % r, j),
            "ne": ((i - 1) % r, (j + 1) % c),
            "w": (i, (j - 1) % c),
            "e": (i, (j + 1) % c),
            "sw": ((i + 1) % r, (j - 1) % c),
            "s": ((i + 1) % r, j),
            "se": ((i + 1) % r, (j + 1) % c),
        }


def layout_for_workers(board_shape: Tuple[int, int], n_workers: int) -> TileLayout:
    """Choose a near-square tile grid with one tile per worker (falling back
    toward fewer tiles until the board divides evenly)."""
    for n in range(n_workers, 0, -1):
        r, c = factor_2d(n)
        if board_shape[0] % r == 0 and board_shape[1] % c == 0:
            return TileLayout(board_shape, (r, c))
    raise ValueError(f"no feasible tiling of {board_shape} for {n_workers} workers")


def stitch(tiles_by_origin) -> "np.ndarray":
    """Assemble origin-keyed tiles {(y, x): (h, w) array} into one board.

    The single tile-to-board stitcher shared by the render observer and the
    frontend's checkpoint/final assembly."""
    import numpy as np

    ys = sorted({o[0] for o in tiles_by_origin})
    xs = sorted({o[1] for o in tiles_by_origin})
    rows = []
    for y in ys:
        rows.append(
            np.concatenate([np.asarray(tiles_by_origin[(y, x)]) for x in xs], axis=1)
        )
    return np.concatenate(rows, axis=0)


@dataclasses.dataclass
class Ring:
    """A tile's width-k boundary ring at one epoch: what neighbors need.

    Width 1 is the reference's per-epoch exchange contract; width k>1 is the
    communication-avoiding trade (one exchange buys k local steps — the
    cluster analog of ``parallel/halo.py``'s on-device width-k halos and of
    the reference's history-buffered asynchrony, ``CellActor.scala:34-47``).
    The ring is purely spatial: a tile at epoch E always *has* its k
    outermost rows/cols, so publishing a wide ring needs no lookahead.
    """

    top: object  # (k, w) rows
    bottom: object  # (k, w)
    left: object  # (h, k) cols
    right: object  # (h, k)
    corners: Dict[str, object]  # nw/ne/sw/se (k, k) blocks

    @classmethod
    def of(cls, tile, width: int = 1) -> "Ring":
        k = width
        h, w = tile.shape
        if h < k or w < k:
            raise ValueError(f"tile {tile.shape} smaller than ring width {k}")
        return cls(
            top=tile[:k, :].copy(),
            bottom=tile[-k:, :].copy(),
            left=tile[:, :k].copy(),
            right=tile[:, -k:].copy(),
            corners={
                "nw": tile[:k, :k].copy(),
                "ne": tile[:k, -k:].copy(),
                "sw": tile[-k:, :k].copy(),
                "se": tile[-k:, -k:].copy(),
            },
        )

    @property
    def width(self) -> int:
        return len(self.top)  # (k, w): first axis is the ring width

    @property
    def nbytes(self) -> int:
        """Dense (unpacked) cell bytes of the ring — the logical payload
        size the wire-cost counters account, whatever the encoding."""
        import numpy as np

        return int(
            sum(
                np.asarray(p).size
                for p in (self.top, self.bottom, self.left, self.right)
            )
            + sum(np.asarray(c).size for c in self.corners.values())
        )
