"""The 2-D device mesh of one process: one board tile per mesh slot.

Counterpart of ``akka_game_of_life_tpu/parallel/mesh.py``.  The JAX package
tiles the torus over a ``jax.sharding.Mesh`` with axes ("row", "col") and
lets ``shard_map`` run one program per device.  Here one process drives a
:class:`GridMesh`: a (rows, cols) grid of slots, each naming the device that
holds its tile, and a sharded board is a plain list of tiles in row-major
slot order.  A device may fill more than one slot, so a mesh of any shape
runs on one card (or on the CPU in the tests); with as many cards as slots
every tile sits on a card of its own.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

ROW_AXIS = "row"
COL_AXIS = "col"


def factor_2d(n: int) -> Tuple[int, int]:
    """Factor a device count into the most-square (rows, cols) grid."""
    best = (n, 1)
    for r in range(1, int(math.isqrt(n)) + 1):
        if n % r == 0:
            best = (n // r, r)
    return best


class GridMesh:
    """A (rows, cols) grid of device slots, row-major; slots may repeat a
    device.  The grid is a torus: the last row and column neighbour the
    first."""

    def __init__(self, shape: Tuple[int, int], devices: Sequence) -> None:
        rows, cols = (int(v) for v in shape)
        devices = [torch.device(d) for d in devices]
        if rows < 1 or cols < 1 or rows * cols != len(devices):
            raise ValueError(
                f"mesh shape {(rows, cols)} needs {rows * cols} devices, "
                f"have {len(devices)}"
            )
        self.shape = (rows, cols)
        self.devices = devices

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return len(self.devices)

    def device_at(self, r: int, c: int) -> torch.device:
        return self.devices[r * self.cols + c]

    def coords(self, i: int) -> Tuple[int, int]:
        """The (row, col) of slot ``i``."""
        return divmod(i, self.cols)

    def neighbour(self, i: int, axis: str, offset: int) -> int:
        """The slot ``offset`` steps from slot ``i`` along ``axis``, around
        the torus."""
        r, c = self.coords(i)
        if axis == ROW_AXIS:
            r = (r + offset) % self.rows
        elif axis == COL_AXIS:
            c = (c + offset) % self.cols
        else:
            raise ValueError(f"unknown mesh axis {axis!r}")
        return r * self.cols + c

    def distinct_devices(self) -> List[torch.device]:
        """Each device of the mesh once, in slot order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"GridMesh({self.shape}, {[str(d) for d in self.devices]})"


def visible_devices() -> List[torch.device]:
    """Every visible CUDA card; raises when CUDA is absent (a CPU mesh names
    its ``cpu`` slots, the mesh never moves to the CPU on its own)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=['cpu', ...] to run the "
            "plain PyTorch versions on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_grid_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> GridMesh:
    """A 2-D mesh with axes ("row", "col") over ``devices`` (default: every
    visible card).  ``shape=None`` factors the device count as square as
    possible (8 devices → 4×2); a (1, 1) mesh runs the sharded code on one
    tile."""
    devices = list(devices) if devices is not None else visible_devices()
    if shape is None:
        shape = factor_2d(len(devices))
    return GridMesh(shape, devices)


def _as_tensor(board) -> torch.Tensor:
    """A host array or a tensor as a tensor; uint32 words become the port's
    int32 words of the same bits."""
    if isinstance(board, torch.Tensor):
        return board
    board = np.ascontiguousarray(board)
    if board.dtype == np.uint32:
        board = board.view(np.int32)
    return torch.from_numpy(board)


def tile_shape(board_shape, mesh: GridMesh) -> Tuple[int, int]:
    """The (rows, cols) of one tile of a ``board_shape`` board (its last two
    axes) on ``mesh``; raises unless the mesh divides them evenly."""
    h, w = board_shape[-2], board_shape[-1]
    if h % mesh.rows or w % mesh.cols:
        raise ValueError(
            f"board {(h, w)} not evenly divisible by mesh {mesh.shape}"
        )
    return h // mesh.rows, w // mesh.cols


def shard_board(board, mesh: GridMesh) -> List[torch.Tensor]:
    """Split an (..., H, W) host array or tensor into equal tiles, one per
    slot in row-major order, each contiguous on its slot's device."""
    x = _as_tensor(board)
    th, tw = tile_shape(x.shape, mesh)
    tiles = []
    for i, dev in enumerate(mesh.devices):
        r, c = mesh.coords(i)
        tile = x[..., r * th : (r + 1) * th, c * tw : (c + 1) * tw]
        tiles.append(tile.to(dev).contiguous())
    return tiles


def gather(tiles: Sequence[torch.Tensor], mesh: GridMesh) -> np.ndarray:
    """The whole board on the host, O(board): the tiles concatenated in
    their mesh places.  int32 words come back as the JAX package's uint32
    words of the same bits."""
    if len(tiles) != mesh.size:
        raise ValueError(f"{len(tiles)} tiles for a mesh of {mesh.size} slots")
    host = [t.detach().cpu() for t in tiles]
    bands = [
        torch.cat(host[r * mesh.cols : (r + 1) * mesh.cols], dim=-1)
        for r in range(mesh.rows)
    ]
    out = torch.cat(bands, dim=-2).contiguous().numpy()
    return out.view(np.uint32) if out.dtype == np.int32 else out
