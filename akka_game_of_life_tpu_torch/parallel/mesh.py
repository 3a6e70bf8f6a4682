"""The 2-D device mesh: one board tile per mesh slot, on one process or
several.

Counterpart of ``akka_game_of_life_tpu/parallel/mesh.py``.  The JAX package
tiles the torus over a ``jax.sharding.Mesh`` with axes ("row", "col") and
lets ``shard_map`` run one program per device.  Here a :class:`GridMesh` is
a (rows, cols) grid of slots, each naming the device that holds its tile and
the process (rank) that owns it, and a sharded board is a plain list of
tiles in row-major slot order.  A device may fill more than one slot, so a
mesh of any shape runs on one card (or on the CPU in the tests); with as
many cards as slots every tile sits on a card of its own.

A multi-process run (:mod:`.distributed`) lays the slots out rank-major, as
``jax.devices()`` orders a pod: rank 0's devices fill the first slots, so
a (2, 2) mesh over two ranks of two slots gives rank 0 mesh row 0.  Each
process holds only its own slots' tiles; the others' entries are ``None``.
A single-process mesh has every slot local.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.parallel import distributed

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
    first.  ``owners[i]`` is the rank that holds slot ``i`` (default: this
    process, every slot local); ``rank`` is this process's."""

    def __init__(
        self,
        shape: Tuple[int, int],
        devices: Sequence,
        owners: Optional[Sequence[int]] = None,
    ) -> None:
        rows, cols = (int(v) for v in shape)
        devices = [torch.device(d) for d in devices]
        if rows < 1 or cols < 1 or rows * cols != len(devices):
            raise ValueError(
                f"mesh shape {(rows, cols)} needs {rows * cols} devices, "
                f"have {len(devices)}"
            )
        self.shape = (rows, cols)
        self.devices = devices
        self.rank = distributed.process_info()[0]
        self.owners = (
            [self.rank] * len(devices) if owners is None else [int(o) for o in owners]
        )
        if len(self.owners) != len(devices):
            raise ValueError(f"{len(self.owners)} owners for {len(devices)} slots")
        self.local_slots = [i for i, o in enumerate(self.owners) if o == self.rank]

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multi_process(self) -> bool:
        return len(self.local_slots) != self.size

    def owner(self, i: int) -> int:
        return self.owners[i]

    def is_local(self, i: int) -> bool:
        return self.owners[i] == self.rank

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
        """Each device of this process's slots once, in slot order."""
        return list(dict.fromkeys(self.devices[i] for i in self.local_slots))

    def __repr__(self) -> str:
        owners = "" if not self.multi_process else f", owners={self.owners}"
        return f"GridMesh({self.shape}, {[str(d) for d in self.devices]}{owners})"


def local_map(fn: Callable, tiles: Sequence) -> List:
    """``fn`` of each local tile; ``None`` (another rank's slot) stays."""
    return [None if t is None else fn(t) for t in tiles]


def first_local(tiles: Sequence) -> torch.Tensor:
    """A tile this process holds (every tile of a mesh has one shape)."""
    for t in tiles:
        if t is not None:
            return t
    raise ValueError("no local tile: this process owns no slot of the mesh")


def visible_devices() -> List[torch.device]:
    """Every visible CUDA card; raises when CUDA is absent (a CPU mesh names
    its ``cpu`` slots, the mesh never moves to the CPU on its own)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=['cpu', ...] to run the "
            "plain PyTorch versions on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_slots(devices: Sequence) -> Tuple[List[torch.device], List[int]]:
    """The slots of a mesh over every process's ``devices`` (this process's
    list; other ranks pass theirs), rank-major, with each slot's owner.  A
    collective in a multi-process run; this process's list otherwise."""
    local = [str(torch.device(d)) for d in devices]
    per_rank = distributed.all_gather_object(local)
    slots = [torch.device(d) for devs in per_rank for d in devs]
    owners = [r for r, devs in enumerate(per_rank) for _ in devs]
    return slots, owners


def make_grid_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> GridMesh:
    """A 2-D mesh with axes ("row", "col") over ``devices`` (default: every
    visible card) of every process.  ``shape=None`` factors the global slot
    count as square as possible (8 devices → 4×2); a (1, 1) mesh runs the
    sharded code on one tile.  In a multi-process run each rank passes its
    own devices, and every rank must call it."""
    devices = list(devices) if devices is not None else visible_devices()
    slots, owners = global_slots(devices)
    if shape is None:
        shape = factor_2d(len(slots))
    return GridMesh(shape, slots, owners)


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


def shard_board(board, mesh: GridMesh) -> List[Optional[torch.Tensor]]:
    """Split an (..., H, W) host array or tensor into equal tiles, one per
    slot in row-major order, each contiguous on its slot's device; another
    rank's slots get ``None`` (every rank passes the whole board)."""
    x = _as_tensor(board)
    th, tw = tile_shape(x.shape, mesh)
    tiles = []
    for i, dev in enumerate(mesh.devices):
        if not mesh.is_local(i):
            tiles.append(None)
            continue
        r, c = mesh.coords(i)
        tile = x[..., r * th : (r + 1) * th, c * tw : (c + 1) * tw]
        tiles.append(tile.to(dev).contiguous())
    return tiles


def assemble(host: Sequence[torch.Tensor], mesh: GridMesh) -> np.ndarray:
    """Host tiles, one per slot, concatenated in their mesh places; int32
    words come back as uint32 words of the same bits."""
    bands = [
        torch.cat(list(host[r * mesh.cols : (r + 1) * mesh.cols]), dim=-1)
        for r in range(mesh.rows)
    ]
    out = torch.cat(bands, dim=-2).contiguous().numpy()
    return out.view(np.uint32) if out.dtype == np.int32 else out


def gather(
    tiles: Sequence[Optional[torch.Tensor]], mesh: GridMesh, dst: Optional[int] = None
) -> Optional[np.ndarray]:
    """The whole board on the host, O(board): the tiles concatenated in
    their mesh places.  int32 words come back as the JAX package's uint32
    words of the same bits.  Across processes the tiles are fetched from
    their owners (:func:`.distributed.fetch`): on every rank, or on rank
    ``dst`` only (None elsewhere)."""
    if len(tiles) != mesh.size:
        raise ValueError(f"{len(tiles)} tiles for a mesh of {mesh.size} slots")
    return distributed.fetch(tiles, mesh, dst=dst)
