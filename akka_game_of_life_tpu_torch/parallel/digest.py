"""Sharded digest fold: per-tile fingerprints merged on the host — the mesh
paths certify the board without ever gathering it.

Counterpart of ``akka_game_of_life_tpu/parallel/digest.py``.  Each tile is
digested on its own device with its GLOBAL cell offsets, through
``ops/digest.py``'s ``digest_{dense,packed,planes}(…, row0, wordcol0)``
(whose empty-block skip then works per tile), and the lanes merge with
``digest.merge_lanes``, where the JAX package uses ``psum``.  Two lanes per
tile reach the host, whatever the board's size.  One function per sharded
layout:

- :func:`sharded_dense_digest_fn`: dense uint8 (H, W) tiles
  (:mod:`.halo`'s layout);
- :func:`sharded_packed2d_digest_fn`: packed (H, W/32) int32 word tiles
  (:mod:`.packed_halo2d`'s and :mod:`.sweep_halo`'s layout);
- :func:`sharded_gen_digest_fn`: (m, H, W/32) bit-plane tiles.

Each returns a ``tiles -> (2,) uint32 lanes`` closure whose value is
bit-identical to the single-device digest of the whole board.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.ops import bitpack_gen
from akka_game_of_life_tpu_torch.ops.bitpack import LANE_BITS
from akka_game_of_life_tpu_torch.ops.digest import (
    digest_dense,
    digest_packed,
    digest_planes,
    merge_lanes,
)
from akka_game_of_life_tpu_torch.parallel.mesh import GridMesh

DigestFn = Callable[[Sequence[torch.Tensor]], np.ndarray]


def _origins(mesh: GridMesh, tile_rows: int, tile_cols: int) -> List[Tuple[int, int]]:
    """Each slot's global (row0, col0) in tile units of the given size."""
    return [
        (r * tile_rows, c * tile_cols)
        for r, c in (mesh.coords(i) for i in range(mesh.size))
    ]


def _fold(mesh: GridMesh, tile_rows: int, tile_cols: int, lanes) -> DigestFn:
    origins = _origins(mesh, tile_rows, tile_cols)

    def fn(tiles: Sequence[torch.Tensor]) -> np.ndarray:
        if len(tiles) != mesh.size:
            raise ValueError(f"{len(tiles)} tiles for a mesh of {mesh.size} slots")
        parts = [lanes(t, r0, c0) for t, (r0, c0) in zip(tiles, origins)]
        return merge_lanes(p.cpu().numpy() for p in parts)

    return fn


def sharded_dense_digest_fn(mesh: GridMesh, shape: Tuple[int, int]) -> DigestFn:
    """Digest of a dense (H, W) uint8 board held as tiles."""
    h, w = shape
    return _fold(
        mesh, h // mesh.rows, w // mesh.cols,
        lambda t, r0, c0: digest_dense(t, r0, c0, width=w),
    )


def sharded_packed2d_digest_fn(mesh: GridMesh, shape: Tuple[int, int]) -> DigestFn:
    """Digest of a packed (H, W/32) board held as word tiles (the plain
    sharded step's and the sharded sweep's layout)."""
    h, w = shape
    return _fold(
        mesh, h // mesh.rows, (w // LANE_BITS) // mesh.cols,
        lambda t, r0, wc0: digest_packed(t, w, r0, wc0),
    )


def sharded_gen_digest_fn(
    mesh: GridMesh, shape: Tuple[int, int], states: int
) -> DigestFn:
    """Digest of (m, H, W/32) Generations/WireWorld bit planes held as
    plane tiles."""
    h, w = shape
    m = bitpack_gen.n_planes(states)

    def lanes(planes: torch.Tensor, r0: int, wc0: int) -> torch.Tensor:
        if planes.shape[0] != m:
            raise ValueError(f"expected {m} planes for {states} states, got {planes.shape[0]}")
        return digest_planes(planes, w, r0, wc0)

    return _fold(mesh, h // mesh.rows, (w // LANE_BITS) // mesh.cols, lanes)
