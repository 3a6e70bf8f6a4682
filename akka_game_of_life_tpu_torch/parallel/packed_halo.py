"""Sharded bit-packed stepping over a 1-D row ring.

Counterpart of ``akka_game_of_life_tpu/parallel/packed_halo.py``, under its
names.  The row ring is the (n, 1) mesh of :mod:`.packed_halo2d`: every tile
holds whole rows, a k-row halo buys k plain packed steps per exchange, and
the one-column word halo is the tile's own far edge, the true torus wrap.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from akka_game_of_life_tpu_torch.parallel.mesh import GridMesh, visible_devices
from akka_game_of_life_tpu_torch.parallel.packed_halo2d import (
    Tiles,
    shard_packed2d,
    sharded_packed2d_step_fn,
)

shard_packed = shard_packed2d


def make_row_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> GridMesh:
    """An (n, 1) mesh over the first ``n_devices`` of ``devices`` (default:
    every visible card)."""
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} available")
    return GridMesh((n, 1), devices[:n])


def sharded_packed_step_fn(
    mesh: GridMesh, rule, *, steps_per_call: int = 1, halo_width: int = 1
) -> Callable[[Tiles], Tiles]:
    """A multi-step advance of a row-sharded packed board: a ``halo_width``
    row halo and as many local steps per exchange."""
    if mesh.cols != 1:
        raise ValueError(f"the row ring needs a one-column mesh, got {mesh.shape}")
    return sharded_packed2d_step_fn(
        mesh, rule, steps_per_call=steps_per_call, halo_rows=halo_width
    )
