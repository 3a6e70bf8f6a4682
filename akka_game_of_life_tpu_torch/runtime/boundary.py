"""Epoch-tagged boundary-ring store with pull semantics and bounded history.

This reproduces the reference's neighbor-state exchange contract
(``CellActor.scala:71-88``) at tile granularity:

- workers *push* their boundary ring after computing each epoch (the analog
  of a cell's state landing in its ``History`` map);
- workers *pull* the assembled halo for an epoch; a pull for an epoch whose
  neighbor rings haven't all arrived is **queued** and answered when the last
  ring lands — exactly the reference's request queue for not-yet-computed
  epochs (``CellActor.scala:75-77,82-88``);
- history is **bounded**: rings older than the last durable checkpoint are
  pruned (the reference's histories grow forever — SURVEY.md §2 bug 5 — and
  here the checkpoint, not an unbounded log, is the replay source).

Assembly: a tile's halo at epoch E needs its 8 tile-torus neighbors' rings at
E — edge rows/cols from the 4 axis neighbors, single corner cells from the 4
diagonals (the corner-propagation job that the sharded data plane solves with
its two-phase ppermute)."""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from akka_game_of_life_tpu_torch.runtime.tiles import Ring, TileId, TileLayout


class Halo:
    """The assembled width-k halo for a tile: four edge blocks incl. corners.

    k=1 is the reference's per-epoch exchange; k>1 is the communication-
    avoiding contract — one assembled halo licenses k local steps (the outer
    garbage front advances one cell per step, so the (h, w) interior of the
    padded slab stays exact through step k)."""

    def __init__(self, top: np.ndarray, bottom: np.ndarray, left: np.ndarray, right: np.ndarray):
        self.top = top  # (k, w+2k)
        self.bottom = bottom  # (k, w+2k)
        self.left = left  # (h, k)
        self.right = right  # (h, k)

    @property
    def width(self) -> int:
        return len(self.top)

    def pad(self, tile: np.ndarray) -> np.ndarray:
        """(h, w) tile → (h+2k, w+2k) halo-padded array."""
        k = self.width
        h, w = tile.shape
        out = np.empty((h + 2 * k, w + 2 * k), dtype=tile.dtype)
        out[k : h + k, k : w + k] = tile
        out[:k, :] = self.top
        out[h + k :, :] = self.bottom
        out[k : h + k, :k] = self.left
        out[k : h + k, w + k :] = self.right
        return out


def halos_equal(a: Optional[Halo], b: Optional[Halo]) -> bool:
    """Exact equality of two assembled halos — the quiescence tier's
    neighborhood-unchanged test (O(perimeter); cheap enough to run every
    chunk, and the first thing checked so active tiles never pay an
    O(tile) state compare)."""
    if a is None or b is None:
        return False
    return (
        np.array_equal(a.top, b.top)
        and np.array_equal(a.bottom, b.bottom)
        and np.array_equal(a.left, b.left)
        and np.array_equal(a.right, b.right)
    )


class BoundaryStore:
    """Thread-safe ring store + halo assembler + pending-pull queue."""

    def __init__(self, layout: TileLayout, width: int = 1) -> None:
        th, tw = layout.tile_shape
        if width < 1 or th < width or tw < width:
            raise ValueError(
                f"ring width {width} infeasible for tile shape {(th, tw)}"
            )
        self.layout = layout
        self.width = width
        self._rings: Dict[Tuple[TileId, int], Ring] = {}  # graftlint: guarded-by _lock
        self._pending: Dict[Tuple[TileId, int], List[Callable[[Halo], None]]] = {}  # graftlint: guarded-by _lock
        self._lock = threading.Lock()

    def push_ring(self, tile: TileId, epoch: int, ring: Ring) -> None:
        """Store a ring; answer any queued pulls it completes."""
        self.push_rings([(tile, epoch, ring)])

    def push_rings(self, items: List[Tuple[TileId, int, Ring]]) -> None:
        """Store a whole batch of rings under ONE lock acquisition, then
        answer the queued pulls the batch completes.  Callbacks fire only
        after every ring of the batch is stored: a coalesced PEER_RING_BATCH
        unblocks all its dependent tiles at once, so their steps (and the
        outbound rings those produce) run back-to-back — which is exactly
        what lets the sender's next batch fill up."""
        ready: List[Tuple[Callable[[Halo], None], Halo]] = []
        with self._lock:
            epochs = set()
            for tile, epoch, ring in items:
                self._rings[(tile, epoch)] = ring
                epochs.add(epoch)
            for (want_tile, want_epoch), callbacks in list(self._pending.items()):
                if want_epoch not in epochs:
                    continue
                halo = self._assemble_locked(want_tile, want_epoch)
                if halo is not None:
                    for cb in callbacks:
                        ready.append((cb, halo))
                    del self._pending[(want_tile, want_epoch)]
        for cb, halo in ready:
            cb(halo)

    def pull_halo_now(
        self, tile: TileId, epoch: int, callback: Callable[[Halo], None]
    ) -> Optional[Halo]:
        """Return the halo if assemblable right now; otherwise queue
        ``callback`` for when the last ring lands and return None.  Lets a
        caller catching up over many epochs consume ready halos in a loop
        instead of recursing through callbacks."""
        with self._lock:
            halo = self._assemble_locked(tile, epoch)
            if halo is None:
                self._pending.setdefault((tile, epoch), []).append(callback)
            return halo

    def _assemble_locked(self, tile: TileId, epoch: int) -> Optional[Halo]:
        nb = self.layout.neighbors(tile)
        rings = {}
        for direction, ntile in nb.items():
            ring = self._rings.get((ntile, epoch))
            if ring is None:
                return None
            rings[direction] = ring
        h, w = self.layout.tile_shape
        k = self.width
        top = np.empty((k, w + 2 * k), dtype=np.uint8)
        top[:, :k] = rings["nw"].corners["se"]
        top[:, k : w + k] = rings["n"].bottom
        top[:, w + k :] = rings["ne"].corners["sw"]
        bottom = np.empty((k, w + 2 * k), dtype=np.uint8)
        bottom[:, :k] = rings["sw"].corners["ne"]
        bottom[:, k : w + k] = rings["s"].top
        bottom[:, w + k :] = rings["se"].corners["nw"]
        left = np.asarray(rings["w"].right, dtype=np.uint8)
        right = np.asarray(rings["e"].left, dtype=np.uint8)
        return Halo(top, bottom, left, right)

    def missing_neighbor_rings(self, tile: TileId, epoch: int) -> List[TileId]:
        """Which of a tile's 8 neighbors have no stored ring at ``epoch`` —
        the re-ask targets for a stale pull."""
        with self._lock:
            return sorted(
                {
                    ntile
                    for ntile in self.layout.neighbors(tile).values()
                    if (ntile, epoch) not in self._rings
                }
            )

    def ring_at(self, tile: TileId, epoch: int):
        """The stored ring of ``tile`` at exactly ``epoch``, or None.  The
        resolution target of a quiescent peer's "same-ring" marker: the
        marker names the epoch whose ring bytes it repeats, and this lookup
        turns it back into the Ring without any wire payload."""
        with self._lock:
            return self._rings.get((tile, epoch))

    def ring_count(self) -> int:
        with self._lock:
            return len(self._rings)

    def rings_from(
        self, tile: TileId, epoch: int, limit: int = 256
    ) -> List[Tuple[int, Ring]]:
        """All stored rings of ``tile`` at epochs >= ``epoch`` (ascending,
        bounded).  A PEER_PULL reply streams these so a replaying neighbor
        catches up without one round-trip per epoch."""
        with self._lock:
            eps = sorted(e for (t, e) in self._rings if t == tile and e >= epoch)
            return [(e, self._rings[(tile, e)]) for e in eps[:limit]]

    def prune_below(self, epoch: int) -> int:
        """Drop rings for epochs < epoch (called after a durable checkpoint).
        Returns how many were dropped."""
        with self._lock:
            stale = [k for k in self._rings if k[1] < epoch]
            for k in stale:
                del self._rings[k]
            return len(stale)

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    def drop_pending_for_owner(self, tiles: List[TileId]) -> None:
        """Forget queued pulls from tiles being re-deployed (their new owner
        will re-pull)."""
        with self._lock:
            for key in [k for k in self._pending if k[0] in tiles]:
                del self._pending[key]
