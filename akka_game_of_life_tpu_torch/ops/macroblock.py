"""Canonical macro-cell block codec — the ops half of the serve memo plane.

Hashlife's observation (PAPERS.md, Gosper 1984) is that a 2^k-sided block
of cells *determines* its center 2^(k-1)-sided tile for the next 2^(k-2)
generations, under ANY radius-1 rule: influence travels one cell per
generation, so a center cell at depth ≥ 2^(k-2) from the block edge cannot
see past the edge within that many steps.  That makes the pair

    (rule, block content)  →  center tile after 2^(k-2) steps

a pure function of block *content* — position-free, session-free,
tenant-free — and therefore memoizable across every board that ever
exhibits the same 2^k×2^k neighborhood.  ``serve/memo.py`` builds the
content-addressed cache; this module owns the geometry and the canonical
byte encoding the cache is keyed by:

- :func:`plan` — eligibility + cached toroidal gather/scatter maps for a
  board shape (a board tiles into T-sided result tiles, T = block/2; each
  tile's context is the B-sided block centered on it, extracted with
  toroidal wrap);
- :func:`extract_contexts` — all context blocks of a board in one
  vectorized gather, ``[n_tiles, B, B]``;
- :func:`encode_blocks` / :func:`decode_block` — the canonical payload
  codec (bit-packed for binary rules, raw C-order bytes for multi-state
  Generations rules; byte-for-byte deterministic in both directions);
- :func:`block_key` — the cheap content hash (crc32) the cache buckets
  by.  crc32 is 32 bits on purpose: collisions are *expected* at scale,
  and the cache resolves them by full payload compare (never by trusting
  the hash), so the hash only has to be fast.

Correctness of the toroidal shortcut: the device path steps the extracted
B×B block *toroidally* (reusing the serve batch kernel).  Wrap-corrupted
values enter at the block edge and travel inward one cell per step, so
after S = B/4 steps they reach depth < S — and every center-tile cell sits
at depth ≥ S.  When the board itself is narrower than the block (side
T = B/2, the smallest eligible side), the wrapped extraction is exactly
T-periodic, the toroidal step preserves that periodicity, and the periodic
dynamics quotient to the true T-torus dynamics — so the center is exact in
every eligible geometry.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "MacroPlan",
    "block_key",
    "decode_block",
    "encode_blocks",
    "extract_contexts",
    "plan",
]

# Smallest supported block: 16 → 8-sided tiles advancing 4 epochs per
# macro-step.  Below that the halo (B/4) is under the practical minimum
# for the gather layout and the memo quantum stops paying for its hashing.
MIN_BLOCK = 16


@dataclass(frozen=True, eq=False)
class MacroPlan:
    """Macro-step geometry for one (height, width, block) combination.

    ``rows``/``cols`` are the wrapped context gather maps: tile (i, j)'s
    B-sided context block is ``board[rows[i]][:, cols[j]]`` — rows[i][k] =
    (i·T − S + k) mod height.  Extraction for ALL tiles happens in one
    fancy-index gather (:func:`extract_contexts`).
    """

    height: int
    width: int
    block: int          # context block side B (power of two)
    tile: int           # result tile side T = B // 2
    steps: int          # epochs one macro-step advances: S = B // 4
    n_tr: int           # tile rows  = height // T
    n_tc: int           # tile cols  = width  // T
    rows: np.ndarray = field(repr=False)    # [n_tr, B] int32 wrapped rows
    cols: np.ndarray = field(repr=False)    # [n_tc, B] int32 wrapped cols

    @property
    def n_tiles(self) -> int:
        return self.n_tr * self.n_tc

    def origins(self) -> List[Tuple[int, int]]:
        """Tile origins in board coordinates, row-major tile order (the
        order :func:`extract_contexts` emits blocks in)."""
        t = self.tile
        return [
            (i * t, j * t) for i in range(self.n_tr) for j in range(self.n_tc)
        ]

    def assemble(self, centers: np.ndarray) -> np.ndarray:
        """Inverse of the tiling: ``[n_tiles, T, T]`` center results →
        the (height, width) board they compose, row-major tile order."""
        t = self.tile
        return (
            centers.reshape(self.n_tr, self.n_tc, t, t)
            .transpose(0, 2, 1, 3)
            .reshape(self.height, self.width)
        )


# plan() is pure geometry keyed by three small ints — memoized because the
# serve ticker asks for it on every memo tick of every session.
_PLANS: Dict[Tuple[int, int, int], Optional[MacroPlan]] = {}


def plan(height: int, width: int, block: int) -> Optional[MacroPlan]:
    """The macro-step plan for a board shape, or None when the shape is
    ineligible (sides must be positive multiples of the tile side T =
    block/2 so the T-tiling is exact; everything else degrades to the
    dense path, never to a wrong answer)."""
    key = (height, width, block)
    got = _PLANS.get(key, False)
    if got is not False:
        return got
    p: Optional[MacroPlan] = None
    t = block // 2
    s = block // 4
    if (
        block >= MIN_BLOCK
        and block & (block - 1) == 0
        and height > 0
        and width > 0
        and height % t == 0
        and width % t == 0
    ):
        span = np.arange(block, dtype=np.int64) - s
        rows = np.stack(
            [(i * t + span) % height for i in range(height // t)]
        ).astype(np.int32)
        cols = np.stack(
            [(j * t + span) % width for j in range(width // t)]
        ).astype(np.int32)
        p = MacroPlan(
            height=height, width=width, block=block, tile=t, steps=s,
            n_tr=height // t, n_tc=width // t, rows=rows, cols=cols,
        )
    _PLANS[key] = p
    return p


def extract_contexts(board: np.ndarray, p: MacroPlan) -> np.ndarray:
    """Every tile's toroidal context block in one gather:
    ``[n_tiles, B, B]`` uint8, row-major tile order."""
    # board[rows] → [n_tr, B, W]; [..., cols] → [n_tr, B, n_tc, B].
    ctx = board[p.rows][:, :, p.cols]
    return (
        ctx.transpose(0, 2, 1, 3).reshape(p.n_tiles, p.block, p.block)
    )


def encode_blocks(blocks: np.ndarray, states: int) -> List[bytes]:
    """Canonical payloads for a ``[n, side, side]`` uint8 block stack.

    Binary rules (states == 2) bit-pack (8 cells/byte, C-order, zero-padded
    tail — ``np.packbits`` semantics); multi-state rules ship raw C-order
    bytes (cell values up to states−1 don't fit a bit).  The encoding is a
    bijection on valid blocks, so payload equality ⟺ block equality — the
    property the cache's collision handling rests on."""
    n = blocks.shape[0]
    if states == 2:
        packed = np.packbits(blocks.reshape(n, -1), axis=1)
        return [packed[i].tobytes() for i in range(n)]
    return [blocks[i].tobytes() for i in range(n)]


def decode_block(payload: bytes, side: int, states: int) -> np.ndarray:
    """Inverse of :func:`encode_blocks` for one payload → (side, side)
    uint8 block."""
    if states == 2:
        flat = np.unpackbits(
            np.frombuffer(payload, dtype=np.uint8), count=side * side
        )
        return flat.reshape(side, side)
    return (
        np.frombuffer(payload, dtype=np.uint8)
        .reshape(side, side)
        .copy()
    )


def block_key(payload: bytes) -> int:
    """The bucket hash: crc32 of the canonical payload.  Weak on purpose
    (fast beats wide here); the cache compares full payloads within a
    bucket, so a collision costs a memcmp, never a wrong answer."""
    return zlib.crc32(payload)
