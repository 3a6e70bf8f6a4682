"""On-device board fingerprints: O(1)-byte state certification.

Counterpart of ``akka_game_of_life_tpu/ops/digest.py``, over the same
definition, so the two packages give the same 64-bit value for the same
board and a digest certifies the port against the JAX package:

    key_lane(r, c) = fmix32((r·W + c) XOR seed_lane)        (murmur3 final)
    D_lane        = Σ_cells state(r, c) · key_lane(r, c)     (mod 2³²)
    digest        = (D_hi << 32) | D_lo

PyTorch does not promise uint32 wrap-around, so the torch versions compute
in int64 and mask with ``& 0xFFFFFFFF``: each 32x32-bit product is split in
16-bit halves so no intermediate reaches 2⁶³, and sums run over row blocks
small enough that a block sum of values below 2³² stays below 2⁶³.  Row
blocks also bound scratch: a 65536² board never holds more than one block's
int64 temporaries.  Row blocks with no set bit are skipped (they contribute
nothing), which makes digests of sparse boards cheap.

The numpy twins (``*_np``), ``merge_lanes``, ``value``, ``format_digest``
and ``BlockLaneCache`` are copies of the JAX package's;
``digest_dense_batch`` folds a serving batch's per-board lanes, and
``key_lanes_np`` / ``digest_keyed_np`` split a host tile's digest into its
cell-free key table and one product.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit

LANE_SEEDS = (0x9E3779B9, 0x7F4A7C15)
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF
# Elements per row block of int64 scratch (64 MiB each).
_BLOCK_ELEMS = 1 << 23


def _mulmod32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h · m) mod 2³² for int64 ``h`` in [0, 2³²) without overflow."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2³²)."""
    h = h ^ (h >> 16)
    h = _mulmod32(h, _M1)
    h = h ^ (h >> 13)
    h = _mulmod32(h, _M2)
    return h ^ (h >> 16)


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    """Host twin of :func:`_fmix32` on uint32 (mutates its scratch input)."""
    h ^= h >> np.uint32(16)
    h *= np.uint32(_M1)
    h ^= h >> np.uint32(13)
    h *= np.uint32(_M2)
    h ^= h >> np.uint32(16)
    return h


def _block_rows(row_elems: int) -> int:
    return max(1, _BLOCK_ELEMS // max(1, row_elems))


# -- device (torch) implementations --------------------------------------------


def digest_dense(
    board: torch.Tensor, row0: int = 0, col0: int = 0, width: Optional[int] = None
) -> torch.Tensor:
    """Digest lanes of a dense (h, w) board (any state alphabet).
    ``row0``/``col0`` are its global origin, ``width`` the GLOBAL board
    width.  Returns a (2,) int64 tensor ``[lo, hi]`` of values < 2³²."""
    h, w = board.shape
    if width is None:
        width = w
    dev = board.device
    lanes = torch.zeros(2, dtype=torch.int64, device=dev)
    cols = torch.arange(w, dtype=torch.int64, device=dev)[None, :] + col0
    step = _block_rows(w)
    for r0 in range(0, h, step):
        block = board[r0 : r0 + step]
        if not bool(torch.any(block)):
            continue
        rows = torch.arange(r0, r0 + block.shape[0], dtype=torch.int64, device=dev)
        idx = ((rows[:, None] + row0) * width + cols) & _MASK32
        state = block.to(torch.int64)
        for lane, seed in enumerate(LANE_SEEDS):
            part = (state * _fmix32(idx ^ seed)).sum() & _MASK32
            lanes[lane] = (lanes[lane] + part) & _MASK32
    return lanes


def digest_packed(
    words: torch.Tensor, width: int, row0: int = 0, wordcol0: int = 0
) -> torch.Tensor:
    """Digest lanes of a bit-packed (h, words) int32 board (LSB-first, bit
    j of word c = cell x = 32c+j); equal to :func:`digest_dense` of the
    unpacked board.  Returns a (2,) int64 tensor ``[lo, hi]``.

    Each call is a program of the ledger (family ``digest``, keyed by the
    words' shape and the board's width), so its device seconds are counted
    like a stepper's; priced as one read of the packed words.  Its eager
    passes build nothing, so its first call bills no compile."""
    h, nwords = words.shape
    return registered_jit(
        "digest", ("packed", h, nwords, width), _digest_packed,
        cost={"bytes": float(words.numel() * words.element_size())},
        compiles=False,
    )(words, width, row0, wordcol0)


def _digest_packed(
    words: torch.Tensor, width: int, row0: int, wordcol0: int
) -> torch.Tensor:
    h, nwords = words.shape
    dev = words.device
    lanes = torch.zeros(2, dtype=torch.int64, device=dev)
    wcs = (torch.arange(nwords, dtype=torch.int64, device=dev) + wordcol0) * 32
    step = _block_rows(nwords)
    for r0 in range(0, h, step):
        block = words[r0 : r0 + step]
        if not bool(torch.any(block)):
            continue
        rows = torch.arange(r0, r0 + block.shape[0], dtype=torch.int64, device=dev)
        base = (rows[:, None] + row0) * width + wcs[None, :]
        for j in range(32):
            bit = ((block >> j) & 1).to(torch.int64)
            idx = (base + j) & _MASK32
            for lane, seed in enumerate(LANE_SEEDS):
                part = (bit * _fmix32(idx ^ seed)).sum() & _MASK32
                lanes[lane] = (lanes[lane] + part) & _MASK32
    return lanes


def digest_planes(
    planes: torch.Tensor, width: int, row0: int = 0, wordcol0: int = 0
) -> torch.Tensor:
    """Digest lanes of (m, h, words) Generations/WireWorld bit planes (LSB
    plane first).  Exact by linearity: state = Σ_k 2^k·bit_k, so the board
    digest is Σ_k (plane_k's binary digest << k), mod 2³²."""
    total = torch.zeros(2, dtype=torch.int64, device=planes.device)
    for k in range(planes.shape[0]):
        part = digest_packed(planes[k], width, row0, wordcol0) << k
        total = (total + part) & _MASK32
    return total


def digest_dense_batch(boards: torch.Tensor, widths) -> torch.Tensor:
    """Per-board digest lanes of a batched ``[B, H, W]`` uint8 stack, the
    serving plane's certification fold.  Returns a ``[B, 2]`` int64 tensor
    of uint32 values, board b's row equal to :func:`digest_dense` of that
    board alone at global width ``widths[b]``.

    Boards of mixed logical shapes ride one stack zero-padded to the size
    class: a padding cell holds state 0 and adds nothing, so each row
    certifies exactly the board's live region (its index stream ``r ·
    widths[b] + c`` is the one the single-board definition walks).  Rows
    are summed and masked before the boards' sums, so no partial sum of
    products (< 2⁴⁰ each) passes 2⁶³; boards go in chunks of at most
    ``_BLOCK_ELEMS`` cells to bound the int64 scratch."""
    b, h, w = boards.shape
    dev = boards.device
    if not isinstance(widths, torch.Tensor):
        widths = torch.from_numpy(np.asarray(widths, dtype=np.int64))
    widths = widths.to(device=dev, dtype=torch.int64)
    out = torch.zeros((b, 2), dtype=torch.int64, device=dev)
    rows = torch.arange(h, dtype=torch.int64, device=dev)[None, :, None]
    cols = torch.arange(w, dtype=torch.int64, device=dev)[None, None, :]
    step = max(1, _BLOCK_ELEMS // max(1, h * w))
    for b0 in range(0, b, step):
        state = boards[b0 : b0 + step].to(torch.int64)
        idx = (rows * widths[b0 : b0 + step, None, None] + cols) & _MASK32
        for lane, seed in enumerate(LANE_SEEDS):
            row_sums = (state * _fmix32(idx ^ seed)).sum(dim=2) & _MASK32
            out[b0 : b0 + step, lane] = row_sums.sum(dim=1) & _MASK32
    return out


# -- host (np) twins -----------------------------------------------------------

_NP_BLOCK_ROWS = 1024


def digest_dense_np(
    arr: np.ndarray,
    origin: Tuple[int, int] = (0, 0),
    width: Optional[int] = None,
) -> np.ndarray:
    """Host twin of :func:`digest_dense` ((2,) uint32 lanes).  ``origin`` is
    the tile's global (row, col); ``width`` the global board width."""
    arr = np.asarray(arr, dtype=np.uint8)
    h, w = arr.shape
    if width is None:
        width = w
    oy, ox = origin
    cols = (np.arange(w, dtype=np.uint32) + np.uint32(ox))[None, :]
    lanes = [0, 0]
    for r0 in range(0, h, _NP_BLOCK_ROWS):
        r1 = min(r0 + _NP_BLOCK_ROWS, h)
        if not arr[r0:r1].any():
            continue  # an empty block adds nothing (as on the device)
        rows = (np.arange(r0, r1, dtype=np.uint32) + np.uint32(oy))[:, None]
        idx = rows * np.uint32(width) + cols
        state = arr[r0:r1].astype(np.uint32)
        for lane, seed in enumerate(LANE_SEEDS):
            mixed = _fmix32_np(idx ^ np.uint32(seed))
            mixed *= state
            lanes[lane] = (
                lanes[lane] + int(mixed.sum(dtype=np.uint32))
            ) & 0xFFFFFFFF
    return np.asarray(lanes, dtype=np.uint32)


def key_lanes_np(
    shape: Tuple[int, int], origin: Tuple[int, int], width: int
) -> np.ndarray:
    """Both lanes' keys of a ``shape`` tile at global ``origin`` of a
    ``width``-wide board, (2, h·w) uint32, so that
    ``digest_keyed_np(keys, tile) == digest_dense_np(tile, origin, width)``.
    The table depends on no cell: it can be made before the tile's state
    exists, leaving one product a tile."""
    h, w = shape
    rows = (np.arange(h, dtype=np.uint32) + np.uint32(origin[0]))[:, None]
    cols = (np.arange(w, dtype=np.uint32) + np.uint32(origin[1]))[None, :]
    idx = (rows * np.uint32(width) + cols).ravel()
    return np.stack([_fmix32_np(idx ^ np.uint32(seed)) for seed in LANE_SEEDS])


def digest_keyed_np(keys: np.ndarray, tile: np.ndarray) -> np.ndarray:
    """(2,) uint32 lanes of ``tile`` under its :func:`key_lanes_np` table:
    Σ state · key per lane, wrapping mod 2³² in uint32 arithmetic."""
    return keys @ np.asarray(tile, dtype=np.uint32).ravel()


def digest_packed_np(words: np.ndarray, width: int) -> np.ndarray:
    """Host twin of :func:`digest_packed` ((h, words) uint32 LSB-first)."""
    words = np.asarray(words, dtype=np.uint32)
    h, nwords = words.shape
    wcs = (np.arange(nwords, dtype=np.uint32) * np.uint32(32))[None, :]
    lanes = [0, 0]
    for r0 in range(0, h, _NP_BLOCK_ROWS):
        r1 = min(r0 + _NP_BLOCK_ROWS, h)
        block = words[r0:r1]
        if not block.any():
            continue  # an empty block adds nothing (as on the device)
        rows = np.arange(r0, r1, dtype=np.uint32)[:, None]
        base = rows * np.uint32(width) + wcs
        for j in range(32):
            idx = base + np.uint32(j)
            bit = (block >> np.uint32(j)) & np.uint32(1)
            for lane, seed in enumerate(LANE_SEEDS):
                mixed = _fmix32_np(idx ^ np.uint32(seed))
                mixed *= bit
                lanes[lane] = (
                    lanes[lane] + int(mixed.sum(dtype=np.uint32))
                ) & 0xFFFFFFFF
    return np.asarray(lanes, dtype=np.uint32)


def digest_planes_np(planes: np.ndarray, width: int) -> np.ndarray:
    """Host twin of :func:`digest_planes` ((m, h, words) uint32)."""
    planes = np.asarray(planes, dtype=np.uint32)
    lanes = np.zeros(2, dtype=np.uint32)
    for k in range(planes.shape[0]):
        lanes += digest_packed_np(planes[k], width) << np.uint32(k)
    return lanes


def digest_payload_np(
    payload: dict, origin: Tuple[int, int], width: int
) -> np.ndarray:
    """Digest lanes of a wire/checkpoint tile payload (``wire.pack_tile``
    form) at its global ``origin`` of a ``width``-wide board — one tile at
    a time, never the assembled board."""
    from akka_game_of_life_tpu_torch.runtime.wire import unpack_tile

    return digest_dense_np(unpack_tile(payload), origin, width)


# -- merge / presentation ------------------------------------------------------


def merge_lanes(parts: Iterable) -> np.ndarray:
    """Fold per-part digest lanes into the whole-board lanes: lane-wise
    uint32 sum.  An empty iterable merges to zero lanes."""
    lo = hi = 0
    for part in parts:
        p = np.asarray(part)
        lo = (lo + int(p[0])) & 0xFFFFFFFF
        hi = (hi + int(p[1])) & 0xFFFFFFFF
    return np.asarray([lo, hi], dtype=np.uint32)


def value(lanes) -> int:
    """The presented 64-bit digest: (hi << 32) | lo, as a Python int."""
    if isinstance(lanes, torch.Tensor):
        lanes = lanes.cpu().numpy()
    lanes = np.asarray(lanes)
    return (int(lanes[1]) << 32) | int(lanes[0])


def format_digest(v: int) -> str:
    """Canonical text form: 16 hex digits."""
    return f"{v:016x}"


# -- block-granular lane reuse -------------------------------------------------


class BlockLaneCache:
    """Memoized per-block lane contributions for tiled re-digesting (a copy
    of the JAX package's).

    The digest is a sum over cells, so a board tiled into disjoint blocks
    digests as the lane-wise sum of per-block contributions — and a block's
    contribution depends only on (content, origin, board width).  Boards
    that evolve by block substitution (the serve memo plane: most tiles of
    a structured board are static or cycling between a few contents) keep
    re-presenting the same (content, origin) pairs, so their whole-board
    lanes reduce to dict hits plus one :func:`merge_lanes` fold instead of
    an O(board) re-mix every epoch.

    Keys are the caller's canonical content payloads (``ops/macroblock``
    codec bytes) plus origin/width; values are (2,) uint32 lanes.  Bounded
    LRU (``max_entries``); a miss just recomputes, so tightness costs speed,
    never correctness."""

    def __init__(self, max_entries: int = 1 << 16) -> None:
        from collections import OrderedDict

        self.max_entries = int(max_entries)
        self._entries: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def block_lanes(
        self,
        payload: bytes,
        block: np.ndarray,
        origin: Tuple[int, int],
        width: int,
    ) -> np.ndarray:
        """The block's lane contribution at ``origin`` of a ``width``-wide
        board: cached by (payload, origin, width), computed via
        :func:`digest_dense_np` on miss."""
        key = (payload, origin[0], origin[1], width)
        lanes = self._entries.get(key)
        if lanes is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return lanes
        self.misses += 1
        lanes = digest_dense_np(block, origin, width)
        self._entries[key] = lanes
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
        return lanes
