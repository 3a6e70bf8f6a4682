"""The plain reference of outer-totalistic rules (life-like and
Generations) on a torus, in plain PyTorch.

It imports nothing of the program and takes nothing the program made:
each rule's birth and survival sets, the seeded board the serve plane
makes (:func:`random_grid`), the packed word layout and the 64-bit digest
are written out here from their definitions.

A generation of a board of ``states`` states (2 for life-like rules):
a dead cell (0) with a birth count of live (state 1) neighbours among its
eight becomes 1; a live cell with a survival count stays 1, else becomes
2 (or 0 where ``states`` is 2); a cell in state s >= 2 becomes s + 1, or
0 at ``states``.  The board wraps at every edge; ``torus=False`` treats
cells beyond the edges as dead instead (the control: a guarantee broken).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

import numpy as np
import torch

# name -> (birth counts, survival counts, states)
RULES: Dict[str, Tuple[FrozenSet[int], FrozenSet[int], int]] = {
    "conway": (frozenset({3}), frozenset({2, 3}), 2),
    "highlife": (frozenset({3, 6}), frozenset({2, 3}), 2),
    "seeds": (frozenset({2}), frozenset(), 2),
    "brians-brain": (frozenset({2}), frozenset(), 3),
    "star-wars": (frozenset({2}), frozenset({3, 4, 5}), 4),
}

# Cells a row block of the step or the digest holds at once.
BLOCK_CELLS = 1 << 27
MASK32 = 0xFFFFFFFF
DIGEST_SEEDS = (0x9E3779B9, 0x7F4A7C15)
FMIX_M1 = 0x85EBCA6B
FMIX_M2 = 0xC2B2AE35


def _rows(board: torch.Tensor, r0: int, r1: int, torus: bool) -> torch.Tensor:
    """Rows r0 - 1 .. r1 of ``[B, H, W]``, wrapped or dead beyond the edges."""
    h = board.shape[1]
    idx = torch.arange(r0 - 1, r1 + 1, device=board.device)
    if torus:
        return board.index_select(1, idx % h)
    inside = (idx >= 0) & (idx < h)
    ext = board.index_select(1, idx.clamp(0, h - 1))
    return ext * inside.to(board.dtype)[None, :, None]


def _counts(ext: torch.Tensor, torus: bool) -> torch.Tensor:
    """Live neighbours of the middle rows of ``ext``, as uint8."""
    alive = (ext == 1).to(torch.uint8)
    across = alive.clone()
    if torus:
        across += alive.roll(1, 2)
        across += alive.roll(-1, 2)
    else:
        across[:, :, 1:] += alive[:, :, :-1]
        across[:, :, :-1] += alive[:, :, 1:]
    return across[:, :-2] + across[:, 1:-1] + across[:, 2:] - alive[:, 1:-1]


def _any_of(count: torch.Tensor, values) -> torch.Tensor:
    out = torch.zeros_like(count, dtype=torch.bool)
    for v in values:
        out |= count == v
    return out


def _next_one_rule(cell, count, rule):
    """The next states under one rule for every board."""
    birth, survive, states = RULES[rule]
    born = _any_of(count, birth)
    kept = _any_of(count, survive)
    if states == 2:
        return torch.where(cell == 1, kept, born).to(torch.uint8)
    aged = cell + 1
    aged = torch.where(aged < states, aged, torch.zeros_like(aged))
    live = torch.where(kept, torch.ones_like(cell), torch.full_like(cell, 2))
    return torch.where(cell == 0, born.to(torch.uint8), torch.where(cell == 1, live, aged))


def masks(rules, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-board (birth bits, survival bits, states), each ``[B, 1, 1]``
    int32: bit k of a mask is set where the count k is in the set."""
    rows = [RULES[r] for r in rules]
    return tuple(
        torch.tensor(v, dtype=torch.int32, device=device).reshape(-1, 1, 1)
        for v in ([sum(1 << k for k in b) for b, _, _ in rows],
                  [sum(1 << k for k in s) for _, s, _ in rows],
                  [n for _, _, n in rows])
    )


def _next_per_board(cell, count, birth, survive, states):
    """The next states with each board's rule as bit masks over counts."""
    count = count.to(torch.int32)
    born = ((birth >> count) & 1).to(torch.uint8)
    kept = ((survive >> count) & 1).bool()
    dying = torch.where(states > 2, 2, 0).to(torch.uint8)
    aged = cell.to(torch.int32) + 1
    aged = torch.where(aged < states, aged, 0).to(torch.uint8)
    live = torch.where(kept, torch.ones_like(cell), dying.expand_as(cell))
    return torch.where(cell == 0, born, torch.where(cell == 1, live, aged))


def step(board: torch.Tensor, rules, torus: bool = True, per_board=None) -> torch.Tensor:
    """One generation of a ``[B, H, W]`` uint8 stack, board b under
    ``rules[b]``, in row blocks; ``per_board`` is :func:`masks` of
    ``rules`` where they differ."""
    b, h, w = board.shape
    out = torch.empty_like(board)
    rows = max(1, BLOCK_CELLS // (b * w))
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        ext = _rows(board, r0, r1, torus)
        count = _counts(ext, torus)
        cell = ext[:, 1:-1]
        if per_board is None:
            out[:, r0:r1] = _next_one_rule(cell, count, rules[0])
        else:
            out[:, r0:r1] = _next_per_board(cell, count, *per_board)
    return out


def run(board: torch.Tensor, generations: int, rules, torus: bool = True) -> torch.Tensor:
    """``generations`` generations of a ``[B, H, W]`` stack, board b under
    ``rules[b]``."""
    per_board = None if len(set(rules)) == 1 else masks(rules, board.device)
    for _ in range(generations):
        board = step(board, rules, torus, per_board)
    return board


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """``[H, NW]`` 32-bit words (bit j of word c is cell 32c + j) as an
    ``[H, 32 NW]`` uint8 board."""
    h, nw = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    out = torch.empty((h, nw * 32), dtype=torch.uint8, device=words.device)
    rows = max(1, BLOCK_CELLS // (nw * 32))
    for r0 in range(0, h, rows):
        block = words[r0:r0 + rows].to(torch.int32)
        bits = (block[:, :, None] >> shifts) & 1
        out[r0:r0 + rows] = bits.reshape(block.shape[0], nw * 32).to(torch.uint8)
    return out


def pack_words(board: torch.Tensor) -> torch.Tensor:
    """An ``[H, W]`` 0/1 uint8 board as ``[H, W / 32]`` int32 words, the
    inverse of :func:`unpack_words`."""
    h, w = board.shape
    shifts = torch.arange(32, dtype=torch.int64, device=board.device)
    out = torch.empty((h, w // 32), dtype=torch.int32, device=board.device)
    rows = max(1, BLOCK_CELLS // (4 * w))
    for r0 in range(0, h, rows):
        bits = board[r0:r0 + rows].reshape(-1, w // 32, 32).to(torch.int64)
        words = (bits << shifts).sum(dim=2)
        out[r0:r0 + rows] = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    return out


def random_grid(height: int, width: int, density: float, seed: int) -> np.ndarray:
    """The serve plane's seeded start board: numpy's PCG64 from ``seed``
    draws uint16 values in blocks of 2**27 cells of whole rows; a cell is
    live where its value is below round(density * 65536)."""
    rng = np.random.default_rng(seed)
    thresh = max(0, min(65536, round(density * 65536)))
    if thresh in (0, 65536):
        return np.full((height, width), thresh // 65536, dtype=np.uint8)
    out = np.empty((height, width), dtype=np.uint8)
    rows = max(1, (1 << 27) // max(1, width))
    for y in range(0, height, rows):
        block = rng.integers(0, 65536, size=(min(rows, height - y), width), dtype=np.uint16)
        out[y:y + block.shape[0]] = block < np.uint16(thresh)
    return out


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for int64 x < 2**32, in 16-bit halves of m."""
    return ((x * (m & 0xFFFF)) + (((x * (m >> 16)) & 0xFFFF) << 16)) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer."""
    x = x ^ (x >> 16)
    x = _mul32(x, FMIX_M1)
    x = x ^ (x >> 13)
    x = _mul32(x, FMIX_M2)
    return x ^ (x >> 16)


def digest_keys(width: int, r0: int, r1: int, device) -> torch.Tensor:
    """Both lanes' keys of rows r0..r1 of a ``width``-wide board: ``[2,
    rows, width]`` int64, key(r, c) = fmix32(((r * width + c) mod 2**32)
    XOR seed)."""
    r = torch.arange(r0, r1, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    idx = (r * width + c) & MASK32
    return torch.stack([_fmix32(idx ^ s) for s in DIGEST_SEEDS])


def digest(boards: torch.Tensor) -> np.ndarray:
    """Each board's 64-bit digest, ``(hi << 32) | lo`` with lane =
    sum(state * key) mod 2**32; ``[B]`` uint64 for a ``[B, H, W]`` stack."""
    b, h, w = boards.shape
    lanes = torch.zeros((b, 2), dtype=torch.int64, device=boards.device)
    rows = max(1, BLOCK_CELLS // (4 * b * w))
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        keys = digest_keys(w, r0, r1, boards.device)
        state = boards[:, r0:r1].to(torch.int64)
        for lane in range(2):
            part = (state * keys[lane]).sum(dim=(1, 2)) & MASK32
            lanes[:, lane] = (lanes[:, lane] + part) & MASK32
    lanes = lanes.cpu().numpy().astype(np.uint64)
    return (lanes[:, 1] << np.uint64(32)) | lanes[:, 0]
