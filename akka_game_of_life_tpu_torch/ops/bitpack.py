"""Bit-packed SWAR stencil in plain PyTorch: 32 cells per 32-bit word.

Counterpart of ``akka_game_of_life_tpu/ops/bitpack.py``, with the same
LSB-first layout: grid (H, W) uint8 → packed (H, W/32) words, bit i of word k
= cell x = 32k+i.  This module is the plain version the CUDA sweep
(``ops/packed_sweep.py``) is held against, and the explicit ``kernel=bitpack``
stepper.

Words are held as ``torch.int32`` views of the uint32 bits: PyTorch has no
shifts, ``~`` or ``+`` on uint32 tensors on the CPU.  On int32, ``<<`` and
``^``/``&``/``|``/``~`` act on the bits exactly as on uint32, but ``>>`` is
arithmetic, so every right shift here is masked (``(x >> 31) & 1``,
``(x >> 1) & 0x7FFFFFFF``) to make it logical.  :func:`words_from_numpy` and
:func:`words_to_numpy` convert bit-exactly between these tensors and the JAX
package's uint32 arrays.

Binary (2-state) radius-1 outer-totalistic rules only.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

LANE_BITS = 32
WORD_DTYPE = torch.int32
_LOW31 = 0x7FFFFFFF


def require_packed_support(rule: Rule) -> None:
    """The SWAR kernels encode binary radius-1 outer-totalistic semantics;
    ltl rules are binary too, so an is_binary check alone would let them
    through and silently compute radius-1 — hence the shared guard."""
    if not (rule.is_binary and rule.is_totalistic):
        raise ValueError(
            f"bit-packed kernel supports binary radius-1 totalistic rules "
            f"only, got {rule}"
        )


# -- layout --------------------------------------------------------------------


def words_from_numpy(words: np.ndarray, device="cpu") -> torch.Tensor:
    """(H, W/32) uint32 words (the JAX package's packed layout) → the port's
    int32 tensor of the same bits on ``device``."""
    words = np.require(words, dtype=np.uint32, requirements=["C", "W"])
    return torch.from_numpy(words.view(np.int32)).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`words_from_numpy`: the same bits as uint32."""
    if words.dtype != WORD_DTYPE:
        raise ValueError(f"packed words must be int32, got {words.dtype}")
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def pack(grid: torch.Tensor) -> torch.Tensor:
    """(H, W) 0/1 uint8 tensor → (H, W/32) int32 words, LSB-first."""
    h, w = grid.shape
    if w % LANE_BITS:
        raise ValueError(f"width {w} not a multiple of {LANE_BITS}")
    cells = grid.reshape(h, w // LANE_BITS, LANE_BITS).to(WORD_DTYPE)
    out = torch.zeros((h, w // LANE_BITS), dtype=WORD_DTYPE, device=grid.device)
    for j in range(LANE_BITS):
        out |= cells[..., j] << j
    return out


def unpack(words: torch.Tensor) -> torch.Tensor:
    """(H, W/32) int32 words → (H, W) uint8 cells."""
    h, nwords = words.shape
    shifts = torch.arange(LANE_BITS, dtype=WORD_DTYPE, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.to(torch.uint8).reshape(h, nwords * LANE_BITS)


def pack_np(grid: np.ndarray) -> np.ndarray:
    """Host-side packer: (H, W) uint8 → (H, W/32) uint32 words.  Peak scratch
    is board/8 bytes (the packbits output viewed as words)."""
    h, w = grid.shape
    if w % LANE_BITS:
        raise ValueError(f"width {w} not a multiple of {LANE_BITS}")
    packed_bytes = np.packbits(
        np.asarray(grid, dtype=np.uint8), axis=-1, bitorder="little"
    )
    # 4 consecutive LSB-first bytes little-endian-viewed = one LSB-first word.
    return (
        np.ascontiguousarray(packed_bytes)
        .reshape(h, (w // LANE_BITS) * 4)
        .view("<u4")
    )


def unpack_np(words: np.ndarray) -> np.ndarray:
    """Host-side unpacker: (H, W/32) uint32 LSB-first words → (H, W) uint8."""
    h, w32 = words.shape
    packed_bytes = np.ascontiguousarray(words.astype("<u4")).view(np.uint8)
    return np.unpackbits(
        packed_bytes.reshape(h, w32 * 4), axis=-1, bitorder="little"
    )


# -- one generation ------------------------------------------------------------


def _hshift_west(x: torch.Tensor) -> torch.Tensor:
    """Plane of west neighbors: bit i ← cell (x-1), wrapping across words
    and the torus edge."""
    prev_word = torch.roll(x, 1, dims=1)
    return (x << 1) | ((prev_word >> 31) & 1)


def _hshift_east(x: torch.Tensor) -> torch.Tensor:
    next_word = torch.roll(x, -1, dims=1)
    return ((x >> 1) & _LOW31) | (next_word << 31)


def _row_triple_sum(x: torch.Tensor):
    """Per-row horizontal 3-cell sums including the center: bit planes
    ``(s, c)`` with ``west+center+east = s + 2c`` (a full adder), computed
    once per row and shared by the three output rows it feeds."""
    w = _hshift_west(x)
    e = _hshift_east(x)
    xw = x ^ w
    return xw ^ e, (x & w) | (e & xw)


def _count_bits(sN, cN, sC, cC, sS, cS):
    """``count = (sN+sC+sS) + 2*(cN+cC+cS)`` — the 9-cell Moore sum including
    the center, range 0..9 — as bit planes (b3, b2, b1, b0)."""
    sNC = sN ^ sC
    b0 = sNC ^ sS
    p1 = (sN & sC) | (sS & sNC)
    cNC = cN ^ cC
    q0 = cNC ^ cS
    q1 = (cN & cC) | (cS & cNC)
    b1 = p1 ^ q0
    r2 = p1 & q0
    b2 = q1 ^ r2
    b3 = q1 & r2
    return b3, b2, b1, b0


def count_eq_fn(b3, b2, b1, b0):
    """A predicate plane factory: ``eq(n)`` = bits where the count is n."""
    nb3, nb2, nb1, nb0 = ~b3, ~b2, ~b1, ~b0

    def eq(n: int) -> torch.Tensor:
        t = b3 if n & 8 else nb3
        t = t & (b2 if n & 4 else nb2)
        t = t & (b1 if n & 2 else nb1)
        return t & (b0 if n & 1 else nb0)

    return eq


def _combine_rows(x, sN, cN, sC, cC, sS, cS, rule: Rule) -> torch.Tensor:
    """Next state from three rows' (s, c) planes.  The count includes the
    center, so survive thresholds shift by +1; counts in B ∩ (S+1) make the
    cell alive whatever x is, so they skip the x masking (for Conway:
    ``eq(3) | (x & eq(4))``)."""
    eq = count_eq_fn(*_count_bits(sN, cN, sC, cC, sS, cS))

    def union(ns):
        acc = None
        for n in sorted(ns):
            acc = eq(n) if acc is None else acc | eq(n)
        return acc

    survive_counts = {n + 1 for n in rule.survive}
    always = rule.birth & survive_counts
    terms = [union(always)]
    birth = union(rule.birth - always)
    if birth is not None:
        terms.append(~x & birth)
    survive = union(survive_counts - always)
    if survive is not None:
        terms.append(x & survive)
    terms = [t for t in terms if t is not None]
    return functools.reduce(torch.bitwise_or, terms) if terms else torch.zeros_like(x)


def step_padded_rows(padded: torch.Tensor, rule) -> torch.Tensor:
    """One packed step on a row-padded slab: (h+2, words) with one halo row
    top and bottom → (h, words)."""
    rule = resolve_rule(rule)
    s, c = _row_triple_sum(padded)
    return _combine_rows(
        padded[1:-1], s[:-2], c[:-2], s[1:-1], c[1:-1], s[2:], c[2:], rule
    )


def step_packed(x: torch.Tensor, rule) -> torch.Tensor:
    """One toroidal step on a packed (H, W/32) int32 grid."""
    rule = resolve_rule(rule)
    require_packed_support(rule)
    s, c = _row_triple_sum(x)
    return _combine_rows(
        x,
        torch.roll(s, 1, dims=0),
        torch.roll(c, 1, dims=0),
        s,
        c,
        torch.roll(s, -1, dims=0),
        torch.roll(c, -1, dims=0),
        rule,
    )


def packed_multi_step(words: torch.Tensor, rule, n: int) -> torch.Tensor:
    """``n`` generations of :func:`step_packed`."""
    rule = resolve_rule(rule)
    require_packed_support(rule)
    for _ in range(n):
        words = step_packed(words, rule)
    return words


def _packed_cost(x: torch.Tensor, steps: int) -> dict:
    """Plan-priced per-call cost of a packed-word program: 1 bit/cell on
    the wire, ~2 word-ops per cell-update in the adder tree."""
    cells = float(x.numel()) * x.element_size() * 8 * steps
    return {
        "cells": cells,
        "bytes": 2.0 * x.numel() * x.element_size() * steps,
        "flops": 2.0 * cells,
    }


def packed_step_fn(rule) -> Callable[[torch.Tensor], torch.Tensor]:
    """One generation of :func:`step_packed`, registered on the program
    ledger (family ``bitpack``)."""
    rule = resolve_rule(rule)
    require_packed_support(rule)
    return registered_jit(
        "bitpack", ("step", rule.name), lambda words: step_packed(words, rule),
        cost=lambda x: _packed_cost(x, 1),
    )


def packed_multi_step_fn(rule, n_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ``kernel=bitpack`` stepper: a closure over :func:`packed_multi_step`,
    registered on the program ledger (family ``bitpack``)."""
    rule = resolve_rule(rule)
    require_packed_support(rule)
    return registered_jit(
        "bitpack", ("multi_step", rule.name, n_steps),
        lambda words: packed_multi_step(words, rule, n_steps),
        cost=lambda x: _packed_cost(x, n_steps),
    )


# -- observation ---------------------------------------------------------------


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of values in [0, 2^16) held in int32 (no overflow)."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def population_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row population of a packed board: (H, W/32) int32 → (H,) int64.
    PyTorch has no popcount, so each word counts as two 16-bit halves."""
    counts = _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)
    return counts.sum(dim=1, dtype=torch.int64)


def cells_at(x: torch.Tensor, rows, xs: np.ndarray) -> torch.Tensor:
    """The cells at cell columns ``xs`` (a host int array) of the rows
    ``rows`` (any first-axis index) of a packed board, as uint8."""
    words = x[rows][:, torch.from_numpy(xs // LANE_BITS).to(x.device)]
    bits = torch.from_numpy((xs % LANE_BITS).astype(np.int32)).to(x.device)
    return ((words >> bits) & 1).to(torch.uint8)


def sample_packed_core(
    sy: int, sx: int, width: int
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Strided probe of a packed board: bit (x·sx) of every sy-th row, as a
    small uint8 view (the render sample for boards too big to ship)."""
    xs = np.arange(0, width, sx)
    return lambda x: cells_at(x, slice(None, None, sy), xs)
