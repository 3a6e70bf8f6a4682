"""Bit-plane SWAR stepping for multi-state rules: Generations and WireWorld.

Counterpart of ``akka_game_of_life_tpu/ops/bitpack_gen.py`` in plain
PyTorch.  A cell's state (0 = dead, 1 = alive, 2..S-1 refractory, decaying
upward and wrapping S-1 → 0) is held in ``m = ceil(log2(S))`` packed bit
planes, stacked as an (m, H, W/32) int32 tensor (LSB plane first, the same
LSB-first words as ``ops/bitpack.py``), and every transition is plane-wise
logic:

- the *alive* plane (state == 1) feeds the shared-row-sum Moore counter of
  the binary step (``bitpack._row_triple_sum`` / ``_count_bits``);
- birth/survive hits come from the count-equality predicate planes; the
  alive centre adds +1 to its own count, so survive thresholds shift by +1;
- refractory decay is a ripple-carry increment over the m planes with a
  wrap-to-zero mask at state S-1.

WireWorld (4 states: 0 empty, 1 head, 2 tail, 3 conductor) shares the
pipeline, with the planes (p0, p1)::

    next_p0 = p1
    next_p1 = (p0 ^ p1) | (p0 & p1 & ~excite)

where ``excite`` is the birth-count predicate without the +1 shift (a
conductor is not a head and never counts itself).

These formulas, not a per-cell state machine, define the step: plane values
that encode no state of the rule (state 3 under Brian's Brain) evolve as the
JAX package's planes do.  The CUDA plane sweep (``ops/gen_sweep.py``) is held
against this module bit for bit, and ``kernel=bitpack`` steps with it.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit
from akka_game_of_life_tpu_torch.ops.bitpack import (
    _count_bits,
    _row_triple_sum,
    count_eq_fn,
    pack,
    pack_np,
    unpack,
    unpack_np,
    words_from_numpy,
    words_to_numpy,
)
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule


def require_plane_support(rule) -> None:
    """The plane steppers encode Generations decay and WireWorld; radius-R
    Larger-than-Life runs on the dense layout (``ops/ltl.py``)."""
    if not (rule.is_totalistic or rule.kind == "wireworld"):
        raise ValueError(
            f"bit-plane kernel supports totalistic and wireworld rules "
            f"only, got {rule}"
        )


def n_planes(states: int) -> int:
    return max(1, (states - 1).bit_length())


def _require_plane_count(planes, rule) -> int:
    m = n_planes(rule.states)
    if planes.shape[0] != m:
        raise ValueError(f"expected {m} planes for {rule.states} states")
    return m


# -- layout --------------------------------------------------------------------


def planes_from_numpy(planes: np.ndarray, device="cpu") -> torch.Tensor:
    """(m, H, W/32) uint32 planes (the JAX package's layout) → the port's
    int32 tensor of the same bits on ``device``."""
    if np.ndim(planes) != 3:
        raise ValueError(f"bit planes must be (m, H, W/32), got shape {np.shape(planes)}")
    return words_from_numpy(planes, device)


def planes_to_numpy(planes: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`planes_from_numpy`: the same bits as uint32."""
    if planes.dim() != 3:
        raise ValueError(f"bit planes must be (m, H, W/32), got shape {tuple(planes.shape)}")
    return words_to_numpy(planes)


def pack_gen(grid: torch.Tensor, states: int) -> torch.Tensor:
    """(H, W) uint8 states → (m, H, W/32) int32 bit planes, LSB plane first."""
    if states > 2**8:
        raise ValueError("states > 256 not supported")
    grid = grid.to(torch.uint8)
    return torch.stack([pack((grid >> k) & 1) for k in range(n_planes(states))])


def unpack_gen(planes: torch.Tensor) -> torch.Tensor:
    """(m, H, W/32) int32 → (H, W) uint8."""
    out = unpack(planes[0])
    for k in range(1, planes.shape[0]):
        out = out | (unpack(planes[k]) << k)
    return out


def pack_gen_np(grid: np.ndarray, states: int) -> np.ndarray:
    """Host twin of :func:`pack_gen`: (H, W) uint8 → (m, H, W/32) uint32."""
    if states > 2**8:
        raise ValueError("states > 256 not supported")
    grid = np.asarray(grid, dtype=np.uint8)
    return np.stack([pack_np((grid >> k) & 1) for k in range(n_planes(states))])


def unpack_gen_np(planes: np.ndarray) -> np.ndarray:
    """Host twin of :func:`unpack_gen`: (m, H, W/32) uint32 → (H, W) uint8."""
    out = unpack_np(planes[0])
    for k in range(1, planes.shape[0]):
        out = out | (unpack_np(planes[k]) << k)
    return out.astype(np.uint8)


# -- one generation ------------------------------------------------------------


def _eq_const(planes: List[torch.Tensor], value: int) -> torch.Tensor:
    """Plane where the m-bit state equals ``value``."""
    t = None
    for k, p in enumerate(planes):
        bit = p if (value >> k) & 1 else ~p
        t = bit if t is None else t & bit
    return t


def _increment(planes: List[torch.Tensor]) -> List[torch.Tensor]:
    """state+1 over m bit planes (ripple carry; overflow discarded — the
    wrap mask zeroes the only state that can overflow)."""
    out = [~planes[0]]
    carry = planes[0]
    for p in planes[1:]:
        out.append(p ^ carry)
        carry = p & carry
    return out


def _union(eq, counts) -> torch.Tensor:
    acc = None
    for n in sorted(counts):
        acc = eq(n) if acc is None else acc | eq(n)
    return acc


def _transition(ps_center, alive_c, dead_c, eq, rule) -> List[torch.Tensor]:
    """Next-state Generations planes from the centre planes and the count
    predicates: dead → 1 on a birth hit, alive → 1 on a survive hit
    (count + 1 for the self term), everything else not dead increments,
    wrapping S-1 → 0."""
    zero = torch.zeros_like(alive_c)
    birth = _union(eq, rule.birth)
    survive = _union(eq, {n + 1 for n in rule.survive})
    to_one = (dead_c & (zero if birth is None else birth)) | (
        alive_c & (zero if survive is None else survive)
    )
    inc = _increment(ps_center)
    wrap = _eq_const(ps_center, rule.states - 1)
    advance = ~dead_c & ~to_one & ~wrap
    return [
        (to_one if k == 0 else zero) | (advance & inc[k])
        for k in range(len(ps_center))
    ]


def _transition_wire(ps_center, eq, rule) -> List[torch.Tensor]:
    """Next-state WireWorld planes (see the module docstring)."""
    p0, p1 = ps_center
    excite = _union(eq, rule.birth)
    if excite is None:
        excite = torch.zeros_like(p0)
    return [p1, (p0 ^ p1) | (p0 & p1 & ~excite)]


def step_gen_padded_rows_planes(ps: List[torch.Tensor], rule) -> List[torch.Tensor]:
    """One plane step on ``m`` separate row-padded slabs, each (h+2, words)
    with one halo row top and bottom → m × (h, words).  Row triple sums of
    the counted plane (state 1) are computed once per slab row and shared by
    the three output rows each feeds."""
    rule = resolve_rule(rule)
    require_plane_support(rule)
    m = n_planes(rule.states)
    if len(ps) != m:
        raise ValueError(f"expected {m} planes for {rule.states} states")
    alive = _eq_const(ps, 1)
    s, c = _row_triple_sum(alive)
    eq = count_eq_fn(*_count_bits(s[:-2], c[:-2], s[1:-1], c[1:-1], s[2:], c[2:]))
    center = [p[1:-1] for p in ps]
    if rule.kind == "wireworld":
        return _transition_wire(center, eq, rule)
    dead = _eq_const(ps, 0)
    return _transition(center, alive[1:-1], dead[1:-1], eq, rule)


def step_gen_padded_rows(padded: torch.Tensor, rule) -> torch.Tensor:
    """Stacked twin of :func:`step_gen_padded_rows_planes`:
    (m, h+2, words) → (m, h, words)."""
    rule = resolve_rule(rule)
    m = _require_plane_count(padded, rule)
    return torch.stack(step_gen_padded_rows_planes([padded[k] for k in range(m)], rule))


def step_gen(planes: torch.Tensor, rule) -> torch.Tensor:
    """One toroidal plane step on (m, H, W/32) int32 planes."""
    rule = resolve_rule(rule)
    require_plane_support(rule)
    m = _require_plane_count(planes, rule)
    ps = [planes[k] for k in range(m)]
    alive = _eq_const(ps, 1)
    s, c = _row_triple_sum(alive)
    eq = count_eq_fn(
        *_count_bits(
            torch.roll(s, 1, dims=0),
            torch.roll(c, 1, dims=0),
            s,
            c,
            torch.roll(s, -1, dims=0),
            torch.roll(c, -1, dims=0),
        )
    )
    if rule.kind == "wireworld":
        return torch.stack(_transition_wire(ps, eq, rule))
    return torch.stack(_transition(ps, alive, _eq_const(ps, 0), eq, rule))


def gen_multi_step(planes: torch.Tensor, rule, n: int) -> torch.Tensor:
    """``n`` generations of :func:`step_gen`."""
    rule = resolve_rule(rule)
    for _ in range(n):
        planes = step_gen(planes, rule)
    return planes


def gen_multi_step_fn(rule, n_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ``kernel=bitpack`` plane stepper: a closure over
    :func:`gen_multi_step`, registered on the program ledger (family
    ``bitpack_gen``)."""
    rule = resolve_rule(rule)
    require_plane_support(rule)
    return registered_jit(
        "bitpack_gen", ("multi_step", rule.name, n_steps),
        lambda planes: gen_multi_step(planes, rule, n_steps),
        # One board's worth of cells per step; the plane stack is the byte
        # traffic.
        cost=lambda planes: {
            "cells": float(planes.shape[-2])
            * planes.shape[-1] * planes.element_size() * 8 * n_steps,
            "bytes": 2.0 * planes.numel() * planes.element_size() * n_steps,
            "flops": 4.0 * planes.numel() * planes.element_size() * 8 * n_steps,
        },
    )


# -- observation ---------------------------------------------------------------


def alive_plane(planes: torch.Tensor) -> torch.Tensor:
    """The (H, W/32) words of the cells in state 1 (the population and the
    counted plane)."""
    return _eq_const([planes[k] for k in range(planes.shape[0])], 1)
