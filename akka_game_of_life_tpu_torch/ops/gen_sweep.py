"""The temporally blocked plane sweep: k Generations/WireWorld generations
per pass over m stacked bit planes.

Counterpart of ``akka_game_of_life_tpu/ops/pallas_gen.py``.  On a CUDA
tensor :func:`gen_sweep` launches the hand-written kernel
``csrc/gen_sweep.cu`` (which replaces the TPU's ``gen_sweep_fn``); on a CPU
tensor it runs the plain version :func:`gen_sweep_reference`, which is
``steps_per_sweep`` calls of ``bitpack_gen.step_gen``.  The tensor's device
alone decides: there is no fallback from one to the other.

Planes are stacked (m, H, W/32) int32, in and out, as the Pallas API's
public form is.  Kept from it: a rule the planes cannot step, a wrong plane
count, ``steps_per_sweep < 1`` and ``n_steps`` not a multiple of
``steps_per_sweep`` raise ``ValueError``.  Mosaic's constraints (8-row halo
rounding, ``H % block_rows == 0``) do not bind the CUDA kernel, which wraps
every index modulo the torus.  Binary rules (one plane) step through
``ops/packed_sweep.py``; this kernel takes m = 2..8 planes (3..255 states).

``tile_rows`` (the Pallas API's ``block_rows``) picks a compile-time variant:
``None`` is the default library, whose tile is ``ROW_BUDGET // m`` rows of
every plane; another value a library built with ``-DTILE_ROWS=<rows>``, whose
tile is that many rows at every m.  A variant computes the same planes; only a
tile whose buffers do not fit a block (:func:`tile_fits`) is refused, with
``ValueError``, on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen
from akka_game_of_life_tpu_torch.ops.packed_sweep import MAX_STEPS_PER_SWEEP, plan_sweeps
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

PLANE_COUNTS = range(2, 9)
# Shared memory a block may opt into on the H100 (227 KB), and the words of
# one tile row (30 output words and one halo word a side).
SMEM_LIMIT_BYTES = 232448
TILE_COLS = 32
# The default library's tile: ROW_BUDGET // m output rows of each of m planes
# (``csrc/gen_sweep.cu``'s kRowBudget).
ROW_BUDGET = 256


def default_tile_rows(m: int) -> int:
    return ROW_BUDGET // m


def smem_bytes(m: int, tile_rows: Optional[int], steps_per_sweep: int) -> int:
    """Shared memory of one block: two buffers of m planes of (tile + 2k)
    rows of :data:`TILE_COLS` words."""
    rows = default_tile_rows(m) if tile_rows is None else tile_rows
    return 2 * m * (rows + 2 * steps_per_sweep) * TILE_COLS * 4


def tile_fits(m: int, tile_rows: Optional[int], steps_per_sweep: int) -> bool:
    """Does a ``tile_rows`` variant take a ``steps_per_sweep``-deep sweep of
    m planes?"""
    return (tile_rows is None or tile_rows >= 1) and (
        smem_bytes(m, tile_rows, steps_per_sweep) <= SMEM_LIMIT_BYTES
    )


def check_tile(m: int, tile_rows: Optional[int], steps_per_sweep: int) -> None:
    if not tile_fits(m, tile_rows, steps_per_sweep):
        raise ValueError(
            f"tile_rows={tile_rows} at steps_per_sweep={steps_per_sweep} does "
            f"not fit a block of {m} planes: "
            f"{smem_bytes(m, tile_rows, steps_per_sweep)} B of shared memory, "
            f"the limit is {SMEM_LIMIT_BYTES}"
        )


def tile_defines(tile_rows: Optional[int]) -> Tuple[str, ...]:
    """The ``-D`` flags of a tile variant (``None``: the default library)."""
    return () if tile_rows is None else (f"-DTILE_ROWS={int(tile_rows)}",)


def require_sweep_support(rule: Rule) -> int:
    """The plane count of a rule the sweep steps; raises for the others."""
    bitpack_gen.require_plane_support(rule)
    m = bitpack_gen.n_planes(rule.states)
    if m not in PLANE_COUNTS:
        raise ValueError(
            f"the plane sweep takes 3..255-state rules (2..8 planes); binary "
            f"rule {rule} steps through the packed sweep"
        )
    return m


def rule_masks(rule: Rule) -> Tuple[int, int]:
    """The kernel's rule encoding, 10-bit masks over the alive plane's
    9-cell count (centre included): birth (WireWorld: excite) at n, survive
    at n+1 for the live centre's self term."""
    birth = sum(1 << n for n in rule.birth)
    if rule.kind == "wireworld":
        return birth, 0
    return birth, sum(1 << (n + 1) for n in rule.survive)


def _check_steps(m: int, steps_per_sweep: int) -> int:
    if steps_per_sweep < 1:
        raise ValueError(f"steps_per_sweep={steps_per_sweep} must be >= 1")
    if steps_per_sweep > MAX_STEPS_PER_SWEEP:
        raise ValueError(
            f"steps_per_sweep={steps_per_sweep} exceeds the kernel's "
            f"{MAX_STEPS_PER_SWEEP}-generation limit at {m} planes"
        )
    return steps_per_sweep


def _check_planes(planes: torch.Tensor, m: int) -> None:
    if planes.dim() != 3 or planes.shape[0] != m:
        raise ValueError(
            f"expected {m} stacked planes (m, H, W/32), got shape "
            f"{tuple(planes.shape)}"
        )


def gen_sweep_reference(planes: torch.Tensor, rule, steps_per_sweep: int) -> torch.Tensor:
    """The plain version: ``steps_per_sweep`` toroidal plane steps."""
    rule = resolve_rule(rule)
    m = require_sweep_support(rule)
    _check_planes(planes, m)
    return bitpack_gen.gen_multi_step(planes, rule, _check_steps(m, steps_per_sweep))


@functools.lru_cache(maxsize=None)
def _library(defines: Tuple[str, ...] = ()):
    """``csrc/gen_sweep.cu`` built at first use; ``defines``
    (``-DTILE_ROWS=..``) pick a tile variant."""
    from akka_game_of_life_tpu_torch.ops import _build

    lib = _build.load("gen_sweep", defines).lib
    lib.gen_sweep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gen_sweep_launch.restype = ctypes.c_int
    return lib


def _launch(
    planes: torch.Tensor,
    rule: Rule,
    steps_per_sweep: int,
    defines: Tuple[str, ...] = (),
) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; raises on anything else,
    including a depth the kernel refuses."""
    m = bitpack_gen.n_planes(rule.states)
    if planes.device.type != "cuda":
        raise ValueError(f"the CUDA plane sweep needs a CUDA tensor, got {planes.device}")
    if planes.dtype != bitpack.WORD_DTYPE:
        raise ValueError(f"bit planes must be int32, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("bit planes must be a contiguous (m, H, W/32) tensor")
    _check_planes(planes, m)
    _, h, nw = planes.shape
    out = torch.empty_like(planes)
    birth, survive1 = rule_masks(rule)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        rc = _library(defines).gen_sweep_launch(
            planes.data_ptr(), out.data_ptr(), m, h, nw, steps_per_sweep,
            birth, survive1, rule.states, int(rule.kind == "wireworld"), stream,
        )
    if rc != 0:
        raise RuntimeError(f"gen_sweep_launch failed: CUDA error {rc}")
    gen_sweep.launches += 1
    return out


def gen_sweep(
    planes: torch.Tensor, rule, steps_per_sweep: int, *, tile_rows: Optional[int] = None
) -> torch.Tensor:
    """Advance stacked (m, H, W/32) int32 planes by ``steps_per_sweep``
    generations in one pass: the CUDA kernel (its ``tile_rows`` variant)
    for a CUDA tensor, the plain version for a CPU tensor.
    ``gen_sweep.launches`` counts kernel launches of every variant."""
    rule = resolve_rule(rule)
    m = require_sweep_support(rule)
    _check_planes(planes, m)
    _check_steps(m, steps_per_sweep)
    check_tile(m, tile_rows, steps_per_sweep)
    if planes.device.type == "cpu":
        return gen_sweep_reference(planes, rule, steps_per_sweep)
    return _launch(planes, rule, steps_per_sweep, tile_defines(tile_rows))


gen_sweep.launches = 0


def gen_multi_step_fn(
    rule,
    n_steps: int,
    *,
    steps_per_sweep: Optional[int] = None,
    tile_rows: Optional[int] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """An ``n_steps`` advance built from the sweeps ``plan_sweeps`` gives
    (``packed_sweep.DEFAULT_STEPS_PER_SWEEP`` deep, the last one taking the
    remainder, or ``steps_per_sweep`` deep where given, which must divide
    ``n_steps``), through the ``tile_rows`` variant.  Each sweep writes a
    fresh buffer; the caller's input is never overwritten."""
    rule = resolve_rule(rule)
    m = require_sweep_support(rule)
    depths = plan_sweeps(n_steps, steps_per_sweep)
    for k in set(depths):
        _check_steps(m, k)
        check_tile(m, tile_rows, k)

    def run(planes: torch.Tensor) -> torch.Tensor:
        for k in depths:
            planes = gen_sweep(planes, rule, k, tile_rows=tile_rows)
        return planes

    return run


def _eq_lop3(m: int) -> int:
    """Three-input logic instructions for an m-input AND (state == v)."""
    return math.ceil((m - 1) / 2)


def ops_per_word_step(rule) -> int:
    """Instructions per word per generation of the plane step in its
    LOP3/SHF form, the operation count of a sweep's bound: the alive plane
    (an m-input AND), its row sums (2 funnel shifts, 2 LOP3) and count bits
    (6 LOP3, +1 for b3 where a predicate reads counts 8-9), then each
    non-empty count predicate in at most 3 LOP3 (a 4-input function by
    Shannon expansion on one bit).  WireWorld adds one LOP3 for p1' (p0' is
    p1).  Generations adds the dead and S-1 planes (two m-input ANDs),
    to_one (2), advance (1), plane 0 (1) and, for each higher plane, the
    increment's sum and carry (2, no carry out of the top plane)."""
    rule = resolve_rule(rule)
    m = require_sweep_support(rule)
    if rule.kind == "wireworld":
        read = set(rule.birth)
    else:
        read = set(rule.birth) | {n + 1 for n in rule.survive}
    ops = _eq_lop3(m) + 4 + 6 + int(any(n >= 8 for n in read))
    predicates = [rule.birth] if rule.kind == "wireworld" else [
        rule.birth, rule.survive
    ]
    ops += sum(3 for p in predicates if p)
    if rule.kind == "wireworld":
        return ops + 1
    return ops + 2 * _eq_lop3(m) + 2 + 1 + 1 + 2 * (m - 1) - 1
