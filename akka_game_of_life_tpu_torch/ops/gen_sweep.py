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

The kernel is compiled per rule: a library is built with the rule's masks,
its state count, the WireWorld flag and its combine network, and
:func:`library_defines` is its key (``_build.load`` hashes the source with
those flags), so a rule a run names is built at its first launch.
``tile_rows`` (the Pallas API's ``block_rows``) picks the tile: ``None`` is
:data:`DEFAULT_TILE_ROWS` output rows per block at every m, another value
``-DTILE_ROWS=<rows>``.  A variant computes the same planes; only a tile
whose strips would pass the grid's rows of blocks (:func:`tile_fits`) is
refused, with ``ValueError``, on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit
from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen
from akka_game_of_life_tpu_torch.ops.packed_sweep import (
    MAX_GRID_ROWS,
    MAX_STEPS_PER_SWEEP,
    combine_choice,
    launch_on_stream,
    plan_sweeps,
)
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

PLANE_COUNTS = range(2, 9)
# Output rows per block (one warp's strip) of a library built without
# -DTILE_ROWS (``csrc/gen_sweep.cu``), at every m: the best tile of ``tune
# --rule wireworld --size 16384 --steps-per-call 60 --sweeps 10`` on an H100
# at 700 W (PERF.md), and within 4% of Brian's Brain's best at 65536².
DEFAULT_TILE_ROWS = 192
# The cluster's in-process workers launch from several threads; the launch
# count must not lose an increment between them.
_COUNT_LOCK = threading.Lock()


def tile_fits(
    tile_rows: Optional[int], steps_per_sweep: int, height: int = 1
) -> bool:
    """Does a ``tile_rows`` variant take a ``steps_per_sweep``-deep sweep of
    ``height`` rows?  The kernel needs no more shared memory at one tile
    than another, so only the depth and the grid's rows of strips bound it,
    at every plane count."""
    rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    return (
        rows >= 1
        and 1 <= steps_per_sweep <= MAX_STEPS_PER_SWEEP
        and -(-height // rows) <= MAX_GRID_ROWS
    )


def check_tile(tile_rows: Optional[int], steps_per_sweep: int, height: int = 1) -> None:
    if not tile_fits(tile_rows, steps_per_sweep, height):
        raise ValueError(
            f"tile_rows={tile_rows} does not fit the plane sweep at "
            f"steps_per_sweep={steps_per_sweep} on {height} rows (tiles of "
            f">= 1 rows, 1..{MAX_STEPS_PER_SWEEP} steps, at most "
            f"{MAX_GRID_ROWS} tiles down the board)"
        )


def tile_defines(tile_rows: Optional[int]) -> Tuple[str, ...]:
    """The ``-D`` flags of a tile; the default tile adds none."""
    if tile_rows is None or tile_rows == DEFAULT_TILE_ROWS:
        return ()
    return (f"-DTILE_ROWS={int(tile_rows)}",)


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


def combine_cells(rule: Rule) -> Tuple[int, ...]:
    """The centres the kernel's combine network serves: dead and live cells
    (``survive(t)`` on a live one), or dead cells alone where no live cell
    survives and for WireWorld's excite."""
    return (0,) if rule.kind == "wireworld" or not rule.survive else (0, 1)


def library_defines(rule, tile_rows: Optional[int] = None) -> Tuple[str, ...]:
    """The library key of a rule and a tile: its ``-D`` flags, the rule's
    masks (:func:`rule_masks`), its state count and the WireWorld flag
    first, then its combine network (``packed_sweep.combine_choice`` over
    :func:`combine_cells`), then the tile's."""
    rule = resolve_rule(rule)
    require_sweep_support(rule)
    birth, survive1 = rule_masks(rule)
    return (
        f"-DRULE_BIRTH={birth:#x}",
        f"-DRULE_SURVIVE1={survive1:#x}",
        f"-DRULE_STATES={rule.states}",
        *(("-DRULE_WIREWORLD=1",) if rule.kind == "wireworld" else ()),
        *combine_choice(rule, combine_cells(rule))[1],
        *tile_defines(tile_rows),
    )


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


def _variant(rule: Rule) -> Tuple[int, int, int, int]:
    """(birth, survive1, states, WireWorld flag): what a library holds."""
    return (*rule_masks(rule), rule.states, int(rule.kind == "wireworld"))


class _Library(NamedTuple):
    launch: Callable
    variant: Tuple[int, int, int, int, int]  # _variant's four, then tile rows


@functools.lru_cache(maxsize=None)
def _launcher(defines: Tuple[str, ...]) -> _Library:
    """The C entry point of ``csrc/gen_sweep.cu`` built with ``defines``
    (:func:`library_defines`: a rule and a tile), at first use."""
    from akka_game_of_life_tpu_torch.ops import _build

    lib = _build.load("gen_sweep", defines).lib
    fn = lib.gen_sweep_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    birth, survive1, states = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_uint()
    wire, tile = ctypes.c_int(), ctypes.c_int()
    lib.gen_sweep_variant.argtypes = [ctypes.c_void_p] * 5
    lib.gen_sweep_variant.restype = None
    lib.gen_sweep_variant(*(ctypes.byref(v) for v in (birth, survive1, states, wire, tile)))
    if not any(d.startswith("-DTILE_ROWS=") for d in defines) and tile.value != DEFAULT_TILE_ROWS:
        raise RuntimeError(
            f"csrc/gen_sweep.cu's default tile is {tile.value} rows, "
            f"ops/gen_sweep.py's {DEFAULT_TILE_ROWS}"
        )
    return _Library(
        fn, (birth.value, survive1.value, states.value, wire.value, tile.value)
    )


def _check_cuda_planes(planes: torch.Tensor, m: int) -> None:
    """Refuse what the kernel cannot take: anything but ``m`` contiguous
    (H, W/32) int32 planes on the card."""
    if planes.device.type != "cuda":
        raise ValueError(f"the CUDA plane sweep needs a CUDA tensor, got {planes.device}")
    if planes.dtype != bitpack.WORD_DTYPE:
        raise ValueError(f"bit planes must be int32, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("bit planes must be a contiguous (m, H, W/32) tensor")
    _check_planes(planes, m)


def _checked_library(rule: Rule, defines: Tuple[str, ...]) -> _Library:
    """The library ``defines`` names; raises if it was built for another
    rule."""
    library = _launcher(defines)
    if library.variant[:4] != _variant(rule):
        raise RuntimeError(
            f"plane sweep library {defines} was built for rule "
            f"{library.variant[:4]}, not {rule}'s {_variant(rule)}"
        )
    return library


def _enqueue(library: _Library, planes: torch.Tensor, steps_per_sweep: int) -> torch.Tensor:
    """Queue one sweep of checked ``planes`` through ``library`` on the
    current stream: the whole of a launch's host work."""
    m, h, nw = planes.shape
    out = torch.empty_like(planes)
    rc = launch_on_stream(
        planes.device, library.launch, planes.data_ptr(), out.data_ptr(), m, h, nw, steps_per_sweep
    )
    if rc != 0:
        raise RuntimeError(f"gen_sweep_launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        gen_sweep.launches += 1
    return out


def _launch(
    planes: torch.Tensor,
    rule: Rule,
    steps_per_sweep: int,
    defines: Optional[Tuple[str, ...]] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor through the library
    ``defines`` names (by default the rule's, at the default tile); raises
    on anything else, including a depth the kernel refuses, and if the
    library was built for another rule."""
    _check_cuda_planes(planes, bitpack_gen.n_planes(rule.states))
    if defines is None:
        defines = library_defines(rule)
    return _enqueue(_checked_library(rule, defines), planes, steps_per_sweep)


def gen_sweep(
    planes: torch.Tensor, rule, steps_per_sweep: int, *, tile_rows: Optional[int] = None
) -> torch.Tensor:
    """Advance stacked (m, H, W/32) int32 planes by ``steps_per_sweep``
    generations in one pass: the CUDA kernel (the library of the rule and
    its ``tile_rows`` variant) for a CUDA tensor, the plain version for a
    CPU tensor.  ``gen_sweep.launches`` counts kernel launches of every
    variant."""
    rule = resolve_rule(rule)
    m = require_sweep_support(rule)
    _check_planes(planes, m)
    _check_steps(m, steps_per_sweep)
    check_tile(tile_rows, steps_per_sweep, planes.shape[1])
    if planes.device.type == "cpu":
        return gen_sweep_reference(planes, rule, steps_per_sweep)
    return _launch(planes, rule, steps_per_sweep, library_defines(rule, tile_rows))


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
    fresh buffer; the caller's input is never overwritten.  Registered on
    the program ledger as family ``pallas_gen``, keyed and priced as the
    JAX package's plane sweep.

    Whatever depends on the rule and the plan alone is settled here, and
    the library once, at the first call on the card: a call's host work
    before its first launch is time in which the card waits."""
    rule = resolve_rule(rule)
    m = require_sweep_support(rule)
    depths = plan_sweeps(n_steps, steps_per_sweep)
    for k in set(depths):
        _check_steps(m, k)
        check_tile(tile_rows, k)
    defines = library_defines(rule, tile_rows)
    library: Optional[_Library] = None

    def run(planes: torch.Tensor) -> torch.Tensor:
        nonlocal library
        if planes.device.type != "cuda":
            for k in depths:
                planes = gen_sweep(planes, rule, k, tile_rows=tile_rows)
            return planes
        _check_cuda_planes(planes, m)
        check_tile(tile_rows, depths[0], planes.shape[1])
        if library is None:
            library = _checked_library(rule, defines)
        for k in depths:
            planes = _enqueue(library, planes, k)
        return planes

    rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    return registered_jit(
        "pallas_gen", ("multi_step", rule.name, n_steps, rows), run,
        # m packed planes encode one board: one board of cells per step,
        # m planes of byte traffic per sweep.
        cost=lambda planes: {
            "cells": float(planes.shape[-2])
            * planes.shape[-1] * planes.element_size() * 8 * n_steps,
            "bytes": 2.0 * planes.numel() * planes.element_size() * len(depths),
            "flops": 4.0 * planes.numel() * planes.element_size() * 8 * n_steps,
        },
    )


def _and_lop3(n: int) -> int:
    """Three-input logic instructions of an n-input AND (n >= 2)."""
    return math.ceil((n - 1) / 2)


def ops_per_word_step(rule) -> int:
    """Instructions per word per generation of the plane step in its
    LOP3/SHF form, the operation count of a sweep's bound, counted as
    ``packed_sweep.ops_per_word_step`` counts the binary step: the alive
    plane (an m-input AND), its row sums (2 funnel shifts, 2 LOP3) and the
    count bits (6 LOP3, one more where the combine reads b3), the rule's
    fewest-LOP3 combine (``packed_sweep.combine_choice`` over
    :func:`combine_cells`), then the planes' update: WireWorld one LOP3
    (p1' over p0, p1 and excite; p0' is p1), Generations at m = 2 one LOP3
    per plane over (net, p0, p1), deeper at least one per plane and one per
    carry of the increment past p0 & p1 (WireWorld 13, Brian's Brain 14)."""
    rule = resolve_rule(rule)
    m = require_sweep_support(rule)
    combine = combine_choice(rule, combine_cells(rule))[0]
    ops = _and_lop3(m) + 4 + 6 + combine
    if rule.kind == "wireworld":
        return ops + 1
    return ops + m + max(0, m - 3)
