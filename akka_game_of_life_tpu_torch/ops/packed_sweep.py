"""The temporally blocked packed sweep: k generations per pass over the board.

Counterpart of ``akka_game_of_life_tpu/ops/pallas_stencil.py``.  On a CUDA
tensor :func:`packed_sweep` launches the hand-written kernel
``csrc/packed_sweep.cu`` (which replaces the TPU's ``packed_sweep_fn``); on a
CPU tensor it runs the plain version :func:`packed_sweep_reference`, which is
``steps_per_sweep`` calls of ``bitpack.step_packed``.  The tensor's device
alone decides: there is no fallback from one to the other.

Kept from the Pallas API: a non-binary or LtL rule, ``steps_per_sweep < 1``
and ``n_steps`` not a multiple of ``steps_per_sweep`` raise ``ValueError``.
Mosaic's constraints (8-row halo rounding, ``H % block_rows == 0``) do not
bind the CUDA kernel, which wraps every index modulo the torus, so any height
and any word count work.  The kernel's one halo word per side holds at most
:data:`MAX_STEPS_PER_SWEEP` generations per sweep.

The kernel is compiled per rule: a library is built with the rule's masks
(``-DRULE_BIRTH``, ``-DRULE_SURVIVE1``) and its tile, and
:func:`library_defines` is its key (``_build.load`` hashes the source with
those flags), so a rule a run names is built at its first launch.
``tile_rows`` (the Pallas API's ``block_rows``) picks the tile: ``None`` is
:data:`DEFAULT_TILE_ROWS` output rows per block, another value
``-DTILE_ROWS=<rows>``.  A variant computes the same words; only a tile
whose strips would pass the grid's rows of blocks (:func:`tile_fits`) is
refused, with ``ValueError``, on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import threading
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit
from akka_game_of_life_tpu_torch.ops import bitpack
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

MAX_STEPS_PER_SWEEP = 31
# Output rows per block (one warp's strip) of a library built without
# -DTILE_ROWS (``csrc/packed_sweep.cu``).
DEFAULT_TILE_ROWS = 192
# Rows of blocks a launch's grid may have (``gridDim.y``).
MAX_GRID_ROWS = 65535
# The best depth of ``tune --steps-per-call 60`` at 65536² on an H100 at
# 700 W (PERF.md): 1.456 ms per 10 generations at 192-row tiles,
# within 4% from k = 6 to 12; k = 10 divides the headline's 60-step chunks.
DEFAULT_STEPS_PER_SWEEP = 10
# The cluster's in-process workers launch from several threads; the launch
# count must not lose an increment between them.
_COUNT_LOCK = threading.Lock()


def rule_masks(rule: Rule) -> Tuple[int, int]:
    """The kernel's rule encoding: 10-bit masks over the 9-cell count
    (centre included) — birth at n, survive at n+1."""
    birth = sum(1 << n for n in rule.birth)
    survive1 = sum(1 << (n + 1) for n in rule.survive)
    return birth, survive1


def _check_steps(steps_per_sweep: int) -> int:
    if steps_per_sweep < 1:
        raise ValueError(f"steps_per_sweep={steps_per_sweep} must be >= 1")
    if steps_per_sweep > MAX_STEPS_PER_SWEEP:
        raise ValueError(
            f"steps_per_sweep={steps_per_sweep} exceeds the kernel's "
            f"{MAX_STEPS_PER_SWEEP}-generation halo"
        )
    return steps_per_sweep


def tile_fits(
    tile_rows: Optional[int], steps_per_sweep: int, height: int = 1
) -> bool:
    """Does a ``tile_rows`` variant take a ``steps_per_sweep``-deep sweep of
    ``height`` rows?  The kernel keeps every level in registers (no shared
    memory), so only the depth and the grid's rows of strips bound it."""
    rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    return (
        rows >= 1
        and 1 <= steps_per_sweep <= MAX_STEPS_PER_SWEEP
        and -(-height // rows) <= MAX_GRID_ROWS
    )


def check_tile(tile_rows: Optional[int], steps_per_sweep: int, height: int = 1) -> None:
    if not tile_fits(tile_rows, steps_per_sweep, height):
        raise ValueError(
            f"tile_rows={tile_rows} does not fit the packed sweep at "
            f"steps_per_sweep={steps_per_sweep} on {height} rows (tiles of "
            f">= 1 rows, 1..{MAX_STEPS_PER_SWEEP} steps, at most "
            f"{MAX_GRID_ROWS} tiles down the board)"
        )


def tile_defines(tile_rows: Optional[int]) -> Tuple[str, ...]:
    """The ``-D`` flags of a tile; the default tile adds none."""
    if tile_rows is None or tile_rows == DEFAULT_TILE_ROWS:
        return ()
    return (f"-DTILE_ROWS={int(tile_rows)}",)


def library_defines(rule, tile_rows: Optional[int] = None) -> Tuple[str, ...]:
    """The library key of a rule and a tile: its ``-D`` flags, the rule's
    masks first (:func:`rule_masks`), its combine network
    (:func:`combine_define`), then the tile's."""
    birth, survive1 = rule_masks(resolve_rule(rule))
    return (
        f"-DRULE_BIRTH={birth:#x}",
        f"-DRULE_SURVIVE1={survive1:#x}",
        *combine_define(rule),
        *tile_defines(tile_rows),
    )


def plan_sweeps(n_steps: int, steps_per_sweep: Optional[int] = None) -> List[int]:
    """The sweep depths of an ``n_steps`` advance.  An explicit
    ``steps_per_sweep`` must divide ``n_steps``; by default the sweeps are
    ``DEFAULT_STEPS_PER_SWEEP`` deep and the last one takes the remainder."""
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    if steps_per_sweep is None:
        k = min(DEFAULT_STEPS_PER_SWEEP, n_steps)
        return [k] * (n_steps // k) + ([n_steps % k] if n_steps % k else [])
    _check_steps(steps_per_sweep)
    if n_steps % steps_per_sweep:
        raise ValueError(
            f"n_steps={n_steps} not a multiple of steps_per_sweep={steps_per_sweep}"
        )
    return [steps_per_sweep] * (n_steps // steps_per_sweep)


def packed_sweep_reference(words: torch.Tensor, rule, steps_per_sweep: int) -> torch.Tensor:
    """The plain version: ``steps_per_sweep`` toroidal packed steps."""
    rule = resolve_rule(rule)
    bitpack.require_packed_support(rule)
    return bitpack.packed_multi_step(words, rule, _check_steps(steps_per_sweep))


class _Library(NamedTuple):
    launch: Callable
    variant: Tuple[int, int, int]  # (birth, survive1, tile rows) built in


@functools.lru_cache(maxsize=None)
def _launcher(defines: Tuple[str, ...]) -> _Library:
    """The C entry point of ``csrc/packed_sweep.cu`` built with
    ``defines`` (:func:`library_defines`: a rule and a tile), at first use."""
    from akka_game_of_life_tpu_torch.ops import _build

    lib = _build.load("packed_sweep", defines).lib
    fn = lib.packed_sweep_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    birth, survive1, tile = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_int()
    lib.packed_sweep_variant.argtypes = [ctypes.c_void_p] * 3
    lib.packed_sweep_variant.restype = None
    lib.packed_sweep_variant(
        ctypes.byref(birth), ctypes.byref(survive1), ctypes.byref(tile)
    )
    if not any(d.startswith("-DTILE_ROWS=") for d in defines) and tile.value != DEFAULT_TILE_ROWS:
        raise RuntimeError(
            f"csrc/packed_sweep.cu's default tile is {tile.value} rows, "
            f"ops/packed_sweep.py's {DEFAULT_TILE_ROWS}"
        )
    return _Library(fn, (birth.value, survive1.value, tile.value))


def _check_words(words: torch.Tensor) -> None:
    """Refuse what the kernel cannot take: anything but a contiguous
    (H, W/32) int32 tensor on the card."""
    if words.device.type != "cuda":
        raise ValueError(f"the CUDA sweep needs a CUDA tensor, got {words.device}")
    if words.dtype != bitpack.WORD_DTYPE:
        raise ValueError(f"packed words must be int32, got {words.dtype}")
    if words.dim() != 2 or not words.is_contiguous():
        raise ValueError(
            f"packed words must be a contiguous (H, W/32) tensor, got "
            f"shape {tuple(words.shape)}"
        )


def _checked_library(rule: Rule, defines: Tuple[str, ...]) -> _Library:
    """The library ``defines`` names; raises if it was built for another
    rule."""
    library = _launcher(defines)
    if library.variant[:2] != rule_masks(rule):
        raise RuntimeError(
            f"packed sweep library {defines} was built for rule masks "
            f"{library.variant[:2]}, not {rule}'s {rule_masks(rule)}"
        )
    return library


def launch_on_stream(device: torch.device, launch: Callable, *args) -> int:
    """``launch(*args, stream)``: a library's C entry point called with the
    raw handle of ``device``'s current stream last, that card made current
    where it is not.  ``torch.cuda.current_stream`` and ``torch.cuda.device``
    build Python objects on every call, host work that the card waits
    through before a call's first launch."""
    index = device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return launch(*args, stream)
    with torch.cuda.device(index):
        return launch(*args, stream)


def _enqueue(library: _Library, words: torch.Tensor, steps_per_sweep: int) -> torch.Tensor:
    """Queue one sweep of checked ``words`` through ``library`` on the
    current stream: the whole of a launch's host work."""
    h, nw = words.shape
    out = torch.empty_like(words)
    rc = launch_on_stream(
        words.device, library.launch, words.data_ptr(), out.data_ptr(), h, nw, steps_per_sweep
    )
    if rc != 0:
        raise RuntimeError(f"packed_sweep_launch failed: CUDA error {rc}")
    _count_launch()
    return out


def _launch(
    words: torch.Tensor,
    rule: Rule,
    steps_per_sweep: int,
    defines: Optional[Tuple[str, ...]] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor through the library
    ``defines`` names (by default the rule's, at the default tile); raises
    on anything else, and if the library was built for another rule."""
    _check_words(words)
    if defines is None:
        defines = library_defines(rule)
    return _enqueue(_checked_library(rule, defines), words, steps_per_sweep)


def _count_launch() -> None:
    with _COUNT_LOCK:
        packed_sweep.launches += 1


def packed_sweep(
    words: torch.Tensor, rule, steps_per_sweep: int, *, tile_rows: Optional[int] = None
) -> torch.Tensor:
    """Advance a packed (H, W/32) int32 torus by ``steps_per_sweep``
    generations in one pass: the CUDA kernel (the library of the rule and
    its ``tile_rows`` variant) for a CUDA tensor, the plain version for a CPU tensor.
    ``packed_sweep.launches`` counts kernel launches of every variant."""
    rule = resolve_rule(rule)
    bitpack.require_packed_support(rule)
    _check_steps(steps_per_sweep)
    check_tile(tile_rows, steps_per_sweep, words.shape[0])
    if words.device.type == "cpu":
        return packed_sweep_reference(words, rule, steps_per_sweep)
    return _launch(words, rule, steps_per_sweep, library_defines(rule, tile_rows))


packed_sweep.launches = 0


def packed_multi_step_fn(
    rule,
    n_steps: int,
    *,
    steps_per_sweep: Optional[int] = None,
    tile_rows: Optional[int] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """An ``n_steps`` advance built from the sweeps :func:`plan_sweeps`
    gives, through the ``tile_rows`` variant.  Each sweep writes a fresh
    buffer; the one it read is released to PyTorch's caching allocator,
    which hands it back to the next sweep, so two buffers alternate and the
    caller's input is never overwritten.  Registered on the program ledger
    as family ``pallas``, keyed and priced as the JAX package's sweep.

    Whatever depends on the rule and the plan alone is settled here, and
    the library once, at the first call on the card: a call's host work
    before its first launch is time in which the card waits."""
    rule = resolve_rule(rule)
    bitpack.require_packed_support(rule)
    depths = plan_sweeps(n_steps, steps_per_sweep)
    for k in set(depths):
        check_tile(tile_rows, k)
    defines = library_defines(rule, tile_rows)
    library: Optional[_Library] = None

    def run(words: torch.Tensor) -> torch.Tensor:
        nonlocal library
        if words.device.type != "cuda":
            for k in depths:
                words = packed_sweep(words, rule, k, tile_rows=tile_rows)
            return words
        _check_words(words)
        check_tile(tile_rows, depths[0], words.shape[0])
        if library is None:
            library = _checked_library(rule, defines)
        for k in depths:
            words = _enqueue(library, words, k)
        return words

    rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    return registered_jit(
        "pallas", ("packed_multi_step", rule.name, n_steps, rows), run,
        # Packed words: 32 cells/element; the temporal blocking reads and
        # writes the board once per sweep, not per step.
        cost=lambda x: {
            "cells": float(x.numel()) * x.element_size() * 8 * n_steps,
            "bytes": 2.0 * x.numel() * x.element_size() * len(depths),
            "flops": 2.0 * x.numel() * x.element_size() * 8 * n_steps,
        },
    )


def _combine_network(
    rule: Rule, count_bits: int, cells: Tuple[int, ...] = (0, 1)
) -> Tuple[int, Optional[int]]:
    """Fewest three-input logic instructions (LOP3) that map the low
    ``count_bits`` bits of the 9-cell count and the cell itself to the next
    state, and the network that does it: 0, 1 or 2 by exhaustive search
    (the network encoded as :func:`library_defines`' ``-DRULE_COMBINE``
    reads it); 3 where two do not suffice, which is then a lower bound,
    and no network.  ``cells`` are the centre values the network must
    serve: (0,) asks for the birth function of dead cells alone (the plane
    sweep's rules without survival, and WireWorld's excite)."""
    survive1 = {n + 1 for n in rule.survive}
    rows = [(t, x) for t in range(10) for x in cells if x <= t <= 8 + x]
    target = tuple(int(t in (survive1 if x else rule.birth)) for t, x in rows)
    signals = [tuple((t >> i) & 1 for t, _ in rows) for i in range(count_bits)]
    signals.append(tuple(x for _, x in rows))
    # The kernel's signal numbers: count bits b0..b3 are 0..3, the cell 4.
    ids = list(range(count_bits)) + [4]

    def table(cols) -> Optional[int]:
        """The LOP3 table of the target over these columns (first column
        the table's a), or None where it is no function of them."""
        seen = {}
        for key, want in zip(zip(*cols), target):
            if seen.setdefault(key, want) != want:
                return None
        return sum(want << (4 * a + 2 * b + c) for (a, b, c), want in seen.items())

    def encode(trio, t1, pair=None, t2=0) -> int:
        i, j, k = trio
        net = t1 | ids[i] << 8 | ids[j] << 11 | ids[k] << 14
        if pair is not None:
            net |= t2 << 17 | ids[pair[0]] << 25 | ids[pair[1]] << 28 | 1 << 31
        return net

    if len(set(target)) == 1:
        return 0, encode((0, 1, 2), 0xFF if target[0] else 0x00)
    if target in signals:
        return 0, encode((signals.index(target), 0, 1), 0xF0)
    trios = list(itertools.combinations(range(len(signals)), 3))
    for trio in trios:
        t1 = table([signals[i] for i in trio])
        if t1 is not None:
            return 1, encode(trio, t1)
    pairs = list(itertools.combinations(range(len(signals)), 2))
    for trio in trios:
        for t1 in range(256):
            first = tuple(
                (t1 >> (4 * a + 2 * b + c)) & 1
                for a, b, c in zip(*(signals[i] for i in trio))
            )
            for pair in pairs:
                t2 = table([first, signals[pair[0]], signals[pair[1]]])
                if t2 is not None:
                    return 2, encode(trio, t1, pair, t2)
    return 3, None


def combine_define(rule) -> Tuple[str, ...]:
    """``-DRULE_COMBINE=..``: the rule's fewest-LOP3 network over the
    count bits and the cell (two LOP3 for Conway), where one of at most two
    exists; none for a rule that needs more, whose kernel combines by two
    lookup tables and a select."""
    return combine_choice(resolve_rule(rule))[1]


@functools.lru_cache(maxsize=None)
def combine_choice(rule: Rule, cells: Tuple[int, ...] = (0, 1)) -> Tuple[int, Tuple[str, ...]]:
    """The combine a library is built with, over the count bits and the
    cell (:func:`_combine_network`'s ``cells``): its LOP3 count, one more
    where it reads b3 (a 3 stands for the lookup tables, a lower bound), and
    its ``-DRULE_COMBINE`` define (none for the lookup tables)."""
    low, net = _combine_network(rule, 3, cells)
    high, net4 = _combine_network(rule, 4, cells)
    if net4 is not None and 1 + high < low:  # reading b3 costs one LOP3
        return 1 + high, (f"-DRULE_COMBINE={net4:#x}",)
    return low, (() if net is None else (f"-DRULE_COMBINE={net:#x}",))


def ops_per_word_step(rule) -> int:
    """Instructions per word per generation of the step in its LOP3/SHF
    form, the operation count of a sweep's bound: the row sums take two
    funnel shifts (west, east) and two LOP3 (sum, majority carry); the count
    bits b0, p1, q0, q1, b1 and b2 six LOP3, and b3 one more where the rule
    reads it; then the rule's fewest LOP3 combine (Conway: 4 + 6 + 2 = 12)."""
    rule = resolve_rule(rule)
    bitpack.require_packed_support(rule)
    return 4 + 6 + combine_choice(rule)[0]
