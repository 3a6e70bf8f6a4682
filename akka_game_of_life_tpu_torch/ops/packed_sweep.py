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

``tile_rows`` (the Pallas API's ``block_rows``) picks a compile-time variant
of the kernel: ``None`` is the default library (:data:`DEFAULT_TILE_ROWS`
output rows per block), another value a library built with
``-DTILE_ROWS=<rows>``.  A variant computes the same words; only a tile whose
two shared-memory buffers do not fit a block (:func:`tile_fits`) is refused,
with ``ValueError``, on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import threading
from typing import Callable, List, Optional, Tuple

import torch

from akka_game_of_life_tpu_torch.ops import bitpack
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

MAX_STEPS_PER_SWEEP = 31
# Output rows per block of the default library (``csrc/packed_sweep.cu``).
DEFAULT_TILE_ROWS = 256
# Shared memory a block may opt into on the H100 (227 KB), and the words of
# one tile row (30 output words and one halo word a side).
SMEM_LIMIT_BYTES = 232448
TILE_COLS = 32
# Chosen on an H100 (700 W) by the tile sweep of
# ``python -m akka_game_of_life_tpu_torch.bench`` at 65536² (PERF.md): time
# per generation falls until k ≈ 6 and is flat (within 4%) from k = 6 to 15
# with the kernel's 256-row tiles.  k = 10 divides the headline's 60-step
# chunks.
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


def smem_bytes(tile_rows: Optional[int], steps_per_sweep: int) -> int:
    """Shared memory of one block: two buffers of (tile + 2k) rows of
    :data:`TILE_COLS` words."""
    rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    return 2 * (rows + 2 * steps_per_sweep) * TILE_COLS * 4


def tile_fits(tile_rows: Optional[int], steps_per_sweep: int) -> bool:
    """Does a ``tile_rows`` variant take a ``steps_per_sweep``-deep sweep?"""
    return (tile_rows is None or tile_rows >= 1) and (
        smem_bytes(tile_rows, steps_per_sweep) <= SMEM_LIMIT_BYTES
    )


def check_tile(tile_rows: Optional[int], steps_per_sweep: int) -> None:
    if not tile_fits(tile_rows, steps_per_sweep):
        raise ValueError(
            f"tile_rows={tile_rows} at steps_per_sweep={steps_per_sweep} does "
            f"not fit a block: {smem_bytes(tile_rows, steps_per_sweep)} B of "
            f"shared memory, the limit is {SMEM_LIMIT_BYTES}"
        )


def tile_defines(tile_rows: Optional[int]) -> Tuple[str, ...]:
    """The ``-D`` flags of a tile variant; the default tile is the default
    library."""
    if tile_rows is None or tile_rows == DEFAULT_TILE_ROWS:
        return ()
    return (f"-DTILE_ROWS={int(tile_rows)}",)


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


@functools.lru_cache(maxsize=None)
def _launcher(defines: Tuple[str, ...] = ()):
    """The C entry point of ``csrc/packed_sweep.cu``, built at first use;
    ``defines`` (``-DTILE_ROWS=..``, ``-DSTRIPS=..``) pick a tile variant."""
    from akka_game_of_life_tpu_torch.ops import _build

    fn = _build.load("packed_sweep", defines).lib.packed_sweep_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(
    words: torch.Tensor,
    rule: Rule,
    steps_per_sweep: int,
    defines: Tuple[str, ...] = (),
) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; raises on anything else."""
    if words.device.type != "cuda":
        raise ValueError(f"the CUDA sweep needs a CUDA tensor, got {words.device}")
    if words.dtype != bitpack.WORD_DTYPE:
        raise ValueError(f"packed words must be int32, got {words.dtype}")
    if words.dim() != 2 or not words.is_contiguous():
        raise ValueError(
            f"packed words must be a contiguous (H, W/32) tensor, got "
            f"shape {tuple(words.shape)}"
        )
    h, nw = words.shape
    out = torch.empty_like(words)
    birth, survive1 = rule_masks(rule)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    with torch.cuda.device(words.device):
        rc = _launcher(defines)(
            words.data_ptr(), out.data_ptr(), h, nw, steps_per_sweep,
            birth, survive1, stream,
        )
    if rc != 0:
        raise RuntimeError(f"packed_sweep_launch failed: CUDA error {rc}")
    _count_launch()
    return out


def _count_launch() -> None:
    with _COUNT_LOCK:
        packed_sweep.launches += 1


def packed_sweep(
    words: torch.Tensor, rule, steps_per_sweep: int, *, tile_rows: Optional[int] = None
) -> torch.Tensor:
    """Advance a packed (H, W/32) int32 torus by ``steps_per_sweep``
    generations in one pass: the CUDA kernel (its ``tile_rows`` variant)
    for a CUDA tensor, the plain version for a CPU tensor.
    ``packed_sweep.launches`` counts kernel launches of every variant."""
    rule = resolve_rule(rule)
    bitpack.require_packed_support(rule)
    _check_steps(steps_per_sweep)
    check_tile(tile_rows, steps_per_sweep)
    if words.device.type == "cpu":
        return packed_sweep_reference(words, rule, steps_per_sweep)
    return _launch(words, rule, steps_per_sweep, tile_defines(tile_rows))


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
    caller's input is never overwritten."""
    rule = resolve_rule(rule)
    bitpack.require_packed_support(rule)
    depths = plan_sweeps(n_steps, steps_per_sweep)
    for k in set(depths):
        check_tile(tile_rows, k)

    def run(words: torch.Tensor) -> torch.Tensor:
        for k in depths:
            words = packed_sweep(words, rule, k, tile_rows=tile_rows)
        return words

    return run


def _combine_instructions(rule: Rule, count_bits: int) -> int:
    """Fewest three-input logic instructions (LOP3) that map the low
    ``count_bits`` bits of the 9-cell count and the cell itself to the next
    state: 0, 1 or 2 by exhaustive search; 3 where two do not suffice, which
    is then a lower bound."""
    survive1 = {n + 1 for n in rule.survive}
    rows = [(t, x) for t in range(10) for x in (0, 1) if x <= t <= 8 + x]
    target = tuple(int(t in (survive1 if x else rule.birth)) for t, x in rows)
    signals = [tuple((t >> i) & 1 for t, _ in rows) for i in range(count_bits)]
    signals.append(tuple(x for _, x in rows))

    def fits(cols) -> bool:  # is the target a function of these columns?
        seen = {}
        return all(
            seen.setdefault(key, want) == want
            for key, want in zip(zip(*cols), target)
        )

    if len(set(target)) == 1 or target in signals:
        return 0
    trios = list(itertools.combinations(signals, 3))
    if any(fits(trio) for trio in trios):
        return 1
    firsts = {
        tuple((table >> (4 * a + 2 * b + c)) & 1 for a, b, c in zip(*trio))
        for trio in trios
        for table in range(256)
    }
    pairs = list(itertools.combinations(signals, 2))
    if any(fits((first, *pair)) for first in firsts for pair in pairs):
        return 2
    return 3


def ops_per_word_step(rule) -> int:
    """Instructions per word per generation of the step in its LOP3/SHF
    form, the operation count of a sweep's bound: the row sums take two
    funnel shifts (west, east) and two LOP3 (sum, majority carry); the count
    bits b0, p1, q0, q1, b1 and b2 six LOP3, and b3 one more where the rule
    reads it; then the rule's fewest LOP3 combine (Conway: 4 + 6 + 2 = 12)."""
    rule = resolve_rule(rule)
    bitpack.require_packed_support(rule)
    combine = min(
        _combine_instructions(rule, 3), 1 + _combine_instructions(rule, 4)
    )
    return 4 + 6 + combine
