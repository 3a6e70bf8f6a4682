"""One Larger-than-Life generation per launch on the dense uint8 torus.

Counterpart of ``akka_game_of_life_tpu/ops/pallas_ltl.py``.  On a CUDA
tensor :func:`ltl_sweep` launches the hand-written kernel
``csrc/ltl_sweep.cu`` (which replaces the TPU's ``ltl_sweep_fn``); on a CPU
tensor it runs the plain version :func:`ltl_sweep_reference`, which is
``ltl.step_ltl``.  The tensor's device alone decides: there is no fallback
from one to the other.

Box neighborhoods only, as the Pallas kernel: the diamond raises (it runs
the plain cumsum path of ``ops/ltl.py``).  Mosaic's ``H % block_rows == 0``
does not bind the CUDA kernel, which wraps rows and columns modulo the
torus, so any H and W are taken.

``tile_rows`` (the Pallas API's ``block_rows``) picks a compile-time variant:
``None`` is the default library (:data:`DEFAULT_TILE_ROWS` output rows per
block), another value a library built with ``-DTILE_ROWS=<rows>``.  A variant
computes the same board; only a window that does not fit a block's shared
memory, or a grid taller than the launch allows (:func:`tile_fits`), is
refused, with ``ValueError``, on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Tuple

import torch

from akka_game_of_life_tpu_torch.ops import ltl
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

MAX_RADIUS = 10
RULE_WORDS = ((2 * MAX_RADIUS + 1) ** 2 + 31) // 32  # bitset words over 0..440
# The default library's tile (``csrc/ltl_sweep.cu``): DEFAULT_TILE_ROWS x
# TILE_COLS output cells per block.
DEFAULT_TILE_ROWS = 64
TILE_COLS = 256
# Dynamic shared memory a block may opt into on the H100 (227 KB), less the
# kernel's static copy of the rule; and the launch's grid rows.
SMEM_LIMIT_BYTES = 232448 - 2 * RULE_WORDS * 4
MAX_GRID_ROWS = 65535


def smem_bytes(tile_rows: Optional[int], radius: int) -> int:
    """Shared memory of one block: the (tile + 2R) x (256 + 2R) window of
    0/1 bytes and a double row buffer."""
    rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    cols = TILE_COLS + 2 * radius
    return (rows + 2 * radius) * cols + 2 * cols


def tile_fits(tile_rows: Optional[int], radius: int, height: int = 1) -> bool:
    """Does a ``tile_rows`` variant take radius ``radius`` on ``height``
    rows?"""
    rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    return (
        rows >= 1
        and smem_bytes(tile_rows, radius) <= SMEM_LIMIT_BYTES
        and -(-height // rows) <= MAX_GRID_ROWS
    )


def check_tile(tile_rows: Optional[int], radius: int, height: int = 1) -> None:
    if not tile_fits(tile_rows, radius, height):
        raise ValueError(
            f"tile_rows={tile_rows} does not fit the LtL kernel at R={radius} "
            f"on {height} rows ({smem_bytes(tile_rows, radius)} B of shared "
            f"memory, the limit is {SMEM_LIMIT_BYTES}; at most "
            f"{MAX_GRID_ROWS} tiles down the board)"
        )


def tile_defines(tile_rows: Optional[int]) -> Tuple[str, ...]:
    """The ``-D`` flags of a tile variant; the default tile is the default
    library."""
    if tile_rows is None or tile_rows == DEFAULT_TILE_ROWS:
        return ()
    return (f"-DTILE_ROWS={int(tile_rows)}",)


def require_sweep_support(rule: Rule) -> None:
    if rule.kind != "ltl" or rule.neighborhood != "box":
        raise ValueError(
            f"the LtL kernel supports kind='ltl' box neighborhoods, got {rule}"
        )


def rule_words(rule: Rule) -> Tuple[List[int], List[int]]:
    """The kernel's rule encoding: birth and survive as bitsets of
    ``RULE_WORDS`` 32-bit words over the neighbour count."""

    def bitset(counts) -> List[int]:
        words = [0] * RULE_WORDS
        for n in counts:
            words[n >> 5] |= 1 << (n & 31)
        return words

    return bitset(rule.birth), bitset(rule.survive)


def ltl_sweep_reference(board: torch.Tensor, rule) -> torch.Tensor:
    """The plain version: one toroidal ``ltl.step_ltl``."""
    rule = resolve_rule(rule)
    require_sweep_support(rule)
    return ltl.step_ltl(board, rule)


@functools.lru_cache(maxsize=None)
def _library(defines: Tuple[str, ...] = ()):
    """``csrc/ltl_sweep.cu`` built at first use; ``defines``
    (``-DTILE_ROWS=..``) pick a tile variant."""
    from akka_game_of_life_tpu_torch.ops import _build

    lib = _build.load("ltl_sweep", defines).lib
    lib.ltl_sweep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ltl_sweep_launch.restype = ctypes.c_int
    lib.ltl_sweep_rule_words.argtypes = []
    lib.ltl_sweep_rule_words.restype = ctypes.c_int
    if lib.ltl_sweep_rule_words() != RULE_WORDS:
        raise RuntimeError("csrc/ltl_sweep.cu and ops/ltl_sweep.py disagree on the rule bitset")
    return lib


def _launch(
    board: torch.Tensor, rule: Rule, defines: Tuple[str, ...] = ()
) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; raises on anything else."""
    if board.device.type != "cuda":
        raise ValueError(f"the CUDA LtL step needs a CUDA tensor, got {board.device}")
    if board.dtype != torch.uint8:
        raise ValueError(f"the LtL board must be uint8, got {board.dtype}")
    if board.dim() != 2 or not board.is_contiguous():
        raise ValueError(
            f"the LtL board must be a contiguous (H, W) tensor, got shape "
            f"{tuple(board.shape)}"
        )
    h, w = board.shape
    out = torch.empty_like(board)
    birth, survive = (
        (ctypes.c_uint * RULE_WORDS)(*words) for words in rule_words(rule)
    )
    stream = torch.cuda.current_stream(board.device).cuda_stream
    with torch.cuda.device(board.device):
        rc = _library(defines).ltl_sweep_launch(
            board.data_ptr(), out.data_ptr(), h, w, rule.radius, birth, survive,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"ltl_sweep_launch failed: CUDA error {rc}")
    ltl_sweep.launches += 1
    return out


def ltl_sweep(
    board: torch.Tensor, rule, *, tile_rows: Optional[int] = None
) -> torch.Tensor:
    """One LtL generation of an (H, W) uint8 torus: the CUDA kernel (its
    ``tile_rows`` variant) for a CUDA tensor, the plain version for a CPU
    tensor.  ``ltl_sweep.launches`` counts kernel launches of every
    variant."""
    rule = resolve_rule(rule)
    require_sweep_support(rule)
    check_tile(tile_rows, rule.radius, board.shape[0])
    if board.device.type == "cpu":
        return ltl_sweep_reference(board, rule)
    return _launch(board, rule, tile_defines(tile_rows))


ltl_sweep.launches = 0


def ltl_multi_step_fn(
    rule, n_steps: int, *, tile_rows: Optional[int] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """An ``n_steps`` advance: one launch per generation (the Pallas scan
    of ``ltl_pallas_multi_step_fn`` as a Python loop), through the
    ``tile_rows`` variant.  Each launch writes a fresh buffer; the caller's
    input is never overwritten."""
    rule = resolve_rule(rule)
    require_sweep_support(rule)
    check_tile(tile_rows, rule.radius)

    def run(board: torch.Tensor) -> torch.Tensor:
        for _ in range(n_steps):
            board = ltl_sweep(board, rule, tile_rows=tile_rows)
        return board

    return run


def ops_per_cell(rule) -> int:
    """Integer operations per cell per generation that the LtL step needs,
    the operation count of its bound: the box sum as running sums along
    both axes (2 adds along the columns and 2 along the rows, one term in
    and one out each), 1 for the centre and 4 for the rule (word index,
    shift, mask, live/dead select).  It does not grow with R; the kernel's
    own row sum, which re-adds 2R+1 terms, does more than this."""
    rule = resolve_rule(rule)
    require_sweep_support(rule)
    return 9
