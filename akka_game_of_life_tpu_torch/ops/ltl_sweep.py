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

The rule reaches the kernel as runs of counts (:func:`rule_ranges`), in a
small device table the wrapper uploads once per rule and device.
``tile_rows`` (the Pallas API's ``block_rows``) picks a compile-time variant:
``None`` is the default library (:data:`DEFAULT_TILE_ROWS` output rows per
block), another value a library built with ``-DTILE_ROWS=<rows>``.  A variant
computes the same board; only a grid taller than the launch allows
(:func:`tile_fits`) is refused, with ``ValueError``, on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Tuple

import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit, stencil_cost
from akka_game_of_life_tpu_torch.ops import ltl
from akka_game_of_life_tpu_torch.ops.packed_sweep import launch_on_stream
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

MAX_RADIUS = 10
# The default library's tile (``csrc/ltl_sweep.cu``): DEFAULT_TILE_ROWS
# output rows by 480 columns per block (one warp: 32 lanes of RUN cells,
# the outer lane on each side halo).
DEFAULT_TILE_ROWS = 48
RUN = 16
# Rows of blocks a launch's grid may have (``gridDim.y``).
MAX_GRID_ROWS = 65535


def smem_bytes(radius: int) -> int:
    """Shared memory of one block: the lanes' ring of the 2R+1 rows in the
    window, 16 bytes per lane and row (10.5 KB at R = 10, under the 48 KB a
    block has without an opt-in, at every tile)."""
    return (2 * radius + 1) * 32 * RUN


def tile_fits(tile_rows: Optional[int], radius: int, height: int = 1) -> bool:
    """Does a ``tile_rows`` variant take radius ``radius`` on ``height``
    rows?"""
    rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    return rows >= 1 and 1 <= radius <= MAX_RADIUS and -(-height // rows) <= MAX_GRID_ROWS


def check_tile(tile_rows: Optional[int], radius: int, height: int = 1) -> None:
    if not tile_fits(tile_rows, radius, height):
        raise ValueError(
            f"tile_rows={tile_rows} does not fit the LtL kernel at R={radius} "
            f"on {height} rows (tiles of >= 1 rows, R in 1..{MAX_RADIUS}, at "
            f"most {MAX_GRID_ROWS} tiles down the board)"
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


def rule_ranges(rule: Rule) -> List[int]:
    """The kernel's rule table: the number of birth and of survive runs,
    then each run's lowest box count and one past its highest.  Box counts
    include the centre, so a live cell's survive count n reads as n + 1."""

    def runs(counts, shift: int) -> List[int]:
        out: List[int] = []
        for n in sorted(counts):
            if out and out[-1] == n + shift:
                out[-1] += 1
            else:
                out += [n + shift, n + shift + 1]
        return out

    birth, survive = runs(rule.birth, 0), runs(rule.survive, 1)
    return [len(birth) // 2, len(survive) // 2, *birth, *survive]


@functools.lru_cache(maxsize=None)
def _ranges_on(rule: Rule, device: torch.device) -> torch.Tensor:
    """:func:`rule_ranges` on ``device``, uploaded once."""
    return torch.tensor(rule_ranges(rule), dtype=torch.int32, device=device)


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
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.ltl_sweep_launch.restype = ctypes.c_int
    lib.ltl_sweep_tile_rows.argtypes = []
    lib.ltl_sweep_tile_rows.restype = ctypes.c_int
    if not defines and lib.ltl_sweep_tile_rows() != DEFAULT_TILE_ROWS:
        raise RuntimeError(
            f"csrc/ltl_sweep.cu's default tile is {lib.ltl_sweep_tile_rows()} "
            f"rows, ops/ltl_sweep.py's {DEFAULT_TILE_ROWS}"
        )
    return lib


def _check_board(board: torch.Tensor) -> None:
    """Refuse what the kernel cannot take: anything but a contiguous
    (H, W) uint8 tensor on the card."""
    if board.device.type != "cuda":
        raise ValueError(f"the CUDA LtL step needs a CUDA tensor, got {board.device}")
    if board.dtype != torch.uint8:
        raise ValueError(f"the LtL board must be uint8, got {board.dtype}")
    if board.dim() != 2 or not board.is_contiguous():
        raise ValueError(
            f"the LtL board must be a contiguous (H, W) tensor, got shape "
            f"{tuple(board.shape)}"
        )


def _enqueue(launch: Callable, board: torch.Tensor, radius: int, ranges: torch.Tensor) -> torch.Tensor:
    """Queue one generation of a checked ``board`` through the library's
    ``launch`` on the current stream, with the rule table ``ranges`` on the
    board's card: the whole of a launch's host work."""
    h, w = board.shape
    out = torch.empty_like(board)
    # 16-byte loads and stores where every row starts on a 16-byte boundary.
    aligned = w % 16 == 0 and board.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    rc = launch_on_stream(
        board.device, launch, board.data_ptr(), out.data_ptr(), h, w, radius,
        ranges.data_ptr(), int(aligned),
    )
    if rc != 0:
        raise RuntimeError(f"ltl_sweep_launch failed: CUDA error {rc}")
    ltl_sweep.launches += 1
    return out


def _launch(
    board: torch.Tensor, rule: Rule, defines: Tuple[str, ...] = ()
) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor; raises on anything else."""
    _check_board(board)
    return _enqueue(
        _library(defines).ltl_sweep_launch, board, rule.radius,
        _ranges_on(rule, board.device),
    )


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
    input is never overwritten.  Registered on the program ledger as family
    ``pallas_ltl``, keyed and priced as the JAX package's LtL sweep.

    Whatever depends on the rule alone is settled here, and the library
    and the rule table once, at the first call on the card: a call's host
    work before its first launch is time in which the card waits."""
    rule = resolve_rule(rule)
    require_sweep_support(rule)
    check_tile(tile_rows, rule.radius)
    defines = tile_defines(tile_rows)
    launch: Optional[Callable] = None

    def run(board: torch.Tensor) -> torch.Tensor:
        nonlocal launch
        if board.device.type != "cuda":
            for _ in range(n_steps):
                board = ltl_sweep(board, rule, tile_rows=tile_rows)
            return board
        _check_board(board)
        check_tile(tile_rows, rule.radius, board.shape[0])
        if launch is None:
            launch = _library(defines).ltl_sweep_launch
        ranges = _ranges_on(rule, board.device)
        for _ in range(n_steps):
            board = _enqueue(launch, board, rule.radius, ranges)
        return board

    rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    return registered_jit(
        "pallas_ltl", ("multi_step", rule.name, n_steps, rows), run,
        cost=lambda x: stencil_cost(
            x.shape[-2], x.shape[-1], n_steps,
            flops_per_cell=4.0 * rule.radius + 4.0,
        ),
    )


def ops_per_cell(rule) -> int:
    """Integer operations per cell per generation that the LtL step needs,
    the operation count of its bound: the box sum as running sums along
    both axes (2 adds along the columns and 2 along the rows, one term in
    and one out each), 1 for the centre and 4 for the rule (word index,
    shift, mask, live/dead select).  It does not grow with R."""
    rule = resolve_rule(rule)
    require_sweep_support(rule)
    return 9
