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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Tuple

import torch

from akka_game_of_life_tpu_torch.ops import ltl
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

MAX_RADIUS = 10
RULE_WORDS = ((2 * MAX_RADIUS + 1) ** 2 + 31) // 32  # bitset words over 0..440


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
def _library():
    """``csrc/ltl_sweep.cu`` built at first use."""
    from akka_game_of_life_tpu_torch.ops import _build

    lib = _build.load("ltl_sweep").lib
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


def _launch(board: torch.Tensor, rule: Rule) -> torch.Tensor:
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
        rc = _library().ltl_sweep_launch(
            board.data_ptr(), out.data_ptr(), h, w, rule.radius, birth, survive,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"ltl_sweep_launch failed: CUDA error {rc}")
    ltl_sweep.launches += 1
    return out


def ltl_sweep(board: torch.Tensor, rule) -> torch.Tensor:
    """One LtL generation of an (H, W) uint8 torus: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor.  ``ltl_sweep.launches``
    counts kernel launches."""
    rule = resolve_rule(rule)
    require_sweep_support(rule)
    if board.device.type == "cpu":
        return ltl_sweep_reference(board, rule)
    return _launch(board, rule)


ltl_sweep.launches = 0


def ltl_multi_step_fn(rule, n_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """An ``n_steps`` advance: one launch per generation (the Pallas scan
    of ``ltl_pallas_multi_step_fn`` as a Python loop).  Each launch writes a
    fresh buffer; the caller's input is never overwritten."""
    rule = resolve_rule(rule)
    require_sweep_support(rule)

    def run(board: torch.Tensor) -> torch.Tensor:
        for _ in range(n_steps):
            board = ltl_sweep(board, rule)
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
