"""Tile autotuner of the CUDA kernels: time (tile rows, sweep depth) points.

Counterpart of ``akka_game_of_life_tpu/runtime/autotune.py`` (TPU kernel #8
of PERF.md: the tune sweeps over the Pallas kernels).  Each point of the
grid is a compile-time variant of a hand-written kernel — the packed sweep
(``csrc/packed_sweep.cu``) for binary rules, the plane sweep
(``csrc/gen_sweep.cu``) for Generations/WireWorld, the LtL step
(``csrc/ltl_sweep.cu``) for box Larger-than-Life — built with
``-DTILE_ROWS=<block_rows>`` and timed over ``steps_per_call``-generation
calls at ``size``².  The JAX names stay: ``block_rows`` is a point's tile
rows, ``steps_per_sweep`` its sweep depth k.  The answer, ``run --kernel
pallas --pallas-block-rows B``, drives the same variant in the product.

On a CUDA device every point's library is built first (one ``nvcc`` each,
all at once), then each point runs two chained warm calls and
``timed_calls`` timed calls between CUDA events.  The JAX package warms
once; the second warm call here lets PyTorch's caching allocator grow to the
three boards a chain holds before the clock starts (with one, the first
point of a grid read slow in some runs, PERF.md).  On the CPU the kernels'
plain versions run, so the records exercise the grid and the output but
time PyTorch's CPU kernels.  A point that fails to build or launch is an
``error`` record, the tuner's result for that point; every other path of the
port raises instead.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from akka_game_of_life_tpu_torch.ops import (
    bitpack,
    bitpack_gen,
    gen_sweep,
    ltl_sweep,
    packed_sweep,
)
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

# The tiles ``kernel=auto`` (and ``kernel=pallas`` without
# ``pallas_block_rows``) runs: each kernel's default library, the
# counterpart of the JAX package's MEASURED_BLOCK_ROWS_CAPS.  Measured by
# ``tune`` on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, row #8 of the
# TPU-kernel table): the packed sweep's 192 rows (at 60 generations per
# call), the LtL step's 48 rows and the plane sweep's 192 rows (WireWorld
# at 16384², 60 generations per call, 10 per sweep; the same tile at every
# m) were the best points of their grids.  Changing one to a tune winner is
# a measured change of its own.
MEASURED_TILE_ROWS = {
    "packed_sweep": packed_sweep.DEFAULT_TILE_ROWS,
    "gen_sweep": gen_sweep.DEFAULT_TILE_ROWS,
    "ltl_sweep": ltl_sweep.DEFAULT_TILE_ROWS,
}


def kernel_of(rule) -> str:
    """The kernel ``tune`` sweeps for ``rule``."""
    rule = resolve_rule(rule)
    if rule.kind == "ltl":
        ltl_sweep.require_sweep_support(rule)
        return "ltl_sweep"
    return "packed_sweep" if rule.is_binary else "gen_sweep"


def default_tile_rows(rule) -> int:
    """The tile rows ``kernel=auto`` runs for ``rule``."""
    return MEASURED_TILE_ROWS[kernel_of(rule)]


def feasible(size: int, steps_per_call: int, b: int, k: int, rule="conway") -> bool:
    """The port's feasibility rules for a (tile rows ``b``, depth ``k``)
    point of a ``size``² board.  The CUDA kernels wrap every index modulo
    the torus, so the JAX rules (``size % b == 0``, 8-row blocks, halo
    blocks that divide the block) do not apply.  Instead:

    - ``b >= 1`` and ``1 <= k <= MAX_STEPS_PER_SWEEP`` (31: one halo word a
      side), and k divides ``steps_per_call``;
    - the packed and plane sweeps (levels in registers) and LtL (one
      generation per launch, k = 1): the board is at most 65535 tiles tall.
    """
    rule = resolve_rule(rule)
    if b < 1 or k < 1 or k > packed_sweep.MAX_STEPS_PER_SWEEP:
        return False
    if steps_per_call % k:
        return False
    kernel = kernel_of(rule)
    if kernel == "ltl_sweep":
        return k == 1 and ltl_sweep.tile_fits(b, rule.radius, size)
    if kernel == "gen_sweep":
        return gen_sweep.tile_fits(b, k, size)
    return packed_sweep.tile_fits(b, k, size)


def _board(rule, size: int, kernel: str, device: torch.device) -> torch.Tensor:
    """A random size² board in the kernel's layout, made in row chunks so
    the host never holds more than a chunk beside the result."""
    rng = np.random.default_rng(0)
    if kernel == "packed_sweep":
        # Uniform random words are a density-1/2 board, 0.25 B per cell.
        return bitpack.words_from_numpy(
            rng.integers(0, 2**32, size=(size, size // 32), dtype=np.uint32), device
        )
    if kernel == "gen_sweep":
        chunk = max(1, min(size, 2**27 // size))
        parts = []
        for r0 in range(0, size, chunk):
            rows = rng.integers(
                0, rule.states, size=(min(chunk, size - r0), size), dtype=np.uint8
            )
            parts.append(bitpack_gen.pack_gen_np(rows, rule.states))
        return bitpack_gen.planes_from_numpy(np.concatenate(parts, axis=1), device)
    board = np.empty((size, size), np.uint8)
    chunk = max(1, min(size, 2**24 // size))
    for r0 in range(0, size, chunk):
        rows = min(chunk, size - r0)
        board[r0 : r0 + rows] = rng.random((rows, size)) < 0.4
    return torch.from_numpy(board).to(device)


def _step_fn(rule, kernel: str, steps_per_call: int, b: int, k: int):
    if kernel == "packed_sweep":
        return packed_sweep.packed_multi_step_fn(
            rule, steps_per_call, steps_per_sweep=k, tile_rows=b
        )
    if kernel == "gen_sweep":
        return gen_sweep.gen_multi_step_fn(
            rule, steps_per_call, steps_per_sweep=k, tile_rows=b
        )
    return ltl_sweep.ltl_multi_step_fn(rule, steps_per_call, tile_rows=b)


def variant_defines(rule, b: int):
    """The ``-D`` flags of a point's library: the tile's (none for the
    default one), after the rule's for the packed and plane sweeps, which
    are built per rule."""
    kernel = kernel_of(rule)
    if kernel == "ltl_sweep":
        return ltl_sweep.tile_defines(b)
    return {"packed_sweep": packed_sweep, "gen_sweep": gen_sweep}[kernel].library_defines(rule, b)


def build_variants(rule, blocks: Sequence[int]) -> dict:
    """Build every tile variant's library for ``rule``, one ``nvcc`` each,
    all started together; returns ``{b: Built or the exception}`` (a failed
    build is that point's error, not the tune's)."""
    from akka_game_of_life_tpu_torch.ops import _build

    kernel = kernel_of(rule)
    blocks = sorted(set(blocks))

    def build(b):
        try:
            return _build.load(kernel, variant_defines(rule, b))
        except Exception as e:  # noqa: BLE001 — recorded per point
            return e

    with concurrent.futures.ThreadPoolExecutor(max(1, len(blocks))) as pool:
        return dict(zip(blocks, pool.map(build, blocks)))


def _seconds(fn, x: torch.Tensor, timed_calls: int) -> float:
    """Seconds of ``timed_calls`` chained calls after two chained warm
    calls: CUDA events on a card, the host clock on the CPU."""
    out = fn(fn(x))  # warm: first launches of this variant, allocator growth
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(timed_calls):
            out = fn(out)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    for _ in range(timed_calls):
        out = fn(out)
    return time.perf_counter() - t0


def sweep(
    size: int,
    *,
    steps_per_call: int = 64,
    blocks: Sequence[int] = (64, 128, 192, 256),
    sweeps: Sequence[int] = (4, 8, 16),
    timed_calls: int = 2,
    vmem_limit_mb: int = 0,
    device="cuda",
    rule="conway",
) -> List[dict]:
    """Time every feasible (block_rows, steps_per_sweep) point; return one
    record per point (``seconds`` and ``cells_per_sec``, or the ``error``
    that disqualified it), best first.  Infeasible points are skipped, as
    in the JAX package.  LtL steps one generation per launch, so its grid's
    ``sweeps`` axis collapses to k = 1.  ``vmem_limit_mb`` is the JAX
    package's Mosaic budget and must be 0."""
    from akka_game_of_life_tpu_torch.runtime.simulation import resolve_device

    if vmem_limit_mb:
        raise ValueError(
            f"vmem_limit_mb={vmem_limit_mb}: there is no Mosaic VMEM budget on "
            f"the card (the kernels keep their tiles in registers and small "
            f"shared-memory rings); leave it 0"
        )
    rule = resolve_rule(rule)
    kernel = kernel_of(rule)
    dev = resolve_device(device)
    if kernel != "ltl_sweep" and size % bitpack.LANE_BITS:
        raise ValueError(f"size={size} must be a multiple of 32 for packed boards")
    depths = [1] if kernel == "ltl_sweep" else list(sweeps)
    points = [
        (int(b), int(k)) for b in blocks for k in depths
        if feasible(size, steps_per_call, b, k, rule)
    ]
    built = (
        build_variants(rule, [b for b, _ in points]) if dev.type == "cuda" else {}
    )
    board = _board(rule, size, kernel, dev)
    results: List[dict] = []
    for b, k in points:
        point = {"block_rows": b, "steps_per_sweep": k}
        try:
            if isinstance(built.get(b), Exception):
                raise built[b]
            dt = _seconds(_step_fn(rule, kernel, steps_per_call, b, k), board, timed_calls)
            point.update(
                seconds=round(dt, 4),
                cells_per_sec=size * size * steps_per_call * timed_calls / dt,
            )
        except Exception as e:  # noqa: BLE001 — a failed point is a result
            point["error"] = f"{type(e).__name__}: {e}"
        results.append(point)
    results.sort(key=lambda p: p.get("cells_per_sec", -1.0), reverse=True)
    return results


def planned_launches(
    results: List[dict], steps_per_call: int, timed_calls: int, rule="conway"
) -> int:
    """Kernel launches a card run of ``sweep`` makes for its timed points:
    two warm and ``timed_calls`` timed calls of steps_per_call / k sweeps
    (LtL: steps_per_call launches a call)."""
    ltl = kernel_of(rule) == "ltl_sweep"
    return sum(
        (2 + timed_calls) * (steps_per_call if ltl else steps_per_call // p["steps_per_sweep"])
        for p in results
        if "cells_per_sec" in p
    )


def best_point(results: List[dict]) -> Optional[dict]:
    """The winning point, shared by :func:`best_flags` and the CLI's summary
    line so the two never describe different points."""
    for p in results:
        if "cells_per_sec" in p:
            return p
    return None


def best_flags(results: List[dict], rule="conway") -> Optional[str]:
    """The winning point as flags of the port's CLI that drive the tuned
    kernel: ``run --kernel pallas --pallas-block-rows B``, and for binary
    rules the tune of that one point (the packed sweep's benchmark).  The
    run plans its own sweeps (``DEFAULT_STEPS_PER_SWEEP`` deep), so a deeper
    winning k is marked tune-only."""
    rule = resolve_rule(rule)
    p = best_point(results)
    if p is None:
        return None
    b, k = p["block_rows"], p["steps_per_sweep"]
    run = f"run --kernel pallas --pallas-block-rows {b}"
    flags = f"tune --blocks {b} --sweeps {k}; {run}" if kernel_of(rule) == "packed_sweep" else run
    cap = packed_sweep.DEFAULT_STEPS_PER_SWEEP
    if k > cap:
        flags += f" (run auto-caps steps_per_sweep at {cap}, so k={k} is tune-only)"
    return flags
