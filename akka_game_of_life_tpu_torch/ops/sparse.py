"""Activity-gated sparse stepping: O(activity) work on dilute boards.

Counterpart of ``akka_game_of_life_tpu/ops/sparse.py``.  The unit of gating
is a coarse block (``block`` cells square, one bit per block).  What makes
skipping exact: a cell whose whole radius-``k`` neighbourhood is the same at
two consecutive chunk boundaries computes the same next state, so with
``k <= block`` (radius-1 rules) ``active(t+1) ⊆ dilate3x3(active(t))``.

Per chunk the stepper (1) dilates last chunk's changed-block bitmap by one
block ring (toroidal 3×3 OR), (2) gathers the active blocks with a
``k``-cell halo into an ``(n, B+2k, B+2k)`` batch on the host, (3) copies
the batch to the device and advances it ``k`` toroidal steps there as one
batched tensor (the cut edges' garbage front moves one cell a step, so the
B×B interiors are exact), and brings back the interiors with one changed
flag per block, (4) scatters the changed interiors into the host board.
Batch sizes are rounded up to powers of two, as in the JAX package.

Dense escape: once the dilated active fraction passes ``threshold`` the
whole board steps on the device and the changed-block bitmap is built in
the same pass (every other chunk of a dense streak skips the bitmap and
assumes everything active).  The first chunk after construction, and after
any board the stepper did not produce itself (a checkpoint restore, a crash
replay), runs dense with every block active.

The board stays a host numpy array, as in the JAX package; on a CUDA device
the slabs and the dense escape step on the card, on the CPU device on the
CPU.  Nothing steps on the host behind the caller's back.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit, stencil_cost
from akka_game_of_life_tpu_torch.ops import stencil
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule


def pick_block(height: int, width: int, requested: int) -> int:
    """The effective gating block: the largest common divisor of the board
    sides that is <= ``requested`` (so blocks tile the torus exactly); 1
    for coprime sides."""
    g = math.gcd(height, width)
    best = 1
    for d in range(1, int(math.isqrt(g)) + 1):
        if g % d == 0:
            for c in (d, g // d):
                if c <= requested and c > best:
                    best = c
    return best


def dilate3x3(active: np.ndarray) -> np.ndarray:
    """Toroidal 3×3 OR-dilation of a bool block bitmap."""
    out = active.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) != (0, 0):
                out |= np.roll(active, (dy, dx), axis=(0, 1))
    return out


def changed_blocks(prev: np.ndarray, new: np.ndarray, block: int) -> np.ndarray:
    """Bool (H//block, W//block) bitmap of blocks whose cells differ."""
    h, w = prev.shape
    nbh, nbw = h // block, w // block
    diff = prev != new
    return diff.reshape(nbh, block, nbw, block).any(axis=(1, 3))


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1): the batch quantizer."""
    return 1 << max(0, int(n - 1).bit_length())


class SparseStepper:
    """Stateful activity-gated chunk engine for one host board.

    ``step(board, k)`` advances a host uint8 board ``k`` generations.  The
    changed-block bitmap of the last chunk is keyed to the array object the
    stepper produced: a board it has never seen resets the gate to
    all-active, which keeps checkpoint restore and crash replay exact.

    **Ownership**: a board the stepper produced is updated IN PLACE on the
    sparse path (every active slab is gathered, as a copy, before any block
    is written back); a foreign board is never mutated.  Callers that keep
    a reference across chunks (checkpoint writers, observation) must copy.
    """

    def __init__(
        self,
        rule,
        shape,
        *,
        block: int = 128,
        threshold: float = 0.5,
        device="cuda",
    ) -> None:
        self.rule = resolve_rule(rule)
        if self.rule.radius != 1:
            raise ValueError(
                f"sparse stepping gates radius-1 rules; {self.rule} "
                f"(radius {self.rule.radius}) runs on the dense kernels"
            )
        self.shape = tuple(shape)
        self.block = pick_block(self.shape[0], self.shape[1], block)
        self.threshold = threshold
        self.device = torch.device(device)
        self.grid = (self.shape[0] // self.block, self.shape[1] // self.block)
        self._changed: Optional[np.ndarray] = None
        self._last_out: Optional[np.ndarray] = None
        # The device programs, cached per (path, steps): each registers on
        # the program ledger once.
        self._fns: dict = {}
        # Consecutive dense chunks: even ones skip the bitmap (assume all
        # active, an over-approximation, so still exact).
        self._dense_streak = 0
        # Gating observability, read by the embedder after each chunk.
        self.last_active_blocks = 0
        self.last_stepped_blocks = 0
        self.dense_chunks = 0
        self.sparse_chunks = 0

    @property
    def total_blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    # -- the device programs (cached per steps, on the program ledger) ----------

    def _block_fn(self, steps: int):
        """(n, B+2k, B+2k) host slabs → (n, B, B) interiors after ``steps``
        toroidal steps on the device, and one changed flag per slab."""
        key = ("block", steps)
        if key not in self._fns:
            rule, b, dev = self.rule, self.block, self.device

            def chunk(slabs: np.ndarray):
                x = torch.from_numpy(slabs).to(dev)
                if rule.kind == "ltl":  # the LtL step takes one board at a time
                    out = torch.stack([stencil.multi_step(s, rule, steps) for s in x])
                else:
                    out = stencil.multi_step(x, rule, steps)
                interior = out[:, steps : steps + b, steps : steps + b]
                before = x[:, steps : steps + b, steps : steps + b]
                flags = (interior != before).flatten(1).any(dim=1)
                return interior.cpu().numpy(), flags.cpu().numpy()

            self._fns[key] = registered_jit(
                "sparse", ("block", rule.name, steps, b), chunk,
                # slabs: (n, B+2k, B+2k); the gated win is that n is the
                # ACTIVE block count, not the board's.
                cost=lambda slabs: {
                    "cells": float(slabs.shape[0]) * b * b * steps,
                    "bytes": 2.0 * slabs.size * slabs.dtype.itemsize,
                    "flops": 18.0 * slabs.shape[0] * b * b * steps,
                },
            )
        return self._fns[key]

    def _dense_fn(self, steps: int):
        """The whole host board ``steps`` generations on the device, with
        the changed-block bitmap from the same pass."""
        key = ("dense", steps)
        if key not in self._fns:
            rule, b, dev = self.rule, self.block, self.device
            nbh, nbw = self.grid

            def run(board: np.ndarray):
                x = torch.from_numpy(board).to(dev)
                out = stencil.multi_step(x, rule, steps)
                diff = (out != x).reshape(nbh, b, nbw, b)
                return out.cpu().numpy(), diff.any(dim=3).any(dim=1).cpu().numpy()

            self._fns[key] = registered_jit(
                "sparse", ("dense", rule.name, steps, self.shape), run,
                cost=lambda board: stencil_cost(board.shape[-2], board.shape[-1], steps),
            )
        return self._fns[key]

    def _dense_plain_fn(self, steps: int):
        """The dense stepper without the bitmap (family ``stencil``)."""
        key = ("plain", steps)
        if key not in self._fns:
            self._fns[key] = stencil.multi_step_fn(self.rule, steps)
        return self._fns[key]

    # -- the chunk ------------------------------------------------------------

    def step(self, board: np.ndarray, steps: int) -> np.ndarray:
        if steps < 1:
            return board
        if steps > self.block:
            raise ValueError(
                f"chunk of {steps} steps exceeds the {self.block}-cell "
                f"gating block: the one-ring dilation would miss influence "
                f"(use steps_per_call <= sparse_block)"
            )
        board = np.asarray(board, dtype=np.uint8)
        if board.shape != self.shape:
            raise ValueError(f"board {board.shape} != stepper {self.shape}")
        owned = self._last_out is not None and board is self._last_out
        if not owned:
            # Unknown provenance (first chunk, restore, replay): everything
            # is presumed active, and the board is not ours to mutate.
            self._dense_streak = 0
            active = np.ones(self.grid, dtype=bool)
        elif self._changed is None:
            # The previous dense chunk skipped its bitmap.
            active = np.ones(self.grid, dtype=bool)
        else:
            active = dilate3x3(self._changed)
        n_active = int(active.sum())
        self.last_active_blocks = n_active
        if n_active > self.threshold * self.total_blocks:
            self._dense_streak += 1
            out = self._dense_step(
                board, steps, with_bitmap=self._dense_streak % 2 == 1
            )
        else:
            self._dense_streak = 0
            out = self._sparse_step(
                board, steps, active,
                inplace=owned and bool(board.flags.writeable),
            )
        self._last_out = out
        return out

    def _dense_step(
        self, board: np.ndarray, steps: int, with_bitmap: bool = True
    ) -> np.ndarray:
        if with_bitmap:
            out, self._changed = self._dense_fn(steps)(board)
        else:
            x = torch.from_numpy(board).to(self.device)
            out = self._dense_plain_fn(steps)(x).cpu().numpy()
            self._changed = None
        self.last_stepped_blocks = self.total_blocks
        self.dense_chunks += 1
        return out

    def _sparse_step(
        self, board: np.ndarray, steps: int, active: np.ndarray,
        inplace: bool = False,
    ) -> np.ndarray:
        b, k = self.block, steps
        h, w = self.shape
        idx = np.argwhere(active)
        self.last_stepped_blocks = len(idx)
        self.sparse_chunks += 1
        if len(idx) == 0:
            # A fixed point: nothing changed last chunk anywhere.
            self._changed = active
            return board
        # Each active block with its k-cell toroidal halo, by two mod-indexed
        # takes (O(active area)); every slab is a copy made before any write
        # below.
        rows = (idx[:, 0, None] * b + np.arange(-k, b + k)[None, :]) % h
        cols = (idx[:, 1, None] * b + np.arange(-k, b + k)[None, :]) % w
        slabs = board[rows[:, :, None], cols[:, None, :]]
        # A power-of-two batch: the padding repeats block 0 and is dropped.
        n = len(idx)
        pad = next_pow2(n) - n
        if pad:
            slabs = np.concatenate([slabs, slabs[:1].repeat(pad, axis=0)])
        outs, flags = self._block_fn(k)(slabs)
        out = board if inplace else board.copy()
        changed = np.zeros(self.grid, dtype=bool)
        for i, (by, bx) in enumerate(idx):
            if not flags[i]:
                continue  # this block did not change
            y0, x0 = by * b, bx * b
            out[y0 : y0 + b, x0 : x0 + b] = outs[i]
            changed[by, bx] = True
        self._changed = changed
        return out
