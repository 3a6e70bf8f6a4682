"""Larger-than-Life: radius-R window sums in plain PyTorch.

Counterpart of ``akka_game_of_life_tpu/ops/ltl.py``.  A Larger-than-Life rule
counts the live cells (state 1) of a radius-R window around each cell — the
(2R+1)² Moore box or the von Neumann diamond — and applies birth/survive
sets over 0..max_neighbors:

- **box**: two separable shift-add passes, a (2R+1)-term column sum of row
  slices, then a (2R+1)-term row sum of column slices;
- **diamond**: each of its 2R+1 rows is a contiguous run, so one float32
  row-cumsum turns every row's contribution into a two-slice difference
  (exact: partial sums stay far below 2²⁴).

Counts are exact in the count dtype (bf16 holds integers to 256, float32
beyond, chosen as the JAX package chooses), so results equal the JAX
package's bit for bit.  The intermediates are priced through ``ops/guard``
before anything is allocated.  The torus wraps by a periodic index pad, so
a radius wider than the board sees the board's periodic extension.

This module is the plain version the CUDA LtL step (``ops/ltl_sweep.py``) is
held against, and the dense stepper for LtL under ``kernel=dense`` (and for
the diamond, which has no kernel).  ``engine="matmul"`` counts with the
banded matrix products of ``ops/matmul_stencil.py`` and applies this
module's tables, so both engines give the same board bit for bit.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit, stencil_cost
from akka_game_of_life_tpu_torch.ops import guard
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

STATE_DTYPE = torch.uint8


def _count_dtype(rule: Rule) -> torch.dtype:
    # bf16 holds integers exactly to 256: enough for R<=7 ((2R+1)^2 <= 225).
    return torch.bfloat16 if rule.max_neighbors < 255 else torch.float32


def neighborhood_mask(radius: int, neighborhood: str) -> np.ndarray:
    """(2R+1, 2R+1) 0/1 window mask INCLUDING the centre: the full box, or
    the von Neumann diamond (L1 ball)."""
    d = 2 * radius + 1
    if neighborhood == "diamond":
        yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
        return (np.abs(yy) + np.abs(xx) <= radius).astype(np.uint8)
    return np.ones((d, d), np.uint8)


def wrap_pad(board: torch.Tensor, r: int) -> torch.Tensor:
    """(H, W) → (H+2r, W+2r), rows and columns continued periodically (any
    r, also wider than the board)."""
    h, w = board.shape
    dev = board.device
    rows = torch.arange(-r, h + r, device=dev) % h
    cols = torch.arange(-r, w + r, device=dev) % w
    return board[rows][:, cols]


def _window_counts(
    alive_2d: torch.Tensor, radius: int, neighborhood: str, dtype: torch.dtype
) -> torch.Tensor:
    """(H+2R, W+2R) 0/1 halo-padded alive plane → (H, W) window sums
    INCLUDING the centre."""
    r = radius
    d = 2 * r + 1
    ph, pw = alive_2d.shape
    h, w = ph - 2 * r, pw - 2 * r
    if neighborhood == "box":
        x = alive_2d.to(dtype)
        col = x[0:h, :]
        for dy in range(1, d):
            col = col + x[dy : dy + h, :]  # (H, W+2R)
        out = col[:, 0:w]
        for dx in range(1, d):
            out = out + col[:, dx : dx + w]
        return out
    # Diamond (von Neumann L1 ball), via an exclusive row-cumsum.
    c = torch.cumsum(alive_2d.to(torch.float32), dim=1)
    c = torch.nn.functional.pad(c, (1, 0))  # c[i, j] = sum of alive[i, :j]
    out = torch.zeros((h, w), dtype=torch.float32, device=alive_2d.device)
    for dy in range(-r, r + 1):
        width = 2 * (r - abs(dy)) + 1
        lo = abs(dy)  # the run starts at padded column x + |dy|
        rows = slice(r + dy, r + dy + h)
        out = out + (c[rows, lo + width : lo + width + w] - c[rows, lo : lo + w])
    return out.to(dtype)


def _tables(rule: Rule, device=None):
    n = rule.max_neighbors + 1
    birth = torch.zeros(n, dtype=STATE_DTYPE, device=device)
    survive = torch.zeros(n, dtype=STATE_DTYPE, device=device)
    birth[torch.tensor(sorted(rule.birth), dtype=torch.long)] = 1
    survive[torch.tensor(sorted(rule.survive), dtype=torch.long)] = 1
    return birth, survive


def _apply(state: torch.Tensor, neighbor_counts: torch.Tensor, rule: Rule) -> torch.Tensor:
    birth_t, survive_t = _tables(rule, state.device)
    c = neighbor_counts.to(torch.int64)
    return torch.where(state == 1, survive_t[c], birth_t[c])


def _require_window_fits(padded_shape, rule: Rule) -> None:
    """Price the shift-add intermediates (the padded count-dtype plane plus
    the separable column-sum plane) before anything is allocated."""
    ph, pw = int(padded_shape[-2]), int(padded_shape[-1])
    item = _count_dtype(rule).itemsize
    planes = [((ph, pw), item), ((ph - 2 * rule.radius, pw), item)]
    guard.require_intermediates_fit(
        sum(guard.plane_bytes(s, i) for s, i in planes),
        what=(
            f"ltl shift-add window sums ({rule}, padded {ph}x{pw}, "
            f"radius {rule.radius})"
        ),
        detail="Use a smaller board, or kernel=auto for the CUDA LtL step.",
        shapes=planes,
    )


def step_padded_ltl(padded: torch.Tensor, rule) -> torch.Tensor:
    """One LtL step on an R-halo-padded tile: (H+2R, W+2R) → (H, W)."""
    rule = resolve_rule(rule)
    r = rule.radius
    _require_window_fits(padded.shape, rule)
    alive = (padded == 1).to(STATE_DTYPE)
    counts = _window_counts(alive, r, rule.neighborhood, _count_dtype(rule))
    interior = padded[r:-r, r:-r]
    # The window sum includes the centre; the neighbour count excludes it.
    neighbors = counts - alive[r:-r, r:-r].to(counts.dtype)
    return _apply(interior, neighbors, rule)


def step_ltl(state: torch.Tensor, rule, engine: str = "shift-add") -> torch.Tensor:
    """One toroidal LtL step on an (H, W) uint8 board.  ``engine`` is
    ``"shift-add"`` (the separable passes above) or ``"matmul"`` (the
    banded products, what ``kernel=matmul`` runs)."""
    rule = resolve_rule(rule)
    if engine == "matmul":
        from akka_game_of_life_tpu_torch.ops import matmul_stencil

        return matmul_stencil.step_matmul(state, rule)
    if engine != "shift-add":
        raise ValueError(f"unknown ltl count engine {engine!r}")
    return step_padded_ltl(wrap_pad(state, rule.radius), rule)


def ltl_multi_step_fn(
    rule, n_steps: int, engine: str = "shift-add"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``n_steps`` generations of :func:`step_ltl` on ``engine``, registered
    on the program ledger (family ``ltl``)."""
    rule = resolve_rule(rule)

    def run(state: torch.Tensor) -> torch.Tensor:
        for _ in range(n_steps):
            state = step_ltl(state, rule, engine)
        return state

    return registered_jit(
        "ltl", ("multi_step", rule.name, engine, n_steps), run,
        # Shift-add visits the (2R+1)-wide window per cell: 2(2R+1) adds
        # via the separable row/col pass.
        cost=lambda state: stencil_cost(
            state.shape[-2], state.shape[-1], n_steps,
            flops_per_cell=4.0 * rule.radius + 4.0,
        ),
    )


# -- host (np) twins -----------------------------------------------------------


def step_padded_ltl_np(padded: np.ndarray, rule) -> np.ndarray:
    """Host twin of :func:`step_padded_ltl` via an integral image (the
    numpy oracle, a copy of the JAX package's)."""
    rule = resolve_rule(rule)
    r = rule.radius
    alive = (padded == 1).astype(np.int32)
    h, w = padded.shape[0] - 2 * r, padded.shape[1] - 2 * r
    d = 2 * r + 1
    if rule.neighborhood == "box":
        ii = np.zeros((padded.shape[0] + 1, padded.shape[1] + 1), np.int32)
        ii[1:, 1:] = alive.cumsum(0).cumsum(1)
        window = (
            ii[d : d + h, d : d + w]
            - ii[0:h, d : d + w]
            - ii[d : d + h, 0:w]
            + ii[0:h, 0:w]
        )
    else:
        mask = neighborhood_mask(r, rule.neighborhood)
        window = np.zeros((h, w), np.int32)
        for dy in range(d):
            for dx in range(d):
                if mask[dy, dx]:
                    window += alive[dy : dy + h, dx : dx + w]
    interior = padded[r : r + h, r : r + w]
    neighbors = window - alive[r : r + h, r : r + w]
    birth = np.zeros(rule.max_neighbors + 1, np.uint8)
    survive = np.zeros(rule.max_neighbors + 1, np.uint8)
    for b in rule.birth:
        birth[b] = 1
    for s in rule.survive:
        survive[s] = 1
    return np.where(interior == 1, survive[neighbors], birth[neighbors]).astype(
        np.uint8
    )


def step_ltl_np(board: np.ndarray, rule) -> np.ndarray:
    rule = resolve_rule(rule)
    return step_padded_ltl_np(np.pad(board, rule.radius, mode="wrap"), rule)
