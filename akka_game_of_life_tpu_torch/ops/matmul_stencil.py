"""Neighbour counts as banded matrix products: ``kernel=matmul``.

Counterpart of ``akka_game_of_life_tpu/ops/matmul_stencil.py``.  The Moore
window sum of a torus factors into two banded products

    W = A_R · S · A_Rᵀ

where ``A_R`` is the ±R band circulant.  The band is evaluated block by
block, never as a dense (n, n) operand: each row or column tile multiplies
a (K, K + 2R) slab of ``A_R`` against a slice of the board, with the torus
wrap folded into the edge tiles' operands.  The same band gives radius-R
Larger-than-Life.  Every plan is priced through :mod:`ops/guard` before
anything is allocated, with the JAX package's refusals word for word.

The products are PyTorch's own GEMMs (``torch.mm``, ``torch._int_mm``): the
JAX package leaves them to XLA outside any Pallas kernel.  Three lanes, each
giving exact integer counts:

- ``f32``: digit packing.  ``digits`` torus column groups ride one float32
  word as base-``base`` digits (a power of two above (2R+1)², so window sums
  never carry between digits and stay below 2²⁴); the torus seam rotates the
  digits in the pad columns.  **TF32 would break it**: TF32 keeps 10
  mantissa bits, so a caller's ``allow_tf32`` or
  ``set_float32_matmul_precision("high")`` would round the packed words.
  The lane runs its products at full float32 whatever the caller set
  (:func:`_full_fp32`).
- ``int8``: int8 operands, int32 counts (``torch._int_mm``).  cuBLASLt on
  the card wants more than 16 rows in A, k and n multiples of 8, and B
  column-major: with B row-major it refuses some shapes on the H100
  (``CUBLAS_STATUS_NOT_SUPPORTED`` at (40, 56) @ (56, 64), PERF.md) while
  taking others.  Every operand here is built to those
  shapes with zero rows and columns (exact), on both devices, so the CPU
  tests run the card's shapes.
- ``bf16``: bf16 operands, float32 counts.  ``torch.mm`` of two bf16
  tensors rounds its result to bf16, which holds integers only to 256,
  while the column pass's sums reach (2R+1)² − 1 = 440 at R = 10.  On the
  card the product asks for a float32 result (``out_dtype``); on the CPU,
  where that overload does not exist, the operands are cast up to float32,
  which is exact (every operand is at most 21).

``auto`` is ``f32`` on the CPU, as in the JAX package off the TPU, and
:data:`AUTO_CUDA_MODE` on a CUDA device: the lane measured fastest on the
H100 at 16384² (PERF.md).  Counts are exact on every lane, so applying the
rule tables (``stencil.apply_rule``, ``ltl._apply``) gives the dense
stencil's board bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit
from akka_game_of_life_tpu_torch.ops import guard
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
from akka_game_of_life_tpu_torch.ops.stencil import alive_mask, apply_rule

# Counts and digit-packed words must stay exact integers in f32.
_MAX_EXACT_F32 = 1 << 24
# Digit-packing depth cap: beyond 6 the per-digit bases stop fitting the
# f32 mantissa for any radius.
_MAX_DIGITS = 6
# Row/column tile bound (the JAX package's).
_MAX_TILE = 512
# cuBLASLt's int8 GEMM shapes: A needs more than 16 rows, k and n
# multiples of 8.
_MIN_ROWS = 17
_ALIGN = 8

MODES = ("auto", "f32", "int8", "bf16")
# The lane ``auto`` takes on a CUDA device: the fastest of the three on the
# H100 at Conway and bugs 16384² and a radius-10 box at 12288² (PERF.md,
# "the steppers on the card"; ``chip_smoke.py`` prints them).
AUTO_CUDA_MODE = "bf16"

_OPERAND = {"f32": torch.float32, "int8": torch.int8, "bf16": torch.bfloat16}


def band_matrix(n: int, radius: int, wrap: bool = True) -> np.ndarray:
    """The (n, n) ±radius band matrix ``A_R`` (f32 ones), circulant when
    ``wrap``: the object the blocked products evaluate."""
    a = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for k in range(-radius, radius + 1):
        if wrap:
            a[idx, (idx + k) % n] = 1.0
        else:
            j = idx + k
            ok = (j >= 0) & (j < n)
            a[idx[ok], j[ok]] = 1.0
    return a


def _band_slab(tile: int, radius: int) -> np.ndarray:
    """(tile, tile + 2·radius) slab of ``A_R``: row t has ones on columns
    t..t+2R (the operand every row or column tile shares)."""
    slab = np.zeros((tile, tile + 2 * radius), np.float32)
    for t in range(tile):
        slab[t, t : t + 2 * radius + 1] = 1.0
    return slab


def _pick_tile(n: int) -> int:
    """Largest divisor of ``n`` at most ``_MAX_TILE`` (n itself when small
    or awkwardly prime: the guard prices the resulting full-band slab)."""
    if n <= _MAX_TILE:
        return n
    best = 1
    for k in range(1, int(math.isqrt(n)) + 1):
        if n % k == 0:
            for d in (k, n // k):
                if best < d <= _MAX_TILE:
                    best = d
    return best if best >= 8 else n


def _pick_digits(width: int, radius: int) -> Tuple[int, int]:
    """(digits, base) for f32 packing: the deepest d dividing ``width``
    whose packed window sums stay under 2²⁴ (base = the next power of two
    above the largest window sum, so digit extraction is exact)."""
    wmax = (2 * radius + 1) ** 2
    base = 1 << max(1, (wmax + 1).bit_length())
    for d in range(_MAX_DIGITS, 0, -1):
        if width % d:
            continue
        if width // d < max(radius, 1):
            continue  # seam slivers need R columns per digit group
        if wmax * (base**d - 1) // (base - 1) < _MAX_EXACT_F32:
            return d, base
    return 1, base


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """A validated banded-matmul plan for one (shape, R, lane): the JAX
    package's fields.  Building it runs the guard, so an infeasible plan
    raises with the shapes and the cap's knob before any allocation."""

    height: int
    width: int
    radius: int
    mode: str  # resolved: f32 | int8 | bf16
    digits: int
    base: int
    row_tile: int
    col_tile: int
    est_bytes: int

    @property
    def packed_width(self) -> int:
        return self.width // self.digits


def _resolve_mode(mode: str, device) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown matmul dtype mode {mode!r}; use {MODES}")
    if mode == "auto":
        return AUTO_CUDA_MODE if torch.device(device).type == "cuda" else "f32"
    return mode


@functools.lru_cache(maxsize=None)
def plan_matmul(
    shape: Tuple[int, int],
    radius: int,
    mode: str = "auto",
    neighborhood: str = "box",
    device="cuda",
) -> MatmulPlan:
    """Validate and price a banded-matmul plan; raises ``ValueError`` with
    the JAX package's message for every infeasible request.  ``device``
    only resolves ``auto`` (the CUDA lane, or ``f32`` on the CPU)."""
    h, w = int(shape[-2]), int(shape[-1])
    if neighborhood != "box":
        raise ValueError(
            "kernel=matmul supports box (Moore) neighborhoods only: the "
            "von Neumann diamond is not separable into A_R·S·A_Rᵀ — use "
            "the cumsum-difference path on kernel=dense"
        )
    if min(h, w) < 2 * radius + 1:
        raise ValueError(
            f"kernel=matmul needs min(height, width) >= 2R+1 "
            f"({2 * radius + 1} for radius {radius}), got {h}x{w}: the "
            f"torus window must not wrap onto itself"
        )
    mode = _resolve_mode(mode, device)
    digits, base = _pick_digits(w, radius) if mode == "f32" else (1, 0)
    wd = w // digits
    kr, kc = _pick_tile(h), _pick_tile(wd)
    item = {"f32": 4, "int8": 1, "bf16": 2}[mode]
    acc_item = 4  # int32 / f32 accumulator planes
    planes = [
        ((h, wd + 2 * radius), item),  # packed, column-padded operand
        ((h, wd + 2 * radius), item),  # pass-1 row sums (operand dtype)
        ((h, wd), acc_item),  # pass-2 window sums (accumulator dtype)
        ((h, w), 4),  # unpacked int32 counts feeding the rule epilogue
        ((kr, kr + 2 * radius), item),  # row band slab
        ((kc, kc + 2 * radius), item),  # column band slab
    ]
    est = sum(guard.plane_bytes(s, i) for s, i in planes)
    detail = (
        "Shrink the board/radius, or use kernel=dense (the shift-add "
        "path keeps intermediates board-sized)."
    )
    if mode == "f32" and digits <= 2:
        # Digit depth must divide the width, so power-of-two widths cap
        # packing at d=2 where a 3-divisible width packs deeper.
        w3 = guard.nearest_3smooth(w)
        d3, _ = _pick_digits(w3, radius)
        if d3 > digits:
            detail += (
                f" Or pad the width to the nearest 3-smooth size "
                f"({w} → {w3}): depth-{digits} digit packing is the "
                f"power-of-two-width cap here, while width {w3} packs "
                f"d={d3} digits and divides the packed planes (and the "
                f"GEMM width) by {d3}/{digits}."
            )
    guard.require_intermediates_fit(
        est,
        what=f"kernel=matmul ({mode}, {h}x{w}, radius {radius})",
        detail=detail,
        shapes=planes,
    )
    return MatmulPlan(h, w, radius, mode, digits, base, kr, kc, est)


# -- the blocked banded products -------------------------------------------------


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


@contextlib.contextmanager
def _full_fp32():
    """Float32 products at full float32 for the section, whatever the
    caller set (TF32 or bf16 splitting would round the digit-packed words);
    the caller's settings are restored after.  torch >= 2.9 keeps a new
    per-backend flag beside the legacy one: the legacy setter sets both,
    and whichever the caller used is put back."""
    matmul = torch.backends.cuda.matmul
    new = getattr(matmul, "fp32_precision", None)
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller mixed the two APIs: restore the new one
        legacy = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        if new is not None:
            matmul.fp32_precision = new


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """One slab product with exact accumulation: int8 → int32, bf16 and
    f32 → f32.  Shapes are already cuBLASLt's (A rows > 16, k and n
    multiples of 8); int8 takes A row-major and B column-major."""
    if mode == "int8":
        return torch._int_mm(a.contiguous(), b.t().contiguous().t())
    if mode == "bf16":
        if a.device.type == "cuda":
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b)


@functools.lru_cache(maxsize=64)
def _slab(pattern: Tuple[int, ...], tile: int, span: int, depth: int, width: int,
          transpose: bool, dtype: torch.dtype, device: str) -> torch.Tensor:
    """A GEMM slab on ``device``: row t has ones at columns t + span + o for
    each offset o of ``pattern`` (the ±R band: offsets -R..R), zero-padded
    to (max(tile, 17), depth) and transposed to (depth, width) for the
    column pass."""
    slab = np.zeros((max(tile, _MIN_ROWS), depth), np.float32)
    rows = np.arange(tile)
    for off in pattern:
        slab[rows, rows + span + off] = 1.0
    if transpose:
        out = np.zeros((depth, width), np.float32)
        out[:, :tile] = slab[:tile].T
        slab = out
    return torch.from_numpy(slab).to(dtype=dtype, device=device)


def _row_pass(x: torch.Tensor, slab: torch.Tensor, tile: int, span: int,
              out: torch.Tensor, mode: str) -> None:
    """``out[:h] = A · x`` over the torus rows: tile c multiplies the slab
    by rows c·tile − span .. of ``x`` (mod h; interior tiles read a
    contiguous slice, edge tiles gather their wrap).  Rows past the slab's
    band meet zero columns."""
    h = x.shape[0]
    depth = slab.shape[1]
    for c in range(h // tile):
        start = c * tile - span
        if start >= 0 and start + depth <= h:
            op = x[start : start + depth]
        else:
            op = x[(torch.arange(depth, device=x.device) + start) % h]
        out[c * tile : (c + 1) * tile] = _mm(slab, op, mode)[:tile]


def _col_pass(y: torch.Tensor, slab_t: torch.Tensor, tile: int, h: int, n: int,
              out: torch.Tensor, mode: str) -> None:
    """``out = y · Aᵀ`` over ``n`` columns: tile c multiplies the columns
    c·tile .. of the column-padded ``y`` (the torus pads ride in it) by
    the transposed slab."""
    depth = slab_t.shape[0]
    for c in range(n // tile):
        op = y[:, c * tile : c * tile + depth]
        out[:, c * tile : (c + 1) * tile] = _mm(op, slab_t, mode)[:h, :tile]


def _padded_width(n: int, tile: int, span: int) -> int:
    """Columns of a column-padded operand: the n columns, their 2·span torus
    pads and room for the last tile's depth, rounded up to 8."""
    return _up(max(n + 2 * span, n - tile + _up(tile + 2 * span)))


def _with_pads(left: torch.Tensor, mid: torch.Tensor, right: torch.Tensor,
               width: int, dtype: torch.dtype) -> torch.Tensor:
    """[left | mid | right] in a zeroed (max(h, 17), width) operand."""
    h, n = mid.shape
    s = left.shape[1]
    x = torch.zeros((max(h, _MIN_ROWS), width), dtype=dtype, device=mid.device)
    x[:h, :s] = left
    x[:h, s : s + n] = mid
    x[:h, s + n : n + 2 * s] = right
    return x


def _packed_window_sums(alive: torch.Tensor, plan: MatmulPlan) -> torch.Tensor:
    """(H, W) 0/1 alive plane → (H, W/digits) window sums in the packed
    (digit-carrying) accumulator layout: the two blocked products without
    the unpack, so the epilogue extracts digits itself."""
    h, r = plan.height, plan.radius
    d, wd = plan.digits, plan.packed_width
    od = _OPERAND[plan.mode]
    acc = torch.int32 if plan.mode == "int8" else torch.float32
    dev = alive.device

    # 1. Pack: d torus column groups per word as base-b digits (d == 1 is
    # the identity cast).
    if d > 1:
        pows = [float(plan.base) ** i for i in range(d)]
        packed = alive[:, :wd].to(od) * pows[0]
        for i in range(1, d):
            packed = packed + alive[:, i * wd : (i + 1) * wd].to(od) * pows[i]
        p_hi, base = pows[-1], float(plan.base)
        # Torus seam: column -k carries x[:, m·wd - k] in digit m, i.e. the
        # neighbour word's digits rotated up (and down on the right).
        # Exact: integers < 2²⁴ and a power-of-two base.
        left = packed[:, wd - r :]
        right = packed[:, :r]
        left = torch.floor(left / p_hi) + torch.remainder(left, p_hi) * base
        right = torch.floor(right / base) + torch.remainder(right, base) * p_hi
    else:
        packed = alive.to(od)
        left = packed[:, wd - r :]
        right = packed[:, :r]
    kr, kc = plan.row_tile, plan.col_tile
    width = _padded_width(wd, kc, r)
    x_cp = _with_pads(left, packed, right, width, od)

    band = tuple(range(-r, r + 1))
    dname = str(dev)
    with _full_fp32():
        # 2. Row pass: y = A_R · x, tiled over rows; row sums ≤ (2R+1) per
        # digit, exact back in the operand dtype.
        y = torch.zeros_like(x_cp)
        slab_r = _slab(band, kr, r, _up(kr + 2 * r), 0, False, od, dname)
        _row_pass(x_cp[:h], slab_r, kr, r, y, plan.mode)
        # 3. Column pass: W = y · A_Rᵀ over packed columns; the column pads
        # (with their seam rotation) rode through the row pass.
        out = torch.empty((h, wd), dtype=acc, device=dev)
        depth = _up(kc + 2 * r)
        slab_c = _slab(band, kc, r, depth, _up(kc), True, od, dname)
        _col_pass(y, slab_c, kc, h, wd, out, plan.mode)
    return out


def _extract_digit(packed_sums: torch.Tensor, plan: MatmulPlan, i: int) -> torch.Tensor:
    """Digit ``i`` of the packed window sums as int32 (exact: integers
    below 2²⁴ over a power-of-two base)."""
    if plan.digits == 1:
        return packed_sums.to(torch.int32)
    base = float(plan.base)
    return torch.remainder(torch.floor(packed_sums / base**i), base).to(torch.int32)


def window_counts_matmul(alive: torch.Tensor, plan: MatmulPlan) -> torch.Tensor:
    """(H, W) 0/1 alive plane → (H, W) int32 window sums INCLUDING the
    centre, on a torus."""
    out_p = _packed_window_sums(alive, plan)
    return torch.cat([_extract_digit(out_p, plan, i) for i in range(plan.digits)], dim=1)


def neighbor_counts_matmul(
    alive: torch.Tensor, radius: int = 1, mode: str = "auto"
) -> torch.Tensor:
    """Torus neighbour counts EXCLUDING the centre: the banded-matmul twin
    of ``stencil.neighbor_counts`` (R=1) and the LtL window sums (R>1)."""
    plan = plan_matmul(tuple(alive.shape), radius, mode, device=alive.device.type)
    return window_counts_matmul(alive, plan) - alive.to(torch.int32)


def step_matmul(state: torch.Tensor, rule, mode: str = "auto") -> torch.Tensor:
    """One toroidal step with banded-matmul counts, for every rule whose
    window is the Moore box (binary, Generations, WireWorld, box LtL; the
    diamond refuses in ``plan_matmul``).  The rule applies per digit group
    straight off the packed sums, so no full-board count plane is built."""
    rule = resolve_rule(rule)
    plan = plan_matmul(
        tuple(state.shape), rule.radius, mode, rule.neighborhood, state.device.type
    )
    alive = alive_mask(state)
    out_p = _packed_window_sums(alive, plan)
    wd = plan.packed_width

    def _epilogue(state_slab, neighbors):
        if rule.kind == "ltl":
            from akka_game_of_life_tpu_torch.ops import ltl

            return ltl._apply(state_slab, neighbors, rule)
        return apply_rule(state_slab, neighbors, rule)

    parts = []
    for i in range(plan.digits):
        sl = slice(i * wd, (i + 1) * wd)
        window = _extract_digit(out_p, plan, i)
        parts.append(_epilogue(state[:, sl], window - alive[:, sl].to(torch.int32)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def matmul_multi_step_fn(
    rule, n_steps: int, mode: str = "auto", device="cuda"
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ``kernel=matmul`` stepper: ``n_steps`` banded-matmul generations
    per call, in the lane ``mode`` resolves to on ``device``; registered on
    the program ledger (family ``matmul``, keyed by the ``mode`` asked
    for, as the JAX package keys it)."""
    rule = resolve_rule(rule)
    lane = _resolve_mode(mode, device)

    def run(state: torch.Tensor) -> torch.Tensor:
        for _ in range(n_steps):
            state = step_matmul(state, rule, lane)
        return state

    def cost(state):
        h, w = int(state.shape[-2]), int(state.shape[-1])
        # The plan priced these intermediates when the step was first
        # planned; lru_cache makes the re-ask free.
        plan = plan_matmul((h, w), rule.radius, lane, device=state.device.type)
        return {
            "cells": float(h) * w * n_steps,
            "bytes": float(plan.est_bytes) * n_steps,
            # Two banded GEMM passes per step over the packed operand.
            "flops": 4.0 * h * plan.packed_width * (2 * rule.radius + 1) * n_steps,
        }

    return registered_jit(
        "matmul", ("multi_step", rule.name, mode, n_steps), run, cost=cost
    )
