"""Logarithmic time travel: O(log T) fast-forward for XOR-linear rules.

Counterpart of ``akka_game_of_life_tpu/ops/fastforward.py``.  For the
odd-rule family (``ops/rules.linear_kernel``) one step is a XOR-convolution
of the board by a fixed ±R kernel over GF(2), so T steps are one
convolution by the kernel's T-th XOR-power, and two facts make that cheap:

- **Squaring is free (Frobenius).**  Over GF(2), ``(Σ aᵢ xⁱ)² = Σ aᵢ x²ⁱ``:
  ``K^(2^k)`` is the base kernel with every offset scaled by ``2^k`` (mod
  the torus), never more cells than K itself.
- **The factored jump.**  ``K^T = Π K^(2^k)`` over T's set bits, and the
  factors commute, so :func:`fast_forward` applies ``popcount(T)`` scaled
  copies of the base kernel, each at most |K| ``torch.roll`` + XOR passes
  over the board, on the board's device.

On a 2^m-sided torus every factor scaled by 2^k with k ≥ m − 1 cancels in
pairs, so a jump there can reduce to the zero or identity map;
:func:`jump_plan` reports each factor's roll count after that cancellation.

:func:`pow_offsets` / :func:`kernel_plane` materialize the composed kernel
(square-and-multiply on a sparse offset set, every working set priced
through :mod:`ops/guard` first).  For the separable kernels (the Fredkin
family, ``ones ⊗ ones``) :func:`jump_matmul_fn` runs the jump as two
blocked banded products over GF(2) in the lanes of ``ops/matmul_stencil``.
:func:`certify_jump` compares a jump's digest with the same T iterated
through the dense stepper.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit
from akka_game_of_life_tpu_torch.ops import guard
from akka_game_of_life_tpu_torch.ops.rules import linear_kernel, resolve_rule


def kernel_offsets(rule) -> np.ndarray:
    """The linear rule's one-step kernel as centred ``(k, 2)`` int64
    offsets.  Raises ``ValueError`` for non-linear rules: every
    fast-forward surface refuses through here."""
    rule = resolve_rule(rule)
    kern = linear_kernel(rule)
    if kern is None:
        raise ValueError(
            f"rule {rule} is not XOR-linear: fast-forward applies only to "
            f"the odd-rule family (birth on odd counts with odd/even "
            f"survival — see ops/rules.linear_kernel); every other rule "
            f"must iterate"
        )
    r = rule.radius
    ys, xs = np.nonzero(kern)
    return np.stack([ys.astype(np.int64) - r, xs.astype(np.int64) - r], 1)


def support_radius(rule, t: int) -> int:
    """The composed kernel's support half-width after ``t`` steps: R·t
    (until ``2·R·t + 1`` reaches the board side and the kernel wraps)."""
    return resolve_rule(rule).radius * int(t)


def _parity_dedup(offs: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Canonicalize offsets mod the torus and cancel pairs (GF(2)
    coefficients: an offset seen an even number of times vanishes)."""
    h, w = shape
    if len(offs) == 0:
        return offs.reshape(0, 2)
    offs = np.stack([offs[:, 0] % h, offs[:, 1] % w], 1)
    uniq, counts = np.unique(offs, axis=0, return_counts=True)
    return uniq[counts % 2 == 1]


def _compose_guard(n_left: int, n_right: int, what: str) -> None:
    """Price one XOR-convolution's offset working set (the n_left·n_right
    candidate rows built before parity cancellation) up front."""
    rows = n_left * n_right
    guard.require_intermediates_fit(
        rows * 2 * 8 * 2,  # (rows, 2) int64, candidate + unique scratch
        what=what,
        detail=(
            "Use the factored jump (fast_forward) instead — it applies "
            "the per-bit scaled kernels to the board directly and never "
            "materializes the composed kernel."
        ),
        shapes=[((rows, 2), 8), ((rows, 2), 8)],
    )


# Span ceiling: the per-jump program count is the span's bit length, so one
# absurd request cannot mint unbounded work.  Offset arithmetic is exact at
# any span (scales reduce mod the torus side before multiplying).
MAX_SPAN_BITS = 62


def _scaled_offsets(base: np.ndarray, k: int, shape: Tuple[int, int]) -> np.ndarray:
    """The 2^k-scaled kernel offsets, canonical mod the torus and
    parity-deduped.  The scale reduces mod each side first: a raw int64
    ``base << k`` would wrap for k ≥ 61."""
    h, w = shape
    sy, sx = pow(2, k, h), pow(2, k, w)
    return _parity_dedup(
        np.stack([base[:, 0] * sy, base[:, 1] * sx], 1), (h, w)
    )


def _require_span(t: int) -> int:
    t = int(t)
    if t < 0:
        raise ValueError(f"cannot fast-forward a negative span: t={t}")
    if t.bit_length() > MAX_SPAN_BITS:
        raise ValueError(
            f"fast-forward span t={t} exceeds {MAX_SPAN_BITS} bits "
            f"(offsets scale as 2^k in int64, and the per-jump program "
            f"count is bounded by the span's bit length)"
        )
    return t


def pow_offsets(rule, t: int, shape: Tuple[int, int]) -> np.ndarray:
    """The T-th XOR-power of the one-step kernel as sparse offsets on the
    ``(H, W)`` torus, by square-and-multiply (squaring doubles the offsets;
    each multiply is a XOR-convolution whose working set is guard-priced
    first)."""
    rule = resolve_rule(rule)
    base = kernel_offsets(rule)
    h, w = int(shape[-2]), int(shape[-1])
    t = _require_span(t)
    if t == 0:
        return np.zeros((1, 2), dtype=np.int64)  # the identity kernel
    acc = _parity_dedup(base, (h, w))
    for bit in bin(t)[3:]:  # remaining bits below the MSB, high to low
        acc = _parity_dedup(2 * acc, (h, w))  # Frobenius: K² offsets = 2·offsets
        if bit == "1":
            _compose_guard(
                len(acc), len(base),
                what=f"fastforward kernel composition ({rule}, t={t}, "
                     f"{h}x{w})",
            )
            cand = (acc[None, :, :] + base[:, None, :]).reshape(-1, 2)
            acc = _parity_dedup(cand, (h, w))
    return acc


def kernel_plane(rule, t: int, shape: Tuple[int, int]) -> np.ndarray:
    """The T-step kernel as a wrapped ``(H, W)`` uint8 plane
    (guard-priced): row/column 0 is the zero offset."""
    h, w = int(shape[-2]), int(shape[-1])
    guard.require_intermediates_fit(
        h * w,
        what=f"fastforward kernel plane ({resolve_rule(rule)}, t={t}, {h}x{w})",
        detail="Use pow_offsets (sparse) or the factored fast_forward jump.",
        shapes=[((h, w), 1)],
    )
    plane = np.zeros((h, w), dtype=np.uint8)
    offs = pow_offsets(rule, t, (h, w))
    plane[offs[:, 0], offs[:, 1]] ^= 1
    return plane


def apply_offsets(board: torch.Tensor, offs: np.ndarray) -> torch.Tensor:
    """XOR-convolve a 0/1 board by a sparse offset kernel: one roll + XOR
    per offset (``next[p] = XOR_o board[p + o]``), on the board's device."""
    if len(offs) == 0:
        return torch.zeros_like(board)
    h, w = board.shape[-2], board.shape[-1]
    acc = None
    for dy, dx in offs:
        term = (
            board
            if (int(dy) % h, int(dx) % w) == (0, 0)
            else torch.roll(board, shifts=(-int(dy), -int(dx)), dims=(-2, -1))
        )
        acc = term if acc is None else torch.bitwise_xor(acc, term)
    return acc


# Bounded, as in the JAX package: callers choose (rule, k, shape).
@functools.lru_cache(maxsize=2048)
def _jump_pow2_fn(rule_key, k: int, shape: Tuple[int, int]) -> Callable:
    """A 2^k-epoch jump: the base kernel with offsets scaled by 2^k,
    parity-deduped on the host, applied as at most |K| rolls + XORs;
    registered on the program ledger (family ``fastforward``)."""
    rule = resolve_rule(rule_key)
    shifts = _scaled_offsets(kernel_offsets(rule), k, shape)
    h, w = int(shape[-2]), int(shape[-1])
    return registered_jit(
        "fastforward", ("jump_pow2", rule.name, k, shape),
        lambda board: apply_offsets(board, shifts),
        # Effective work: one call advances 2^k epochs; the device traffic
        # is |shifts| rolls + XORs over one board.
        cost={
            "cells": float(h) * w * (2 ** k),
            "bytes": float(len(shifts) + 1) * h * w,
            "flops": float(len(shifts)) * h * w,
        },
    )


def fast_forward(board: torch.Tensor, rule, t: int) -> torch.Tensor:
    """Advance a dense 0/1 board ``t`` epochs under a linear rule in
    ``popcount(t)`` passes of the scaled kernels, on the board's device.
    Bit-identical to iterating ``t`` steps; raises ``ValueError`` for
    non-linear rules."""
    rule = resolve_rule(rule)
    kernel_offsets(rule)  # the linearity refusal, before any work
    t = _require_span(t)
    h, w = int(board.shape[-2]), int(board.shape[-1])
    out = board
    k = 0
    while t:
        if t & 1:
            out = _jump_pow2_fn(rule, k, (h, w))(out)
        t >>= 1
        k += 1
    return out


def fast_forward_np(board: np.ndarray, rule, t: int, device="cuda") -> np.ndarray:
    """Host arrays in and out, the jump on ``device`` in between."""
    x = torch.from_numpy(np.ascontiguousarray(board, dtype=np.uint8)).to(device)
    return fast_forward(x, rule, t).cpu().numpy()


def certify_jump(board: torch.Tensor, rule, t: int) -> int:
    """The jump-vs-iterate certificate: jump ``board`` by ``t`` AND iterate
    ``t`` steps through the dense stepper; the two digests must agree.
    Returns the digest; raises ``RuntimeError`` on divergence.  O(t)
    stepper work, so callers certify a small sample."""
    from akka_game_of_life_tpu_torch.ops import digest as odigest, stencil

    rule = resolve_rule(rule)
    jumped = fast_forward(board, rule, t)
    iterated = stencil.multi_step_fn(rule, t)(board) if t else board
    d_jump = odigest.value(odigest.digest_dense(jumped).cpu().numpy())
    d_iter = odigest.value(odigest.digest_dense(iterated).cpu().numpy())
    if d_jump != d_iter:
        raise RuntimeError(
            f"fast-forward certification failed for {rule} at t={t}: "
            f"jump digest {d_jump:016x} != iterate digest {d_iter:016x} — "
            f"refusing to trust the jump"
        )
    return d_jump


# -- the banded-matmul GF(2) lane (separable kernels: the Fredkin family) ------


def _pow1d_offsets(radius: int, t: int, n: int) -> np.ndarray:
    """The 1-D XOR-power mask: the T-th GF(2) power of ``ones(2R+1)`` on
    the length-``n`` circle, as sorted residues."""
    base = np.arange(-radius, radius + 1, dtype=np.int64)

    def dedup(vals: np.ndarray) -> np.ndarray:
        uniq, counts = np.unique(vals % n, return_counts=True)
        return uniq[counts % 2 == 1]

    if t == 0:
        return np.zeros(1, dtype=np.int64)
    acc = dedup(base)
    for bit in bin(t)[3:]:
        acc = dedup(2 * acc)
        if bit == "1":
            acc = dedup((acc[None, :] + base[:, None]).ravel())
    return acc


def _centered(residues: np.ndarray, n: int) -> np.ndarray:
    """Map circle residues to the centred range (-n//2, n//2]."""
    return ((residues + n // 2 - 1) % n) - (n // 2 - 1) if n > 1 else residues * 0


def _mask_slab(tile: int, centered: np.ndarray, s: int) -> np.ndarray:
    """(tile, tile + 2s) slab: row t has ones at columns t + s + o for each
    centred mask offset o (the band slab with an arbitrary 0/1 mask)."""
    slab = np.zeros((tile, tile + 2 * s), np.float32)
    for off in centered:
        slab[np.arange(tile), np.arange(tile) + s + int(off)] = 1.0
    return slab


@functools.lru_cache(maxsize=64)  # keyed on raw t: a bounded test/bench lane
def jump_matmul_fn(rule_key, t: int, shape: Tuple[int, int], mode: str = "auto",
                   device="cuda"):
    """The T-step jump as two blocked banded products over GF(2), for
    SEPARABLE linear kernels only (the full-box Fredkin family, ``ones ⊗
    ones``).  The row pass sums each column's 1-D XOR-power window and
    takes the parity between passes (so every product sums at most a board
    side of 0/1 terms, exact in every lane), the column pass does the same
    along rows.  ``mode`` takes the lanes of ``ops/matmul_stencil``
    (``auto`` resolved on ``device``); the working set is guard-priced when
    the closure is built."""
    from akka_game_of_life_tpu_torch.ops import matmul_stencil as ms

    rule = resolve_rule(rule_key)
    t = _require_span(t)
    kern = linear_kernel(rule)
    if kern is None or not kern.all():
        raise ValueError(
            f"rule {rule} has no separable (full-box) linear kernel; the "
            f"banded GF(2) matmul jump needs ones⊗ones — use fast_forward "
            f"(the factored roll path) instead"
        )
    h, w = int(shape[-2]), int(shape[-1])
    mode = ms._resolve_mode(mode, device)
    rows_c = _centered(_pow1d_offsets(rule.radius, t, h), h)
    cols_c = _centered(_pow1d_offsets(rule.radius, t, w), w)
    sr = int(np.max(np.abs(rows_c))) if len(rows_c) else 0
    sc = int(np.max(np.abs(cols_c))) if len(cols_c) else 0
    kr, kc = ms._pick_tile(h), ms._pick_tile(w)
    item = {"f32": 4, "int8": 1, "bf16": 2}[mode]
    planes = [
        ((h + 2 * sr, w), item),  # row-padded operand
        ((h, w), 4),  # row-pass counts (accumulator dtype)
        ((h, w + 2 * sc), item),  # col-padded parity plane
        ((h, w), 4),  # col-pass counts
        ((kr, kr + 2 * sr), item),  # row mask slab
        ((kc, kc + 2 * sc), item),  # col mask slab
    ]
    est = sum(guard.plane_bytes(s, i) for s, i in planes)
    guard.require_intermediates_fit(
        est,
        what=f"fastforward matmul jump ({rule}, t={t}, {h}x{w}, {mode})",
        detail="Use fast_forward (the factored roll path keeps working "
               "sets board-sized at any T).",
        shapes=planes,
    )
    od = ms._OPERAND[mode]
    acc = torch.int32 if mode == "int8" else torch.float32
    rows_p = tuple(int(o) for o in rows_c)
    cols_p = tuple(int(o) for o in cols_c)
    width = ms._padded_width(w, kc, sc)

    def run(board: torch.Tensor) -> torch.Tensor:
        dev = board.device
        with ms._full_fp32():
            x = torch.zeros((h, ms._up(w)), dtype=od, device=dev)
            x[:, :w] = board
            rows = torch.empty((h, ms._up(w)), dtype=acc, device=dev)
            slab_r = ms._slab(rows_p, kr, sr, ms._up(kr + 2 * sr), 0, False, od, str(dev))
            ms._row_pass(x, slab_r, kr, sr, rows, mode)
            # Parity BETWEEN passes keeps the column pass's sums small.
            y = (rows[:, :w].to(torch.int32) & 1).to(od)
            yp = ms._with_pads(y[:, w - sc :], y, y[:, :sc], width, od)
            out = torch.empty((h, w), dtype=acc, device=dev)
            slab_c = ms._slab(cols_p, kc, sc, ms._up(kc + 2 * sc), ms._up(kc), True, od, str(dev))
            ms._col_pass(yp, slab_c, kc, h, w, out, mode)
        return (out.to(torch.int32) & 1).to(board.dtype)

    return registered_jit(
        "fastforward", ("jump_matmul", rule.name, t, shape, mode), run,
        # Effective cells: t epochs in one call; bytes from the guard-priced
        # plane estimate; flops from the two banded GEMM passes.
        cost={
            "cells": float(h) * w * t,
            "bytes": float(est),
            "flops": 2.0 * h * w * ((kr + 2 * sr) + (kc + 2 * sc)),
        },
    )


def jump_plan(rule, t: int, shape: Tuple[int, int]) -> dict:
    """What a jump costs, as data: passes, per-factor roll counts after
    torus parity cancellation (on a 2^m-side torus a factor scaled by 2^k,
    k ≥ m − 1, cancels, so a whole jump can reduce to the zero or identity
    map), support half-width, and whether the composed kernel wrapped."""
    rule = resolve_rule(rule)
    t = _require_span(t)
    base = kernel_offsets(rule)
    h, w = int(shape[-2]), int(shape[-1])
    s = support_radius(rule, t)
    factor_rolls = [
        int(len(_scaled_offsets(base, k, (h, w))))
        for k in range(max(1, int(t)).bit_length())
        if (t >> k) & 1
    ]
    return {
        "programs": max(1, bin(int(t)).count("1")),
        "rolls_per_program": int(len(base)),
        "factor_rolls": factor_rolls,
        "support_radius": s,
        "wrapped": 2 * s + 1 >= min(h, w),
    }
