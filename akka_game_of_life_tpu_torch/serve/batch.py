"""Batched multi-tenant stepping: many small boards in one device call.

Counterpart of ``akka_game_of_life_tpu/serve/batch.py``.  Everywhere else
the rule is built into the stepper (the CUDA sweeps are compiled per rule);
the serving plane flips that trade, as the JAX package does: thousands of
small boards with *heterogeneous* rules advance together, so the rule
masks ``(birth_mask, survive_mask, states)`` ride the batch as per-board
tensors like the boards do, and one function serves every
outer-totalistic rule (binary life-likes and multi-state Generations decay)
at once.

Mixed shapes bucket into a few padded **size classes**: a board of logical
shape ``(h, w)`` occupies the top-left corner of a ``C×C`` slot (zeros
beyond it) and steps toroidally *on its own h×w region* through per-board
modular index vectors — ``(r+dy) mod h`` never reads padding, and the
output mask keeps padding dead — so the batched step is bit-identical to
the single-board toroidal step at every shape up to the class side.  Per-
board step counts ride the batch too (an iteration applies only while
``i < n[b]``); the caller rounds the iteration count and the batch size up
to powers of two, as in the JAX package.

Each generation is a few whole-batch tensor passes (six ``torch.gather``
calls over the batch, then the rule's elementwise selects), never a Python
loop over boards.  The JAX package computes this as XLA programs
(``jax.jit`` + ``vmap`` + ``lax.scan``), not a Pallas kernel, so the port's
counterpart is PyTorch on the device's tensors.  Iterations past every
board's count are skipped (they are the identity) and the per-board
``where`` is skipped while every board is still counting; both leave the
result unchanged.

The per-board digest lanes (``ops.digest.digest_dense_batch``) come back
from the same call: certification rides the step, 8 bytes per board.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.ops.rules import Rule
from akka_game_of_life_tpu_torch.ops.sparse import next_pow2
from akka_game_of_life_tpu_torch.runtime.config import parse_size_classes

__all__ = [
    "DEFAULT_SIZE_CLASSES",
    "batch_step_fn",
    "memo_block_step_fn",
    "next_pow2",
    "parse_size_classes",  # canonical home: runtime.config (validation)
    "rule_operands",
    "size_class",
]

# Default padded size classes (square sides): the serving plane targets
# many small per-user boards, not the 65536² headline board — that one
# stays on the single-board kernels.
DEFAULT_SIZE_CLASSES: Tuple[int, ...] = (32, 64, 128, 256)


def size_class(
    height: int, width: int, classes: Sequence[int] = DEFAULT_SIZE_CLASSES
) -> Optional[int]:
    """The smallest class side that fits an (height, width) board, or None
    when the board exceeds every class (the caller's 400, not a crash)."""
    side = max(height, width)
    for c in classes:
        if side <= c:
            return c
    return None


def rule_operands(rule: Rule) -> Tuple[int, int, int]:
    """A rule as per-board data: (birth_mask, survive_mask, states).  Only
    outer-totalistic families serve batched — wireworld's transition is not
    mask-encodable and LtL needs radius-R geometry."""
    if rule.kind != "totalistic":
        raise ValueError(
            f"the serving plane steps outer-totalistic rules only "
            f"(life-like and Generations); {rule} is kind={rule.kind!r}"
        )
    return rule.birth_mask, rule.survive_mask, rule.states


def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor, an array or a sequence) as ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype)


def _mod_idx(n: int, d: int, m: torch.Tensor) -> torch.Tensor:
    """``[B, n]`` index rows ``(i + d) mod m[b]``: the toroidal shift on
    each board's live extent (``%`` is floor-signed, so -1 % m == m-1;
    indices land in [0, m[b]) and never read padding)."""
    return (torch.arange(n, dtype=torch.int64, device=m.device)[None, :] + d) % m[:, None]


class _Geometry:
    """The per-call constants of a batch: the six expanded gather indices
    of the separable Moore sum and the live-region mask."""

    def __init__(self, b: int, side: int, h: torch.Tensor, w: torch.Tensor) -> None:
        shape = (b, side, side)
        self.cols = [_mod_idx(side, d, w)[:, None, :].expand(shape) for d in (-1, 0, 1)]
        self.rows = [_mod_idx(side, d, h)[:, :, None].expand(shape) for d in (-1, 0, 1)]
        ar = torch.arange(side, dtype=torch.int64, device=h.device)
        self.live = (ar[None, :, None] < h[:, None, None]) & (ar[None, None, :] < w[:, None, None])


def _neighbor_counts(alive: torch.Tensor, geo: _Geometry) -> torch.Tensor:
    """Moore-8 live-neighbour counts, toroidal on each slot's live region:
    three column gathers then three row gathers, minus the centre.  Rows
    and columns past the live extent compute garbage the region mask
    discards."""
    s1 = torch.gather(alive, 2, geo.cols[0])
    s1 += torch.gather(alive, 2, geo.cols[1])
    s1 += torch.gather(alive, 2, geo.cols[2])
    acc = torch.gather(s1, 1, geo.rows[0])
    acc += torch.gather(s1, 1, geo.rows[1])
    acc += torch.gather(s1, 1, geo.rows[2])
    return acc - alive


def _step_once(board, birth, survive, states, geo: _Geometry) -> torch.Tensor:
    """One toroidal step of a ``[B, C, C]`` uint8 batch; the rule is three
    ``[B, 1, 1]`` int32 tensors.  Bit-identical to the single-board step of
    each ``[:h, :w]`` region for every outer-totalistic rule, Generations
    decay included (a live cell failing survival enters state 2 and decays
    to 0; refractory cells block birth and never count as neighbours)."""
    counts = _neighbor_counts((board == 1).to(torch.uint8), geo).to(torch.int32)
    born = ((birth >> counts) & 1).to(torch.uint8)
    kept = ((survive >> counts) & 1) == 1
    # Binary rules (states == 2) fall out of the Generations form: the
    # first refractory state only exists when states > 2, and the decay
    # branch never sees a state >= 2 cell.
    dying = torch.where(states > 2, 2, 0).to(torch.uint8)
    live_next = torch.where(kept, torch.ones_like(board), dying)
    bumped = board.to(torch.int32) + 1
    decayed = torch.where(bumped < states, bumped, 0).to(torch.uint8)
    out = torch.where(board == 0, born, torch.where(board == 1, live_next, decayed))
    # Padding stays dead: a birth in the garbage region (or from a B0 mask)
    # must not leak live cells outside [:h, :w].
    return torch.where(geo.live, out, torch.zeros_like(out))


def _rule_tensors(birth, survive, states, b: int, device: torch.device):
    return tuple(
        _on(x, torch.int32, device).reshape(b, 1, 1) for x in (birth, survive, states)
    )


def _check_square(x: torch.Tensor, side: int, what: str) -> None:
    """The index vectors are built for ``side``: a stack of another shape
    would gather out of bounds (on a card, a device-side assert)."""
    if x.dim() != 3 or tuple(x.shape[1:]) != (side, side):
        raise ValueError(f"{what} must be [N, {side}, {side}], got {list(x.shape)}")


def _resolve(device) -> torch.device:
    from akka_game_of_life_tpu_torch.runtime.simulation import resolve_device

    return resolve_device(device)


@functools.lru_cache(maxsize=None)
def batch_step_fn(class_side: int, length: int, device="cuda"):
    """The batched advance for one size class on ``device`` (cached per
    ``(class_side, length, device)``; the caller also quantizes the batch
    to powers of two, so the program count stays O(classes · log steps)
    whatever the traffic mix).  Raises where CUDA is wanted and absent.

    Signature of the returned callable (tensors or arrays in, tensors on
    ``device`` out)::

        boards' [B,C,C]u8, lanes [B,2]i64 = run(
            boards [B,C,C]u8,   # zero-padded beyond each [:h,:w] region
            birth   [B]u32,     # per-board Rule.birth_mask
            survive [B]u32,     # per-board Rule.survive_mask
            states  [B]i32,     # per-board state count (2 = binary)
            h, w    [B]i32,     # per-board live extents (1..C)
            n       [B]i32,     # per-board step counts (0..length)
        )

    Board b advances exactly ``n[b]`` toroidal epochs, then its digest
    lanes (uint32 values) are folded in the same call."""
    dev = _resolve(device)

    def run(boards, birth, survive, states, h, w, n):
        s = _on(boards, torch.uint8, dev)
        _check_square(s, class_side, "boards")
        b = s.shape[0]
        birth_t, survive_t, states_t = _rule_tensors(birth, survive, states, b, dev)
        h_t, w_t = _on(h, torch.int64, dev), _on(w, torch.int64, dev)
        n_host = n.cpu().numpy() if isinstance(n, torch.Tensor) else np.asarray(n)
        n_t = _on(n_host, torch.int64, dev).reshape(b, 1, 1)
        geo = _Geometry(b, class_side, h_t, w_t)
        n_min = int(n_host.min()) if b else 0
        n_max = int(n_host.max()) if b else 0
        for i in range(min(length, n_max)):
            stepped = _step_once(s, birth_t, survive_t, states_t, geo)
            s = stepped if i < n_min else torch.where(i < n_t, stepped, s)
        return s, odigest.digest_dense_batch(s, w_t)

    from akka_game_of_life_tpu_torch.obs.programs import registered_jit, stencil_cost

    return registered_jit(
        "serve_batch", (class_side, length, str(dev)), run,
        # Priced as the JAX program runs it: every board scans `length`
        # iterations (identity past its own n).
        cost=lambda boards, *rest: stencil_cost(
            class_side, class_side, length, boards=boards.shape[0]
        ),
    )


@functools.lru_cache(maxsize=None)
def memo_block_step_fn(block: int, device="cuda"):
    """The macro-cell miss batch (``serve/memo.py``): advance a batch of
    B-sided context blocks exactly S = B/4 toroidal epochs and return their
    T-sided centres (T = B/2), the payload a memo cache entry stores.

    One function per block size, for every rule and every session: the
    rule masks ride per block exactly like :func:`batch_step_fn`, and
    blocks are always full B×B (the codec only emits exact blocks).

    Signature of the returned callable (tensors on ``device`` out)::

        centres [N,T,T]u8 = run(
            blocks  [N,B,B]u8,  # toroidal context blocks
            birth   [N]u32,     # per-block Rule.birth_mask
            survive [N]u32,     # per-block Rule.survive_mask
            states  [N]i32,     # per-block state count (2 = binary)
        )

    Why the toroidal shortcut is exact is argued in ``ops/macroblock.py``:
    wrap corruption travels inward one cell per step and never reaches the
    centre within S steps."""
    dev = _resolve(device)
    tile = block // 2
    steps = block // 4

    def run(blocks, birth, survive, states):
        s = _on(blocks, torch.uint8, dev)
        _check_square(s, block, "blocks")
        nb = s.shape[0]
        birth_t, survive_t, states_t = _rule_tensors(birth, survive, states, nb, dev)
        full = torch.full((nb,), block, dtype=torch.int64, device=dev)
        geo = _Geometry(nb, block, full, full)
        for _ in range(steps):
            s = _step_once(s, birth_t, survive_t, states_t, geo)
        return s[:, steps : steps + tile, steps : steps + tile]

    from akka_game_of_life_tpu_torch.obs.programs import registered_jit, stencil_cost

    return registered_jit(
        "serve_memo", (block, steps, str(dev)), run,
        cost=lambda blocks, *rest: stencil_cost(
            block, block, steps, boards=blocks.shape[0]
        ),
    )
