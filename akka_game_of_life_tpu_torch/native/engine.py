"""ctypes wrappers presenting the native actor engine with the same API as
:mod:`akka_game_of_life_tpu_torch.runtime.actor_engine` (ActorBoard /
ActorTileEngine), so the two are drop-in interchangeable wherever the
per-cell-actor backend is selected, and the three SWAR chunk steppers.

Counterpart of ``akka_game_of_life_tpu/native/engine.py``.  Every entry
builds the library on first use (``native.load``) and raises with the
compiler's stderr when it cannot: there is no fallback."""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from akka_game_of_life_tpu_torch.native import load
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

Position = Tuple[int, int]


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeActorBoard:
    """Toroidal per-cell actor board backed by the C++ event loop."""

    def __init__(self, board: np.ndarray, rule) -> None:
        self._lib = lib = load()
        self.rule = resolve_rule(rule)
        if self.rule.radius != 1:
            raise ValueError(
                "the native per-cell engine is Moore-8 (radius 1); "
                "radius-R ltl rules run on the dense kernel"
            )
        board = np.ascontiguousarray(board, dtype=np.uint8)
        self.shape = board.shape
        h, w = board.shape
        self._ptr = lib.ae_create(
            h, w, _as_u8p(board),
            self.rule.birth_mask, self.rule.survive_mask, self.rule.states, 0,
            0 if self.rule.is_totalistic else 1,
        )
        if not self._ptr:
            raise ValueError(f"board {h}x{w} too large for the per-cell engine")
        self.global_epoch = 0

    def __del__(self) -> None:
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.ae_destroy(ptr)
            self._ptr = None

    # -- coordinator API (ActorBoard parity) ---------------------------------

    def advance_to(self, target_epoch: int) -> None:
        self.global_epoch = max(self.global_epoch, target_epoch)
        self._lib.ae_advance_to(self._ptr, target_epoch)

    def crash_cell(self, pos: Position) -> None:
        self._lib.ae_crash_cell(self._ptr, pos[0], pos[1])

    def board_at_current(self) -> np.ndarray:
        out = np.empty(self.shape, dtype=np.uint8)
        self._lib.ae_get_board(self._ptr, _as_u8p(out))
        return out

    def min_epoch(self) -> int:
        return int(self._lib.ae_min_epoch(self._ptr))

    def prune_histories_below(self, epoch: int) -> None:
        self._lib.ae_prune_below(self._ptr, epoch)

    @property
    def messages_processed(self) -> int:
        return int(self._lib.ae_messages(self._ptr))


class NativeActorTileEngine:
    """``engine="actor-native"`` adapter for BackendWorker: the ghost-ring
    tile variant (remote neighbors fed from the cluster halo)."""

    def __init__(self, rule) -> None:
        self.rule = resolve_rule(rule)
        if self.rule.radius != 1:
            raise ValueError(
                "the native per-cell engine is Moore-8 (radius 1); "
                "radius-R ltl rules run on the dense kernel"
            )
        self._lib = load()
        self._ptr: Optional[int] = None
        self._shape: Optional[Tuple[int, int]] = None
        self._epoch = 0

    def __del__(self) -> None:
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.ae_destroy(ptr)
            self._ptr = None

    def step(self, padded: np.ndarray) -> np.ndarray:
        padded = np.ascontiguousarray(padded, dtype=np.uint8)
        interior = padded[1:-1, 1:-1]
        if self._ptr is None:
            h, w = interior.shape
            self._shape = (h, w)
            arr = np.ascontiguousarray(interior)
            self._ptr = self._lib.ae_create(
                h, w, _as_u8p(arr),
                self.rule.birth_mask, self.rule.survive_mask,
                self.rule.states, 1,
                0 if self.rule.is_totalistic else 1,
            )
            if not self._ptr:
                raise ValueError(
                    f"tile {h}x{w} too large for the per-cell engine"
                )
        self._lib.ae_feed_halo(self._ptr, self._epoch, _as_u8p(padded))
        self._epoch += 1
        self._lib.ae_advance_to(self._ptr, self._epoch)
        assert int(self._lib.ae_min_epoch(self._ptr)) == self._epoch
        self._lib.ae_prune_below(self._ptr, self._epoch - 1)
        out = np.empty(self._shape, dtype=np.uint8)
        self._lib.ae_get_board(self._ptr, _as_u8p(out))
        return out



def _native_chunk(padded, steps, halo, call):
    """Shared body of the chunk wrappers: steps/halo contract, library
    load, contiguity, and interior-output allocation; ``call(lib, padded,
    ph, pw, out)`` invokes the kernel."""
    if steps > halo:
        raise ValueError(f"steps={steps} > halo={halo}")
    lib = load()
    padded = np.ascontiguousarray(padded, dtype=np.uint8)
    ph, pw = padded.shape
    out = np.empty((ph - 2 * halo, pw - 2 * halo), dtype=np.uint8)
    call(lib, padded, ph, pw, out)
    return out


def swar_chunk_native(
    padded: np.ndarray, steps: int, halo: int, rule
) -> np.ndarray:
    """Advance the (h, w) interior of a width-``halo`` padded slab by
    ``steps`` (<= halo) generations with the C++ SWAR kernel (64 cells per
    uint64 lane; native/swar_kernel.cpp) — the host-CPU twin of the packed
    sweep, and the machine-code replacement for the numpy
    engine's roll-sum stepping on binary rules."""
    rule = resolve_rule(rule)
    if not (rule.is_binary and rule.is_totalistic):
        raise ValueError(
            "native SWAR kernel supports binary totalistic rules only"
        )
    return _native_chunk(
        padded, steps, halo,
        lambda lib, p, ph, pw, out: lib.swar_chunk(
            _as_u8p(p), ph, pw, steps, halo,
            rule.birth_mask, rule.survive_mask, _as_u8p(out),
        ),
    )


def swar_wire_chunk_native(
    padded: np.ndarray, steps: int, halo: int, rule
) -> np.ndarray:
    """WireWorld twin of :func:`swar_chunk_native`: the 4-state CA as two
    uint64 bit planes through the same carry-save head-count adders
    (native/swar_kernel.cpp ``swar_wire_chunk``)."""
    rule = resolve_rule(rule)
    if rule.kind != "wireworld":
        raise ValueError(f"expected a wireworld rule, got {rule}")
    return _native_chunk(
        padded, steps, halo,
        lambda lib, p, ph, pw, out: lib.swar_wire_chunk(
            _as_u8p(p), ph, pw, steps, halo, rule.birth_mask, _as_u8p(out)
        ),
    )


def swar_gen_chunk_native(
    padded: np.ndarray, steps: int, halo: int, rule
) -> np.ndarray:
    """Generations twin of :func:`swar_chunk_native`: m bit planes with
    ripple-carry refractory decay (native/swar_kernel.cpp
    ``swar_gen_chunk``)."""
    rule = resolve_rule(rule)
    # Rule() caps states at 255, so totalistic + multi-state is the whole
    # gate.
    if not (rule.is_totalistic and not rule.is_binary):
        raise ValueError(
            f"expected a multi-state Generations rule, got {rule}"
        )
    return _native_chunk(
        padded, steps, halo,
        lambda lib, p, ph, pw, out: lib.swar_gen_chunk(
            _as_u8p(p), ph, pw, steps, halo,
            rule.birth_mask, rule.survive_mask, rule.states, _as_u8p(out),
        ),
    )
