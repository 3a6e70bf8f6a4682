"""Plain-numpy CA kernels for host-side tile stepping.

The distributed control plane steps coarse tiles inside worker processes.  A
worker whose shard lives on a TPU uses the jitted stencil
(:mod:`akka_game_of_life_tpu_torch.ops.stencil`); a CPU-only worker (the parity
configuration, BASELINE.json config 1) uses these numpy twins — identical
semantics, no device runtime required.  Both consume the same halo-padded
tile layout, so the engines are swappable per worker (the role-config
pluggability the reference gets from its actor protocol).
"""

from __future__ import annotations

import numpy as np

from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule


def _apply_rule_np(state: np.ndarray, counts: np.ndarray, rule: Rule) -> np.ndarray:
    c = counts.astype(np.uint32)
    birth = ((np.uint32(rule.birth_mask) >> c) & 1).astype(np.uint8)
    if not rule.is_totalistic:  # wireworld: see ops/stencil.apply_rule
        # (survive plane skipped — unused by this kind, and unlike the jax
        # twin there is no compiler to dead-code-eliminate it.)
        return np.where(
            state == 1,
            np.uint8(2),
            np.where(
                state == 2,
                np.uint8(3),
                np.where((state == 3) & (birth == 1), np.uint8(1), state),
            ),
        ).astype(np.uint8)
    survive = ((np.uint32(rule.survive_mask) >> c) & 1).astype(np.uint8)
    if rule.is_binary:
        return np.where(state == 1, survive, birth).astype(np.uint8)
    decayed = np.where(state + 1 < rule.states, state + 1, 0).astype(np.uint8)
    live_next = np.where(survive == 1, 1, 2).astype(np.uint8)
    return np.where(
        state == 0, birth, np.where(state == 1, live_next, decayed)
    ).astype(np.uint8)


def neighbor_counts_padded_np(padded_alive: np.ndarray) -> np.ndarray:
    h, w = padded_alive.shape[0] - 2, padded_alive.shape[1] - 2
    acc = np.zeros((h, w), dtype=np.uint8)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if (dy, dx) == (1, 1):
                continue
            acc += padded_alive[dy : dy + h, dx : dx + w]
    return acc


def step_padded_np(padded: np.ndarray, rule) -> np.ndarray:
    """One step on a radius-deep halo-padded tile: (h+2R, w+2R) → (h, w)."""
    rule = resolve_rule(rule)
    if rule.kind == "ltl":
        from akka_game_of_life_tpu_torch.ops.ltl import step_padded_ltl_np

        return step_padded_ltl_np(padded, rule)
    alive = (padded == 1).astype(np.uint8)
    counts = neighbor_counts_padded_np(alive)
    return _apply_rule_np(padded[1:-1, 1:-1], counts, rule)


def step_np(board: np.ndarray, rule) -> np.ndarray:
    """One toroidal step on a full board (numpy oracle / CPU engine)."""
    rule = resolve_rule(rule)
    return step_padded_np(np.pad(board, rule.radius, mode="wrap"), rule)
