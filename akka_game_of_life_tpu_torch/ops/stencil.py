"""The dense stencil in plain PyTorch: one uint8 state per cell.

Counterpart of ``akka_game_of_life_tpu/ops/stencil.py``.  The Moore count of
the live cells (state 1) is a sum of eight toroidal ``torch.roll`` shifts;
the rule applies as bitmask lookups.  Binary, Generations and WireWorld
rules step here; Larger-than-Life dispatches to ``ops/ltl.py``.  This is the
``kernel=dense`` stepper (and ``auto`` on widths that are not a multiple of
32), and the dense oracle the packed layouts are held against.
"""

from __future__ import annotations

from typing import Callable

import torch

from akka_game_of_life_tpu_torch.obs.programs import registered_jit, stencil_cost
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

STATE_DTYPE = torch.uint8

# Moore-8 neighborhood offsets (dy, dx), self excluded.
MOORE_OFFSETS = tuple(
    (dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)
)


def neighbor_counts(alive: torch.Tensor) -> torch.Tensor:
    """Live Moore neighbours on a torus: ``alive`` is a (..., H, W) uint8
    0/1 indicator (a batch of boards rolls each on its own); the result is
    uint8 in 0..8."""
    acc = torch.zeros_like(alive)
    for dy, dx in MOORE_OFFSETS:
        acc = acc + torch.roll(alive, shifts=(dy, dx), dims=(-2, -1))
    return acc


def apply_rule(state: torch.Tensor, counts: torch.Tensor, rule: Rule) -> torch.Tensor:
    """Apply an outer-totalistic (or WireWorld) rule given per-cell live
    neighbour counts.  Generations: a live cell that fails to survive enters
    state 2 and decays to 0; refractory cells block birth and do not count.
    WireWorld: head → tail → conductor, conductor → head iff the head count
    hits the birth mask, empty stays."""
    c = counts.to(torch.int32)
    birth = ((torch.tensor(rule.birth_mask, dtype=torch.int32, device=c.device) >> c) & 1).to(STATE_DTYPE)
    survive = ((torch.tensor(rule.survive_mask, dtype=torch.int32, device=c.device) >> c) & 1).to(STATE_DTYPE)
    one = torch.ones((), dtype=STATE_DTYPE, device=state.device)
    two = one + 1
    if not rule.is_totalistic:  # wireworld (the only non-totalistic kind)
        three = two + 1
        return torch.where(
            state == 1,
            two,
            torch.where(
                state == 2,
                three,
                torch.where((state == 3) & (birth == 1), one, state),
            ),
        )
    if rule.is_binary:
        return torch.where(state == 1, survive, birth)
    nxt = state + 1  # uint8, as the JAX package's (255 wraps to 0)
    decayed = torch.where(nxt < rule.states, nxt, torch.zeros_like(nxt))
    live_next = torch.where(survive == 1, one, two)
    return torch.where(state == 0, birth, torch.where(state == 1, live_next, decayed))


def neighbor_counts_padded(padded_alive: torch.Tensor) -> torch.Tensor:
    """Live Moore neighbours of the interior of a 1-halo-padded indicator:
    (..., H+2, W+2) → (..., H, W) uint8, from eight slices (no wrap)."""
    h, w = padded_alive.shape[-2] - 2, padded_alive.shape[-1] - 2
    acc = torch.zeros_like(padded_alive[..., 1:-1, 1:-1])
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if (dy, dx) != (1, 1):
                acc = acc + padded_alive[..., dy : dy + h, dx : dx + w]
    return acc


def alive_mask(state: torch.Tensor) -> torch.Tensor:
    """0/1 live indicator (state == 1)."""
    return (state == 1).to(STATE_DTYPE)


def step(state: torch.Tensor, rule) -> torch.Tensor:
    """One toroidal step of a (H, W) uint8 board, or of each board of an
    (N, H, W) batch (every kind but ltl)."""
    rule = resolve_rule(rule)
    if rule.kind == "ltl":
        from akka_game_of_life_tpu_torch.ops import ltl

        return ltl.step_ltl(state, rule)
    return apply_rule(state, neighbor_counts(alive_mask(state)), rule)


def step_padded(padded: torch.Tensor, rule) -> torch.Tensor:
    """One step on a tile padded with a radius-deep halo: (H+2R, W+2R) →
    (H, W); R is 1 for every kind except ltl.  The sharded dense path's
    local step."""
    rule = resolve_rule(rule)
    if rule.kind == "ltl":
        from akka_game_of_life_tpu_torch.ops import ltl

        return ltl.step_padded_ltl(padded, rule)
    counts = neighbor_counts_padded(alive_mask(padded))
    return apply_rule(padded[..., 1:-1, 1:-1], counts, rule)


def multi_step(state: torch.Tensor, rule, n_steps: int) -> torch.Tensor:
    """``n_steps`` generations of :func:`step`."""
    rule = resolve_rule(rule)
    for _ in range(n_steps):
        state = step(state, rule)
    return state


def step_fn(rule) -> Callable[[torch.Tensor], torch.Tensor]:
    """One dense generation of :func:`step`, registered on the program
    ledger (family ``stencil``)."""
    rule = resolve_rule(rule)
    return registered_jit(
        "stencil", ("step", rule.name), lambda state: step(state, rule),
        cost=lambda state: stencil_cost(state.shape[-2], state.shape[-1]),
    )


def multi_step_fn(rule, n_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The dense ``n_steps`` stepper: a closure over :func:`multi_step`,
    registered on the program ledger (family ``stencil``)."""
    rule = resolve_rule(rule)
    return registered_jit(
        "stencil", ("multi_step", rule.name, n_steps),
        lambda state: multi_step(state, rule, n_steps),
        cost=lambda state: stencil_cost(state.shape[-2], state.shape[-1], n_steps),
    )
