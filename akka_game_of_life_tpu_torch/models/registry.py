"""Model registry: the CA families the port ships.

Counterpart of ``akka_game_of_life_tpu/models/registry.py``: each model is a
rule with its dense stepper — binary life-likes, Generations (Brian's Brain,
Star Wars), WireWorld and Larger-than-Life (``bugs``), plus any rulestring on
demand.  ``run(k)`` is the dense k-generation stepper the standalone run
uses under ``kernel=dense``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from akka_game_of_life_tpu_torch.ops import stencil
from akka_game_of_life_tpu_torch.ops.rules import NAMED_RULES, Rule, resolve_rule
from akka_game_of_life_tpu_torch.utils.patterns import random_grid


@dataclasses.dataclass(frozen=True)
class CAModel:
    """A cellular-automaton model: rule + init + step."""

    rule: Rule

    @property
    def name(self) -> str:
        return str(self.rule)

    @property
    def dtype(self) -> torch.dtype:
        return stencil.STATE_DTYPE

    def init(
        self, shape: Tuple[int, int], *, density: float = 0.5, seed: int = 0
    ) -> np.ndarray:
        return random_grid(shape, density=density, seed=seed, states=self.rule.states)

    @property
    def step(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return stencil.step_fn(self.rule)

    def run(self, n_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
        return stencil.multi_step_fn(self.rule, n_steps)


def get_model(spec) -> CAModel:
    """Build a model from a Rule, a registered name, or any rulestring."""
    return CAModel(rule=resolve_rule(spec))


def list_models() -> Tuple[str, ...]:
    return tuple(sorted(NAMED_RULES))
