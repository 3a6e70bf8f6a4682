"""PyTorch/CUDA port of ``akka_game_of_life_tpu``.

The standalone simulator on one NVIDIA GPU: binary Life-like rules on
bit-packed words, Generations and WireWorld on bit planes and
Larger-than-Life on the dense board, stepped by hand-written CUDA kernels
(``csrc/packed_sweep.cu``, ``gen_sweep.cu``, ``ltl_sweep.cu``), with
on-device observation, digests and npz checkpoints compatible with the JAX
package.  It imports ``torch`` and numpy, never ``jax`` nor the JAX package.

    python -m akka_game_of_life_tpu_torch run --config examples/headline-65536.toml
"""

from akka_game_of_life_tpu_torch.ops.rules import NAMED_RULES, Rule, resolve_rule
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig, load_config
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

__all__ = [
    "NAMED_RULES",
    "Rule",
    "Simulation",
    "SimulationConfig",
    "load_config",
    "resolve_rule",
]
