"""Layered configuration for the standalone run: defaults < file < overrides.

Counterpart of ``akka_game_of_life_tpu/runtime/config.py`` restricted to the
fields the PyTorch port honours so far.  ``load_config`` reads the same TOML
or JSON files (``examples/headline-65536.toml`` loads unchanged).  A key the
port does not support yet — a mesh, chaos, ``obs_defer``, cluster or serve
knob, or any other — raises a ``ValueError`` that names it, never a silent
default.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

# The JAX package's kernel names.  auto/pallas step through the CUDA kernels
# (the packed sweep, the plane sweep, the LtL step; auto runs the dense
# stencil on widths that are not a multiple of 32 and for the LtL diamond),
# bitpack through the plain packed/plane step, dense through the plain dense
# stencil; matmul waits for a later port slice (the Simulation refuses it).
KERNEL_CHOICES = ("auto", "dense", "bitpack", "pallas", "matmul")


@dataclasses.dataclass
class SimulationConfig:
    """The knobs of one standalone run, with the JAX package's names and
    defaults."""

    height: int = 64
    width: int = 64
    rule: str = "conway"
    density: float = 0.5
    seed: int = 0
    pattern: Optional[str] = None
    pattern_offset: Tuple[int, int] = (2, 2)
    max_epochs: Optional[int] = None
    kernel: str = "auto"
    steps_per_call: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # epochs between checkpoints; 0 = disabled
    render_every: int = 0  # epochs between rendered frames; 0 = never
    render_max_cells: int = 128  # stride-sample larger boards down to this
    # Exact-cell window (y0, y1, x0, x1) printed at render cadence.
    probe_window: Optional[Tuple[int, int, int, int]] = None
    log_file: Optional[str] = None
    metrics_every: int = 0
    # The 64-bit on-device board digest on every metrics line.
    obs_digest: bool = False

    def __post_init__(self) -> None:
        if self.height <= 0 or self.width <= 0:
            raise ValueError(f"board must be positive, got {self.height}x{self.width}")
        if self.kernel not in KERNEL_CHOICES:
            raise ValueError(
                f"unknown kernel {self.kernel!r}; choose from {KERNEL_CHOICES}"
            )
        if self.steps_per_call < 1:
            raise ValueError(f"steps_per_call={self.steps_per_call} must be >= 1")
        for name in ("checkpoint_every", "render_every", "metrics_every"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name}={getattr(self, name)} must be >= 0")
        if self.render_max_cells < 1:
            raise ValueError(
                f"render_max_cells={self.render_max_cells} must be >= 1"
            )
        if self.probe_window is not None:
            y0, y1, x0, x1 = self.probe_window
            if not (0 <= y0 < y1 <= self.height and 0 <= x0 < x1 <= self.width):
                raise ValueError(
                    f"probe_window {self.probe_window} out of bounds for "
                    f"{self.height}x{self.width}"
                )

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


# The reference's config spellings the JAX package also accepts.
_ALIASES = {"x": "width", "y": "height"}


def _normalize(data: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in data.items():
        key = _ALIASES.get(key, key.replace("-", "_"))
        if isinstance(value, Mapping) and key in ("board", "game_of_life"):
            out.update(_normalize(value))
            continue
        out[key] = value
    return out


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Mapping[str, Any]] = None,
) -> SimulationConfig:
    """Build a config with layered precedence: defaults < file < overrides
    (``None`` overrides are ignored).  ``path`` may be TOML or JSON."""
    merged: Dict[str, Any] = {}
    if path is not None:
        p = Path(path)
        text = p.read_text()
        if p.suffix == ".json":
            data = json.loads(text)
        else:
            import tomllib

            data = tomllib.loads(text)
        merged.update(_normalize(data))
    if overrides:
        merged.update(_normalize({k: v for k, v in overrides.items() if v is not None}))
    fields = {f.name for f in dataclasses.fields(SimulationConfig)}
    unsupported = sorted(set(merged) - fields)
    if unsupported:
        raise ValueError(
            f"config keys {unsupported} are not supported by the PyTorch "
            f"port yet (it honours {sorted(fields)})"
        )
    for key in ("pattern_offset", "probe_window"):
        if merged.get(key) is not None:
            merged[key] = tuple(merged[key])
    return SimulationConfig(**merged)
