"""Cells shrunk to sizes a CPU test holds: the same drivers, references
and comparisons, on a 256 x 256 board or 8 sessions of 32 x 32."""

from benchmark.core import spec

SEED = 2 ** 31 + 11


def small_cell(name: str, **kwargs) -> spec.Cell:
    cell = spec.load_cell(name, **kwargs)
    if cell.mix["driver"] == "run_chunks":
        cell.config["run"].update(height=256, width=256)
    else:
        cell.mix.update(sessions=8, height=32, width=32, steps=16, reference_sessions=4,
                        rate_per_s=20, drain_seconds=20)
    return cell
