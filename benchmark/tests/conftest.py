"""The benchmark's own tests (CPU; tests marked ``cuda`` need the card).

    python -m pytest benchmark/tests -q

They shrink each cell's board or mix in memory and drive the harness on
the CPU, where the program runs its plain versions.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
