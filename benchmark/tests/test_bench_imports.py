"""What the benchmark loads: no JAX and no JAX package in the process
that runs a cell, compared by top-level names whole (the port's name
begins with the JAX package's); nothing of the program in the reference."""

import json
import subprocess
import sys

from benchmark.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "akka_game_of_life_tpu"}

RUN_CELLS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/benchmark/tests")
from benchmark.core import harness
from small import SEED, small_cell
for name in json.loads(sys.argv[2]):
    for trace in (False, True):
        harness.run_cell(small_cell(name), SEED, 1.0, trace, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark.core.spec import BENCH_DIR, load_module
import torch
for path in sorted((BENCH_DIR / "references").glob("*.py")):
    ref = load_module(path)
    b = ref.run(torch.ones((2, 8, 8), dtype=torch.uint8), 3, ["conway", "star-wars"])
    ref.digest(b)
    ref.random_grid(8, 8, 0.5, 1)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code, *args):
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT), *args],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax():
    cells = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
    loaded = _modules(RUN_CELLS, json.dumps(cells))
    assert "akka_game_of_life_tpu_torch" in loaded  # the program ran
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(REFERENCE)
    assert not loaded & (FORBIDDEN | {"akka_game_of_life_tpu_torch"})
