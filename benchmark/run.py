"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's set-up (build, load, warm-up) is
followed by ``--seconds`` of measurement and the comparison with the plain
reference; the last line of standard output is one JSON object (see
``benchmark/README.md``).  Exits 2 without the CUDA devices the cell
needs, 3 if JAX or the JAX package was loaded.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Every compile cache at a fixed path inside the checkout, set before torch
# is imported: only a checkout's first run of a cell builds.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT))

from benchmark.core.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
