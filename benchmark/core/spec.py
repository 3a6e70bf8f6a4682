"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``benchmark/configs/<config>.json``;
- a cell's traffic mix: ``benchmark/workloads/<cell>.json``, which names its
  driver, ``benchmark/traffic/<driver>.py``;
- a per-layer metric's reader: ``benchmark/metrics/<metric>.py``;
- a configuration's plain reference: ``benchmark/references/<reference>.py``,
  named by the configuration's file.

A new cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path) -> ModuleType:
    """A module from its file (names may hold dots: ``idle_share.run.py``)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(f"bench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    mix: dict
    # The end-to-end metrics this cell reports, and the per-layer ones.
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path = BENCH_DIR

    def driver(self) -> ModuleType:
        return load_module(self.bench_dir / "traffic" / f"{self.mix['driver']}.py")

    def reference(self) -> ModuleType:
        return load_module(self.bench_dir / "references" / f"{self.config['reference']}.py")

    def readers(self) -> Dict[str, ModuleType]:
        return {
            m["name"]: load_module(self.bench_dir / "metrics" / f"{m['name']}.py")
            for m in self.per_layer
        }


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json", bench_dir: Path = BENCH_DIR) -> Cell:
    spec = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {bench_file.name}; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((bench_dir.parent / configs[w["config"]]["file"]).read_text())
    mix = json.loads((bench_dir / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if m["moves"] in e2e_names and _reports(m, name)]
    return Cell(name, int(w["chips"]), config, mix, e2e, per_layer, bench_dir)
