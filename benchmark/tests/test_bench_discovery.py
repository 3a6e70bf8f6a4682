"""The harness finds cells, configurations, metrics and drivers by name:
a cell, a configuration and a metric added as files to a copy of the
benchmark run with no file of it edited."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.core import harness, spec
from small import SEED

ROOT = spec.ROOT


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_a_new_cell_config_and_metric_are_files_and_entries(copy):
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    config = json.loads((copy / "benchmark/configs/conway-65536.json").read_text())
    config["run"].update(height=128, width=128)
    (copy / "benchmark/configs/conway-128.json").write_text(json.dumps(config))
    mix = json.loads((copy / "benchmark/workloads/conway-65536.stream.json").read_text())
    (copy / "benchmark/workloads/conway-128.stream.json").write_text(json.dumps(mix))
    (copy / "benchmark/metrics/calls_in_window.py").write_text(
        "def read(r):\n    return r.counts['calls']\n")
    bench["configs"].append({"name": "conway-128", "source": "a test", "file": "benchmark/configs/conway-128.json",
                             "reduced": ["height", "width"], "why": "a test"})
    bench["workloads"].append({"name": "conway-128.stream", "config": "conway-128", "traffic": "stream",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "L2", "moves": "run_cell_updates_per_s",
                               "workloads": ["conway-128.stream"]})
    for m in bench["end_to_end"]:
        if m["name"] == "run_cell_updates_per_s":
            m["workloads"].append("conway-128.stream")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("conway-128.stream", copy / "BENCHMARK.json", copy / "benchmark")
    assert cell.config["run"]["height"] == 128
    assert {m["name"] for m in cell.per_layer} == {"calls_in_window"}
    outcome, metrics = harness.run_cell(cell, SEED, 1.0, True, "cpu")
    assert metrics["calls_in_window"]["value"] == outcome.attempted > 0
    assert all(c.ok for c in outcome.checks)


def test_every_cell_names_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.driver().run and cell.reference().step
        assert set(cell.readers()) == {m["name"] for m in cell.per_layer}
        assert cell.per_layer and any(m["name"] != "setup_s" for m in cell.end_to_end)


def test_run_without_a_card_exits_2_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "conway-65536.stream",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
