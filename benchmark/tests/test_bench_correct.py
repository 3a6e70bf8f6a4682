"""``correct`` on the CPU at test sizes: sound runs pass; the control
(the reference with the torus broken, in the program's place) and every
fault the cells can have, planted in the program underneath a whole run,
come out false.  The exchange between chips is no fault these cells can
have: each runs on one chip."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import control as bench_control
from benchmark.core import harness, spec
from small import SEED, small_cell

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONWAY = [c for c in CELLS if spec.load_cell(c).mix["driver"] == "run_chunks"]
SERVE = [c for c in CELLS if spec.load_cell(c).mix["driver"] == "serve_clients"]


def correct(name: str) -> bool:
    outcome, _ = harness.run_cell(small_cell(name), SEED, 1.0, False, "cpu")
    return all(c.ok for c in outcome.checks)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert correct(name)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    checks = bench_control.control(small_cell(name), SEED, "cpu", 2.0)
    assert not all(c.ok for c in checks)


def _sweep_fault(kind):
    from akka_game_of_life_tpu_torch.ops import packed_sweep

    real = packed_sweep.packed_multi_step_fn

    def factory(rule, k, **kw):
        step = real(rule, k, **kw)

        def run(words):
            if kind == "unchanged":
                return words.clone()
            out = step(words)
            if kind == "half":
                out[words.shape[0] // 2:] = words[words.shape[0] // 2:]
            elif kind == "altered":
                out = out.clone()
                out[5, 3] ^= 1
            return out

        return run

    return packed_sweep, "packed_multi_step_fn", factory


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CONWAY)
def test_a_faulty_sweep_is_not_correct(name, kind, monkeypatch):
    monkeypatch.setattr(*_sweep_fault(kind))
    assert not correct(name)


@pytest.mark.parametrize("name", CONWAY)
def test_an_altered_population_is_not_correct(name, monkeypatch):
    from akka_game_of_life_tpu_torch.ops import bitpack

    real = bitpack.population_rows
    monkeypatch.setattr(bitpack, "population_rows", lambda words: real(words) + (torch.arange(
        words.shape[0], device=words.device) == 0).to(real(words).dtype))
    assert not correct(name)


def _batch_fault(kind):
    from akka_game_of_life_tpu_torch.serve import batch

    real = batch.batch_step_fn

    def factory(cls, length, device):
        step = real(cls, length, device)

        def run(boards, birth, survive, states, h, w, n):
            n = np.array(n)
            if kind == "unchanged":
                n[:] = 0
            elif kind == "half":
                n[len(n) // 2:] = 0
            out, lanes = step(boards, birth, survive, states, h, w, n)
            if kind == "altered":
                lanes = lanes.clone()
                lanes[0, 0] ^= 1
            return out, lanes

        return run

    return batch, "batch_step_fn", factory


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", SERVE)
def test_a_faulty_batched_step_is_not_correct(name, kind, monkeypatch):
    monkeypatch.setattr(*_batch_fault(kind))
    assert not correct(name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_own_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.load_cell(name)
    t = time.perf_counter()
    checks = bench_control.control(cell, SEED, "cuda", 51.0)
    assert not all(c.ok for c in checks), (time.perf_counter() - t, checks)
