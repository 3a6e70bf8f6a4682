"""The port's standalone run against the JAX package's, end to end on the CPU.

Populations and ``digest=`` on every cadence line, checkpoints resumed across
the two packages, and the two CLIs' ``run --obs-digest`` output must agree.
Also: config loading, the device rule (CUDA unless the caller asks for the
CPU; no silent move), and the kernels the slice refuses.
"""

import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
from akka_game_of_life_tpu.runtime.render import BoardObserver as JObserver
from akka_game_of_life_tpu.runtime.simulation import Simulation as JSimulation
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.ops import bitpack, packed_sweep
from akka_game_of_life_tpu_torch.runtime import simulation as tsim
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig, load_config
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver

REPO = Path(__file__).resolve().parent.parent
_LINE = re.compile(r"^epoch (\d+): pop=(\d+) .*digest=([0-9a-f]{16})$", re.M)

BASE = dict(
    height=64, width=64, rule="conway", seed=11, steps_per_call=8,
    render_every=16, metrics_every=16, obs_digest=True,
)


def _lines(text):
    return _LINE.findall(text)


def _run_jax(epochs, **kw):
    out = io.StringIO()
    cfg = JConfig(**{**BASE, "kernel": "bitpack", **kw})
    sim = JSimulation(cfg, observer=JObserver(out=out, metrics_every=16))
    sim.advance(epochs)
    sim.close()
    return out.getvalue(), sim


def _run_port(epochs, **kw):
    out = io.StringIO()
    cfg = SimulationConfig(**{**BASE, **kw})
    sim = tsim.Simulation(
        cfg, observer=BoardObserver(out=out, metrics_every=16), device="cpu"
    )
    sim.advance(epochs)
    sim.close()
    return out.getvalue(), sim


@pytest.mark.parametrize("kernel", ["auto", "bitpack"])
def test_simulation_matches_jax(kernel):
    jtext, jsim = _run_jax(64)
    ttext, tsim_ = _run_port(64, kernel=kernel)
    assert len(_lines(jtext)) == 4
    assert _lines(ttext) == _lines(jtext)
    np.testing.assert_array_equal(tsim_.board_host(), jsim.board_host())
    assert tsim_.kernel == {"auto": "sweep", "bitpack": "bitpack"}[kernel]


def test_probe_window_and_partial_chunk_match_jax():
    kw = dict(pattern="gosper-glider-gun", probe_window=(2, 11, 2, 38), steps_per_call=7)
    _, jsim = _run_jax(30, **kw)
    _, tsim_ = _run_port(30, **kw)
    np.testing.assert_array_equal(
        tsim_.board_window(2, 11, 2, 38), jsim.board_window(2, 11, 2, 38)
    )
    # Period 30: the gun's bounding box is back in phase.
    gun = tsim.initial_board(SimulationConfig(**{**BASE, **kw}))[2:11, 2:38]
    np.testing.assert_array_equal(tsim_.board_window(2, 11, 2, 38), gun)
    assert tsim_.board_digest() == jsim.board_digest()


@pytest.mark.parametrize("offset", [(2, 2), (60, 50)])
def test_initial_words_match_dense_board(offset):
    cfg = SimulationConfig(
        height=64, width=64, pattern="gosper-glider-gun", pattern_offset=offset
    )
    np.testing.assert_array_equal(
        tsim.initial_words(cfg), bitpack.pack_np(tsim.initial_board(cfg))
    )


def test_checkpoints_cross_resume(tmp_path):
    """A checkpoint written by either package resumes in the other to the
    same digest as an uninterrupted run."""
    _, whole = _run_port(48)
    want = whole.board_digest()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    _run_jax(16, checkpoint_dir=str(jdir), checkpoint_every=16)
    _run_port(16, checkpoint_dir=str(tdir), checkpoint_every=16)
    # The JAX checkpoint resumes in the port and vice versa.
    _, t_from_j = _run_port(32, checkpoint_dir=str(jdir), checkpoint_every=0)
    _, j_from_t = _run_jax(32, checkpoint_dir=str(tdir), checkpoint_every=0)
    assert t_from_j.epoch == j_from_t.epoch == 48
    assert t_from_j.board_digest() == j_from_t.board_digest() == want


@pytest.mark.parametrize("states", [2, 3])
def test_dense_checkpoint_files_cross_load(states, tmp_path):
    """Dense saves (packbits for binary, raw uint8 otherwise) load in the
    other package with the same board, epoch, rule and meta."""
    from akka_game_of_life_tpu.runtime.checkpoint import CheckpointStore as JStore
    from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore as TStore

    board = np.random.default_rng(states).integers(0, states, (12, 40), dtype=np.uint8)
    TStore(str(tmp_path / "t")).save(7, board, "B3/S23", meta={"k": 1})
    JStore(str(tmp_path / "j")).save(7, board, "B3/S23", meta={"k": 1})
    for got in (JStore(str(tmp_path / "t")).load(), TStore(str(tmp_path / "j")).load()):
        assert (got.epoch, got.rule, got.meta) == (7, "B3/S23", {"k": 1})
        np.testing.assert_array_equal(got.board, board)


def test_cli_matches_jax_cli(capsys, tmp_path):
    from akka_game_of_life_tpu import cli as jcli

    args = [
        "--rule", "highlife", "--height", "48", "--width", "64", "--seed", "3",
        "--max-epochs", "40", "--steps-per-call", "10", "--metrics-every", "10",
        "--obs-digest",
    ]
    assert jcli.main(["run", "--platform", "cpu", *args]) == 0
    jtext = capsys.readouterr().out
    assert tcli.main(["run", "--device", "cpu", *args]) == 0
    ttext = capsys.readouterr().out
    assert len(_lines(jtext)) == 4
    assert _lines(ttext) == _lines(jtext)
    assert '"kernel": "sweep"' in ttext


def test_headline_config_loads_unchanged():
    cfg = load_config(str(REPO / "examples" / "headline-65536.toml"))
    assert cfg.shape == (65536, 65536)
    assert (cfg.rule, cfg.pattern, cfg.max_epochs) == ("conway", "gosper-glider-gun", 240)
    assert (cfg.steps_per_call, cfg.render_every, cfg.metrics_every) == (60, 60, 60)
    assert cfg.probe_window == (2, 11, 2, 38)
    assert (cfg.checkpoint_dir, cfg.checkpoint_every) == ("ckpt-65536", 120)


@pytest.mark.parametrize(
    "key,value",
    [("pallas_vmem_limit_mb", 16), ("pallas_block_rows", 0), ("serve_memo", True)],
)
def test_unsupported_keys_raise_by_name(key, value, tmp_path):
    with pytest.raises(ValueError, match=key):
        load_config(None, {key: value})
    path = tmp_path / "c.toml"
    path.write_text(f"height = 64\n{key} = {str(value).lower()}\n")
    with pytest.raises(ValueError, match=key):
        load_config(str(path))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.Simulation(SimulationConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["run", "--height", "32", "--width", "32", "--max-epochs", "1"])


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(kernel="matmul", mesh_shape=(1, 1)), "single-device"),
        (dict(kernel="pallas", rule="R2,B3-5,S2-6,NN"), "box neighborhoods"),
        (dict(kernel="bitpack", rule="bugs"), "totalistic and wireworld"),
        (dict(kernel="bitpack", width=48), "width % 32"),
        (dict(kernel="pallas", rule="brians-brain", width=48), "width % 32"),
        (dict(exchange_width=4), "exchange_width"),
    ],
)
def test_refuses_what_later_slices_bring(kw, match):
    with pytest.raises(ValueError, match=match):
        tsim.Simulation(load_config(None, kw), device="cpu")


def test_cpu_run_launches_no_kernel():
    before = packed_sweep.packed_sweep.launches
    _run_port(16)
    assert packed_sweep.packed_sweep.launches == before
