"""The port's standalone run on the bit-plane and dense layouts against the
JAX package's, end to end on the CPU.

The two CLIs' ``run --obs-digest`` must print the same ``digest=`` line at
every cadence epoch for Generations and WireWorld (bit planes), for
Larger-than-Life through the LtL kernel's wrapper and through the plain
dense step, for the diamond, and for a binary rule on a width that is not a
multiple of 32 (dense under ``auto``).  Layout-3 (planes) and dense
checkpoints resume across the two packages both ways.
"""

import io
import re

import numpy as np
import pytest

from akka_game_of_life_tpu import cli as jcli
from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
from akka_game_of_life_tpu.runtime.render import BoardObserver as JObserver
from akka_game_of_life_tpu.runtime.simulation import Simulation as JSimulation
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.ops import bitpack_gen
from akka_game_of_life_tpu_torch.runtime import simulation as tsim
from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver

_LINE = re.compile(r"^epoch (\d+): pop=(\d+) .*digest=([0-9a-f]{16})$", re.M)
_KERNEL = re.compile(r'"kernel": "(\w+)"')

ARGS = [
    "--height", "64", "--width", "64", "--seed", "3", "--max-epochs", "16",
    "--steps-per-call", "4", "--metrics-every", "4", "--obs-digest",
]
CASES = {
    "wireworld-clock": (["--rule", "wireworld", "--pattern", "wireworld-clock"], "gen_sweep"),
    "brians-brain": (["--rule", "brians-brain"], "gen_sweep"),
    "star-wars": (["--rule", "star-wars"], "gen_sweep"),
    "B2/S/7": (["--rule", "B2/S/7", "--density", "0.05"], "gen_sweep"),
    "bugs-pallas": (["--rule", "bugs", "--kernel", "pallas"], "ltl_sweep"),
    "bugs-dense": (["--rule", "bugs", "--kernel", "dense"], "dense"),
    "diamond": (["--rule", "R2,B3-5,S2-6,NN"], "dense"),
    "conway-48": (["--rule", "conway", "--width", "48"], "dense"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax_cli(case, capsys):
    extra, kernel = CASES[case]
    assert jcli.main(["run", "--platform", "cpu", *ARGS, *extra]) == 0
    jtext = capsys.readouterr().out
    assert tcli.main(["run", "--device", "cpu", *ARGS, *extra]) == 0
    ttext = capsys.readouterr().out
    lines = _LINE.findall(jtext)
    assert [e for e, _, _ in lines] == ["4", "8", "12", "16"]
    assert int(lines[-1][1]) > 0  # the board is still alive
    assert _LINE.findall(ttext) == lines
    assert _KERNEL.findall(ttext) == [kernel]


def test_pattern_planes_start_and_windows_match_jax():
    """The clock's planes are packed from its rows only; its probe window
    is in phase every 10 epochs in both packages."""
    kw = dict(
        height=64, width=64, rule="wireworld", pattern="wireworld-clock",
        pattern_offset=(60, 62), steps_per_call=5,
    )
    cfg = SimulationConfig(**kw)
    np.testing.assert_array_equal(
        tsim.initial_planes(cfg, 4), bitpack_gen.pack_gen_np(tsim.initial_board(cfg), 4)
    )
    jsim = JSimulation(JConfig(**kw, kernel="bitpack"), observer=JObserver(out=io.StringIO()))
    port = tsim.Simulation(cfg, observer=BoardObserver(out=io.StringIO()), device="cpu")
    start = port.board_window(58, 64, 58, 64)
    for sim in (jsim, port):
        sim.advance(20)
    np.testing.assert_array_equal(port.board_window(58, 64, 58, 64), start)
    np.testing.assert_array_equal(port.board_window(58, 64, 58, 64), jsim.board_window(58, 64, 58, 64))
    np.testing.assert_array_equal(port.board_host(), jsim.board_host())
    assert port.board_digest() == jsim.board_digest()


def _run(package, epochs, **kw):
    base = dict(
        height=64, width=64, seed=11, steps_per_call=8, metrics_every=8,
        obs_digest=True, **kw,
    )
    if package == "jax":
        sim = JSimulation(JConfig(**base), observer=JObserver(out=io.StringIO()))
    else:
        sim = tsim.Simulation(
            SimulationConfig(**base), observer=BoardObserver(out=io.StringIO()), device="cpu"
        )
    sim.advance(epochs)
    sim.close()
    return sim


@pytest.mark.parametrize(
    "kw,layout",
    [
        (dict(rule="brians-brain", kernel="bitpack"), 3),
        (dict(rule="star-wars", kernel="bitpack"), 3),
        (dict(rule="bugs", kernel="dense"), 1),
    ],
)
def test_checkpoints_cross_resume(kw, layout, tmp_path):
    """A checkpoint written by either package resumes in the other to the
    same digest as an uninterrupted run."""
    want = _run("port", 32, **kw).board_digest()
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    _run("jax", 16, checkpoint_dir=str(jdir), checkpoint_every=16, **kw)
    _run("port", 16, checkpoint_dir=str(tdir), checkpoint_every=16, **kw)
    for d in (jdir, tdir):
        with np.load(next(d.glob("ckpt_*.npz"))) as z:
            assert int(z["packed"]) == layout
    t_from_j = _run("port", 16, checkpoint_dir=str(jdir), **kw)
    j_from_t = _run("jax", 16, checkpoint_dir=str(tdir), **kw)
    assert t_from_j.epoch == j_from_t.epoch == 32
    assert t_from_j.board_digest() == j_from_t.board_digest() == want


def test_layout3_store_round_trip(tmp_path):
    planes = np.random.default_rng(0).integers(0, 2**32, size=(3, 4, 2), dtype=np.uint32)
    store = CheckpointStore(str(tmp_path))
    store.save_packed32(5, planes, (4, 64), "B2/S/7", meta={"k": 1})
    packed = store.load(keep_packed=True)
    np.testing.assert_array_equal(packed.packed32, planes)
    assert (packed.board, packed.rule, packed.meta) == (None, "B2/S/7", {"k": 1})
    np.testing.assert_array_equal(store.load().board, bitpack_gen.unpack_gen_np(planes))
    with pytest.raises(ValueError, match="packed words"):
        store.save_packed32(6, planes[:2], (4, 64), "B2/S/7")


def test_mismatched_checkpoint_layout_raises(tmp_path):
    """Binary words do not resume a plane run: the shapes say so."""
    _run("port", 8, rule="conway", checkpoint_dir=str(tmp_path), checkpoint_every=8)
    with pytest.raises(ValueError, match="planes shape"):
        _run("port", 8, rule="brians-brain", checkpoint_dir=str(tmp_path))
