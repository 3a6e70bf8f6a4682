"""The port's orbax-format store (async per-shard saves on DCP), case by case
after ``tests/test_orbax_checkpoint.py``.

Same contract as the JAX package's orbax store: unknown and foreign formats
refused, round-trip and retention, a meshed save, ``Simulation`` resume,
packed binary and Generations round-trips, ``describe_store``, and a save
written by two processes loaded in one.  The directories are per package:
a JAX orbax directory (written here with the JAX package) is refused by
name, and the JAX package's ``make_store(dir, "npz")`` refuses a port one.
Every comparison is exact.
"""

import io
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from akka_game_of_life_tpu.models import get_model as jget_model
from akka_game_of_life_tpu.runtime.checkpoint import make_store as jmake_store
from akka_game_of_life_tpu_torch.runtime.checkpoint import describe_store, make_store
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig, load_config
from akka_game_of_life_tpu_torch.runtime.orbax_store import OrbaxCheckpointStore
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation, initial_board

REPO = Path(__file__).resolve().parent.parent


def _sim(cfg, device="cpu"):
    return Simulation(cfg, observer=BoardObserver(out=io.StringIO()), device=device)


def test_make_store_rejects_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="checkpoint format"):
        make_store(str(tmp_path), "pickle")


def test_make_store_refuses_foreign_format_dir(tmp_path):
    npz = make_store(str(tmp_path / "a"), "npz")
    npz.save(5, np.zeros((4, 4), np.uint8), "B3/S23")
    with pytest.raises(ValueError, match="already holds npz"):
        make_store(str(tmp_path / "a"), "orbax")

    orb = make_store(str(tmp_path / "b"), "orbax")
    orb.save(5, np.zeros((4, 4), np.uint8), "B3/S23")
    orb.close()
    with pytest.raises(ValueError, match="already holds orbax"):
        make_store(str(tmp_path / "b"), "npz")
    # The JAX package sees a foreign format, not an empty directory.
    with pytest.raises(ValueError, match="already holds orbax"):
        jmake_store(str(tmp_path / "b"), "npz")


def test_jax_orbax_directory_refused_by_name(tmp_path):
    jstore = jmake_store(str(tmp_path), "orbax")
    jstore.save(5, np.zeros((8, 8), np.uint8), "B3/S23")
    jstore.close()
    for fmt in ("orbax", "npz"):
        with pytest.raises(ValueError, match="written by the JAX package's orbax store"):
            make_store(str(tmp_path), fmt)
    assert list(describe_store(str(tmp_path))) == []


def test_orbax_roundtrip_and_retention(tmp_path):
    store = make_store(str(tmp_path), "orbax", keep=2)
    rng = np.random.default_rng(0)
    boards = {}
    for epoch in (10, 20, 30):
        boards[epoch] = rng.integers(0, 3, size=(16, 16), dtype=np.uint8)
        store.save(epoch, boards[epoch], "/2/3", meta={"height": 16, "width": 16})
    store.wait()
    assert store.latest_epoch() == 30
    ckpt = store.load()
    assert ckpt.epoch == 30 and ckpt.rule == "/2/3"
    np.testing.assert_array_equal(ckpt.board, boards[30])
    np.testing.assert_array_equal(store.load(20).board, boards[20])
    # keep=2: epoch 10 is gone, and no unfinished step is left behind.
    with pytest.raises(FileNotFoundError):
        store.load(10)
    store.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["20", "30"]


def test_unfinished_step_is_not_an_epoch(tmp_path):
    store = make_store(str(tmp_path), "orbax")
    store.save(4, np.ones((8, 8), np.uint8), "B3/S23")
    store.close()
    (tmp_path / "8.dcp-tmp" / "state").mkdir(parents=True)
    assert OrbaxCheckpointStore(str(tmp_path)).epochs() == [4]
    # A directory holding only an unfinished save is still this store's.
    (tmp_path / "c" / "12.dcp-tmp").mkdir(parents=True)
    with pytest.raises(ValueError, match="already holds orbax"):
        make_store(str(tmp_path / "c"), "npz")


def test_orbax_accepts_sharded_tiles(tmp_path):
    from akka_game_of_life_tpu_torch.parallel import make_grid_mesh, shard_board

    mesh = make_grid_mesh((2, 4), ["cpu"] * 8)
    board = (np.random.default_rng(1).random((32, 32)) < 0.5).astype(np.uint8)
    tiles = shard_board(board, mesh)
    store = make_store(str(tmp_path), "orbax")
    store.save(7, tiles, "B3/S23", mesh=mesh)
    store.wait()
    np.testing.assert_array_equal(store.load().board, board)
    assert store.step_meta(7)["mesh"] == [2, 4]
    store.close()


def test_simulation_resume_from_orbax(tmp_path):
    over = {
        "height": 24, "width": 24, "seed": 5, "steps_per_call": 5,
        "checkpoint_dir": str(tmp_path), "checkpoint_every": 5,
        "checkpoint_format": "orbax",
    }
    sim = _sim(load_config(None, dict(over, max_epochs=10)))
    sim.advance()
    sim.flush()
    assert sim.store.latest_epoch() == 10
    sim.close()

    resumed = _sim(load_config(None, dict(over, max_epochs=10)))
    assert resumed.epoch == 10
    resumed.advance(10)
    oracle = _sim(load_config(None, {"height": 24, "width": 24, "seed": 5, "max_epochs": 20}))
    oracle.advance()
    np.testing.assert_array_equal(resumed.board_host(), oracle.board_host())
    resumed.close()


def test_meshed_sweep_resume_from_orbax(tmp_path):
    """The sharded sweep on an (8, 1) mesh writing per-tile saves, and a
    fresh meshed Simulation resuming them."""
    over = {
        "height": 64, "width": 64, "seed": 13, "steps_per_call": 8,
        "kernel": "pallas", "mesh_shape": (8, 1), "pallas_block_rows": 8,
        "checkpoint_dir": str(tmp_path), "checkpoint_every": 8,
        "checkpoint_format": "orbax",
    }
    sim = _sim(load_config(None, dict(over, max_epochs=16)), device=["cpu"] * 8)
    assert sim.kernel == "sweep" and sim.mesh is not None
    sim.advance()
    sim.close()
    assert OrbaxCheckpointStore(str(tmp_path)).step_meta(16)["mesh"] == [8, 1]

    resumed = _sim(load_config(None, dict(over, max_epochs=16)), device=["cpu"] * 8)
    assert resumed.epoch == 16 and resumed.mesh is not None
    resumed.advance(8)
    oracle = _sim(load_config(None, {"height": 64, "width": 64, "seed": 13, "max_epochs": 24}))
    oracle.advance()
    np.testing.assert_array_equal(resumed.board_host(), oracle.board_host())
    resumed.close()


@pytest.mark.parametrize("rule", ["conway", "brians-brain"])
def test_orbax_packed_roundtrip_binary_and_gen(tmp_path, rule):
    mk = lambda kern: SimulationConfig(  # noqa: E731
        height=64, width=64, rule=rule, seed=31, steps_per_call=8, kernel=kern,
        checkpoint_dir=str(tmp_path), checkpoint_format="orbax", checkpoint_every=8,
    )
    sim = _sim(mk("bitpack"))
    assert sim.layout in ("words", "planes")
    sim.advance(16)
    want16 = sim.board_host()
    sim.close()
    assert OrbaxCheckpointStore(str(tmp_path)).step_meta(16)["layout"] == "packed32"

    resumed = _sim(mk("bitpack"))
    assert resumed.epoch == 16
    np.testing.assert_array_equal(resumed.board_host(), want16)
    resumed.close()

    dense = _sim(mk("dense"))
    assert dense.epoch == 16
    dense.advance(8)
    oracle = np.asarray(jget_model(rule).run(24)(jnp.asarray(initial_board(mk("dense")))))
    np.testing.assert_array_equal(dense.board_host(), oracle)
    dense.close()


def test_describe_store_orbax(tmp_path):
    store = make_store(str(tmp_path), "orbax", keep=5)
    board = np.arange(64, dtype=np.uint8).reshape(8, 8) % 2
    store.save(4, board, "B3/S23")
    store.save(8, board, "B3/S23")
    store.close()

    # rule/shape/layout are present even WITHOUT validate.
    infos = list(describe_store(str(tmp_path)))
    assert [i["epoch"] for i in infos] == [4, 8]
    assert all(i["store"] == "orbax" and i["layout"] == "device-native" for i in infos)
    assert all(i["rule"] == "B3/S23" and i["shape"] == [8, 8] for i in infos)
    assert all(i["bytes"] > 0 and "ok" not in i for i in infos)

    infos = list(describe_store(str(tmp_path), validate=True))
    assert all(i["ok"] for i in infos)


def test_describe_store_validates_the_recorded_digest(tmp_path):
    cfg = SimulationConfig(height=32, width=64, seed=2, steps_per_call=4, obs_digest=True,
                           checkpoint_dir=str(tmp_path), checkpoint_every=4,
                           checkpoint_format="orbax")
    with _sim(cfg) as sim:
        sim.advance(8)
        digest = sim.board_digest()
    infos = list(describe_store(str(tmp_path), validate=True))
    assert [i["epoch"] for i in infos] == [4, 8]
    assert all(i["ok"] and i["digest_ok"] for i in infos)
    assert infos[-1]["digest"] == f"{digest:016x}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_save_loads_in_one_process(tmp_path):
    """``run --distributed --checkpoint-format orbax`` on two processes (a
    (2, 1) mesh over gloo): each rank writes its own tile; one process with
    no mesh loads the step and resumes it to the oracle's board."""
    port = _free_port()
    ck = tmp_path / "ck"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    argv = [
        "run", "--distributed", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
        "--device", "cpu", "--height", "32", "--width", "64", "--seed", "6",
        "--max-epochs", "8", "--steps-per-call", "4", "--checkpoint-dir", str(ck),
        "--checkpoint-every", "4", "--checkpoint-format", "orbax", "--metrics-every", "4",
    ]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "akka_game_of_life_tpu_torch", *argv, "--process-id", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp_path,
        )
        for r in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    store = OrbaxCheckpointStore(str(ck))
    assert store.epochs() == [4, 8]
    meta = store.step_meta(8)
    assert meta["mesh"] == [2, 1] and meta["layout"] == "packed32"
    assert sorted(p.name for p in (ck / "8" / "state").glob("*.distcp")) == [
        "__0_0.distcp", "__1_0.distcp",
    ]
    cfg = SimulationConfig(height=32, width=64, seed=6, steps_per_call=4)
    oracle = np.asarray(jget_model("conway").run(8)(jnp.asarray(initial_board(cfg))))
    np.testing.assert_array_equal(store.load(8).board, oracle)
    resumed = _sim(SimulationConfig(height=32, width=64, seed=6, steps_per_call=4,
                                    checkpoint_dir=str(ck), checkpoint_format="orbax"))
    assert resumed.epoch == 8 and resumed.mesh is None
    resumed.advance(4)
    np.testing.assert_array_equal(
        resumed.board_host(),
        np.asarray(jget_model("conway").run(12)(jnp.asarray(initial_board(cfg)))),
    )
    resumed.close()
