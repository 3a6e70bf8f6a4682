"""The port's device mesh and its meshed ``run`` against the JAX package's.

``parallel/mesh.py`` (factoring, mesh shapes and errors, shard/gather round
trips) and the meshed ``Simulation``: over a mesh of ``cpu`` slots it must
print the same ``digest=`` lines at every cadence epoch as the JAX
``Simulation`` with the same ``mesh_shape`` on the conftest's virtual CPU
devices, for Conway words, WireWorld planes and bugs (LtL, dense).
Checkpoints resume across mesh shapes, a single device and the two
packages; ``mesh_shape`` and ``halo_width`` load from TOML as the JAX
package loads them; ``run --mesh`` refuses a mesh larger than its devices.
"""

import io
import re

import jax
import numpy as np
import pytest
import torch

from akka_game_of_life_tpu import parallel as jpar
from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
from akka_game_of_life_tpu.runtime.config import load_config as jload
from akka_game_of_life_tpu.runtime.render import BoardObserver as JObserver
from akka_game_of_life_tpu.runtime.simulation import Simulation as JSimulation
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch import parallel as tpar
from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen
from akka_game_of_life_tpu_torch.runtime import simulation as tsim
from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig, load_config
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)

_LINE = re.compile(r"^epoch (\d+): pop=(\d+) .*digest=([0-9a-f]{16})$", re.M)
_FRAME = re.compile(r"^(epoch \d+:\n\[[^\]]*\]\n(?:[.#ox*+=%?]+\n)+)", re.M)


# -- parallel/mesh.py ---------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 13))
def test_factor_2d_matches_jax(n):
    assert tpar.factor_2d(n) == jpar.factor_2d(n)


@pytest.mark.parametrize("shape", [None, (8, 1), (2, 4), (1, 8), (3, 2), (4, 4)])
def test_make_grid_mesh_matches_jax(shape):
    try:
        want = jpar.make_grid_mesh(shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpar.make_grid_mesh(shape, ["cpu"] * 8)
        assert str(got.value) == str(e)
        return
    mesh = tpar.make_grid_mesh(shape, ["cpu"] * 8)
    assert mesh.shape == (want.shape["row"], want.shape["col"])
    assert mesh.size == 8 and mesh.distinct_devices() == [mesh.device_at(0, 0)]


def test_grid_mesh_neighbours_wrap():
    mesh = tpar.make_grid_mesh((4, 2), ["cpu"] * 8)
    assert mesh.coords(5) == (2, 1)
    assert mesh.neighbour(0, "row", -1) == 6  # above row 0 is row 3
    assert mesh.neighbour(7, "row", +1) == 1
    assert mesh.neighbour(1, "col", +1) == 0
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.neighbour(0, "depth", 1)


def test_default_devices_without_cuda(monkeypatch):
    """The default devices are the visible cards: without CUDA the mesh
    raises rather than falling back to the CPU, which is named explicitly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.make_grid_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpar.make_row_mesh(1)
    mesh = tpar.make_grid_mesh(devices=["cpu"])
    assert [str(d) for d in mesh.devices] == ["cpu"] and mesh.shape == (1, 1)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 2), (2, 4), (8, 1), (1, 8)])
@pytest.mark.parametrize("layout", ["dense", "words", "planes"])
def test_shard_gather_round_trip(mesh_shape, layout):
    rng = np.random.default_rng(3)
    board = rng.integers(0, 4, size=(64, 256)).astype(np.uint8)
    host = {
        "dense": board,
        "words": bitpack.pack_np(board & 1),
        "planes": bitpack_gen.pack_gen_np(board, 4),
    }[layout]
    n = mesh_shape[0] * mesh_shape[1]
    mesh = tpar.make_grid_mesh(mesh_shape, ["cpu"] * n)
    tiles = tpar.shard_board(host, mesh)
    assert len(tiles) == n and all(t.is_contiguous() for t in tiles)
    r, c = mesh.coords(n - 1)
    th, tw = host.shape[-2] // mesh_shape[0], host.shape[-1] // mesh_shape[1]
    np.testing.assert_array_equal(
        tiles[-1].numpy().view(host.dtype),
        host[..., r * th : (r + 1) * th, c * tw : (c + 1) * tw],
    )
    back = tpar.gather(tiles, mesh)
    assert back.dtype == host.dtype
    np.testing.assert_array_equal(back, host)


def test_shard_board_refuses_uneven_tiles():
    with pytest.raises(ValueError, match="not evenly divisible"):
        jpar.shard_board(np.zeros((30, 16), np.uint8), jpar.make_grid_mesh((4, 2)))
    with pytest.raises(ValueError, match="not evenly divisible"):
        tpar.shard_board(np.zeros((30, 16), np.uint8), tpar.make_grid_mesh((4, 2), ["cpu"] * 8))
    with pytest.raises(ValueError, match="not divisible by mesh"):
        tpar.shard_packed2d(np.zeros((32, 3), np.uint32), tpar.make_grid_mesh((4, 2), ["cpu"] * 8))


# -- the meshed Simulation against the JAX package's --------------------------


@pytest.fixture
def jax_devices(monkeypatch):
    """Show the JAX package only the first n virtual devices: its meshed
    Simulation builds its mesh over every device it sees."""
    real = jax.devices

    def limit(n):
        monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:n])

    return limit


CASES = {
    "conway": dict(rule="conway", height=64, width=128, seed=3, max_epochs=24),
    "wireworld": dict(
        rule="wireworld", height=64, width=128, pattern="wireworld-clock", max_epochs=24
    ),
    "bugs": dict(rule="bugs", height=40, width=40, seed=1, density=0.4, max_epochs=8),
}
COMMON = dict(steps_per_call=4, metrics_every=4, render_every=8, obs_digest=True,
              render_max_cells=32)


def _port(cfg_kw, n, **kw):
    out = io.StringIO()
    cfg = SimulationConfig(**{**COMMON, **cfg_kw, **kw})
    sim = tsim.Simulation(
        cfg, observer=BoardObserver(out=out, metrics_every=4, render_every=8,
                                    render_max_cells=32),
        device=["cpu"] * n,
    )
    return sim, out


def _jax(cfg_kw, **kw):
    out = io.StringIO()
    cfg = JConfig(**{**COMMON, **cfg_kw, **kw})
    sim = JSimulation(
        cfg, observer=JObserver(out=out, metrics_every=4, render_every=8, render_max_cells=32)
    )
    return sim, out


@pytest.mark.parametrize("mesh_shape", [(4, 2), (4, 1), (2, 2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_meshed_simulation_matches_jax(case, mesh_shape, jax_devices):
    kw = CASES[case]
    n = mesh_shape[0] * mesh_shape[1]
    jax_devices(n)
    jsim, jout = _jax(kw, mesh_shape=mesh_shape)
    jsim.advance(kw["max_epochs"])
    tsim_, tout = _port(kw, n, mesh_shape=mesh_shape)
    tsim_.advance(kw["max_epochs"])
    assert jsim.mesh is not None and tsim_.mesh.shape == mesh_shape
    assert tsim_.kernel == {"conway": "sweep", "wireworld": "gen_sweep", "bugs": "dense"}[case]
    lines = _LINE.findall(jout.getvalue())
    assert len(lines) == kw["max_epochs"] // 4 and int(lines[-1][1]) > 0
    assert _LINE.findall(tout.getvalue()) == lines
    # The rendered frames are cut from the tiles as the JAX package cuts them.
    frames = _FRAME.findall(jout.getvalue())
    assert len(frames) == kw["max_epochs"] // 8
    assert _FRAME.findall(tout.getvalue()) == frames
    np.testing.assert_array_equal(tsim_.board_host(), jsim.board_host())
    np.testing.assert_array_equal(
        tsim_.board_window(3, 30, 5, 37), jsim.board_window(3, 30, 5, 37)
    )


@pytest.mark.parametrize("kernel,rule,expect", [
    ("bitpack", "conway", "bitpack"), ("bitpack", "brians-brain", "bitpack"),
    ("dense", "conway", "dense"), ("pallas", "star-wars", "gen_sweep"),
])
def test_meshed_plain_and_explicit_kernels_match_jax(kernel, rule, expect, jax_devices):
    jax_devices(8)
    kw = dict(rule=rule, height=64, width=128, seed=5, max_epochs=16, halo_width=2)
    jsim, jout = _jax(dict(kw, kernel="bitpack" if kernel == "pallas" else kernel))
    jsim.advance(16)
    tsim_, tout = _port(dict(kw, kernel=kernel), 8)
    tsim_.advance(16)
    assert tsim_.kernel == expect
    # Several devices and no mesh_shape: packed boards auto-mesh as rows.
    assert tsim_.mesh.shape == ((4, 2) if expect == "dense" else (8, 1))
    assert _LINE.findall(tout.getvalue()) == _LINE.findall(jout.getvalue())


def test_auto_mesh_and_ltl_kernel_rules():
    # kernel=pallas with LtL has no sharded form: one device, no mesh.
    sim, _ = _port(CASES["bugs"], 4, kernel="pallas")
    assert sim.mesh is None and sim.kernel == "ltl_sweep"
    with pytest.raises(ValueError, match="single-device"):
        _port(CASES["bugs"], 4, kernel="pallas", mesh_shape=(2, 2))
    # auto on a mesh that does not divide the packed board steps dense.
    sim, _ = _port(dict(CASES["conway"], height=36, width=96), 4, mesh_shape=(2, 2))
    assert sim.kernel == "dense" and sim.mesh.shape == (2, 2)
    # An explicit pallas on such a mesh raises; with no mesh asked for it
    # runs on one device.
    with pytest.raises(ValueError, match="does not divide"):
        _port(dict(CASES["conway"], height=36, width=96), 4, mesh_shape=(1, 4), kernel="pallas")
    sim, _ = _port(dict(CASES["conway"], height=36), 8, kernel="pallas")
    assert sim.mesh is None and sim.kernel == "sweep"
    with pytest.raises(ValueError, match="cannot shard over mesh"):
        _port(dict(CASES["conway"], height=16), 8, kernel="bitpack", halo_width=4)
    with pytest.raises(ValueError, match="needs 4 devices, have 8"):
        _port(CASES["conway"], 8, mesh_shape=(2, 2))


# -- checkpoints across meshes, one device and the packages -------------------


@pytest.mark.parametrize("case", ["conway", "wireworld", "bugs"])
def test_checkpoints_resume_across_meshes_and_packages(case, tmp_path, jax_devices):
    kw = dict(CASES[case], checkpoint_every=4 if case == "bugs" else 12)
    total, mid = kw["max_epochs"], kw["checkpoint_every"]
    whole, _ = _port(kw, 1)
    whole.advance(total)
    want = whole.board_digest()

    def resume(make, src, **extra):
        sim, _ = make(dict(kw, checkpoint_dir=str(src), checkpoint_every=0), **extra)
        assert sim.epoch == mid
        sim.advance(total - mid)
        return sim.board_digest()

    # Written on a (2, 2) mesh: resumes on one device, on a (4, 1) mesh and
    # in the JAX package (on four devices); the file holds what a
    # single-device run's holds.
    jax_devices(4)
    meshed, _ = _port(dict(kw, checkpoint_dir=str(tmp_path / "mesh")), 4, mesh_shape=(2, 2))
    meshed.advance(mid)
    single, _ = _port(dict(kw, checkpoint_dir=str(tmp_path / "one")), 1)
    single.advance(mid)
    meshed.flush()  # both packages save on a writer thread
    single.flush()
    a, b = (CheckpointStore(str(tmp_path / d)).load(keep_packed=True) for d in ("mesh", "one"))
    assert (a.epoch, a.rule, a.meta) == (b.epoch, b.rule, b.meta)
    for x, y in ((a.board, b.board), (a.packed32, b.packed32)):
        assert (x is None and y is None) or np.array_equal(x, y)
    assert resume(lambda c: _port(c, 1), tmp_path / "mesh") == want
    assert resume(lambda c: _port(c, 4, mesh_shape=(4, 1)), tmp_path / "mesh") == want
    assert resume(lambda c: _jax(c, mesh_shape=(2, 2)), tmp_path / "mesh") == want
    # Written on one device, and by the JAX package on a mesh: both resume
    # on the port's (2, 2) mesh.
    assert resume(lambda c: _port(c, 4, mesh_shape=(2, 2)), tmp_path / "one") == want
    jsim, _ = _jax(dict(kw, checkpoint_dir=str(tmp_path / "jax")), mesh_shape=(2, 2))
    jsim.advance(mid)
    jsim.close()  # the JAX package saves on a writer thread
    assert resume(lambda c: _port(c, 4, mesh_shape=(2, 2)), tmp_path / "jax") == want


# -- config and CLI ---------------------------------------------------------------


def test_mesh_keys_load_from_toml_as_jax_loads_them(tmp_path):
    path = tmp_path / "mesh.toml"
    path.write_text("height = 64\nsteps_per_call = 6\nhalo_width = 3\nmesh_shape = [4, 2]\n")
    t, j = load_config(str(path)), jload(str(path))
    assert (t.mesh_shape, t.halo_width) == (j.mesh_shape, j.halo_width) == ((4, 2), 3)
    assert load_config(None, {"mesh_shape": [2, 2]}).mesh_shape == (2, 2)
    assert SimulationConfig().mesh_shape is None and SimulationConfig().halo_width == 1
    for loader in (load_config, jload):
        with pytest.raises(ValueError, match="multiple of halo_width"):
            loader(None, {"steps_per_call": 4, "halo_width": 3})
    with pytest.raises(ValueError, match="mesh_shape"):
        load_config(None, {"mesh_shape": [2, 2, 2]})


@pytest.mark.parametrize(
    "key,value",
    [("distributed", True), ("coordinator_address", "localhost:1"),
     ("num_processes", 2), ("process_id", 0), ("pallas_vmem_limit_mb", 16)],
)
def test_multi_process_and_block_keys_refused_by_name(key, value, monkeypatch):
    if key == "pallas_vmem_limit_mb":
        with pytest.raises(ValueError, match=key):
            load_config(None, {key: value})
        return
    # The multi-process keys are honoured: each reaches the config, and a
    # distributed run missing it is refused naming it, before any connection.
    assert getattr(load_config(None, {key: value}), key) == value
    for name in ("GOL_COORDINATOR", "GOL_NUM_PROCESSES", "GOL_PROCESS_ID",
                 "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    full = {"distributed": True, "coordinator_address": "localhost:1",
            "num_processes": 2, "process_id": 0}
    missing = "coordinator_address" if key == "distributed" else key
    cfg = load_config(None, {k: v for k, v in full.items() if k != missing})
    with pytest.raises(ValueError, match=missing):
        tsim.Simulation(cfg, device="cpu")


def test_cli_mesh_needs_as_many_devices(capsys):
    with pytest.raises(ValueError, match=r"needs 4 devices, have 1"):
        tcli.main(["run", "--device", "cpu", "--mesh", "2x2", "--height", "64",
                   "--width", "64", "--max-epochs", "4"])
    with pytest.raises(SystemExit):
        tcli.main(["run", "--device", "cpu", "--mesh", "2by2"])
    with pytest.raises(SystemExit):
        tcli.main(["run", "--device", "gpu0"])


def test_cli_mesh_run_matches_jax_cli(capsys):
    from akka_game_of_life_tpu import cli as jcli

    args = ["--rule", "highlife", "--height", "48", "--width", "64", "--seed", "3",
            "--max-epochs", "20", "--steps-per-call", "10", "--metrics-every", "10",
            "--obs-digest"]
    assert jcli.main(["run", "--platform", "cpu", "--mesh", "4x2", *args]) == 0
    jtext = capsys.readouterr().out
    assert tcli.main(["run", "--device", "cpu", "--mesh", "1x1", "--halo-width", "5", *args]) == 0
    ttext = capsys.readouterr().out
    assert len(_LINE.findall(jtext)) == 2
    assert _LINE.findall(ttext) == _LINE.findall(jtext)
    assert '"kernel": "sweep", "mesh": [1, 1]' in ttext
