"""The port's per-cell actor engine (``runtime/actor_engine.py``) against the
JAX package's, and ``run --backend actor|actor-native`` against the port's
packed run.

Both packages' engines get the same seeded boards; boards, epochs, message
counts and crash replays must be equal, and equal to the numpy oracle.
"""

import io

import numpy as np
import pytest

import akka_game_of_life_tpu.runtime.actor_engine as j_actor
import akka_game_of_life_tpu_torch.runtime.actor_engine as t_actor
from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation
from akka_game_of_life_tpu_torch.utils.patterns import pattern_board, random_grid
from _torch_serve_pkgs import oracle


def _trail(mod, board, rule, script):
    ab = mod.ActorBoard(board, rule)
    out = []
    for op, arg in script:
        if op == "advance":
            ab.advance_to(arg)
        elif op == "crash":
            ab.crash_cell(arg)
            assert ab.cells[arg].epoch == ab.global_epoch
        elif op == "prune":
            ab.prune_histories_below(arg)
        out.append((op, arg, ab.board_at_current().tobytes(), ab.min_epoch(), ab.messages_processed))
    return out


@pytest.mark.parametrize("rule,board,script", [
    ("conway", random_grid((24, 24), density=0.5, seed=42), [("advance", 10)]),
    ("brians-brain", np.random.default_rng(2).integers(0, 3, (12, 12)).astype(np.uint8),
     [("advance", 6)]),
    ("conway", pattern_board("gosper-glider-gun", (48, 48), (2, 2)),
     [("advance", 20), ("crash", (3, 5)), ("crash", (10, 10)), ("crash", (40, 40)), ("advance", 30)]),
    ("conway", random_grid((10, 10), density=0.5, seed=9),
     [("advance", 5), ("crash", (5, 5)), ("advance", 12), ("prune", 10), ("advance", 15)]),
    ("highlife", np.ones((2, 2), np.uint8), [("advance", 1)]),
])
def test_actor_board_matches_jax_and_the_oracle(rule, board, script):
    got = _trail(t_actor, board, rule, script)
    assert got == _trail(j_actor, board, rule, script)
    final = np.frombuffer(got[-1][2], np.uint8).reshape(board.shape)
    np.testing.assert_array_equal(final, oracle(rule, board, script[-1][1]))


def test_tile_engine_with_ghost_halo_matches_jax():
    board = random_grid((12, 12), density=0.5, seed=4)
    engines = (t_actor.ActorTileEngine("conway"), j_actor.ActorTileEngine("conway"))
    cur = [board, board]
    for _ in range(5):
        cur = [eng.step(np.pad(c, 1, mode="wrap")) for eng, c in zip(engines, cur)]
        np.testing.assert_array_equal(cur[0], cur[1])
    np.testing.assert_array_equal(cur[0], oracle("conway", board, 5))
    assert all(len(c.history) <= 2 for c in engines[0]._board.cells.values())


def _digests(backend):
    cfg = SimulationConfig(height=32, width=64, seed=13, steps_per_call=4, backend=backend)
    sim = Simulation(cfg, observer=BoardObserver(out=io.StringIO()), device="cpu")
    got = []
    for _ in range(4):
        sim.advance(4)
        got.append(sim.board_digest())
    return sim, got


@pytest.mark.parametrize("backend", ["actor", "actor-native"])
def test_run_backend_digests_match_the_packed_run(backend):
    packed, want = _digests("tpu")
    sim, got = _digests(backend)
    assert packed.kernel == "sweep" and sim.kernel == backend
    assert got == want and len(got) == 4
    assert sim.device.type == "cpu" and sim.layout == "dense"
    np.testing.assert_array_equal(sim.board_host(), packed.board_host())


@pytest.mark.parametrize("backend", ["actor", "actor-native"])
def test_run_backend_resumes_and_replays_a_crash(tmp_path, backend):
    """Checkpoints of the actor run resume in the packed run and back; an
    injected crash rebuilds the engine from the newest checkpoint."""
    ck = str(tmp_path / "ck")
    base = dict(height=32, width=32, seed=5, steps_per_call=4, checkpoint_dir=ck, checkpoint_every=8)
    with Simulation(SimulationConfig(backend=backend, **base), device="cpu") as sim:
        sim.advance(16)
    with Simulation(SimulationConfig(**base), device="cpu") as sim:
        assert sim.epoch == 16
        sim.advance(8)
        want = sim.board_host()
    with Simulation(SimulationConfig(backend=backend, **base), device="cpu") as sim:
        assert sim.epoch == 24
        sim.checkpoint()
        sim.flush()
        sim._crash_and_recover()
        sim.advance(8)
        got = sim.board_host()
    np.testing.assert_array_equal(got, oracle("conway", want, 8))
    assert odigest.value(odigest.digest_dense_np(got)) == odigest.value(
        odigest.digest_dense_np(oracle("conway", random_grid((32, 32), density=0.5, seed=5), 32))
    )


@pytest.mark.parametrize("kw,match", [
    (dict(sparse_kernel=True), "no block structure to gate"),
    (dict(mesh_shape=(1, 1)), "one host engine"),
    (dict(kernel="matmul"), "per-cell actor engine"),
    (dict(backend="gpu"), "unknown backend"),
])
def test_actor_backend_refusals(kw, match):
    kw.setdefault("backend", "actor")
    with pytest.raises(ValueError, match=match):
        Simulation(SimulationConfig(height=16, width=16, **kw), device="cpu")


def test_actor_backend_refuses_the_fast_forward():
    sim = Simulation(SimulationConfig(height=16, width=16, rule="replicator", backend="actor"), device="cpu")
    with pytest.raises(ValueError, match="per-cell actor backends iterate"):
        sim.fast_forward(10)
