"""The port's native host engines (``native/``: the C++ per-cell actor engine
and the SWAR chunk steppers) against the JAX package's, and the cluster's
``swar`` / ``actor`` / ``actor-native`` workers against the torch engine's
and the JAX package's numpy cluster.

The port builds its own copies of the C++ sources with g++ into
``build/native/``; a failed build raises with the compiler's stderr.
"""

import zlib

import numpy as np
import pytest

import akka_game_of_life_tpu.native.engine as j_native
import akka_game_of_life_tpu.runtime.harness as j_harness
import akka_game_of_life_tpu.runtime.config as j_config
import akka_game_of_life_tpu_torch.native as t_native_lib
import akka_game_of_life_tpu_torch.native.engine as t_native
from akka_game_of_life_tpu_torch.ops.rules import parse_rule, resolve_rule
from akka_game_of_life_tpu_torch.runtime.actor_engine import ActorBoard
from akka_game_of_life_tpu_torch.runtime.backend import BackendWorker, _np_chunk
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.harness import cluster
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation, initial_board
from akka_game_of_life_tpu_torch.utils.patterns import random_grid
from _torch_serve_pkgs import oracle


def test_library_builds_under_build_native():
    lib = t_native_lib.load()
    path = t_native_lib.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert lib is t_native_lib.load()


def test_failed_build_raises_with_the_compiler_stderr(monkeypatch, tmp_path):
    monkeypatch.setattr(t_native_lib, "_lib", None)
    monkeypatch.setattr(t_native_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_native_lib, "FLAGS", t_native_lib.FLAGS + ("-fno-such-flag-anywhere",))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ build failed.*no-such-flag-anywhere"):
        t_native_lib.load()
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("rule", ["conway", "highlife", "brians-brain", "wireworld"])
def test_native_actor_board_matches_jax_and_python(rule):
    r = resolve_rule(rule)
    board = np.random.default_rng(zlib.crc32(rule.encode())).integers(0, r.states, (14, 18)).astype(np.uint8)
    boards = [t_native.NativeActorBoard(board, rule), j_native.NativeActorBoard(board, rule), ActorBoard(board, rule)]
    for b in boards:
        b.advance_to(6)
    got = [b.board_at_current() for b in boards]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], got[2])
    np.testing.assert_array_equal(got[0], oracle(rule, board, 6))


def test_native_crash_replay_matches_jax():
    board = random_grid((20, 20), density=0.4, seed=7)
    t, j = t_native.NativeActorBoard(board, "conway"), j_native.NativeActorBoard(board, "conway")
    for b in (t, j):
        b.advance_to(10)
        b.crash_cell((3, 4))
        b.crash_cell((19, 0))
        assert b.min_epoch() == 10
        b.advance_to(14)
    np.testing.assert_array_equal(t.board_at_current(), j.board_at_current())
    np.testing.assert_array_equal(t.board_at_current(), oracle("conway", board, 14))
    assert t.messages_processed == j.messages_processed


def test_native_tile_engine_matches_jax():
    rng = np.random.default_rng(3)
    full = (rng.random((12, 12)) < 0.5).astype(np.uint8)
    engines = (t_native.NativeActorTileEngine("conway"), j_native.NativeActorTileEngine("conway"))
    for _ in range(5):
        padded = np.pad(full, 1, mode="wrap")[4:10, 4:10]
        got = [e.step(padded) for e in engines]
        full = oracle("conway", full, 1)
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], full[4:8, 4:8])


SWAR_CASES = [
    ("swar_chunk_native", "conway", (40, 70), 4, 4),
    ("swar_chunk_native", "day-and-night", (24, 129), 3, 8),
    ("swar_chunk_native", "highlife", (16, 64), 8, 8),
    ("swar_wire_chunk_native", "wireworld", (34, 34), 1, 1),
    ("swar_wire_chunk_native", "wireworld", (40, 70), 4, 4),
    ("swar_gen_chunk_native", "brians-brain", (40, 70), 4, 4),
    ("swar_gen_chunk_native", "B3/S23/5", (24, 129), 3, 8),
]


@pytest.mark.parametrize("fn,rule,shape,steps,halo", SWAR_CASES)
def test_swar_chunks_match_jax_and_numpy(fn, rule, shape, steps, halo):
    r = parse_rule(rule) if rule.startswith("B") else resolve_rule(rule)
    rng = np.random.default_rng(zlib.crc32(repr((rule, shape)).encode()))
    padded = rng.integers(0, r.states, size=shape, dtype=np.uint8)
    got = getattr(t_native, fn)(padded, steps, halo, r)
    np.testing.assert_array_equal(got, getattr(j_native, fn)(padded, steps, halo, rule))
    np.testing.assert_array_equal(got, _np_chunk(padded, steps, halo, r))


@pytest.mark.parametrize("fn,rule,match", [
    ("swar_chunk_native", "brians-brain", "binary"),
    ("swar_wire_chunk_native", "conway", "wireworld"),
    ("swar_gen_chunk_native", "conway", "Generations"),
])
def test_swar_chunk_refusals(fn, rule, match):
    with pytest.raises(ValueError, match=match):
        getattr(t_native, fn)(np.zeros((10, 10), np.uint8), 1, 1, rule)
    with pytest.raises(ValueError, match="halo"):
        t_native.swar_chunk_native(np.zeros((10, 10), np.uint8), 3, 2, "conway")


@pytest.mark.parametrize("rule,width", [("conway", 4), ("brians-brain", 3), ("wireworld", 4), ("conway", 1)])
def test_cluster_host_engines_match_torch_and_jax(rule, width):
    """In-process clusters of swar, actor and actor-native workers (actors
    exchange one epoch at a time) end on the torch engine's board and the
    JAX package's numpy cluster's."""
    kw = dict(height=24, width=24, seed=9, rule=rule, max_epochs=12, exchange_width=width)
    if rule == "wireworld":
        kw.update(pattern="wireworld-clock", pattern_offset=(7, 7))
    engines = ["swar"] + (["actor", "actor-native"] if width == 1 else [])
    with cluster(SimulationConfig(**kw), 2, engine="torch", device="cpu") as h:
        want = h.run_to_completion()
    with j_harness.cluster(j_config.SimulationConfig(**kw), 2, engine="numpy") as h:
        np.testing.assert_array_equal(h.run_to_completion(), want)
    for engine in engines:
        with cluster(SimulationConfig(**kw), 2, engine=engine) as h:
            np.testing.assert_array_equal(h.run_to_completion(), want)
    cfg = SimulationConfig(**kw)
    np.testing.assert_array_equal(want, oracle(rule, initial_board(cfg), 12))


def test_worker_engines():
    for engine in ("swar", "actor", "actor-native"):
        assert BackendWorker("127.0.0.1", 1, engine=engine).engine == engine
    with pytest.raises(ValueError, match="not supported by the PyTorch port"):
        BackendWorker("127.0.0.1", 1, engine="jax")
    with pytest.raises(ValueError, match="unknown engine"):
        BackendWorker("127.0.0.1", 1, engine="Actor")


def test_actor_run_needs_no_card_with_the_default_device():
    """An actor backend is a host engine: the default device builds nothing
    on a card (and so needs none)."""
    sim = Simulation(SimulationConfig(height=16, width=16, backend="actor-native", steps_per_call=2))
    sim.advance(4)
    assert sim.device.type == "cpu" and sim.kernel == "actor-native"
