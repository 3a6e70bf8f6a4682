"""The port's sharded steppers and digest folds against the JAX package's.

The same numpy-seeded boards go through the JAX function on the conftest's
8 virtual CPU devices and through its counterpart in the port on a mesh of
``cpu`` slots; the results must be bit-equal.  Covered: the dense halo path
(``parallel/halo.py``), the plain packed and plane paths
(``parallel/packed_halo2d.py``), the row ring (``parallel/packed_halo.py``),
the sweep wiring of TPU kernel #6 (``parallel/sweep_halo.py``, against
``sharded_pallas_step_fn`` / ``sharded_gen_pallas_step_fn`` in interpret
mode, at the sizes of ``tests/test_pallas_halo.py``), exchange plans at
the garbage-front limits, and the three digest folds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_game_of_life_tpu import parallel as jpar
from akka_game_of_life_tpu.ops import bitpack as jbitpack
from akka_game_of_life_tpu.ops import bitpack_gen as jgen
from akka_game_of_life_tpu.ops.stencil import multi_step as jmulti_step
from akka_game_of_life_tpu.parallel import digest as jdigest
from akka_game_of_life_tpu.parallel.mesh import GEN_SPEC
from akka_game_of_life_tpu.parallel.pallas_halo import (
    sharded_gen_pallas_step_fn,
    sharded_pallas_step_fn,
)
from akka_game_of_life_tpu.utils.patterns import pattern_board, random_grid
from akka_game_of_life_tpu_torch import parallel as tpar
from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen, digest, packed_sweep
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
from akka_game_of_life_tpu_torch.parallel import digest as tdigest
from akka_game_of_life_tpu_torch.parallel import sweep_halo

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)


def _meshes(shape):
    n = shape[0] * shape[1]
    return (
        jpar.make_grid_mesh(shape, devices=jax.devices()[:n]),
        tpar.make_grid_mesh(shape, ["cpu"] * n),
    )


def _jax_words(board, mesh):
    return jpar.shard_packed2d(jbitpack.pack(jnp.asarray(board)), mesh)


def _port_words(board, mesh):
    return tpar.shard_board(bitpack.pack_np(board), mesh)


def _jax_planes(board, states, mesh):
    from jax.sharding import NamedSharding

    return jax.device_put(
        jgen.pack_gen(jnp.asarray(board), states), NamedSharding(mesh, GEN_SPEC)
    )


def _port_planes(board, states, mesh):
    return tpar.shard_board(bitpack_gen.pack_gen_np(board, states), mesh)


def _dense(board, rule, steps):
    return np.asarray(jmulti_step(jnp.asarray(board), rule, steps))


# -- the dense halo path ------------------------------------------------------


@pytest.mark.parametrize(
    "mesh_shape,shape,rule,steps,halo_width",
    [
        ((1, 1), (32, 32), "conway", 6, 1),
        ((2, 2), (32, 32), "conway", 6, 1),
        ((4, 2), (32, 32), "conway", 6, 1),
        ((2, 4), (32, 32), "conway", 6, 1),
        ((8, 1), (32, 32), "conway", 6, 1),
        ((1, 8), (32, 32), "conway", 6, 1),
        ((4, 2), (48, 24), "conway", 6, 2),
        ((4, 2), (48, 24), "conway", 6, 3),
        ((4, 2), (32, 32), "brians-brain", 4, 2),
        ((2, 2), (24, 40), "bugs", 2, 1),
    ],
)
def test_dense_sharded_step_matches_jax(mesh_shape, shape, rule, steps, halo_width):
    jmesh, tmesh = _meshes(mesh_shape)
    r = resolve_rule(rule)
    rng = np.random.default_rng(13)
    board = rng.integers(0, r.states, size=shape).astype(np.uint8)
    jstep = jpar.sharded_step_fn(jmesh, rule, steps_per_call=steps, halo_width=halo_width)
    tstep = tpar.sharded_step_fn(tmesh, rule, steps_per_call=steps, halo_width=halo_width)
    want = np.asarray(jstep(jpar.shard_board(jnp.asarray(board), jmesh)))
    got = tpar.gather(tstep(tpar.shard_board(board, tmesh)), tmesh)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _dense(board, rule, steps))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 2), (1, 8), (8, 1)])
@pytest.mark.parametrize("pad,itemsize", [(1, 1), (3, 4)])
def test_exchange_bytes_match_jax(mesh_shape, pad, itemsize):
    args = (mesh_shape, (16, 24), pad, itemsize)
    assert tpar.halo.exchange_bytes(*args) == jpar.halo.exchange_bytes(*args)


def test_dense_halo_refuses_small_tiles():
    _, tmesh = _meshes((8, 1))
    with pytest.raises(ValueError, match="smaller than the 3-cell halo"):
        tpar.sharded_step_fn(tmesh, "conway", steps_per_call=3, halo_width=3)(
            tpar.shard_board(np.zeros((16, 16), np.uint8), tmesh)
        )


# -- the plain packed and plane paths ----------------------------------------------


@pytest.mark.parametrize(
    "mesh_shape,shape,steps,halo_rows",
    [
        ((1, 1), (32, 64), 8, 4),
        ((4, 2), (64, 128), 8, 1),
        ((4, 2), (64, 128), 8, 8),
        ((2, 4), (32, 256), 6, 3),
        ((8, 1), (64, 64), 4, 2),
        ((1, 8), (16, 256), 4, 4),
    ],
)
def test_packed2d_step_matches_jax(mesh_shape, shape, steps, halo_rows):
    jmesh, tmesh = _meshes(mesh_shape)
    board = random_grid(shape, seed=5)
    jstep = jpar.sharded_packed2d_step_fn(
        jmesh, "highlife", steps_per_call=steps, halo_rows=halo_rows
    )
    tstep = tpar.sharded_packed2d_step_fn(
        tmesh, "highlife", steps_per_call=steps, halo_rows=halo_rows
    )
    want = np.asarray(jstep(_jax_words(board, jmesh)))
    got = tpar.gather(tstep(_port_words(board, tmesh)), tmesh)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rule", ["brians-brain", "wireworld", "B2/S345/200"])
@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 2)])
def test_gen_step_matches_jax(rule, mesh_shape):
    jmesh, tmesh = _meshes(mesh_shape)
    r = resolve_rule(rule)
    board = np.random.default_rng(31).integers(0, min(r.states, 6), size=(32, 128)).astype(np.uint8)
    jstep = jpar.sharded_gen_step_fn(jmesh, rule, steps_per_call=6, halo_rows=3)
    tstep = tpar.sharded_gen_step_fn(tmesh, r, steps_per_call=6, halo_rows=3)
    want = np.asarray(jstep(_jax_planes(board, r.states, jmesh)))
    got = tpar.gather(tstep(_port_planes(board, r.states, tmesh)), tmesh)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,halo_width", [(1, 1), (4, 2), (8, 1)])
def test_row_ring_matches_jax(n, halo_width):
    jmesh = jpar.make_row_mesh(n)
    tmesh = tpar.make_row_mesh(n, ["cpu"] * 8)
    assert tmesh.shape == (n, 1)
    board = random_grid((64, 96), seed=n)
    jstep = jpar.sharded_packed_step_fn(jmesh, "conway", steps_per_call=4, halo_width=halo_width)
    tstep = tpar.sharded_packed_step_fn(tmesh, "conway", steps_per_call=4, halo_width=halo_width)
    want = np.asarray(jstep(jpar.shard_packed(jbitpack.pack(jnp.asarray(board)), jmesh)))
    got = tpar.gather(tstep(tpar.shard_packed(bitpack.pack_np(board), tmesh)), tmesh)
    np.testing.assert_array_equal(got, want)


# -- the sweep wiring (TPU kernel #6) ------------------------------------------


@pytest.mark.parametrize(
    "mesh_shape,shape,block_rows,steps,rule",
    [
        ((1, 1), (32, 64), 16, 8, "conway"),  # degenerate mesh = plain torus sweep
        ((2, 1), (32, 64), 16, 8, "conway"),  # row ring
        ((8, 1), (64, 64), 8, 8, "conway"),  # full-height ring, tiny tiles
        ((4, 2), (64, 64), 16, 8, "conway"),  # 2-D: word halos engage
        ((2, 2), (32, 128), 16, 12, "highlife"),  # non-power-of-two step count
        ((2, 4), (32, 256), 16, 8, "conway"),  # wide word sharding
        ((2, 1), (32, 64), 16, 1, "highlife"),  # single-step calls
        ((2, 2), (32, 128), 16, 6, "conway"),
    ],
)
def test_sweep_matches_jax_interpret(mesh_shape, shape, block_rows, steps, rule):
    jmesh, tmesh = _meshes(mesh_shape)
    board = random_grid(shape, seed=7)
    jstep = sharded_pallas_step_fn(
        jmesh, rule, steps_per_call=steps, block_rows=block_rows, interpret=True
    )
    tstep = tpar.sharded_sweep_step_fn(tmesh, rule, steps_per_call=steps)
    want = np.asarray(jstep(_jax_words(board, jmesh)))
    got = tpar.gather(tstep(_port_words(board, tmesh)), tmesh)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bitpack.unpack_np(got), _dense(board, rule, steps))


@pytest.mark.parametrize(
    "rule,mesh_shape",
    [("brians-brain", (1, 1)), ("wireworld", (4, 1)), ("brians-brain", (2, 2))],
)
def test_gen_sweep_matches_jax_interpret(rule, mesh_shape):
    jmesh, tmesh = _meshes(mesh_shape)
    r = resolve_rule(rule)
    h, w = 64 * mesh_shape[0], 64 * mesh_shape[1]
    board = np.random.default_rng(31).integers(0, r.states, size=(h, w), dtype=np.uint8)
    jstep = sharded_gen_pallas_step_fn(
        jmesh, rule, steps_per_call=8, block_rows=16, interpret=True
    )
    tstep = tpar.sharded_gen_sweep_step_fn(tmesh, r, steps_per_call=8)
    want = np.asarray(jstep(_jax_planes(board, r.states, jmesh)))
    got = tpar.gather(tstep(_port_planes(board, r.states, tmesh)), tmesh)
    np.testing.assert_array_equal(got, want)


def test_glider_crosses_shard_boundaries():
    # A glider crossing every shard seam and the torus edge: any halo
    # misalignment shifts its phase.
    _, tmesh = _meshes((4, 2))
    board = pattern_board("glider", (32, 64), (2, 2))
    tstep = tpar.sharded_sweep_step_fn(tmesh, "conway", steps_per_call=128)
    got = bitpack.unpack_np(tpar.gather(tstep(_port_words(board, tmesh)), tmesh))
    np.testing.assert_array_equal(got, _dense(board, "conway", 128))
    assert got.sum() == 5


@pytest.mark.parametrize(
    "mesh_shape,shape,steps,depths,halo_rows,halo_words",
    [
        # s = p = the tile's 16 rows: the row front reaches the interior's
        # edge exactly at the exchange.
        ((4, 1), (64, 64), 16, (10, 6), 16, 0),
        # Two exchanges of 16 (the tile caps s).
        ((4, 1), (64, 64), 32, (10, 6), 16, 0),
        # s = 31 = 32·hw − 1 on one-word tiles, and s = p = the tile's 31
        # rows: both fronts at their limits at once.
        ((2, 2), (62, 64), 31, (10, 10, 10, 1), 31, 1),
        # s = 32 takes hw = 2; two-word tiles hold it.
        ((2, 2), (64, 128), 32, (10, 10, 10, 2), 32, 2),
        # s = 40: one halo word (32 bits) would let the front in.
        ((2, 4), (80, 256), 40, (10, 10, 10, 10), 40, 2),
        # One-word tiles cap s at 31: 62 generations take two exchanges.
        ((1, 2), (62, 64), 62, (10, 10, 10, 1), 31, 1),
    ],
)
def test_plans_at_the_garbage_front_limits(
    mesh_shape, shape, steps, depths, halo_rows, halo_words
):
    _, tmesh = _meshes(mesh_shape)
    board = random_grid(shape, density=0.45, seed=steps)
    tstep = tpar.sharded_sweep_step_fn(tmesh, "conway", steps_per_call=steps)
    tile = (shape[0] // mesh_shape[0], shape[1] // 32 // mesh_shape[1])
    plan = tstep.plan(tile)
    assert plan == sweep_halo.ExchangePlan(depths, halo_rows, halo_words)
    got = bitpack.unpack_np(tpar.gather(tstep(_port_words(board, tmesh)), tmesh))
    np.testing.assert_array_equal(got, _dense(board, "conway", steps))


def test_plan_exchange():
    # One exchange per headline call on four 16384-row tiles.
    assert sweep_halo.plan_exchange(60, 16384) == [10] * 6
    assert sweep_halo.plan_exchange(31, 31) == [10, 10, 10, 1]
    assert sweep_halo.plan_exchange(60, 25) == [10, 10]
    assert sweep_halo.plan_exchange(7, 3) == [1]
    assert sweep_halo.max_steps_per_exchange(16384, 1024, 2) == 16384
    assert sweep_halo.max_steps_per_exchange(40000, 1024, 2) == 32 * 1024 - 1
    assert sweep_halo.max_steps_per_exchange(100, 1, 2) == 31
    assert sweep_halo.max_steps_per_exchange(100, 1, 1) == 100
    with pytest.raises(ValueError, match="must be >= 1"):
        sweep_halo.plan_exchange(0, 64)


def test_sweep_launch_plan_and_cpu_tiles():
    """On CPU tiles the wrappers run their plain versions: no launch."""
    _, tmesh = _meshes((2, 2))
    before = packed_sweep.packed_sweep.launches
    tstep = tpar.sharded_sweep_step_fn(tmesh, "conway", steps_per_call=20)
    tstep(_port_words(random_grid((64, 128), seed=1), tmesh))
    assert packed_sweep.packed_sweep.launches == before
    assert tstep.plan((32, 2)).depths == (10, 10)


def test_sweep_refuses_what_it_cannot_step():
    _, tmesh = _meshes((2, 2))
    with pytest.raises(ValueError, match="binary radius-1"):
        tpar.sharded_sweep_step_fn(tmesh, "brians-brain")
    with pytest.raises(ValueError, match="packed sweep"):
        tpar.sharded_gen_sweep_step_fn(tmesh, "conway")
    gen = tpar.sharded_gen_sweep_step_fn(tmesh, "brians-brain", steps_per_call=2)
    with pytest.raises(ValueError, match="expected 2 planes"):
        gen(tpar.shard_board(np.zeros((3, 32, 64), np.uint32), tmesh))


# -- digest folds -------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 2), (2, 4), (8, 1), (1, 2)])
def test_digest_folds_match_jax_and_single_device(mesh_shape):
    jmesh, tmesh = _meshes(mesh_shape)
    rng = np.random.default_rng(sum(mesh_shape))
    h, w = 64, 256
    board = (rng.random((h, w)) < 0.3).astype(np.uint8)
    board[: h // 2] = 0  # empty row blocks: the skip runs per tile
    single = digest.digest_dense_np(board)

    want = np.asarray(jdigest.sharded_dense_digest_fn(jmesh, (h, w))(jpar.shard_board(jnp.asarray(board), jmesh)))
    got = tdigest.sharded_dense_digest_fn(tmesh, (h, w))(tpar.shard_board(board, tmesh))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)

    want = np.asarray(jdigest.sharded_packed2d_digest_fn(jmesh, (h, w))(_jax_words(board, jmesh)))
    got = tdigest.sharded_packed2d_digest_fn(tmesh, (h, w))(_port_words(board, tmesh))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)

    states = 5
    multi = rng.integers(0, states, size=(h, w)).astype(np.uint8)
    want = np.asarray(
        jdigest.sharded_gen_digest_fn(jmesh, (h, w), states)(_jax_planes(multi, states, jmesh))
    )
    got = tdigest.sharded_gen_digest_fn(tmesh, (h, w), states)(_port_planes(multi, states, tmesh))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, digest.digest_dense_np(multi))
    assert digest.value(got) == digest.value(
        digest.digest_planes(torch.from_numpy(bitpack_gen.pack_gen_np(multi, states).view(np.int32)), w)
    )
