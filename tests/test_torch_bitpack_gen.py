"""The port's bit planes (Generations/WireWorld) against the JAX package.

Same numpy-seeded inputs through ``akka_game_of_life_tpu.ops.bitpack_gen``
/ ``digest`` and the port's counterparts; everything is integer, so the
tolerance is bit-exact.  Random uint32 planes include plane values that
encode no state of the rule (state 3 under Brian's Brain): the plane
formulas must agree on those too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_game_of_life_tpu.ops import bitpack_gen as jgen
from akka_game_of_life_tpu.ops import digest as jdigest
from akka_game_of_life_tpu.ops.rules import resolve_rule as jrule
from akka_game_of_life_tpu_torch.ops import bitpack_gen as tgen
from akka_game_of_life_tpu_torch.ops import digest as tdigest
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

RULES = ["brians-brain", "star-wars", "B2/S/7", "wireworld"]
SHAPES = [(1, 1), (3, 1), (7, 2), (16, 3)]


def _planes(m, h, nw, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(m, h, nw), dtype=np.uint32)


def _t(planes):
    return tgen.planes_from_numpy(planes, "cpu")


def _np(planes):
    return tgen.planes_to_numpy(planes)


def _m(rule):
    return tgen.n_planes(resolve_rule(rule).states)


def test_planes_round_trip_bit_exact():
    p = _planes(3, 5, 2)
    t = _t(p)
    assert t.dtype == torch.int32 and t.shape == (3, 5, 2)
    np.testing.assert_array_equal(_np(t), p)
    with pytest.raises(ValueError, match="m, H, W/32"):
        tgen.planes_from_numpy(p[0])


@pytest.mark.parametrize("states", [2, 3, 4, 7, 200])
@pytest.mark.parametrize("h,nw", SHAPES)
def test_pack_unpack_match(states, h, nw):
    assert tgen.n_planes(states) == jgen.n_planes(states)
    rng = np.random.default_rng(states * 100 + h)
    grid = rng.integers(0, states, size=(h, nw * 32), dtype=np.uint8)
    want = np.asarray(jgen.pack_gen(jnp.asarray(grid), states))
    np.testing.assert_array_equal(tgen.pack_gen_np(grid, states), want)
    np.testing.assert_array_equal(_np(tgen.pack_gen(torch.from_numpy(grid), states)), want)
    np.testing.assert_array_equal(tgen.unpack_gen(_t(want)).numpy(), grid)
    np.testing.assert_array_equal(tgen.unpack_gen_np(want), jgen.unpack_gen_np(want))


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("h,nw", SHAPES)
def test_step_gen_matches(rule, h, nw):
    p = _planes(_m(rule), h, nw, seed=h + nw)
    want = np.asarray(jgen.step_gen(jnp.asarray(p), jrule(rule)))
    np.testing.assert_array_equal(_np(tgen.step_gen(_t(p), rule)), want)


@pytest.mark.parametrize("rule", RULES)
def test_padded_rows_match(rule):
    m = _m(rule)
    p = _planes(m, 10, 2, seed=5)
    want = jgen.step_gen_padded_rows_planes([jnp.asarray(p[k]) for k in range(m)], jrule(rule))
    got = tgen.step_gen_padded_rows_planes([_t(p)[k] for k in range(m)], rule)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
    stacked = np.asarray(jgen.step_gen_padded_rows(jnp.asarray(p), jrule(rule)))
    np.testing.assert_array_equal(_np(tgen.step_gen_padded_rows(_t(p), rule)), stacked)


@pytest.mark.parametrize("rule", RULES)
def test_multi_step_matches(rule):
    p = _planes(_m(rule), 12, 2, seed=9)
    want = np.asarray(jgen.gen_multi_step_fn(jrule(rule), 6)(jnp.asarray(p)))
    np.testing.assert_array_equal(_np(tgen.gen_multi_step_fn(rule, 6)(_t(p))), want)


@pytest.mark.parametrize("rule", RULES)
def test_digest_planes_match(rule):
    p = _planes(_m(rule), 9, 3, seed=2)
    want = np.asarray(jdigest.digest_planes(jnp.asarray(p), 96))
    assert tdigest.value(tdigest.digest_planes(_t(p), 96)) == jdigest.value(want)
    np.testing.assert_array_equal(tdigest.digest_planes_np(p, 96), jdigest.digest_planes_np(p, 96))
    # By linearity the planes' digest is the dense board's.
    board = tgen.unpack_gen_np(p)
    np.testing.assert_array_equal(tdigest.digest_planes_np(p, 96), tdigest.digest_dense_np(board))


def test_alive_plane_counts_state_one():
    grid = np.random.default_rng(1).integers(0, 4, size=(6, 64), dtype=np.uint8)
    alive = tgen.alive_plane(tgen.pack_gen(torch.from_numpy(grid), 4))
    np.testing.assert_array_equal(tgen.unpack_gen(alive[None]).numpy(), grid == 1)


def test_refuses_what_planes_cannot_step():
    p = _t(_planes(2, 4, 1))
    with pytest.raises(ValueError, match="expected 3 planes"):
        tgen.step_gen(p, "B2/S/7")
    with pytest.raises(ValueError, match="totalistic and wireworld"):
        tgen.step_gen(p, "bugs")
    with pytest.raises(ValueError, match="expected 2 planes"):
        tgen.step_gen_padded_rows_planes([p[0]], "brians-brain")
