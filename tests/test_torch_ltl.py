"""The port's plain dense stencil, Larger-than-Life step, guard and model
registry against the JAX package.

Same numpy-seeded boards through ``akka_game_of_life_tpu.ops.{ltl,stencil}``
and the port's counterparts, and through the numpy twins
(``step_ltl_np``); counts are exact integers in both, so the tolerance is
bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_game_of_life_tpu.models import registry as jregistry
from akka_game_of_life_tpu.ops import ltl as jltl
from akka_game_of_life_tpu.ops import stencil as jstencil
from akka_game_of_life_tpu.ops.rules import resolve_rule as jrule
from akka_game_of_life_tpu_torch.models import registry as tregistry
from akka_game_of_life_tpu_torch.ops import guard, ltl, stencil
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule


def _soup(h, w, seed=0, density=0.4):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def _rule(radius, neighborhood):
    """Mid-scale thresholds that keep soups alive."""
    diamond = neighborhood == "diamond"
    top = 2 * radius * (radius + 1) if diamond else (2 * radius + 1) ** 2 - 1
    lo = max(1, top // 3)
    nn = ",NN" if diamond else ""
    return f"R{radius},B{lo}-{min(top, lo + 3)},S{max(0, lo - 1)}-{min(top, lo + 5)}{nn}"


@pytest.mark.parametrize("neighborhood", ["box", "diamond"])
@pytest.mark.parametrize("radius", [1, 2, 3])
def test_step_ltl_matches(radius, neighborhood):
    rule = _rule(radius, neighborhood)
    board = _soup(24, 40, seed=radius)
    want = np.asarray(jltl.step_ltl(jnp.asarray(board), jrule(rule)))
    got = ltl.step_ltl(torch.from_numpy(board), rule).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ltl.step_ltl_np(board, rule), want)
    np.testing.assert_array_equal(ltl.step_ltl_np(board, rule), jltl.step_ltl_np(board, jrule(rule)))


def test_bugs_multi_step_matches():
    board = _soup(32, 48, seed=9, density=0.5)
    want = np.asarray(jltl.ltl_multi_step_fn(jrule("bugs"), 3)(jnp.asarray(board)))
    got = ltl.ltl_multi_step_fn("bugs", 3)(torch.from_numpy(board)).numpy()
    np.testing.assert_array_equal(got, want)


def test_narrow_board_is_its_periodic_extension():
    """A window wider than the board sums its periodic extension, as the
    numpy oracle's wrap pad gives it."""
    board = _soup(7, 5, seed=3, density=0.5)
    rule = "R5,B10-40,S8-50"
    np.testing.assert_array_equal(
        ltl.step_ltl(torch.from_numpy(board), rule).numpy(), ltl.step_ltl_np(board, rule)
    )


@pytest.mark.parametrize("radius", [1, 4])
@pytest.mark.parametrize("neighborhood", ["box", "diamond"])
def test_neighborhood_mask_matches(radius, neighborhood):
    np.testing.assert_array_equal(
        ltl.neighborhood_mask(radius, neighborhood),
        jltl.neighborhood_mask(radius, neighborhood),
    )


def test_count_dtype_follows_the_jax_package():
    assert ltl._count_dtype(resolve_rule("bugs")) == torch.bfloat16
    assert ltl._count_dtype(resolve_rule("R8,B100,S100")) == torch.float32


def test_guard_refuses_over_cap(monkeypatch):
    monkeypatch.setenv(guard.CAP_ENV, "0")
    with pytest.raises(ValueError, match=guard.CAP_ENV):
        ltl.step_ltl(torch.zeros((8, 8), dtype=torch.uint8), "bugs")
    monkeypatch.setenv(guard.CAP_ENV, "lots")
    with pytest.raises(ValueError, match="integer MiB"):
        guard.intermediate_cap_bytes()
    monkeypatch.delenv(guard.CAP_ENV)
    assert guard.intermediate_cap_bytes() == guard.DEFAULT_CAP_MB * 2**20


def test_matmul_engine_is_refused_by_name():
    """engine="matmul" runs the banded products (the shift-add engine's
    board, as in the JAX package); what it cannot take, the diamond, and an
    unknown engine are refused by name."""
    board = torch.from_numpy(_soup(24, 40, seed=4, density=0.5))
    np.testing.assert_array_equal(
        ltl.step_ltl(board, "bugs", engine="matmul").numpy(),
        ltl.step_ltl(board, "bugs").numpy(),
    )
    with pytest.raises(ValueError, match="kernel=matmul supports box"):
        ltl.step_ltl(board, _rule(2, "diamond"), engine="matmul")
    with pytest.raises(ValueError, match="unknown ltl count engine"):
        ltl.step_ltl(torch.zeros((8, 8), dtype=torch.uint8), "bugs", engine="fft")


@pytest.mark.parametrize(
    "rule,states",
    [
        ("conway", 2), ("highlife", 2), ("seeds", 2),
        ("brians-brain", 3), ("star-wars", 4), ("B2/S/7", 7),
        ("wireworld", 4), ("bugs", 2),
    ],
)
def test_dense_step_matches(rule, states):
    board = np.random.default_rng(states).integers(0, states, size=(17, 23), dtype=np.uint8)
    want = np.asarray(jstencil.step(jnp.asarray(board), jrule(rule)))
    np.testing.assert_array_equal(stencil.step(torch.from_numpy(board), rule).numpy(), want)


def test_dense_neighbor_counts_match():
    alive = _soup(9, 11, seed=4)
    np.testing.assert_array_equal(
        stencil.neighbor_counts(torch.from_numpy(alive)).numpy(),
        np.asarray(jstencil.neighbor_counts(jnp.asarray(alive))),
    )


@pytest.mark.parametrize("rule", ["star-wars", "wireworld", "bugs"])
def test_registry_models_match(rule):
    assert tregistry.list_models() == jregistry.list_models()
    tm, jm = tregistry.get_model(rule), jregistry.get_model(rule)
    assert tm.name == jm.name and tm.dtype == torch.uint8
    board = tm.init((16, 40), seed=2)
    np.testing.assert_array_equal(board, jm.init((16, 40), seed=2))
    want = np.asarray(jm.run(4)(jnp.asarray(board)))
    np.testing.assert_array_equal(tm.run(4)(torch.from_numpy(board)).numpy(), want)
    np.testing.assert_array_equal(
        tm.step(torch.from_numpy(board)).numpy(), np.asarray(jm.step(jnp.asarray(board)))
    )
