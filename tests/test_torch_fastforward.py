"""The port's linear-rule fast-forward against the JAX package's.

The same numpy-seeded boards go through ``akka_game_of_life_tpu.ops.
fastforward`` and the port's counterpart; a jump is XOR arithmetic, so the
tolerance is 0.  The plans (offsets, per-factor roll counts) must be equal
as data, and every refusal must carry the JAX package's message.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_game_of_life_tpu.ops import fastforward as jff
from akka_game_of_life_tpu.ops.rules import resolve_rule as jrule
from akka_game_of_life_tpu_torch.ops import fastforward as ff
from akka_game_of_life_tpu_torch.ops import stencil
from akka_game_of_life_tpu_torch.ops.rules import LINEAR_RULES, NAMED_RULES
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

LINEAR = [r.name for r in LINEAR_RULES]
NON_LINEAR = sorted(set(NAMED_RULES) - set(LINEAR))
SPANS = [0, 1, 2, 3, 7, 64, 2**20 + 5, 2**61]
SHAPES = [(48, 96), (64, 64)]


def _soup(shape, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(np.uint8)


@pytest.mark.parametrize("rule", LINEAR)
def test_kernel_offsets_match_jax(rule):
    np.testing.assert_array_equal(ff.kernel_offsets(rule), jff.kernel_offsets(jrule(rule)))


@pytest.mark.parametrize("rule", NON_LINEAR)
def test_non_linear_refusal_matches_jax(rule):
    with pytest.raises(ValueError) as want:
        jff.kernel_offsets(jrule(rule))
    with pytest.raises(ValueError) as got:
        ff.kernel_offsets(rule)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="not XOR-linear"):
        ff.fast_forward(torch.zeros((8, 8), dtype=torch.uint8), rule, 5)


@pytest.mark.parametrize("rule", LINEAR)
@pytest.mark.parametrize("shape", SHAPES + [(12288, 12288), (16384, 16384)])
@pytest.mark.parametrize("t", SPANS + [2**30 + 2**14 - 1])
def test_plans_match_jax(rule, shape, t):
    assert ff.jump_plan(rule, t, shape) == jff.jump_plan(jrule(rule), t, shape)
    base = ff.kernel_offsets(rule)
    for k in (0, 1, 13, 61):
        np.testing.assert_array_equal(
            ff._scaled_offsets(base, k, shape), jff._scaled_offsets(base, k, shape))


@pytest.mark.parametrize("rule", LINEAR)
@pytest.mark.parametrize("t", [0, 1, 2, 3, 7, 64, 1000])
def test_pow_offsets_and_kernel_plane_match_jax(rule, t):
    np.testing.assert_array_equal(
        ff.pow_offsets(rule, t, (48, 96)), jff.pow_offsets(jrule(rule), t, (48, 96)))
    np.testing.assert_array_equal(
        ff.kernel_plane(rule, t, (24, 40)), jff.kernel_plane(jrule(rule), t, (24, 40)))


@pytest.mark.parametrize("rule", LINEAR)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("t", SPANS)
def test_fast_forward_matches_jax(rule, shape, t):
    board = _soup(shape, seed=t % 97)
    want = np.asarray(jff.fast_forward(jnp.asarray(board), jrule(rule), t))
    got = ff.fast_forward(torch.from_numpy(board), rule, t)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ff.fast_forward_np(board, rule, t, device="cpu"), want)


@pytest.mark.parametrize("rule", LINEAR)
def test_jump_equals_iteration_and_the_composed_kernel(rule):
    board = _soup((24, 40), seed=4)
    for t in (1, 5, 12):
        iterated = stencil.multi_step(torch.from_numpy(board), rule, t)
        jumped = ff.fast_forward(torch.from_numpy(board), rule, t)
        composed = ff.apply_offsets(torch.from_numpy(board), ff.pow_offsets(rule, t, (24, 40)))
        assert torch.equal(jumped, iterated) and torch.equal(composed, iterated), t


@pytest.mark.parametrize("t", [-1, 2**62, 2**70])
def test_span_refusal_matches_jax(t):
    with pytest.raises(ValueError) as want:
        jff._require_span(t)
    with pytest.raises(ValueError) as got:
        ff._require_span(t)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rule", LINEAR)
def test_certify_jump_matches_jax(rule):
    board = _soup((48, 96), seed=6)
    want = jff.certify_jump(board, jrule(rule), 8)
    assert ff.certify_jump(torch.from_numpy(board), rule, 8) == want


def test_certify_jump_refuses_a_wrong_jump(monkeypatch):
    board = torch.from_numpy(_soup((32, 32), seed=1))
    monkeypatch.setattr(ff, "fast_forward", lambda b, rule, t: torch.zeros_like(b))
    with pytest.raises(RuntimeError, match="certification failed"):
        ff.certify_jump(board, "replicator", 4)


@pytest.mark.parametrize("lane", ["f32", "int8", "bf16", "auto"])
@pytest.mark.parametrize("shape", [(48, 96), (37, 53)])
@pytest.mark.parametrize("t", [0, 1, 5, 1024, 2**20 + 3])
def test_jump_matmul_every_lane(lane, shape, t):
    board = _soup(shape, seed=t % 31)
    want = ff.fast_forward(torch.from_numpy(board), "fredkin", t).numpy()
    got = ff.jump_matmul_fn("fredkin", t, shape, lane, "cpu")(torch.from_numpy(board)).numpy()
    np.testing.assert_array_equal(got, want)
    if lane == "f32":
        jax_got = np.asarray(jff.jump_matmul_fn(jrule("fredkin"), t, shape, "f32")(jnp.asarray(board)))
        np.testing.assert_array_equal(got, jax_got)


def test_jump_matmul_refuses_a_kernel_that_does_not_separate():
    with pytest.raises(ValueError) as want:
        jff.jump_matmul_fn(jrule("replicator"), 4, (48, 96), "f32")
    with pytest.raises(ValueError) as got:
        ff.jump_matmul_fn("replicator", 4, (48, 96), "f32", "cpu")
    assert str(got.value) == str(want.value)


def test_support_radius_matches_jax():
    for rule in LINEAR:
        for t in (0, 3, 2**40):
            assert ff.support_radius(rule, t) == jff.support_radius(jrule(rule), t)


# -- Simulation.fast_forward: the JAX package's order of checks ----------------


def _sim(**kw):
    base = dict(height=48, width=96, rule="replicator", seed=2, steps_per_call=4)
    base.update(kw)
    return Simulation(SimulationConfig(**base), device="cpu")


@pytest.mark.parametrize(
    "kw,epochs,match",
    [
        (dict(ff_enabled=False), -3, "negative span"),  # the span first
        (dict(ff_enabled=False, rule="conway"), 7, "disabled"),  # then ff_enabled
        (dict(rule="conway"), 7, "not XOR-linear"),  # then linearity
        (dict(), 2**62, "exceeds 62 bits"),
    ],
)
def test_fast_forward_refusals_in_order(kw, epochs, match):
    sim = _sim(**kw)
    with pytest.raises(ValueError, match=match):
        sim.fast_forward(epochs)
    assert sim.epoch == 0


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(kernel="dense"), dict(width=90), dict(sparse_kernel=True, sparse_block=8),
     dict(mesh_shape=(2, 2)), dict(rule="fredkin", kernel="bitpack")],
)
def test_fast_forward_equals_iteration_in_every_layout(kw):
    """Words unpack and repack, dense boards jump in place, the sparse host
    board and a mesh's tiles make the round trip through the device."""
    devices = ["cpu"] * 4 if "mesh_shape" in kw else "cpu"
    base = dict(height=48, width=96, rule="replicator", seed=2, steps_per_call=4)
    base.update(kw)
    jumped = Simulation(SimulationConfig(**base), device=devices)
    iterated = Simulation(SimulationConfig(**base), device=devices)
    assert jumped.fast_forward(12) == 12
    iterated.advance(12)
    np.testing.assert_array_equal(jumped.board_host(), iterated.board_host())
    jumped.advance(8)
    iterated.advance(8)
    assert jumped.board_digest() == iterated.board_digest()
    assert jumped.metrics.value("gol_ff_jumps_total") >= 1
