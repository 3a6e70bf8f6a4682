"""The port's plane sweep against the Pallas plane sweep and the plain step.

On the CPU the sweep wrapper runs its plain version; these tests hold it,
and the multi-step planner around it, against ``pallas_gen`` in interpret
mode at the sizes ``tests/test_pallas_gen.py`` uses (64 rows × 2 words),
bit-exact.  The CUDA kernel itself is compared with the plain version on the
card by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from akka_game_of_life_tpu.ops import bitpack_gen as jgen
from akka_game_of_life_tpu.ops import pallas_gen
from akka_game_of_life_tpu.ops.rules import resolve_rule as jrule
from akka_game_of_life_tpu_torch.ops import bitpack_gen as tgen
from akka_game_of_life_tpu_torch.ops import gen_sweep
from akka_game_of_life_tpu_torch.ops.packed_sweep import MAX_STEPS_PER_SWEEP
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule


def _random_planes(rule, h, words, seed=0):
    """Valid boards packed, as tests/test_pallas_gen.py makes them."""
    rng = np.random.default_rng(seed)
    states = resolve_rule(rule).states
    board = rng.integers(0, states, size=(h, words * 32), dtype=np.uint8)
    return tgen.pack_gen_np(board, states)


def _t(planes):
    return tgen.planes_from_numpy(planes, "cpu")


@pytest.mark.parametrize("rule", ["brians-brain", "star-wars", "B2/S/7", "wireworld"])
@pytest.mark.parametrize("block_rows,steps_per_sweep", [(16, 4), (32, 8), (8, 1)])
def test_sweep_matches_pallas(rule, block_rows, steps_per_sweep):
    planes = _random_planes(rule, 64, 2, seed=7)
    n_steps = steps_per_sweep * 3
    want = pallas_gen.gen_pallas_multi_step_fn(
        jrule(rule), n_steps, block_rows=block_rows,
        steps_per_sweep=steps_per_sweep, interpret=True,
    )(jnp.asarray(planes))
    got = gen_sweep.gen_multi_step_fn(rule, n_steps, steps_per_sweep=steps_per_sweep)(_t(planes))
    np.testing.assert_array_equal(tgen.planes_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("n", [5, 10, 23])
@pytest.mark.parametrize("rule", ["brians-brain", "wireworld"])
def test_default_plan_matches_plane_scan(rule, n):
    """Random uint32 planes (invalid encodings included) through the
    default plan (10-deep sweeps plus a remainder)."""
    planes = np.random.default_rng(n).integers(0, 2**32, size=(2, 13, 3), dtype=np.uint32)
    want = jgen.gen_multi_step_fn(jrule(rule), n)(jnp.asarray(planes))
    got = gen_sweep.gen_multi_step_fn(rule, n)(_t(planes))
    np.testing.assert_array_equal(tgen.planes_to_numpy(got), np.asarray(want))


def test_rejects_bad_configs():
    bb = _t(_random_planes("brians-brain", 16, 1))
    with pytest.raises(ValueError, match="planes"):
        gen_sweep.gen_sweep(bb[:1], "brians-brain", 2)  # wrong plane count
    with pytest.raises(ValueError, match="planes"):
        gen_sweep.gen_sweep(bb, "B2/S/7", 2)  # 3 planes expected
    with pytest.raises(ValueError, match=">= 1"):
        gen_sweep.gen_sweep(bb, "brians-brain", 0)
    with pytest.raises(ValueError, match="limit"):
        gen_sweep.gen_sweep(bb, "brians-brain", MAX_STEPS_PER_SWEEP + 1)
    with pytest.raises(ValueError, match="multiple"):
        gen_sweep.gen_multi_step_fn("brians-brain", 10, steps_per_sweep=4)
    with pytest.raises(ValueError, match="totalistic and wireworld"):
        gen_sweep.gen_multi_step_fn("bugs", 4)
    with pytest.raises(ValueError, match="packed sweep"):
        gen_sweep.gen_multi_step_fn("conway", 4)


def test_cpu_runs_plain_version_without_launching():
    before = gen_sweep.gen_sweep.launches
    gen_sweep.gen_multi_step_fn("star-wars", 12)(_t(_random_planes("star-wars", 5, 1)))
    assert gen_sweep.gen_sweep.launches == before


def test_launch_path_raises_on_cpu_tensor():
    """Forced onto the CUDA path, a CPU tensor raises; it never falls back."""
    before = gen_sweep.gen_sweep.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        gen_sweep._launch(_t(_random_planes("wireworld", 4, 2)), resolve_rule("wireworld"), 2)
    assert gen_sweep.gen_sweep.launches == before


@pytest.mark.parametrize("states", [3, 5, 9, 17, 33, 65, 200])
def test_deepest_sweep_at_every_plane_count(states):
    """Every m = 2..8 takes the one-word halo's full depth; one deeper is
    refused."""
    rule = f"B2/S345/{states}"
    m = tgen.n_planes(states)
    planes = np.random.default_rng(states).integers(0, 2**32, size=(m, 9, 1), dtype=np.uint32)
    want = jgen.gen_multi_step_fn(jrule(rule), MAX_STEPS_PER_SWEEP)(jnp.asarray(planes))
    got = gen_sweep.gen_sweep(_t(planes), rule, MAX_STEPS_PER_SWEEP)
    np.testing.assert_array_equal(tgen.planes_to_numpy(got), np.asarray(want))
    with pytest.raises(ValueError, match="limit"):
        gen_sweep.gen_sweep(_t(planes), rule, MAX_STEPS_PER_SWEEP + 1)


def test_rule_masks_and_op_count():
    assert gen_sweep.rule_masks(resolve_rule("brians-brain")) == (1 << 2, 0)
    assert gen_sweep.rule_masks(resolve_rule("star-wars")) == (1 << 2, 0b111 << 4)
    # WireWorld excites on 1 or 2 heads, with no self term.
    assert gen_sweep.rule_masks(resolve_rule("wireworld")) == (0b110, 0)
    assert gen_sweep.ops_per_word_step("wireworld") == 15
    assert gen_sweep.ops_per_word_step("brians-brain") == 21
    assert gen_sweep.ops_per_word_step("star-wars") == 24
    assert gen_sweep.ops_per_word_step("B2/S/7") > gen_sweep.ops_per_word_step("brians-brain")
