"""The port's packed sweep against the Pallas packed sweep and the plain step.

On the CPU the sweep wrapper runs its plain version; these tests hold it, and
the multi-step planner around it, against ``pallas_stencil`` in interpret
mode at the sizes ``tests/test_pallas_stencil.py`` uses, bit-exact.  The CUDA
kernel itself is compared with the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from akka_game_of_life_tpu.ops import bitpack as jbp
from akka_game_of_life_tpu.ops import pallas_stencil
from akka_game_of_life_tpu.ops.rules import resolve_rule as jrule
from akka_game_of_life_tpu_torch.ops import bitpack as tbp
from akka_game_of_life_tpu_torch.ops import packed_sweep
from akka_game_of_life_tpu_torch.ops.rules import BRIANS_BRAIN, resolve_rule


def _random_packed(h, words, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(h, words), dtype=np.uint32)


def _t(words):
    return tbp.words_from_numpy(words, "cpu")


@pytest.mark.parametrize("rule", ["conway", "highlife", "day-and-night"])
def test_sweep_matches_pallas(rule):
    x = _random_packed(32, 8)
    want = pallas_stencil.packed_multi_step_fn(
        jrule(rule), 8, block_rows=16, steps_per_sweep=4, interpret=True
    )(jnp.asarray(x))
    got = packed_sweep.packed_multi_step_fn(rule, 8, steps_per_sweep=4)(_t(x))
    np.testing.assert_array_equal(tbp.words_to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("block_rows,k", [(8, 1), (8, 2), (16, 4), (8, 8)])
def test_sweep_depths_match_pallas(block_rows, k):
    x = _random_packed(32, 8, seed=3)
    want = pallas_stencil.packed_multi_step_fn(
        jrule("conway"), 8, block_rows=block_rows, steps_per_sweep=k,
        interpret=True,
    )(jnp.asarray(x))
    got = packed_sweep.packed_sweep_reference(_t(x), "conway", 8)
    np.testing.assert_array_equal(tbp.words_to_numpy(got), np.asarray(want))
    stepped = packed_sweep.packed_multi_step_fn("conway", 8, steps_per_sweep=k)(_t(x))
    np.testing.assert_array_equal(tbp.words_to_numpy(stepped), np.asarray(want))


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("rule", ["conway", "seeds", "life-without-death"])
def test_sweep_matches_bitpack(rule, k):
    x = _random_packed(13, 3, seed=k)
    want = jbp.packed_multi_step_fn(jrule(rule), k)(jnp.asarray(x))
    got = packed_sweep.packed_sweep(_t(x), rule, k)
    np.testing.assert_array_equal(tbp.words_to_numpy(got), np.asarray(want))


def test_plan_sweeps():
    k = packed_sweep.DEFAULT_STEPS_PER_SWEEP
    assert packed_sweep.plan_sweeps(k) == [k]
    assert packed_sweep.plan_sweeps(2 * k + 1) == [k, k, 1]
    assert packed_sweep.plan_sweeps(12, steps_per_sweep=3) == [3] * 4
    for n in range(1, 70):
        depths = packed_sweep.plan_sweeps(n)
        assert sum(depths) == n and max(depths) <= k


@pytest.mark.parametrize("n", [5, 13])
def test_remainder_sweep_matches_bitpack(n):
    x = _random_packed(9, 2, seed=n)
    want = jbp.packed_multi_step_fn(jrule("highlife"), n)(jnp.asarray(x))
    got = packed_sweep.packed_multi_step_fn("highlife", n)(_t(x))
    np.testing.assert_array_equal(tbp.words_to_numpy(got), np.asarray(want))


def test_rejects_bad_configs():
    x = _t(_random_packed(8, 2))
    with pytest.raises(ValueError, match="binary"):
        packed_sweep.packed_sweep(x, BRIANS_BRAIN, 2)
    with pytest.raises(ValueError, match="binary"):
        packed_sweep.packed_multi_step_fn("bugs", 4)
    with pytest.raises(ValueError, match="multiple"):
        packed_sweep.packed_multi_step_fn("conway", 10, steps_per_sweep=4)
    with pytest.raises(ValueError, match=">= 1"):
        packed_sweep.packed_sweep(x, "conway", 0)
    with pytest.raises(ValueError, match="halo"):
        packed_sweep.packed_sweep(x, "conway", packed_sweep.MAX_STEPS_PER_SWEEP + 1)


def test_cpu_runs_plain_version_without_launching():
    before = packed_sweep.packed_sweep.launches
    packed_sweep.packed_multi_step_fn("conway", 12)(_t(_random_packed(5, 1)))
    assert packed_sweep.packed_sweep.launches == before


def test_launch_path_raises_on_cpu_tensor():
    """Forced onto the CUDA path, a CPU tensor raises; it never falls back."""
    before = packed_sweep.packed_sweep.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        packed_sweep._launch(_t(_random_packed(4, 2)), resolve_rule("conway"), 2)
    assert packed_sweep.packed_sweep.launches == before


def test_rule_masks_and_op_count():
    assert packed_sweep.rule_masks(resolve_rule("conway")) == (1 << 3, (1 << 3) | (1 << 4))
    assert packed_sweep.rule_masks(resolve_rule("seeds")) == (1 << 2, 0)
    # Row sums 2 SHF + 2 LOP3, count bits 6 LOP3 (b3 unread), and Conway's
    # combine in two: t = b1 ? b0 : (~b0 & x), next = t & (b1 ^ b2).
    assert packed_sweep.ops_per_word_step("conway") == 12
    # Replicator (B1357/S1357) lives iff count-without-centre is odd: b0 ^ x.
    assert packed_sweep.ops_per_word_step("replicator") == 11
    # Day & Night's combine needs more than two LOP3.
    assert packed_sweep.ops_per_word_step("day-and-night") == 13
    for rule in ("highlife", "seeds", "life-without-death"):
        assert 10 <= packed_sweep.ops_per_word_step(rule) <= 14


def test_library_key_is_the_rule_and_the_tile():
    """One library per rule: every binary rule of the catalogue and a
    custom B/S string map to their own masks' defines (and combine
    network's), equal rules to one key, and the default tile, named or
    not, adds nothing to it."""
    from akka_game_of_life_tpu_torch.ops.rules import NAMED_RULES

    rules = [r for r in NAMED_RULES.values() if r.kind == "totalistic" and r.states == 2]
    rules.append(resolve_rule("B0378/S1268"))
    assert len(rules) >= 6
    by_key = {}
    for rule in rules:
        birth, survive1 = packed_sweep.rule_masks(rule)
        key = packed_sweep.library_defines(rule)
        assert key[:2] == (f"-DRULE_BIRTH={birth:#x}", f"-DRULE_SURVIVE1={survive1:#x}")
        assert key[2:] == packed_sweep.combine_define(rule)
        by_key.setdefault(key, set()).add((rule.birth, rule.survive))
    assert all(len(same) == 1 for same in by_key.values())
    assert len(by_key) == len({(r.birth, r.survive) for r in rules})
    default = packed_sweep.library_defines("conway")
    assert default == packed_sweep.library_defines("B3/S23", packed_sweep.DEFAULT_TILE_ROWS)
    assert packed_sweep.library_defines("conway", 64) == (*default, "-DTILE_ROWS=64")


def _network_next_state(net, t, x):
    """The kernel's combine from ``-DRULE_COMBINE``: a LOP3 over three of
    the signals b0..b3 (the 9-cell count's bits) and x, then maybe one
    over it and two more."""
    signal = [t & 1, (t >> 1) & 1, (t >> 2) & 1, (t >> 3) & 1, x]

    def lop3(table, a, b, c):
        return (table >> (4 * a + 2 * b + c)) & 1

    first = lop3(net & 0xFF, *(signal[(net >> s) & 7] for s in (8, 11, 14)))
    if not net >> 31:
        return first
    return lop3((net >> 17) & 0xFF, first, *(signal[(net >> s) & 7] for s in (25, 28)))


@pytest.mark.parametrize("seed", range(3))
def test_combine_network_computes_the_rule(seed):
    """Every network ``combine_define`` hands the kernel gives the rule's
    next state at every (count, cell) a torus can show; Conway's and
    HighLife's take two LOP3, Day & Night's none fits in two."""
    from akka_game_of_life_tpu_torch.ops.rules import NAMED_RULES, Rule

    rng = np.random.default_rng(seed)
    rules = [r for r in NAMED_RULES.values() if r.kind == "totalistic" and r.states == 2]
    rules += [Rule(frozenset(int(n) for n in np.flatnonzero(rng.random(9) < 0.3)),
                   frozenset(int(n) for n in np.flatnonzero(rng.random(9) < 0.4)))
              for _ in range(40)]
    networks = 0
    for rule in rules:
        define = packed_sweep.combine_define(rule)
        if not define:
            continue
        networks += 1
        net = int(define[0].split("=")[1], 16)
        for x in (0, 1):
            for t in range(x, 9 + x):
                want = int(t in ({n + 1 for n in rule.survive} if x else rule.birth))
                assert _network_next_state(net, t, x) == want, (rule, t, x)
    assert networks >= 10
    for name in ("conway", "highlife"):
        assert (int(packed_sweep.combine_define(name)[0].split("=")[1], 16) >> 31) == 1
    assert packed_sweep.combine_define("day-and-night") == ()
