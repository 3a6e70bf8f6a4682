"""The port's LtL step against the Pallas LtL kernel and the plain step.

On the CPU the wrapper runs its plain version; these tests hold it against
``pallas_ltl`` in interpret mode at the sizes ``tests/test_pallas_ltl.py``
uses, bit-exact.  The CUDA kernel itself is compared with the plain version
on the card by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_game_of_life_tpu.ops import pallas_ltl
from akka_game_of_life_tpu.ops.rules import Rule as JRule
from akka_game_of_life_tpu.ops.rules import resolve_rule as jrule
from akka_game_of_life_tpu_torch.ops import ltl_sweep
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule


def _soup(h, w, seed=0, density=0.4):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def _band(cls, radius):
    max_n = (2 * radius + 1) ** 2 - 1
    lo = radius * (radius + 1)
    return cls(
        frozenset(n for n in range(lo, lo + 8) if n <= max_n),
        frozenset(n for n in range(max(0, lo - 2), lo + 11) if n <= max_n),
        radius=radius,
        kind="ltl",
    )


def _pallas(rule, board, n, block_rows):
    return np.asarray(
        pallas_ltl.ltl_pallas_multi_step_fn(
            rule, n, block_rows=block_rows, interpret=True
        )(jnp.asarray(board))
    )


@pytest.mark.parametrize("radius", [1, 2, 5])
@pytest.mark.parametrize("block_rows", [8, 16])
def test_matches_pallas(radius, block_rows):
    board = _soup(32, 64, seed=radius)
    want = _pallas(_band(JRule, radius), board, 3, block_rows)
    got = ltl_sweep.ltl_multi_step_fn(_band(Rule, radius), 3)(torch.from_numpy(board))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bugs_matches_pallas():
    board = _soup(24, 48, seed=9, density=0.35)
    want = _pallas(jrule("bugs"), board, 2, 8)
    got = ltl_sweep.ltl_multi_step_fn("bugs", 2)(torch.from_numpy(board))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sparse_count_set_matches_pallas():
    spec = dict(radius=2, kind="ltl")
    board = _soup(16, 32, seed=4)
    want = _pallas(JRule(frozenset({3, 4, 5, 9}), frozenset({2, 3, 8}), **spec), board, 2, 8)
    rule = Rule(frozenset({3, 4, 5, 9}), frozenset({2, 3, 8}), **spec)
    got = ltl_sweep.ltl_multi_step_fn(rule, 2)(torch.from_numpy(board))
    np.testing.assert_array_equal(got.numpy(), want)


def test_refuses_the_diamond_and_other_families():
    board = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="box neighborhoods"):
        ltl_sweep.ltl_sweep(board, "R2,B3-5,S2-6,NN")
    with pytest.raises(ValueError, match="box neighborhoods"):
        ltl_sweep.ltl_multi_step_fn("conway", 2)


def test_cpu_runs_plain_version_without_launching():
    before = ltl_sweep.ltl_sweep.launches
    ltl_sweep.ltl_multi_step_fn("bugs", 2)(torch.from_numpy(_soup(12, 12)))
    assert ltl_sweep.ltl_sweep.launches == before


def test_launch_path_raises_on_cpu_tensor():
    """Forced onto the CUDA path, a CPU tensor raises; it never falls back."""
    before = ltl_sweep.ltl_sweep.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        ltl_sweep._launch(torch.from_numpy(_soup(8, 8)), resolve_rule("bugs"))
    assert ltl_sweep.ltl_sweep.launches == before


def test_rule_words_and_op_count():
    """The kernel's rule table: the counts of birth and survive runs, then
    each run's lowest box count and one past its highest (box counts include
    the centre, so survive runs move up by one)."""
    assert ltl_sweep.rule_ranges(resolve_rule("bugs")) == [1, 1, 34, 46, 34, 59]
    sparse = Rule(frozenset({3, 4, 5, 9}), frozenset({2, 3, 8}), radius=2, kind="ltl")
    assert ltl_sweep.rule_ranges(sparse) == [2, 2, 3, 6, 9, 10, 3, 5, 9, 10]
    top = _band(Rule, 10)
    assert ltl_sweep.rule_ranges(top)[-1] == max(top.survive) + 2
    assert ltl_sweep.ops_per_cell("bugs") == ltl_sweep.ops_per_cell(top) == 9


@pytest.mark.parametrize("seed", range(4))
def test_rule_ranges_decode_to_the_sets(seed):
    rng = np.random.default_rng(seed)
    radius = int(rng.integers(1, 11))
    counts = range((2 * radius + 1) ** 2)
    birth = frozenset(n for n in counts if rng.random() < 0.3)
    survive = frozenset(n for n in counts if rng.random() < 0.6)
    table = ltl_sweep.rule_ranges(Rule(birth, survive, radius=radius, kind="ltl"))
    nb, ns = table[0], table[1]
    runs = [table[2 + 2 * i: 4 + 2 * i] for i in range(nb + ns)]
    assert len(table) == 2 + 2 * (nb + ns)
    assert {n for lo, hi in runs[:nb] for n in range(lo, hi)} == birth
    assert {n - 1 for lo, hi in runs[nb:] for n in range(lo, hi)} == survive
    assert all(hi > lo for lo, hi in runs)
