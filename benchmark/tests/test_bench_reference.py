"""The plain reference against hand-worked boards, and its layout and
digest helpers against their definitions."""

import numpy as np
import pytest
import torch

from benchmark.core.spec import BENCH_DIR, load_module

ref = load_module(BENCH_DIR / "references" / "lifelike.py")


def board(rows):
    return torch.tensor(rows, dtype=torch.uint8)[None]


def test_blinker_flips_with_period_two():
    b = torch.zeros((1, 5, 5), dtype=torch.uint8)
    b[0, 2, 1:4] = 1
    one = ref.run(b, 1, ["conway"])
    want = torch.zeros_like(b)
    want[0, 1:4, 2] = 1
    assert torch.equal(one, want)
    assert torch.equal(ref.run(b, 2, ["conway"]), b)


def test_glider_moves_one_cell_diagonally_in_four_generations_and_wraps():
    g = np.zeros((6, 6), np.uint8)
    g[0, 1] = g[1, 2] = g[2, 0] = g[2, 1] = g[2, 2] = 1
    b = torch.from_numpy(g)[None]
    assert torch.equal(ref.run(b, 4, ["conway"])[0], torch.from_numpy(np.roll(g, (1, 1), (0, 1))))
    # 24 generations on a 6 x 6 torus: six cells down and right, home again.
    assert torch.equal(ref.run(b, 24, ["conway"])[0], b[0])


def test_glider_without_the_torus_dies_at_the_edge():
    g = np.zeros((6, 6), np.uint8)
    g[0, 1] = g[1, 2] = g[2, 0] = g[2, 1] = g[2, 2] = 1
    b = torch.from_numpy(g)[None]
    assert not torch.equal(ref.run(b, 24, ["conway"], torus=False)[0], b[0])


def test_brians_brain_decays_through_its_refractory_state():
    b = torch.zeros((1, 6, 6), dtype=torch.uint8)
    b[0, 2, 2] = 1  # a lone firing cell: no neighbour has two firing neighbours
    one = ref.run(b, 1, ["brians-brain"])
    want = torch.zeros_like(b)
    want[0, 2, 2] = 2
    assert torch.equal(one, want)
    assert int(ref.run(b, 2, ["brians-brain"]).sum()) == 0
    # Two firing cells side by side: the four cells above and below both fire.
    b[0, 2, 3] = 1
    two = ref.run(b, 1, ["brians-brain"])[0]
    assert two[2, 2] == 2 and two[2, 3] == 2
    assert int((two == 1).sum()) == 4 and two[1, 2] == 1 and two[3, 3] == 1


def test_star_wars_counts_down_through_two_refractory_states():
    b = torch.zeros((1, 5, 5), dtype=torch.uint8)
    b[0, 2, 2] = 1
    assert ref.run(b, 1, ["star-wars"])[0, 2, 2] == 2
    assert ref.run(b, 2, ["star-wars"])[0, 2, 2] == 3
    assert int(ref.run(b, 3, ["star-wars"]).sum()) == 0


def test_per_board_rules_equal_one_rule_at_a_time():
    rng = np.random.default_rng(3)
    rules = ["conway", "highlife", "seeds", "brians-brain", "star-wars"]
    b = torch.from_numpy((rng.random((5, 12, 16)) < 0.4).astype(np.uint8))
    together = ref.run(b, 7, rules)
    for i, r in enumerate(rules):
        assert torch.equal(together[i], ref.run(b[i:i + 1], 7, [r])[0])


def test_words_round_trip_lsb_first():
    rng = np.random.default_rng(5)
    dense = torch.from_numpy((rng.random((4, 64)) < 0.5).astype(np.uint8))
    words = ref.pack_words(dense)
    assert words.dtype == torch.int32 and words.shape == (4, 2)
    assert torch.equal(ref.unpack_words(words), dense)
    one = torch.zeros((1, 64), dtype=torch.uint8)
    one[0, 33] = 1  # word 1, bit 1
    assert ref.pack_words(one).tolist() == [[0, 2]]
    top = torch.zeros((1, 32), dtype=torch.uint8)
    top[0, 31] = 1
    assert ref.pack_words(top).tolist() == [[-(2 ** 31)]]


def _fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_digest_follows_its_definition():
    rng = np.random.default_rng(7)
    cells = (rng.random((2, 5, 7)) * 3).astype(np.uint8)
    got = ref.digest(torch.from_numpy(cells))
    for b in range(2):
        lanes = []
        for seed in (0x9E3779B9, 0x7F4A7C15):
            lanes.append(sum(int(cells[b, r, c]) * _fmix32(((r * 7 + c) & 0xFFFFFFFF) ^ seed)
                             for r in range(5) for c in range(7)) & 0xFFFFFFFF)
        assert int(got[b]) == (lanes[1] << 32) | lanes[0]


def test_random_grid_is_the_serve_planes_board():
    from akka_game_of_life_tpu_torch.utils.patterns import random_grid

    for seed, shape, density in [(0, (32, 32), 0.5), (2 ** 31 * 256 + 5, (256, 200), 0.5), (9, (7, 3), 0.1)]:
        assert np.array_equal(ref.random_grid(*shape, density, seed),
                              random_grid(shape, density=density, seed=seed))


@pytest.mark.parametrize("rule", ["conway", "highlife", "seeds", "brians-brain", "star-wars"])
def test_reference_agrees_with_the_ports_plain_stepper(rule):
    from akka_game_of_life_tpu_torch.models.registry import get_model
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    rng = np.random.default_rng(11)
    cells = (rng.random((24, 40)) < 0.45).astype(np.uint8)
    port = get_model(resolve_rule(rule)).run(9)(torch.from_numpy(cells))
    assert torch.equal(ref.run(torch.from_numpy(cells)[None], 9, [rule])[0], port.to(torch.uint8))
