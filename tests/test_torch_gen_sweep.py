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
    # The alive plane 1, its row sums 4, the count bits 6, the combine, the
    # planes' update.  WireWorld: excite = (b0 ^ b1) & ~b2 in one LOP3, p1'
    # one more (p0' is p1).
    assert gen_sweep.ops_per_word_step("wireworld") == 1 + 4 + 6 + 1 + 1
    # Brian's Brain: birth on 2 in one LOP3 (no survival, so dead cells
    # only), then one LOP3 per plane over (net, p0, p1).
    assert gen_sweep.ops_per_word_step("brians-brain") == 1 + 4 + 6 + 1 + 2
    # Star Wars: its combine needs two LOP3, as Conway's does.
    assert gen_sweep.ops_per_word_step("star-wars") == 1 + 4 + 6 + 2 + 2
    # Deeper planes: one LOP3 per plane and per carry past p0 & p1.
    assert gen_sweep.ops_per_word_step("B2/S/7") == 1 + 4 + 6 + 1 + 3
    assert gen_sweep.ops_per_word_step("B2/S345/200") == 4 + 4 + 6 + 2 + 8 + 5
    assert gen_sweep.ops_per_word_step("B2/S/7") > gen_sweep.ops_per_word_step("brians-brain")


def _custom_rules():
    return ["B2/S/7", "B2/S345/200", "B3678/S34678/3", "B28/S0812/17", "B1/S1/5",
            "B2/S/3", "B2/S345/4", "B0/S8/6", "B45/S/33", "B3/S23/65", "B36/S125/128"]


def test_library_key_is_the_rule_and_the_tile():
    """One library per rule: the catalogue's Generations rules, WireWorld
    and custom B/S/C strings map to their masks', state count's, WireWorld
    flag's and combine network's defines; equal rules share a key, and the
    default tile, named or not, adds nothing to it."""
    from akka_game_of_life_tpu_torch.ops.packed_sweep import combine_choice
    from akka_game_of_life_tpu_torch.ops.rules import NAMED_RULES

    rules = [r for r in NAMED_RULES.values() if r.kind != "ltl" and r.states > 2]
    rules += [resolve_rule(r) for r in _custom_rules()]
    by_key = {}
    for rule in rules:
        birth, survive1 = gen_sweep.rule_masks(rule)
        key = gen_sweep.library_defines(rule)
        wire = rule.kind == "wireworld"
        head = (f"-DRULE_BIRTH={birth:#x}", f"-DRULE_SURVIVE1={survive1:#x}",
                f"-DRULE_STATES={rule.states}", *(("-DRULE_WIREWORLD=1",) if wire else ()))
        assert key[: len(head)] == head
        assert key[len(head):] == combine_choice(rule, gen_sweep.combine_cells(rule))[1]
        by_key.setdefault(key, set()).add((rule.birth, rule.survive, rule.states, wire))
    assert all(len(same) == 1 for same in by_key.values())
    assert len(by_key) == len(rules) - 2  # B2/S/3 and B2/S345/4 are named rules
    assert gen_sweep.library_defines("B2/S/3") == gen_sweep.library_defines("brians-brain")
    default = gen_sweep.library_defines("wireworld")
    assert default == gen_sweep.library_defines("wireworld", gen_sweep.DEFAULT_TILE_ROWS)
    assert gen_sweep.library_defines("wireworld", 32) == (*default, "-DTILE_ROWS=32")
    with pytest.raises(ValueError, match="packed sweep"):
        gen_sweep.library_defines("conway")


def _defines(key):
    return dict(d[2:].split("=") for d in key)


def _kernel_next_state(key, t, state):
    """``csrc/gen_sweep.cu``'s step of one cell, read from its library's
    defines: ``net`` from the combine network (or the lookup tables) over
    the count bits and plane 0, then the planes' update."""
    d = _defines(key)
    birth, survive1 = int(d["RULE_BIRTH"], 16), int(d["RULE_SURVIVE1"], 16)
    states, wire = int(d["RULE_STATES"]), "RULE_WIREWORLD" in d
    m = tgen.n_planes(states)
    x = [(state >> j) & 1 for j in range(m)]
    b = [(t >> i) & 1 for i in range(4)]
    dead_only = wire or survive1 == 0
    if "RULE_COMBINE" in d:
        net_code = int(d["RULE_COMBINE"], 16)
        signal = b + [x[0]]

        def lop3(table, a, b_, c):
            return (table >> (4 * a + 2 * b_ + c)) & 1

        net = lop3(net_code & 0xFF, *(signal[(net_code >> s) & 7] for s in (8, 11, 14)))
        if net_code >> 31:
            net = lop3((net_code >> 17) & 0xFF, net,
                       *(signal[(net_code >> s) & 7] for s in (25, 28)))
    else:
        low = t & 7
        born = (birth >> low) & 1 ^ (b[3] if ((birth >> 8) ^ birth) & 1 else 0)
        stays = (survive1 >> (8 if low == 0 else low)) & 1
        if ((survive1 >> 9) ^ (survive1 >> 1)) & 1:
            stays ^= b[3] & b[0]
        net = born if dead_only else (stays if x[0] else born)
    if wire:
        y = [x[1], (x[0] ^ x[1]) | (x[0] & x[1] & (1 - net))]
    elif m == 2:
        dead = state == 0
        to_one = (dead or (state == 1 and not dead_only)) and net
        advance = not dead and not to_one and state != states - 1
        nxt = 1 if to_one else (state + 1) % 4 if advance else 0
        y = [nxt & 1, nxt >> 1]
    else:
        z = int(not any(x[1:]))
        wrap = int(state == states - 1)
        wraps = [(states >> j) & 1 for j in range(m)]
        to_one = z & (1 - x[0]) & net if dead_only else z & net
        rest = (1 - x[0]) & (1 - z) & (1 - wrap if wraps[0] else 1)
        y = [to_one | rest]
        inc = (x[1] ^ x[0]) & (1 - wrap if wraps[1] else 1)
        y.append(inc if dead_only else inc & (1 - to_one))
        carry = x[0] & x[1]
        for j in range(2, m):
            y.append((x[j] ^ carry) & (1 - wrap if wraps[j] else 1))
            carry &= x[j]
    return sum(bit << j for j, bit in enumerate(y))


def _plain_next_states(rule, cases):
    """The plain plane step of each (9-cell count, state) case: the cell
    at row 1 of a 3-row torus, its 8 neighbours holding count - (state ==
    1) live cells, every case 4 columns apart."""
    width = -(-4 * len(cases) // 32) * 32
    board = np.zeros((3, width), np.uint8)
    ring = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1), (2, 2)]
    for i, (t, state) in enumerate(cases):
        board[1, 4 * i + 1] = state
        for r, c in ring[: t - int(state == 1)]:
            board[r, 4 * i + c] = 1
    planes = tgen.planes_from_numpy(tgen.pack_gen_np(board, rule.states))
    after = tgen.unpack_gen_np(tgen.planes_to_numpy(tgen.step_gen(planes, rule)))
    return [int(after[1, 4 * i + 1]) for i in range(len(cases))]


@pytest.mark.parametrize("seed", range(2))
def test_kernel_step_model_matches_the_plane_step(seed):
    """The kernel's step, read from each library's defines, equals the
    plain plane step at every 9-cell count and every one of the 2^m plane
    encodings (those that encode no state of the rule included), for the
    catalogue's rules, custom ones at every m = 2..8 and random ones."""
    from akka_game_of_life_tpu_torch.ops.rules import Rule

    rng = np.random.default_rng(seed)
    names = ["brians-brain", "star-wars", "wireworld", *_custom_rules()]
    rules = [resolve_rule(n) for n in names[seed::2]]
    rules += [Rule(frozenset(int(n) for n in np.flatnonzero(rng.random(9) < 0.3)),
                   frozenset(int(n) for n in np.flatnonzero(rng.random(9) < (j % 4) / 4)),
                   states=int(rng.integers(3, 256)))
              for j in range(8)]
    assert {tgen.n_planes(r.states) for r in rules} >= {2, 3, 8}
    for rule in rules:
        m = tgen.n_planes(rule.states)
        key = gen_sweep.library_defines(rule)
        cases = [(t, state) for state in range(2**m) for t in range(10)
                 if (state == 1) <= t <= 8 + (state == 1)]
        want = _plain_next_states(rule, cases)
        got = [_kernel_next_state(key, t, state) for t, state in cases]
        assert got == want, rule
