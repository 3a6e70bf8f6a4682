"""The port's batched serve step, memo block step, digest batch and lane
cache against the JAX package's, bit for bit, on the CPU.

The same seeded numpy batches (mixed rules, shapes smaller than and not
square in their class, per-board step counts from 0 to the scan length)
go through ``serve/batch.py:batch_step_fn`` of both packages; boards and
digest lanes must be equal, and each board must equal the numpy oracle's
single-board toroidal run.
"""

import numpy as np
import pytest
import torch

import akka_game_of_life_tpu.ops.digest as j_digest
import akka_game_of_life_tpu.serve.batch as jb
import akka_game_of_life_tpu_torch.ops.digest as t_digest
import akka_game_of_life_tpu_torch.serve.batch as tb
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
from _torch_serve_pkgs import oracle

import jax.numpy as jnp

RULES = ("conway", "highlife", "seeds", "brians-brain", "star-wars")


def _mix(cls: int, b: int, length: int, seed: int):
    """A padded class-``cls`` batch of ``b`` boards: rules cycle through
    RULES, shapes from 1 row up to the class side, n from 0 to length."""
    rng = np.random.default_rng(seed)
    boards = np.zeros((b, cls, cls), np.uint8)
    birth = np.zeros(b, np.uint32)
    survive = np.zeros(b, np.uint32)
    states = np.full(b, 2, np.int32)
    hs = np.ones(b, np.int32)
    ws = np.ones(b, np.int32)
    ns = np.zeros(b, np.int32)
    names = []
    for i in range(b):
        rule = resolve_rule(RULES[i % len(RULES)])
        h = cls if i % 4 == 0 else int(rng.integers(1, cls + 1))
        w = cls if i % 4 == 0 else int(rng.integers(1, cls + 1))
        boards[i, :h, :w] = rng.integers(0, rule.states, (h, w))
        birth[i], survive[i], states[i] = tb.rule_operands(rule)
        hs[i], ws[i] = h, w
        ns[i] = (0, length)[i % 2] if i < 2 else int(rng.integers(0, length + 1))
        names.append(rule)
    return names, (boards, birth, survive, states, hs, ws, ns)


@pytest.mark.parametrize("cls,b,length,seed", [
    (32, 8, 8, 0), (32, 32, 4, 1), (64, 16, 8, 2), (64, 8, 16, 3),
])
def test_batch_step_matches_jax_and_the_oracle(cls, b, length, seed):
    names, ops = _mix(cls, b, length, seed)
    j_out, j_lanes = jb.batch_step_fn(cls, length)(*ops)
    t_out, t_lanes = tb.batch_step_fn(cls, length, "cpu")(*ops)
    assert t_out.dtype == torch.uint8 and t_out.shape == (b, cls, cls)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_lanes.numpy().astype(np.uint32), np.asarray(j_lanes, np.uint32))
    boards, _, _, _, hs, ws, ns = ops
    for i, rule in enumerate(names):
        h, w = hs[i], ws[i]
        want = oracle(rule, boards[i, :h, :w], int(ns[i]))
        np.testing.assert_array_equal(t_out[i, :h, :w].numpy(), want)
        assert not t_out[i, h:, :].any() and not t_out[i, :, w:].any()


@pytest.mark.parametrize("block", [16, 32])
def test_memo_block_step_matches_jax(block):
    rng = np.random.default_rng(block)
    n = 8
    blocks = np.zeros((n, block, block), np.uint8)
    birth = np.zeros(n, np.uint32)
    survive = np.zeros(n, np.uint32)
    states = np.full(n, 2, np.int32)
    for i in range(n):
        rule = resolve_rule(RULES[i % len(RULES)])
        blocks[i] = rng.integers(0, rule.states, (block, block))
        birth[i], survive[i], states[i] = tb.rule_operands(rule)
    j_c = np.asarray(jb.memo_block_step_fn(block)(blocks, birth, survive, states))
    t_c = tb.memo_block_step_fn(block, "cpu")(blocks, birth, survive, states)
    assert t_c.shape == (n, block // 2, block // 2)
    np.testing.assert_array_equal(t_c.numpy(), j_c)
    # The centre after B/4 toroidal steps of the block is the block's own
    # oracle run (the macro-cell theorem the memo plane relies on).
    s = block // 4
    rule = resolve_rule(RULES[0])
    want = oracle(rule, blocks[0], s)[s : s + block // 2, s : s + block // 2]
    np.testing.assert_array_equal(t_c[0].numpy(), want)


def test_digest_dense_batch_matches_per_board_and_jax():
    rng = np.random.default_rng(5)
    b, c = 12, 48
    boards = np.zeros((b, c, c), np.uint8)
    widths = np.zeros(b, np.int64)
    for i in range(b):
        h, w = int(rng.integers(1, c + 1)), int(rng.integers(1, c + 1))
        boards[i, :h, :w] = rng.integers(0, 256 if i == 3 else 4, (h, w))
        widths[i] = w
    got = t_digest.digest_dense_batch(torch.from_numpy(boards), widths).numpy()
    assert got.shape == (b, 2)
    for i in range(b):
        w = int(widths[i])
        single = t_digest.digest_dense(torch.from_numpy(boards[i, :, :w])).numpy()
        np.testing.assert_array_equal(got[i], single)
    want = np.asarray(j_digest.digest_dense_batch(jnp.asarray(boards), widths.astype(np.uint32)))
    np.testing.assert_array_equal(got.astype(np.uint32), want.astype(np.uint32))


def test_block_lane_cache_hits_and_misses_match_jax():
    rng = np.random.default_rng(9)
    caches = (t_digest.BlockLaneCache(max_entries=3), j_digest.BlockLaneCache(max_entries=3))
    blocks = [rng.integers(0, 2, (8, 8)).astype(np.uint8) for _ in range(4)]
    script = [(0, (0, 0)), (1, (0, 8)), (0, (0, 0)), (2, (8, 0)), (3, (8, 8)), (1, (0, 8)), (0, (0, 0))]
    trails = []
    for cache in caches:
        trail = []
        for k, origin in script:
            lanes = cache.block_lanes(bytes([k]), blocks[k], origin, 64)
            trail.append((tuple(int(v) for v in lanes), cache.hits, cache.misses, len(cache)))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[0][-1][1:] == (1, 6, 3)  # LRU of 3: only the third lookup hits


def test_program_cache_and_registration():
    from akka_game_of_life_tpu_torch.obs.programs import get_programs

    assert tb.batch_step_fn(32, 8, "cpu") is tb.batch_step_fn(32, 8, "cpu")
    assert tb.batch_step_fn(32, 8, "cpu") is not tb.batch_step_fn(32, 16, "cpu")
    assert tb.memo_block_step_fn(16, "cpu") is tb.memo_block_step_fn(16, "cpu")
    families = get_programs().family_summary()
    assert {"serve_batch", "serve_memo"} <= set(families)


def test_helpers_match_jax():
    for h, w in ((1, 1), (32, 33), (64, 10), (256, 256), (257, 3)):
        assert tb.size_class(h, w) == jb.size_class(h, w)
    assert tb.DEFAULT_SIZE_CLASSES == jb.DEFAULT_SIZE_CLASSES
    for name in RULES + ("wireworld", "bugs"):
        rule = resolve_rule(name)
        try:
            want = jb.rule_operands(rule)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:40]):
                tb.rule_operands(rule)
        else:
            assert tb.rule_operands(rule) == want
    for spec in ("32,64", "8", "64,32", "0,4", "a,b"):
        try:
            want = jb.parse_size_classes(spec)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:30]):
                tb.parse_size_classes(spec)
        else:
            assert tb.parse_size_classes(spec) == want
    assert [tb.next_pow2(n) for n in range(1, 9)] == [jb.next_pow2(n) for n in range(1, 9)]


def test_batch_shapes_other_than_the_class_are_refused():
    names, ops = _mix(32, 4, 2, 0)
    with pytest.raises(ValueError, match=r"boards must be \[N, 64, 64\]"):
        tb.batch_step_fn(64, 2, "cpu")(*ops)
    with pytest.raises(ValueError, match=r"blocks must be \[N, 16, 16\]"):
        tb.memo_block_step_fn(16, "cpu")(ops[0][:, :8, :8], *ops[1:4])


def test_batch_step_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.batch_step_fn(32, 8, "cuda")
