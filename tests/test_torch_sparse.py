"""The port's activity-gated sparse stepping against the JAX package's.

The same numpy boards go through ``akka_game_of_life_tpu.ops.sparse.
SparseStepper`` and the port's, chunk by chunk: the boards and every gating
counter must be equal (tolerance 0), over sequences that cross the dense
threshold both ways.
"""

import numpy as np
import pytest

from akka_game_of_life_tpu.ops import sparse as jsp
from akka_game_of_life_tpu_torch.ops import sparse as sp
from akka_game_of_life_tpu_torch.ops import stencil
from akka_game_of_life_tpu_torch.utils.patterns import get_pattern, place

import torch


def _counters(s):
    return (s.last_active_blocks, s.last_stepped_blocks, s.dense_chunks, s.sparse_chunks,
            s.total_blocks, s.block, s.grid)


def _dilute(shape=(128, 128)):
    """A glider and an R-pentomino: the pentomino's growth pushes the
    dilated active blocks over 0.4 of the board and back under it."""
    board = np.zeros(shape, np.uint8)
    board = place(board, get_pattern("glider"), (10, 10))
    return place(board, get_pattern("r-pentomino"), (70, 70))


def _lockstep(jst, tst, jb, tb, chunks, k=8, thresholds=None):
    """Step both engines chunk by chunk; returns the chunk kinds (d/s)."""
    kinds = []
    for chunk in range(chunks):
        if thresholds is not None:
            jst.threshold = tst.threshold = thresholds[chunk]
        dense_before = tst.dense_chunks
        jb, tb = jst.step(jb, k), tst.step(tb, k)
        np.testing.assert_array_equal(np.asarray(jb), tb, err_msg=str(chunk))
        assert _counters(tst) == _counters(jst), chunk
        kinds.append("d" if tst.dense_chunks > dense_before else "s")
    return "".join(kinds), tb


def test_helpers_match_jax():
    for h, w, b in [(256, 256, 128), (96, 64, 128), (7, 11, 4), (16384, 16384, 128), (48, 96, 20)]:
        assert sp.pick_block(h, w, b) == jsp.pick_block(h, w, b)
    rng = np.random.default_rng(0)
    active = rng.random((9, 7)) < 0.15
    np.testing.assert_array_equal(sp.dilate3x3(active), jsp.dilate3x3(active))
    prev = rng.integers(0, 2, (64, 96), dtype=np.uint8)
    new = prev.copy()
    new[5, 70] ^= 1
    new[63, 0] ^= 1
    np.testing.assert_array_equal(sp.changed_blocks(prev, new, 16), jsp.changed_blocks(prev, new, 16))
    for n in range(1, 70):
        assert sp.next_pow2(n) == jsp.next_pow2(n)


def test_stepper_matches_jax_across_the_threshold():
    """The pentomino crosses the 0.4 threshold both ways (dense after the
    foreign first chunk, sparse, dense again as it grows, and back), and
    the board equals the dense stepper's after 30 chunks."""
    jst = jsp.SparseStepper("conway", (128, 128), block=16, threshold=0.4)
    tst = sp.SparseStepper("conway", (128, 128), block=16, threshold=0.4, device="cpu")
    kinds, board = _lockstep(jst, tst, _dilute(), _dilute(), 30)
    assert "sd" in kinds and "ds" in kinds, kinds
    want = stencil.multi_step(torch.from_numpy(_dilute()), "conway", 240).numpy()
    np.testing.assert_array_equal(board, want)


def test_dense_streak_hysteresis_matches_jax():
    """A dense streak computes the bitmap on odd chunks only; the sparse
    chunk after an even one steps every block (its bitmap was skipped)."""
    thresholds = [0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 1.0]
    jst = jsp.SparseStepper("conway", (128, 128), block=16)
    tst = sp.SparseStepper("conway", (128, 128), block=16, device="cpu")
    kinds, _ = _lockstep(jst, tst, _dilute(), _dilute(), len(thresholds), thresholds=thresholds)
    assert kinds == "dddssddsss", kinds


@pytest.mark.parametrize("rule", ["brians-brain", "wireworld", "highlife"])
def test_multi_state_rules_match_jax(rule):
    rng = np.random.default_rng(5)
    board = np.zeros((96, 96), np.uint8)
    states = 4 if rule == "wireworld" else (3 if rule == "brians-brain" else 2)
    board[40:56, 40:56] = rng.integers(0, states, (16, 16))
    jst = jsp.SparseStepper(rule, board.shape, block=16, threshold=0.4)
    tst = sp.SparseStepper(rule, board.shape, block=16, threshold=0.4, device="cpu")
    jb, tb = board.copy(), board.copy()
    for _ in range(12):
        jb, tb = jst.step(jb, 4), tst.step(tb, 4)
        np.testing.assert_array_equal(np.asarray(jb), tb)
        assert _counters(tst) == _counters(jst)


def test_ownership_contract():
    """A foreign board is never mutated; a board the stepper produced is
    updated in place on the sparse path; a copy of it is foreign again."""
    tst = sp.SparseStepper("conway", (128, 128), block=16, threshold=0.5, device="cpu")
    foreign = _dilute()
    keep = foreign.copy()
    out = tst.step(foreign, 8)
    np.testing.assert_array_equal(foreign, keep)
    assert out is not foreign and tst.dense_chunks == 1
    again = tst.step(out, 8)
    assert again is out and tst.sparse_chunks == 1
    snapshot = again.copy()
    dense_before = tst.dense_chunks
    after = tst.step(snapshot, 8)
    assert after is not snapshot and tst.dense_chunks == dense_before + 1


@pytest.mark.parametrize("case", ["radius", "steps", "shape"])
def test_refusals_match_jax(case):
    def attempt(mod, **kw):
        try:
            if case == "radius":
                mod.SparseStepper("bugs", (64, 64), **kw)
            st = mod.SparseStepper("conway", (64, 64), block=16, **kw)
            board = np.zeros((64, 64) if case == "steps" else (32, 64), np.uint8)
            st.step(board, 17 if case == "steps" else 4)
        except ValueError as e:
            return str(e)
        return None

    want = attempt(jsp)
    assert want is not None
    assert attempt(sp, device="cpu") == want


def test_zero_steps_and_a_fixed_point():
    tst = sp.SparseStepper("conway", (64, 64), block=16, device="cpu")
    board = np.zeros((64, 64), np.uint8)
    assert tst.step(board, 0) is board
    out = tst.step(board, 4)  # foreign: dense, nothing changed
    out2 = tst.step(out, 4)  # owned, nothing active: the fixed point
    assert out2 is out and tst.last_stepped_blocks == 0
