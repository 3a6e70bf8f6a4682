"""The port's banded-matmul stencil against the JAX package's.

The same numpy-seeded boards go through ``akka_game_of_life_tpu.ops.
matmul_stencil`` (its f32 lane, the CPU default) and the port's three lanes.
Counts are exact integers on every lane, so the tolerance is 0.  The JAX
int8 lane does not compile at R = 2, 3 under this host's XLA, so the port's
int8 lane is held against ``ltl.step_ltl_np`` and the JAX f32 lane.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_game_of_life_tpu.ops import matmul_stencil as jms
from akka_game_of_life_tpu.ops.rules import resolve_rule as jrule
from akka_game_of_life_tpu_torch.ops import ltl, stencil
from akka_game_of_life_tpu_torch.ops import matmul_stencil as ms
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

LANES = ("f32", "int8", "bf16")


def _soup(shape, seed=0, density=0.4):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(np.uint8)


def _states(shape, rule, seed=0):
    rule = resolve_rule(rule)
    if rule.states > 2:
        return np.random.default_rng(seed).integers(0, rule.states, shape, dtype=np.uint8)
    return _soup(shape, seed)


def _box_sums(alive: np.ndarray, r: int) -> np.ndarray:
    """The dense oracle: the (2R+1)² torus window sum, by rolls."""
    out = np.zeros(alive.shape, np.int64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out += np.roll(alive, (dy, dx), axis=(0, 1))
    return out


def _band(r):
    top = (2 * r + 1) ** 2 - 1
    lo = r * (r + 1)
    return Rule(frozenset(range(lo, min(lo + 8, top + 1))),
                frozenset(range(max(0, lo - 2), min(lo + 11, top + 1))),
                radius=r, kind="ltl", name=f"band-r{r}")


@pytest.mark.parametrize("shape", [(64, 64), (48, 96), (8, 8), (1200, 520), (16384, 16384)])
@pytest.mark.parametrize("radius", [1, 2, 3, 5, 10])
@pytest.mark.parametrize("mode", ["auto", "f32", "int8", "bf16"])
def test_plan_matches_jax(shape, radius, mode):
    """Field for field, refusals included (JAX's auto is f32 off the TPU)."""
    def plan(mod, *args):
        try:
            return mod.plan_matmul(*args)
        except ValueError as e:
            return str(e)

    want = plan(jms, shape, radius, mode)
    got = plan(ms, shape, radius, mode, "box", "cpu")
    assert (got if isinstance(got, str) else got.__dict__) == (
        want if isinstance(want, str) else want.__dict__)


@pytest.mark.parametrize(
    "shape,radius,mode,neighborhood",
    [((64, 64), 2, "f32", "diamond"), ((8, 40), 5, "f32", "box"),
     ((65536, 65536), 1, "int8", "box"), ((65536, 65536), 5, "f32", "box"),
     ((64, 64), 1, "fp8", "box")],
)
def test_refusals_match_jax(shape, radius, mode, neighborhood):
    with pytest.raises(ValueError) as want:
        jms.plan_matmul(shape, radius, mode, neighborhood)
    with pytest.raises(ValueError) as got:
        ms.plan_matmul(shape, radius, mode, neighborhood, "cpu")
    assert str(got.value) == str(want.value)


def test_auto_lane_by_device():
    assert ms.plan_matmul((64, 64), 1, "auto", "box", "cpu").mode == "f32"
    assert ms.plan_matmul((64, 64), 1, "auto", "box", "cuda").mode == ms.AUTO_CUDA_MODE
    assert ms.AUTO_CUDA_MODE in ms.MODES


@pytest.mark.parametrize("shape", [(64, 64), (48, 96)])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 10])
def test_window_counts_every_lane(shape, radius):
    board = _soup(shape, seed=radius)
    want = np.asarray(jms.window_counts_matmul(
        jnp.asarray(board), jms.plan_matmul(shape, radius, "f32")))
    np.testing.assert_array_equal(want, _box_sums(board, radius))
    for lane in LANES:
        plan = ms.plan_matmul(shape, radius, lane, "box", "cpu")
        got = ms.window_counts_matmul(torch.from_numpy(board), plan).numpy()
        np.testing.assert_array_equal(got, want, err_msg=lane)


@pytest.mark.parametrize("lane", LANES)
def test_every_lane_exact_at_the_max_count(lane):
    """An all-alive board at R = 10: every window sums to 441, past bf16's
    integer range (256), so a bf16-rounded result would show."""
    board = torch.ones((48, 96), dtype=torch.uint8)
    counts = ms.neighbor_counts_matmul(board, 10, lane)
    assert counts.dtype == torch.int32
    assert int(counts.min()) == int(counts.max()) == 440


@pytest.mark.parametrize("radius", [2, 3])
def test_int8_lane_matches_ltl_np_and_jax_f32(radius):
    rule = _band(radius)
    board = _soup((48, 96), seed=radius, density=0.5)
    got = ms.step_matmul(torch.from_numpy(board), rule, "int8").numpy()
    np.testing.assert_array_equal(got, ltl.step_ltl_np(board, rule))
    jr = jrule(rule.rulestring())
    want = np.asarray(jms.step_matmul(jnp.asarray(board), jr, "f32"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rule", ["conway", "highlife", "brians-brain", "star-wars",
                                  "wireworld", "bugs"])
@pytest.mark.parametrize("lane", LANES)
def test_step_matches_jax(rule, lane):
    board = _states((64, 64), rule, seed=3)
    want = np.asarray(jms.step_matmul(jnp.asarray(board), jrule(rule), "f32"))
    got = ms.step_matmul(torch.from_numpy(board), rule, lane).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stencil.step(torch.from_numpy(board), rule).numpy())


@pytest.mark.parametrize("rule", ["conway", "B2/S/7", "wireworld", "bugs"])
def test_multi_step_fn_matches_jax(rule):
    board = _states((48, 96), rule, seed=5)
    want = np.asarray(jms.matmul_multi_step_fn(jrule(rule), 4, "f32")(jnp.asarray(board)))
    got = ms.matmul_multi_step_fn(rule, 4, "auto", "cpu")(torch.from_numpy(board)).numpy()
    np.testing.assert_array_equal(got, want)


def test_band_matrix_and_slab_match_jax():
    for n, r, wrap in [(7, 1, True), (12, 3, False), (30, 5, True)]:
        np.testing.assert_array_equal(ms.band_matrix(n, r, wrap), jms.band_matrix(n, r, wrap))
    np.testing.assert_array_equal(ms._band_slab(9, 2), jms._band_slab(9, 2))
    for n in (7, 512, 520, 1200, 12288, 16384, 65537):
        assert ms._pick_tile(n) == jms._pick_tile(n)
    for w in (64, 96, 12288, 16384):
        for r in (1, 5, 10):
            assert ms._pick_digits(w, r) == jms._pick_digits(w, r)


def test_the_factorization_is_the_band_product():
    board = _soup((24, 40), seed=8).astype(np.float32)
    a_rows, a_cols = ms.band_matrix(24, 2), ms.band_matrix(40, 2)
    want = (a_rows @ board @ a_cols.T).astype(np.int64)
    plan = ms.plan_matmul((24, 40), 2, "int8", "box", "cpu")
    got = ms.window_counts_matmul(torch.from_numpy(board.astype(np.uint8)), plan).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("shape,radius", [((5, 7), 1), ((16, 16), 2), ((37, 53), 3)])
def test_products_have_cublaslt_shapes(monkeypatch, lane, shape, radius):
    """Every product, on every lane, is built to the shapes cuBLASLt's int8
    GEMM takes on the card (A rows > 16, k and n multiples of 8; for int8 A
    row-major and B column-major, the layout it takes at every shape), so
    the CPU runs the card's shapes."""
    seen = []
    real_mm, real_int_mm = torch.mm, torch._int_mm

    def note(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0, seen[-1]

    def mm(a, b, **kw):
        note(a, b)
        return real_mm(a, b, **kw)

    def int_mm(a, b):
        note(a, b)
        assert a.is_contiguous() and b.t().is_contiguous()
        return real_int_mm(a, b)

    monkeypatch.setattr(torch, "mm", mm)
    monkeypatch.setattr(torch, "_int_mm", int_mm)
    board = _soup(shape, seed=1, density=0.5)
    got = ms.step_matmul(torch.from_numpy(board), _band(radius), lane).numpy()
    assert seen
    np.testing.assert_array_equal(got, ltl.step_ltl_np(board, _band(radius)))


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_f32_lane_is_exact_with_reduced_precision_set(precision):
    """A caller's TF32 / bf16 float32 products would round the digit-packed
    words; the lane runs at full float32 and puts the caller's setting back."""
    prev = torch.get_float32_matmul_precision()
    board = _soup((48, 96), seed=9, density=0.5)
    try:
        torch.set_float32_matmul_precision(precision)
        plan = ms.plan_matmul((48, 96), 5, "f32", "box", "cpu")
        got = ms.window_counts_matmul(torch.from_numpy(board), plan).numpy()
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(got, _box_sums(board, 5))


def test_full_fp32_puts_back_the_new_api_setting():
    matmul = torch.backends.cuda.matmul
    if not hasattr(matmul, "fp32_precision"):
        pytest.skip("this torch has only the legacy float32 precision flag")
    prev_legacy = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        matmul.fp32_precision = "tf32"  # the new API alone: legacy reads now raise
        with ms._full_fp32():
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "tf32"
    finally:
        torch.set_float32_matmul_precision(prev_legacy)


def test_neighbor_counts_match_the_dense_stencil():
    board = torch.from_numpy(_soup((40, 72), seed=2))
    want = stencil.neighbor_counts(board).to(torch.int32)
    for lane in LANES:
        assert torch.equal(ms.neighbor_counts_matmul(board, 1, lane), want)
