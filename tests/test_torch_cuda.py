"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one.  They import neither
JAX nor the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import io

import numpy as np
import pytest
import torch

from akka_game_of_life_tpu_torch.ops import (
    bitpack,
    bitpack_gen,
    gen_sweep,
    ltl_sweep,
    packed_sweep,
)
from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

RULES = ["conway", "highlife", "day-and-night", "seeds", "life-without-death"]
GEN_RULES = ["brians-brain", "star-wars", "B2/S/7", "wireworld", "B2/S345/200"]
SHAPES = [(1, 1), (3, 1), (37, 3), (64, 2), (1000, 33)]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _words(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [1, 7, 10, 31])
def test_kernel_matches_plain(shape, k):
    _need_gpu()
    x = bitpack.words_from_numpy(_words(shape, k), "cuda")
    for rule in RULES:
        before = packed_sweep.packed_sweep.launches
        got = packed_sweep.packed_sweep(x, rule, k)
        plain = packed_sweep.packed_sweep_reference(x, rule, k)
        torch.cuda.synchronize()
        assert packed_sweep.packed_sweep.launches == before + 1
        assert torch.equal(got, plain), (shape, rule, k)


@pytest.mark.cuda
def test_launch_rejects_bad_tensors():
    _need_gpu()
    conway = resolve_rule("conway")
    x = bitpack.words_from_numpy(_words((8, 4), 0), "cuda")
    with pytest.raises(ValueError, match="int32"):
        packed_sweep._launch(x.to(torch.int64), conway, 2)
    with pytest.raises(ValueError, match="contiguous"):
        packed_sweep._launch(x[:, ::2], conway, 2)
    with pytest.raises(ValueError, match="contiguous"):
        packed_sweep._launch(x.reshape(-1), conway, 2)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rule,kernel",
    [
        ("conway", "auto"),
        ("brians-brain", "auto"),
        ("wireworld", "auto"),
        ("bugs", "auto"),
        ("R2,B3-5,S2-6,NN", "auto"),
        ("star-wars", "dense"),
    ],
)
def test_simulation_on_cuda_matches_cpu(rule, kernel):
    _need_gpu()
    cfg = SimulationConfig(
        height=96, width=128, rule=rule, seed=5, steps_per_call=13, kernel=kernel
    )
    runs = {}
    for device in ("cpu", "cuda"):
        sim = Simulation(cfg, observer=BoardObserver(out=io.StringIO()), device=device)
        sim.advance(52)
        runs[device] = sim.board_digest()
    assert runs["cpu"] == runs["cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rule", GEN_RULES)
def test_gen_kernel_matches_plain(shape, rule):
    _need_gpu()
    rule = resolve_rule(rule)
    m = bitpack_gen.n_planes(rule.states)
    x = bitpack_gen.planes_from_numpy(_words((m, *shape), m), "cuda")
    for k in sorted({1, 7, 10, packed_sweep.MAX_STEPS_PER_SWEEP}):
        before = gen_sweep.gen_sweep.launches
        got = gen_sweep.gen_sweep(x, rule, k)
        plain = gen_sweep.gen_sweep_reference(x, rule, k)
        torch.cuda.synchronize()
        assert gen_sweep.gen_sweep.launches == before + 1
        assert torch.equal(got, plain), (shape, rule, k)


def _ltl_rules():
    def band(r):
        top = (2 * r + 1) ** 2 - 1
        lo = r * (r + 1)
        return Rule(
            frozenset(n for n in range(lo, lo + 8) if n <= top),
            frozenset(n for n in range(max(0, lo - 2), lo + 11) if n <= top),
            radius=r, kind="ltl",
        )

    sparse = Rule(frozenset({3, 4, 5, 9}), frozenset({2, 3, 8}), radius=2, kind="ltl")
    return [band(1), band(2), resolve_rule("bugs"), band(10), sparse]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (37, 19), (64, 300), (1000, 333)])
def test_ltl_kernel_matches_plain(shape):
    _need_gpu()
    rng = np.random.default_rng(shape[0])
    board = torch.from_numpy((rng.random(shape) < 0.4).astype(np.uint8)).to("cuda")
    for rule in _ltl_rules():
        before = ltl_sweep.ltl_sweep.launches
        got = ltl_sweep.ltl_sweep(board, rule)
        plain = ltl_sweep.ltl_sweep_reference(board, rule)
        torch.cuda.synchronize()
        assert ltl_sweep.ltl_sweep.launches == before + 1
        assert torch.equal(got, plain), (shape, rule)


@pytest.mark.cuda
def test_new_launchers_reject_bad_tensors():
    _need_gpu()
    bb = resolve_rule("brians-brain")
    x = bitpack_gen.planes_from_numpy(_words((2, 8, 4), 0), "cuda")
    with pytest.raises(ValueError, match="int32"):
        gen_sweep._launch(x.to(torch.int64), bb, 2)
    with pytest.raises(ValueError, match="contiguous"):
        gen_sweep._launch(x[:, :, ::2], bb, 2)
    with pytest.raises(ValueError, match="planes"):
        gen_sweep._launch(x[:1].contiguous(), bb, 2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        gen_sweep._launch(x, bb, packed_sweep.MAX_STEPS_PER_SWEEP + 1)
    bugs = resolve_rule("bugs")
    board = torch.zeros((16, 16), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="uint8"):
        ltl_sweep._launch(board.to(torch.int32), bugs)
    with pytest.raises(ValueError, match="contiguous"):
        ltl_sweep._launch(board[:, ::2], bugs)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "h,w,steps,halo",
    [(40, 40, 4, 4), (120, 56, 8, 8), (250, 70, 2, 5), (64, 64, 31, 31), (40, 40, 35, 36)],
)
@pytest.mark.parametrize("rule", ["conway", "highlife"])
def test_worker_chunk_matches_np_chunk(h, w, steps, halo, rule):
    """The cluster's chunk engine on the card, bit-exact against the host
    oracle at the JAX engine's slabs (and past 31 steps, two launches), with
    ``len(plan_sweeps(steps))`` launches per chunk."""
    _need_gpu()
    from akka_game_of_life_tpu_torch.runtime.backend import _np_chunk, _torch_engine

    rng = np.random.default_rng(h + w + steps)
    padded = rng.integers(0, 2, size=(h + 2 * halo, w + 2 * halo), dtype=np.uint8)
    run = _torch_engine(resolve_rule(rule), device="cuda")
    before = packed_sweep.packed_sweep.launches
    got = run(padded, steps, halo)
    assert packed_sweep.packed_sweep.launches - before == len(packed_sweep.plan_sweeps(steps))
    np.testing.assert_array_equal(got, _np_chunk(padded, steps, halo, resolve_rule(rule)))


@pytest.mark.cuda
def test_worker_chunk_full_slab_matches_plain():
    """One 8192 x 16384 tile with a 10-wide halo (the 16384² cluster's
    slab): the kernel path equals the plain packed loop on the card, in one
    launch; plane rules and single-step chunks launch nothing."""
    _need_gpu()
    from akka_game_of_life_tpu_torch.runtime.backend import _np_chunk, _torch_engine

    rng = np.random.default_rng(1)
    padded = (rng.random((8192 + 20, 16384 + 20), dtype=np.float32) < 0.5).astype(np.uint8)
    conway = resolve_rule("conway")
    before = packed_sweep.packed_sweep.launches
    got = _torch_engine(conway, device="cuda")(padded, 10, 10)
    assert packed_sweep.packed_sweep.launches == before + 1
    np.testing.assert_array_equal(
        got, _torch_engine(conway, pallas="off", device="cuda")(padded, 10, 10)
    )
    small = padded[:300, :200]
    bb = resolve_rule("brians-brain")
    before = packed_sweep.packed_sweep.launches
    np.testing.assert_array_equal(
        _torch_engine(bb, device="cuda")(small, 4, 10), _np_chunk(small, 4, 10, bb)
    )
    np.testing.assert_array_equal(
        _torch_engine(conway, device="cuda")(small, 1, 10), _np_chunk(small, 1, 10, conway)
    )
    assert packed_sweep.packed_sweep.launches == before
