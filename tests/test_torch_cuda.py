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


@pytest.mark.cuda
def test_deepest_sweep_on_every_card():
    """Both sweeps opt into more than 48 KB of shared memory on each card
    they launch on (the opt-in applies to one device): a k = 31 sweep, which
    needs it, runs on every visible card."""
    _need_gpu()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    k = packed_sweep.MAX_STEPS_PER_SWEEP
    words = _words((1000, 33), 31)
    planes = _words((2, 1000, 33), 32)
    for i in range(torch.cuda.device_count()):
        dev = f"cuda:{i}"
        x = bitpack.words_from_numpy(words, dev)
        got = packed_sweep.packed_sweep(x, "conway", k)
        assert torch.equal(got, packed_sweep.packed_sweep_reference(x, "conway", k)), dev
        p = bitpack_gen.planes_from_numpy(planes, dev)
        got = gen_sweep.gen_sweep(p, "brians-brain", k)
        assert torch.equal(got, gen_sweep.gen_sweep_reference(p, "brians-brain", k)), dev


def _mesh_devices(n):
    """n distinct cards where the machine has them, else n slots on one."""
    count = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if count >= n else ["cuda:0"] * n


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("steps", [10, 31, 60])
def test_sharded_sweeps_match_plain_sharded(mesh_shape, steps):
    """The sharded sweeps on the card, bit-exact against the plain sharded
    steppers on the card, with tiles x sweeps launches."""
    _need_gpu()
    from akka_game_of_life_tpu_torch import parallel

    n = mesh_shape[0] * mesh_shape[1]
    mesh = parallel.make_grid_mesh(mesh_shape, _mesh_devices(n))
    rng = np.random.default_rng(steps)
    h, w = 256 * mesh_shape[0], 64 * 32 * mesh_shape[1]
    words = parallel.shard_board(rng.integers(0, 2**32, size=(h, w // 32), dtype=np.uint32), mesh)
    sweep = parallel.sharded_sweep_step_fn(mesh, "conway", steps_per_call=steps)
    plan = sweep.plan(words[0].shape)
    before = packed_sweep.packed_sweep.launches
    got = sweep(words)
    assert packed_sweep.packed_sweep.launches - before == (
        n * len(plan.depths) * steps // plan.steps_per_exchange
    )
    plain = parallel.sharded_packed2d_step_fn(mesh, "conway", steps_per_call=steps, halo_rows=1)(words)
    for a, b in zip(got, plain):
        assert torch.equal(a, b), (mesh_shape, steps)
    planes = parallel.shard_board(
        rng.integers(0, 2**32, size=(2, h, w // 32), dtype=np.uint32), mesh
    )
    before = gen_sweep.gen_sweep.launches
    got = parallel.sharded_gen_sweep_step_fn(mesh, "wireworld", steps_per_call=steps)(planes)
    assert gen_sweep.gen_sweep.launches - before == (
        n * len(plan.depths) * steps // plan.steps_per_exchange
    )
    plain = parallel.sharded_gen_step_fn(mesh, "wireworld", steps_per_call=steps, halo_rows=1)(planes)
    for a, b in zip(got, plain):
        assert torch.equal(a, b), (mesh_shape, steps)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["conway", "wireworld", "bugs"])
def test_meshed_simulation_on_card_matches_cpu(rule):
    _need_gpu()
    kw = dict(height=128, width=256, rule=rule, seed=5, steps_per_call=12, obs_digest=True)
    if rule == "wireworld":
        kw["pattern"] = "wireworld-clock"
    runs = {}
    for devices, mesh_shape in ((["cpu"], None), (_mesh_devices(4), (2, 2))):
        cfg = SimulationConfig(**kw, mesh_shape=mesh_shape)
        sim = Simulation(cfg, observer=BoardObserver(out=io.StringIO()), device=devices)
        sim.advance(48)
        runs[devices[0]] = (sim.board_digest(), sim.board_window(0, 40, 0, 70))
    (d_cpu, w_cpu), (d_card, w_card) = runs.values()
    assert d_cpu == d_card
    np.testing.assert_array_equal(w_cpu, w_card)


# -- tile variants (runtime/autotune.py, run --pallas-block-rows) ---------------

# Tiles that are not the default, among them a deep tile at the limit of a
# block's shared memory at k = 31 (846 + 62 rows x 32 words x 4 B x 2).
PACKED_TILES = [8, 64, 192, 846]
GEN_TILES = [8, 100, 384]  # 384: m = 2 at k = 31 is 2 x 2 x 446 x 128 B
LTL_TILES = [1, 16, 200, 600]  # 200 and 600 opt in past 48 KB


@pytest.mark.cuda
@pytest.mark.parametrize("tile", PACKED_TILES)
@pytest.mark.parametrize("k", [1, 10, 31])
def test_packed_tile_variants_match_plain(tile, k):
    _need_gpu()
    before = packed_sweep.packed_sweep.launches
    for i, shape in enumerate(SHAPES):
        x = bitpack.words_from_numpy(_words(shape, 100 + i), "cuda")
        for rule in ("conway", "highlife"):
            got = packed_sweep.packed_sweep(x, rule, k, tile_rows=tile)
            plain = packed_sweep.packed_sweep_reference(x, rule, k)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (tile, shape, rule, k)
    assert packed_sweep.packed_sweep.launches == before + 2 * len(SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", GEN_TILES)
@pytest.mark.parametrize("k", [1, 10, 31])
def test_gen_tile_variants_match_plain(tile, k):
    _need_gpu()
    rng = np.random.default_rng(tile + k)
    for name in ("wireworld", "brians-brain", "B2/S345/200"):
        rule = resolve_rule(name)
        m = bitpack_gen.n_planes(rule.states)
        if not gen_sweep.tile_fits(m, tile, k):
            with pytest.raises(ValueError, match="does not fit"):
                gen_sweep.gen_sweep(torch.zeros((m, 8, 1), dtype=torch.int32, device="cuda"),
                                    rule, k, tile_rows=tile)
            continue
        for shape in SHAPES:
            x = bitpack_gen.planes_from_numpy(
                rng.integers(0, 2**32, size=(m, *shape), dtype=np.uint32), "cuda"
            )
            got = gen_sweep.gen_sweep(x, rule, k, tile_rows=tile)
            plain = gen_sweep.gen_sweep_reference(x, rule, k)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (tile, shape, name, k)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", LTL_TILES)
def test_ltl_tile_variants_match_plain(tile):
    _need_gpu()
    rng = np.random.default_rng(tile)
    for shape in [(1, 1), (3, 5), (37, 19), (64, 300), (1000, 333)]:
        board = torch.from_numpy((rng.random(shape) < 0.4).astype(np.uint8)).to("cuda")
        for rule in _ltl_rules():
            got = ltl_sweep.ltl_sweep(board, rule, tile_rows=tile)
            plain = ltl_sweep.ltl_sweep_reference(board, rule)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (tile, shape, rule)


@pytest.mark.cuda
def test_launchers_refuse_a_tile_past_shared_memory():
    """The C launchers refuse a depth whose tile does not fit, as the
    wrappers do before them: nothing is launched."""
    import ctypes

    _need_gpu()
    x = bitpack.words_from_numpy(_words((64, 2), 1), "cuda")
    out = torch.empty_like(x)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    fn = packed_sweep._launcher(packed_sweep.tile_defines(846))
    assert fn(x.data_ptr(), out.data_ptr(), 64, 2, 31, 8, 12, stream) == 0
    fn = packed_sweep._launcher(packed_sweep.tile_defines(900))
    assert fn(x.data_ptr(), out.data_ptr(), 64, 2, 31, 8, 12, stream) != 0
    assert fn(x.data_ptr(), out.data_ptr(), 64, 2, 4, 8, 12, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["conway", "wireworld", "bugs"])
def test_simulation_tile_on_card_matches_cpu(rule):
    _need_gpu()
    cfg = SimulationConfig(height=96, width=128, rule=rule, seed=5, steps_per_call=10,
                           kernel="pallas", pallas_block_rows=24, flight_dir="")
    boards = []
    for device in ("cuda", "cpu"):
        sim = Simulation(cfg, observer=BoardObserver(out=io.StringIO()), device=device)
        assert sim.tile_rows == 24
        sim.advance(30)
        boards.append(sim.board_host())
    assert np.array_equal(*boards)
