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
    digest,
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


# Every binary rule of the catalogue, each through its own library.
BINARY_RULES = ["conway", "highlife", "day-and-night", "seeds", "life-without-death",
                "fredkin", "replicator", "B0378/S1268"]
# (1, 1), (3, 1), H < 2k at the deepest sweeps, the worker's slab, and word
# counts a warp's span (62 words at k <= 12, 30 deeper) plus or minus one.
RAGGED = [(1, 1), (3, 1), (5, 61), (9, 62), (13, 63), (40, 29), (33, 30), (17, 31), (8212, 513)]


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Every library this module launches, built side by side (one nvcc
    each) before its first test; nothing without a card."""
    import concurrent.futures

    from akka_game_of_life_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        return
    libs = {("ltl_sweep", ()), ("digest", ())}
    libs |= {("gen_sweep", gen_sweep.library_defines(r)) for r in GEN_RULES + PLANE_RULES}
    libs |= {("packed_sweep", packed_sweep.library_defines(r)) for r in BINARY_RULES}
    libs |= {("packed_sweep", packed_sweep.library_defines(r, t))
             for r in TILE_RULES for t in PACKED_TILES}
    libs |= {("gen_sweep", gen_sweep.library_defines(r, t))
             for r in GEN_TILE_RULES for t in GEN_TILES}
    libs |= {("ltl_sweep", ltl_sweep.tile_defines(t)) for t in LTL_TILES}
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: _build.load(*lib), sorted(libs)))


@pytest.mark.cuda
@pytest.mark.parametrize("rule", BINARY_RULES)
def test_every_rule_every_depth_at_ragged_shapes(rule):
    _need_gpu()
    before = packed_sweep.packed_sweep.launches
    for i, shape in enumerate(RAGGED):
        x = bitpack.words_from_numpy(_words(shape, 200 + i), "cuda")
        for k in range(1, packed_sweep.MAX_STEPS_PER_SWEEP + 1):
            got = packed_sweep.packed_sweep(x, rule, k)
            plain = packed_sweep.packed_sweep_reference(x, rule, k)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (rule, shape, k)
    assert packed_sweep.packed_sweep.launches == before + len(RAGGED) * packed_sweep.MAX_STEPS_PER_SWEEP


@pytest.mark.cuda
def test_a_library_refuses_another_rule():
    _need_gpu()
    x = bitpack.words_from_numpy(_words((8, 4), 0), "cuda")
    with pytest.raises(RuntimeError, match="built for rule masks"):
        packed_sweep._launch(x, resolve_rule("highlife"), 2, packed_sweep.library_defines("conway"))


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


# The digest kernel's cases: (name, (h, words), width, row0, wordcol0,
# fill).  The origin (r + row0)·width passes 2³² in "index-wraps"; a width
# that is not a multiple of 32 leaves every word's first index unaligned in
# "ragged-width"; the views are tiles of a larger board (see _digest_case).
DIGEST_CASES = [
    ("1x1", (1, 1), 32, 0, 0, "soup"),
    ("7x3", (7, 3), 96, 0, 0, "soup"),
    ("9x2-origin", (9, 2), 65536, 5, 3, "soup"),
    ("ragged-width", (5, 4), 100, 3, 1, "soup"),
    ("index-wraps", (4, 8), 65536, 65535, 2040, "soup"),
    ("zeros", (16, 8), 256, 0, 0, "zeros"),
    ("ones", (16, 8), 256, 0, 0, "ones"),
    ("row-view", (9, 7), 416, 3, 2, "view"),
    ("aligned-view", (5, 8), 512, 2, 4, "aligned-view"),
    ("soup-4096", (4096, 128), 4096, 0, 0, "soup"),
]


def _digest_case(shape, fill, seed):
    """A case's words on the card: a fresh tensor, or a view of a larger
    board ("view": every other row, offset by 2 words, so its rows are
    neither adjacent nor 16-byte aligned; "aligned-view": a 16-byte
    aligned window whose rows lie 16 words apart)."""
    h, nw = shape
    if fill == "zeros":
        return torch.zeros(shape, dtype=torch.int32, device="cuda")
    if fill == "ones":
        return torch.full(shape, -1, dtype=torch.int32, device="cuda")
    if fill == "view":
        big = bitpack.words_from_numpy(_words((2 * h + 3, nw + 5), seed), "cuda")
        return big[3::2, 2:2 + nw]
    if fill == "aligned-view":
        big = bitpack.words_from_numpy(_words((h + 4, 16), seed), "cuda")
        return big[2:2 + h, 4:4 + nw]
    return bitpack.words_from_numpy(_words(shape, seed), "cuda")


def _digest_twin(words: np.ndarray, width, row0, wordcol0) -> np.ndarray:
    """The host twin's lanes (a copy of the JAX package's): the packed
    twin at the origin, else the dense twin of the unpacked cells at
    (row0, 32·wordcol0)."""
    words = words.astype(np.uint32)
    if row0 == wordcol0 == 0:
        return digest.digest_packed_np(words, width)
    return digest.digest_dense_np(bitpack.unpack_np(words), (row0, 32 * wordcol0), width)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,width,row0,wordcol0,fill", DIGEST_CASES,
                         ids=[c[0] for c in DIGEST_CASES])
def test_digest_kernel_matches_plain_and_host_twin(name, shape, width, row0, wordcol0, fill):
    _need_gpu()
    x = _digest_case(shape, fill, seed=len(name))
    before = digest.digest_packed.launches
    got = digest.digest_packed(x, width, row0, wordcol0)
    plain = digest._digest_packed(x, width, row0, wordcol0)
    torch.cuda.synchronize()
    assert digest.digest_packed.launches == before + 1
    assert got.dtype == torch.int64 and got.shape == (2,) and got.device == x.device
    assert torch.equal(got, plain), (name, got.tolist(), plain.tolist())
    lanes = got.cpu().numpy()
    np.testing.assert_array_equal(
        lanes.astype(np.uint32), _digest_twin(x.cpu().numpy(), width, row0, wordcol0))
    if fill == "zeros":
        assert lanes.tolist() == [0, 0]


@pytest.mark.cuda
def test_digest_planes_on_card_matches_plain_and_host_twin():
    _need_gpu()
    planes = bitpack.words_from_numpy(_words((2, 33, 6), 9), "cuda")
    before = digest.digest_packed.launches
    got = digest.digest_planes(planes, 192)
    assert digest.digest_packed.launches == before + 2
    plain = sum(digest._digest_packed(planes[k], 192, 0, 0) << k for k in range(2)) & 0xFFFFFFFF
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(
        got.cpu().numpy().astype(np.uint32),
        digest.digest_planes_np(planes.cpu().numpy().astype(np.uint32), 192))


@pytest.mark.cuda
def test_digest_kernel_makes_no_host_sync():
    """Under the sync debug mode's "error" any synchronizing call raises:
    the kernel's call, the ledger's events and the zeroed lanes make none."""
    _need_gpu()
    x = bitpack.words_from_numpy(_words((256, 64), 3), "cuda")
    want = digest.digest_packed(x, 2048)  # loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [digest.digest_packed(x, 2048) for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for lanes in got:
        assert torch.equal(lanes, want)


@pytest.mark.cuda
def test_digest_launches_count_each_call():
    _need_gpu()
    x = bitpack.words_from_numpy(_words((40, 12), 4), "cuda")
    before = digest.digest_packed.launches
    for i in range(1, 4):
        digest.digest_packed(x, 384)
        assert digest.digest_packed.launches == before + i


@pytest.mark.cuda
def test_digest_kernel_rejects_bad_tensors():
    _need_gpu()
    x = bitpack.words_from_numpy(_words((8, 4), 0), "cuda")
    before = digest.digest_packed.launches
    with pytest.raises(ValueError, match="int32"):
        digest.digest_packed(x.to(torch.int64), 128)
    with pytest.raises(ValueError, match="2-D"):
        digest.digest_packed(x[None], 128)
    with pytest.raises(ValueError, match="inner stride"):
        digest.digest_packed(x[:, ::2], 128)
    assert digest.digest_packed.launches == before


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


# One rule at each plane count m = 2..8, and the plane sweep's ragged
# shapes: H < 2k at the deepest sweeps and word counts of one and two
# warps' spans (30 words a warp) plus or minus one.
PLANE_RULES = ["brians-brain", "B2/S/7", "B2/S345/9", "B2/S345/17", "B2/S345/33",
               "B2/S345/65", "B2/S345/200"]
PLANE_RAGGED = [(1, 1), (3, 1), (5, 29), (9, 30), (13, 31), (40, 59), (33, 60), (17, 61), (70, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("rule", PLANE_RULES)
def test_gen_every_plane_count_every_depth(rule):
    """Every m = 2..8 at every depth k = 1..31 (each its own kernel: skewed
    levels in registers, or the centre planes in a lane's shared-memory
    ring) at the ragged shapes, on random planes, invalid encodings
    included."""
    _need_gpu()
    rule = resolve_rule(rule)
    m = bitpack_gen.n_planes(rule.states)
    before = gen_sweep.gen_sweep.launches
    for i, shape in enumerate(PLANE_RAGGED):
        x = bitpack_gen.planes_from_numpy(_words((m, *shape), 300 + i), "cuda")
        for k in range(1, packed_sweep.MAX_STEPS_PER_SWEEP + 1):
            got = gen_sweep.gen_sweep(x, rule, k)
            plain = gen_sweep.gen_sweep_reference(x, rule, k)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (rule, shape, k)
    assert gen_sweep.gen_sweep.launches == before + len(PLANE_RAGGED) * packed_sweep.MAX_STEPS_PER_SWEEP


@pytest.mark.cuda
def test_a_plane_library_refuses_another_rule():
    _need_gpu()
    x = bitpack_gen.planes_from_numpy(_words((2, 8, 4), 0), "cuda")
    for other in ("star-wars", "wireworld"):
        with pytest.raises(RuntimeError, match="built for rule"):
            gen_sweep._launch(x, resolve_rule(other), 2, gen_sweep.library_defines("brians-brain"))


def _ltl_band(r):
    top = (2 * r + 1) ** 2 - 1
    lo = r * (r + 1)
    return Rule(
        frozenset(n for n in range(lo, lo + 8) if n <= top),
        frozenset(n for n in range(max(0, lo - 2), lo + 11) if n <= top),
        radius=r, kind="ltl",
    )


def _ltl_rules():
    sparse = Rule(frozenset({3, 4, 5, 9}), frozenset({2, 3, 8}), radius=2, kind="ltl")
    return [_ltl_band(1), _ltl_band(2), resolve_rule("bugs"), _ltl_band(10), sparse]


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
@pytest.mark.parametrize("radius", range(1, ltl_sweep.MAX_RADIUS + 1))
def test_ltl_every_radius_at_ragged_widths(radius):
    """W < 2R+1, and W a lane's 16-cell run x 256 plus or minus one (the
    16-byte path and the byte path); one board holds cells of other states
    (2, 255), which count as dead."""
    _need_gpu()
    rng = np.random.default_rng(radius)
    rules = [_ltl_band(radius),
             Rule(frozenset(range(0, (2 * radius + 1) ** 2, 3)),
                  frozenset(range(1, (2 * radius + 1) ** 2, 2)), radius=radius, kind="ltl")]
    boards = [(rng.random(shape) < 0.4).astype(np.uint8)
              for shape in [(9, 3), (41, 2 * radius), (70, 4095), (37, 4096), (29, 4097)]]
    boards.append(rng.choice(np.array([0, 1, 2, 255], np.uint8), size=(23, 4096), p=[0.5, 0.4, 0.05, 0.05]))
    for host in boards:
        board = torch.from_numpy(host).to("cuda")
        for rule in rules:
            got = ltl_sweep.ltl_sweep(board, rule)
            plain = ltl_sweep.ltl_sweep_reference(board, rule)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (radius, host.shape, rule)


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
    """The deepest sweeps run on every visible card: the packed and plane
    sweeps, which keep their levels in registers, and the plane sweep at
    m = 8, whose deepest levels keep their centre planes in shared
    memory."""
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
        p8 = bitpack_gen.planes_from_numpy(_words((8, 100, 33), 33), dev)
        got = gen_sweep.gen_sweep(p8, "B2/S345/200", k)
        assert torch.equal(got, gen_sweep.gen_sweep_reference(p8, "B2/S345/200", k)), dev


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

# Every tile of the tune grids (chip_smoke.py's TUNE_RUNS) and a few others.
PACKED_TILES = [1, 8, 64, 128, 192, 256, 846]
# At every packed tile, one library per rule and tile: Conway and HighLife
# (each its own combine network) and Day & Night (the lookup-table combine).
TILE_RULES = ["conway", "highlife", "day-and-night"]
GEN_TILES = [1, 8, 32, 100, 384]
GEN_TILE_RULES = ["wireworld", "brians-brain", "B2/S345/200"]
LTL_TILES = [1, 16, 32, 64, 128, 200, 600]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", PACKED_TILES)
@pytest.mark.parametrize("k", [1, 4, 8, 10, 16, 31])
def test_packed_tile_variants_match_plain(tile, k):
    _need_gpu()
    before = packed_sweep.packed_sweep.launches
    for rule in TILE_RULES:
        for i, shape in enumerate(SHAPES):
            x = bitpack.words_from_numpy(_words(shape, 100 + i), "cuda")
            got = packed_sweep.packed_sweep(x, rule, k, tile_rows=tile)
            plain = packed_sweep.packed_sweep_reference(x, rule, k)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (rule, tile, shape, k)
    assert packed_sweep.packed_sweep.launches == before + len(TILE_RULES) * len(SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", GEN_TILES)
@pytest.mark.parametrize("k", [1, 10, 31])
def test_gen_tile_variants_match_plain(tile, k):
    _need_gpu()
    rng = np.random.default_rng(tile + k)
    for name in GEN_TILE_RULES:
        rule = resolve_rule(name)
        m = bitpack_gen.n_planes(rule.states)
        assert gen_sweep.tile_fits(tile, k)  # any tile, at every m
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
    for shape in [(1, 1), (3, 5), (37, 19), (64, 300), (1000, 333), (70, 4096)]:
        board = torch.from_numpy((rng.random(shape) < 0.4).astype(np.uint8)).to("cuda")
        for rule in _ltl_rules():
            got = ltl_sweep.ltl_sweep(board, rule, tile_rows=tile)
            plain = ltl_sweep.ltl_sweep_reference(board, rule)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), (tile, shape, rule)


@pytest.mark.cuda
def test_launchers_refuse_a_tile_past_shared_memory():
    """The C launchers refuse what the wrappers refuse before them, and
    launch nothing: a board whose strips pass the grid's 65535 rows of
    blocks (no kernel needs more shared memory at one tile than another),
    for LtL a radius past 10, and for the plane sweep a depth past 31, a
    plane count not its rule's, and an output that is its input."""
    import ctypes

    _need_gpu()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    x = bitpack.words_from_numpy(_words((65536, 1), 1), "cuda")
    out = torch.empty_like(x)
    launch = packed_sweep._launcher(packed_sweep.library_defines("conway", 1)).launch
    assert launch(x.data_ptr(), out.data_ptr(), 65535, 1, 31, stream) == 0
    assert launch(x.data_ptr(), out.data_ptr(), 65536, 1, 31, stream) != 0
    assert launch(x.data_ptr(), out.data_ptr(), 65536, 1, 32, stream) != 0
    board = torch.zeros((65536, 16), dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(board)
    ranges = ltl_sweep._ranges_on(resolve_rule("bugs"), board.device)
    lib = ltl_sweep._library(ltl_sweep.tile_defines(1))
    assert lib.ltl_sweep_launch(board.data_ptr(), dst.data_ptr(), 65535, 16, 5,
                                ranges.data_ptr(), 1, stream) == 0
    assert lib.ltl_sweep_launch(board.data_ptr(), dst.data_ptr(), 65536, 16, 5,
                                ranges.data_ptr(), 1, stream) != 0
    assert lib.ltl_sweep_launch(board.data_ptr(), dst.data_ptr(), 64, 16, 11,
                                ranges.data_ptr(), 1, stream) != 0
    planes = bitpack_gen.planes_from_numpy(_words((2, 65536, 1), 2), "cuda")
    after = torch.empty_like(planes)
    launch = gen_sweep._launcher(gen_sweep.library_defines("brians-brain", 1)).launch
    assert launch(planes.data_ptr(), after.data_ptr(), 2, 65535, 1, 31, stream) == 0
    assert launch(planes.data_ptr(), after.data_ptr(), 2, 65536, 1, 31, stream) != 0
    assert launch(planes.data_ptr(), after.data_ptr(), 2, 64, 1, 32, stream) != 0
    assert launch(planes.data_ptr(), after.data_ptr(), 3, 64, 1, 4, stream) != 0
    assert launch(planes.data_ptr(), planes.data_ptr(), 2, 64, 1, 4, stream) != 0
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


# -- the banded-matmul stencil, the fast-forward and sparse stepping on the card


def _band(r):
    top = (2 * r + 1) ** 2 - 1
    lo = r * (r + 1)
    return Rule(frozenset(range(lo, min(lo + 8, top + 1))),
                frozenset(range(max(0, lo - 2), min(lo + 11, top + 1))),
                radius=r, kind="ltl", name=f"band-r{r}")


def _states(shape, rule, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, resolve_rule(rule).states, shape, dtype=np.uint8)).to("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lane", ["f32", "int8", "bf16", "auto"])
@pytest.mark.parametrize("rule,shape", [
    ("conway", (5, 7)), ("conway", (16, 16)), ("brians-brain", (37, 53)),
    ("wireworld", (64, 96)), ("bugs", (40, 48)), ("band-r10", (48, 96)),
    ("conway", (1200, 520)), ("bugs", (1031, 777)),
])
def test_matmul_lanes_match_plain(lane, rule, shape):
    """Every lane's counts are exact on the card (cuBLASLt's int8 shapes,
    bf16 products with float32 results), and the f32 lane stays exact with
    TF32 switched on globally."""
    from akka_game_of_life_tpu_torch.ops import matmul_stencil as ms, stencil

    _need_gpu()
    rule = _band(10) if rule == "band-r10" else resolve_rule(rule)
    board = _states(shape, rule, seed=sum(shape))
    plain = stencil.step(board, rule)
    assert torch.equal(ms.step_matmul(board, rule, lane), plain)
    if lane == "f32":
        prev = torch.get_float32_matmul_precision()
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
            assert torch.equal(ms.step_matmul(board, rule, lane), plain)
        finally:
            torch.set_float32_matmul_precision(prev)


@pytest.mark.cuda
@pytest.mark.parametrize("lane", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("t", [0, 5, 1024, 2**20 + 3])
def test_matmul_jump_matches_the_roll_jump(lane, t):
    from akka_game_of_life_tpu_torch.ops import fastforward

    _need_gpu()
    board = _states((96, 144), "fredkin", seed=t % 17)
    want = fastforward.fast_forward(board, "fredkin", t)
    got = fastforward.jump_matmul_fn("fredkin", t, (96, 144), lane, "cuda")(board)
    assert got.device.type == "cuda" and torch.equal(got, want)
    host = fastforward.fast_forward(board.cpu(), "fredkin", t)
    assert torch.equal(want.cpu(), host)


@pytest.mark.cuda
def test_sparse_stepper_on_card_matches_cpu():
    from akka_game_of_life_tpu_torch.ops import sparse
    from akka_game_of_life_tpu_torch.utils.patterns import get_pattern, place

    _need_gpu()
    board = np.zeros((128, 128), np.uint8)
    board = place(place(board, get_pattern("glider"), (10, 10)), get_pattern("r-pentomino"),
                  (70, 70))
    card = sparse.SparseStepper("conway", board.shape, block=16, threshold=0.4, device="cuda")
    host = sparse.SparseStepper("conway", board.shape, block=16, threshold=0.4, device="cpu")
    a, b = board.copy(), board.copy()
    for _ in range(30):
        a, b = card.step(a, 8), host.step(b, 8)
        assert np.array_equal(a, b)
        assert (card.dense_chunks, card.sparse_chunks, card.last_stepped_blocks) == (
            host.dense_chunks, host.sparse_chunks, host.last_stepped_blocks)
    assert card.dense_chunks > 1 and card.sparse_chunks > 1


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(kernel="matmul", rule="bugs"), dict(kernel="matmul"),
    dict(sparse_kernel=True, pattern="glider", sparse_block=16),
    dict(rule="replicator", fast_forward=1000000), dict(rule="fredkin", kernel="dense",
                                                        fast_forward=4096),
])
def test_steppers_on_card_match_cpu(kw):
    _need_gpu()
    kw = dict(kw)
    jump = kw.pop("fast_forward", 0)
    cfg = SimulationConfig(height=96, width=128, seed=5, steps_per_call=8, flight_dir="", **kw)
    boards, digests = [], []
    for device in ("cuda", "cpu"):
        sim = Simulation(cfg, observer=BoardObserver(out=io.StringIO()), device=device)
        if jump:
            sim.fast_forward(jump)
        sim.advance(24)
        boards.append(sim.board_host())
        digests.append(sim.board_digest())
    assert np.array_equal(*boards) and digests[0] == digests[1]


# -- several processes, one mesh -----------------------------------------------


def _dist_worker(port: int, rank: int, device: str) -> None:
    """One rank of a two-process mesh on ``device``: two slots of it, a
    (2, 2) global mesh; the sharded sweeps on random words and planes,
    fetched whole, against the plain step of the whole torus on the card."""
    from akka_game_of_life_tpu_torch.parallel import distributed, make_grid_mesh
    from akka_game_of_life_tpu_torch.parallel.sweep_halo import (
        sharded_gen_sweep_step_fn,
        sharded_sweep_step_fn,
    )

    dev = torch.device(device)
    ids = [dev.index or 0] if dev.type == "cuda" else []
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, local_device_ids=ids)
    mesh = make_grid_mesh(None, [dev, dev])
    assert mesh.shape == (2, 2) and mesh.local_slots == [2 * rank, 2 * rank + 1]
    for lead, rule, fast, whole in (
        ((), "conway", sharded_sweep_step_fn, bitpack.packed_multi_step),
        ((2,), "wireworld", sharded_gen_sweep_step_fn, bitpack_gen.gen_multi_step),
    ):
        host = _words((*lead, 512, 16), 40 + len(lead))
        before = (packed_sweep.packed_sweep.launches, gen_sweep.gen_sweep.launches)
        tiles = fast(mesh, rule, steps_per_call=31)(distributed.make_global_array(host, mesh))
        launched = (packed_sweep.packed_sweep.launches - before[0],
                    gen_sweep.gen_sweep.launches - before[1])
        assert all(t.device == dev for t in tiles if t is not None)
        got = distributed.fetch(tiles, mesh)
        want = whole(torch.from_numpy(host.view(np.int32)).to(dev), rule, 31)
        assert np.array_equal(got, want.cpu().numpy().view(np.uint32)), rule
        sweeps = 2 * len(packed_sweep.plan_sweeps(31))  # two tiles, one exchange
        assert launched[len(lead) > 0] == sweeps and launched[len(lead) == 0] == 0, launched
    print(f"DIST-OK rank={rank} transport={distributed.transport()}", flush=True)
    distributed.shutdown()


def _two_ranks(devices):
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    procs = [
        subprocess.Popen([sys.executable, __file__, str(port), str(r), devices[r]],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         env=env, cwd=repo)
        for r in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs


@pytest.mark.cuda
def test_two_ranks_on_one_card_over_the_staged_transport():
    """Two processes share card 0, so their strips are staged through
    pinned host memory over gloo; each sweeps its own tiles on the card."""
    _need_gpu()
    outs = _two_ranks(["cuda:0", "cuda:0"])
    for r, out in enumerate(outs):
        assert f"DIST-OK rank={r} transport=staged" in out


@pytest.mark.cuda
def test_two_ranks_over_nccl():
    """One process per card: the strips travel over NCCL."""
    _need_gpu()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    outs = _two_ranks(["cuda:0", "cuda:1"])
    for r, out in enumerate(outs):
        assert f"DIST-OK rank={r} transport=nccl" in out


@pytest.mark.cuda
@pytest.mark.parametrize("rule,steps,states", [("conway", 10, 2), ("wireworld", 5, 4),
                                               ("conway", 1, 2)])
def test_meshed_worker_on_two_slots_matches_plain(rule, steps, states):
    """The worker's chunk over ['cuda:0'] * 2 through the sharded sweeps,
    against the plain sharded steppers and the single-device engine."""
    _need_gpu()
    from akka_game_of_life_tpu_torch.runtime import backend

    r = resolve_rule(rule)
    rng = np.random.default_rng(steps)
    slab = rng.integers(0, states, size=(1000 + 2 * steps, 777 + 2 * steps), dtype=np.uint8)
    before = packed_sweep.packed_sweep.launches + gen_sweep.gen_sweep.launches
    got = backend._torch_engine(r, device=["cuda:0", "cuda:0"])(slab, steps, steps)
    launched = packed_sweep.packed_sweep.launches + gen_sweep.gen_sweep.launches - before
    plain = backend._meshed_engine(r, ["cuda:0", "cuda:0"], use_sweep=False)(slab, steps, steps)
    single = backend._torch_engine(r, device="cuda:0")(slab, steps, steps)
    assert np.array_equal(got, plain) and np.array_equal(got, single)
    assert launched == (0 if steps == 1 else 2 * len(packed_sweep.plan_sweeps(steps)))


if __name__ == "__main__":
    import sys

    _dist_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])


# -- the serving plane (slice 10): the batched step on the card ------------------

SERVE_RULES = ["conway", "highlife", "seeds", "brians-brain", "star-wars"]


def _serve_mix(cls, b, length, seed):
    from akka_game_of_life_tpu_torch.serve import batch as sbatch

    rng = np.random.default_rng(seed)
    boards = np.zeros((b, cls, cls), np.uint8)
    ops = [np.zeros(b, np.uint32), np.zeros(b, np.uint32), np.full(b, 2, np.int32)]
    hs, ws, ns = np.ones(b, np.int32), np.ones(b, np.int32), np.zeros(b, np.int32)
    for i in range(b):
        rule = resolve_rule(SERVE_RULES[i % len(SERVE_RULES)])
        h, w = (cls, cls) if i % 3 == 0 else (int(rng.integers(1, cls + 1)), int(rng.integers(1, cls + 1)))
        boards[i, :h, :w] = rng.integers(0, rule.states, (h, w))
        ops[0][i], ops[1][i], ops[2][i] = sbatch.rule_operands(rule)
        hs[i], ws[i], ns[i] = h, w, int(rng.integers(0, length + 1))
    return boards, ops, hs, ws, ns


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [32, 64, 128, 256])
def test_serve_batch_step_on_card_matches_cpu(cls):
    _need_gpu()
    from akka_game_of_life_tpu_torch.serve import batch as sbatch

    boards, (birth, survive, states), hs, ws, ns = _serve_mix(cls, 16, 16, cls)
    got = sbatch.batch_step_fn(cls, 16, "cuda")(boards, birth, survive, states, hs, ws, ns)
    want = sbatch.batch_step_fn(cls, 16, "cpu")(boards, birth, survive, states, hs, ws, ns)
    assert got[0].is_cuda and got[1].is_cuda
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    for block in (b for b in (16, 32, 64) if b <= cls):
        blocks = boards[:8, :block, :block].copy()
        got = sbatch.memo_block_step_fn(block, "cuda")(blocks, birth[:8], survive[:8], states[:8])
        want = sbatch.memo_block_step_fn(block, "cpu")(blocks, birth[:8], survive[:8], states[:8])
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_serve_digest_batch_on_card_matches_per_board():
    _need_gpu()
    from akka_game_of_life_tpu_torch.ops import digest as odigest

    boards, _, hs, ws, _ = _serve_mix(256, 24, 1, 7)
    lanes = odigest.digest_dense_batch(torch.from_numpy(boards).cuda(), ws).cpu().numpy()
    for i in range(len(boards)):
        want = odigest.digest_dense_np(boards[i, : hs[i], : ws[i]])
        np.testing.assert_array_equal(lanes[i].astype(np.uint32), want)


@pytest.mark.cuda
def test_serve_router_on_card_matches_cpu():
    """One scripted session set (mixed rules and classes, a replicator
    fast-forward past the bound) gives the same answers on both devices."""
    _need_gpu()
    from akka_game_of_life_tpu_torch.serve import SessionRouter

    def script(device):
        cfg = SimulationConfig(serve_max_steps=64)
        out = []
        with SessionRouter(cfg, device=device) as router:
            specs = [("conway", 30, 30), ("brians-brain", 64, 40), ("highlife", 200, 256),
                     ("star-wars", 100, 128), ("replicator", 48, 48)]
            sids = [router.create(rule=r, height=h, width=w, seed=i)["id"]
                    for i, (r, h, w) in enumerate(specs)]
            for steps in (1, 7, 64):
                out += [router.step(sid, steps=steps) for sid in sids]
            out.append(router.step(sids[-1], steps=1_000_003))
            out += [router.get(sid)["board"].tobytes() for sid in sids]
        return out

    assert script("cuda") == script("cpu")


@pytest.mark.cuda
def test_serve_cluster_on_card_matches_cpu():
    """A two-worker serving cluster (worker threads on the card) answers one
    script of batch sessions, a worker-resident tiled session and a
    ship-mode one exactly as the same cluster on the CPU."""
    _need_gpu()
    import threading

    from akka_game_of_life_tpu_torch.obs.catalog import install
    from akka_game_of_life_tpu_torch.obs.metrics import MetricsRegistry
    from akka_game_of_life_tpu_torch.ops import digest as odigest
    from akka_game_of_life_tpu_torch.runtime.backend import BackendWorker
    from akka_game_of_life_tpu_torch.runtime.frontend import Frontend

    def script(device, resident):
        cfg = SimulationConfig(
            role="serve", serve_cluster=True, port=0, max_epochs=None, flight_dir="",
            serve_shards=16, serve_size_classes="16,32", failure_timeout_s=5.0,
            serve_tiled_resident=resident,
        )
        registry = install(MetricsRegistry())
        fe = Frontend(cfg, min_backends=2, registry=registry)
        fe.start()
        workers = []
        try:
            for i in range(2):
                w = BackendWorker("127.0.0.1", fe.port, name=f"w{i}", device=device,
                                  registry=registry)
                w.connect()
                threading.Thread(target=w.run, daemon=True).start()
                workers.append(w)
            assert fe.wait_for_backends(timeout=30)
            plane = fe.serve_plane
            sids = [plane.create(rule=r, height=h, width=w, seed=i, with_board=False)["id"]
                    for i, (r, h, w) in enumerate([("conway", 30, 30), ("brians-brain", 16, 9),
                                                   ("highlife", 32, 20)])]
            mega = plane.create(rule="conway", height=72, width=64, seed=9, with_board=False)
            out = [plane.step(sid, 5) for sid in sids]
            out += [plane.step(mega["id"], n) for n in (8, 3)]
            out.append(odigest.digest_dense_np(plane.get(mega["id"])["board"]).tolist())
            assert all(w.serve_plane.device.type == torch.device(device).type for w in workers)
            return out
        finally:
            fe.stop()
            for w in workers:
                w.stop()

    for resident in (True, False):
        assert script("cuda", resident) == script("cpu", resident)


def _headline_words():
    g = torch.Generator(device="cuda").manual_seed(13)
    return torch.randint(-(2**31), 2**31, (65536, 2048), generator=g, device="cuda",
                         dtype=torch.int32)


@pytest.mark.cuda
def test_registered_sweep_adds_no_synchronisation():
    """A registered 60-generation sweep of a 65536² board returns while the
    stream is still busy: the ledger's events add no host wait."""
    _need_gpu()
    from akka_game_of_life_tpu_torch.obs.programs import get_programs

    programs = get_programs()
    programs.reset()
    try:
        words = _headline_words()
        fn = packed_sweep.packed_multi_step_fn("conway", 60)
        fn(words)  # the first call loads the library
        torch.cuda.synchronize()
        out = fn(words)
        assert not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        fam = programs.family_summary()["pallas"]
        assert fam["calls"] == 2 and fam["seconds"] > 0
        assert torch.equal(out, packed_sweep.packed_multi_step_fn("conway", 60)(words))
    finally:
        programs.reset()


@pytest.mark.cuda
def test_registered_sweep_seconds_match_the_bare_kernels_events():
    """The ledger's resolved seconds per call lie within 0.9-1.25x of a
    CUDA-event time of the same six bare launches."""
    _need_gpu()
    from akka_game_of_life_tpu_torch.obs.programs import get_programs

    programs = get_programs()
    rule = resolve_rule("conway")
    words = _headline_words()
    depths = packed_sweep.plan_sweeps(60)
    reps = 5
    programs.reset()
    try:
        fn = packed_sweep.packed_multi_step_fn(rule, 60)
        fn(words)
        torch.cuda.synchronize()
        programs.reset()
        fn = packed_sweep.packed_multi_step_fn(rule, 60)
        for _ in range(reps):
            fn(words)
        fam = programs.family_summary()["pallas"]
        assert fam["calls"] == reps
        ledger_ms = fam["seconds"] * 1e3 / reps
    finally:
        programs.reset()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        x = words
        for k in depths:
            x = packed_sweep._launch(x, rule, k)
    stop.record()
    torch.cuda.synchronize()
    bare_ms = start.elapsed_time(stop) / reps
    assert 0.9 <= ledger_ms / bare_ms <= 1.25, (ledger_ms, bare_ms)
