"""Tile variants of the three CUDA kernels: the tile reaches the launcher.

``pallas_block_rows`` (config, ``run --pallas-block-rows``) and the wrappers'
``tile_rows`` select the kernel library built with ``-DTILE_ROWS=<rows>``
(``_build.load`` is keyed by those flags).  Here the kernel build and the
launchers are replaced by recorders, so no ``nvcc`` is needed; a ``meta``
tensor stands in for a CUDA tensor (its device is not the CPU, so the
wrappers take their kernel branch).  Then, end to end on the CPU, the port's
``run --kernel pallas --pallas-block-rows B`` prints the JAX package's
digests at the same B (Pallas in interpret mode), for a binary, a plane and
an LtL rule.
"""

import re
import types

import numpy as np
import pytest
import torch

from akka_game_of_life_tpu.cli import main as jmain
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.ops import _build, gen_sweep, ltl_sweep, packed_sweep
from akka_game_of_life_tpu_torch.runtime import simulation as tsim
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig, load_config

_DIGEST = re.compile(r"^epoch (\d+): pop=(\d+) .*digest=([0-9a-f]{16})$", re.M)


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def launches(monkeypatch):
    """Record the defines each wrapper hands its launcher."""
    seen = []

    def recorder(name):
        def launch(x, rule, *rest):
            seen.append((name, rest[-1]))
            return x

        return launch

    monkeypatch.setattr(packed_sweep, "_launch", recorder("packed_sweep"))
    monkeypatch.setattr(gen_sweep, "_launch", recorder("gen_sweep"))
    monkeypatch.setattr(ltl_sweep, "_launch", recorder("ltl_sweep"))
    return seen


CONWAY_KEY = ("-DRULE_BIRTH=0x8", "-DRULE_SURVIVE1=0x18", "-DRULE_COMBINE=0xc5068817")
# WireWorld's excite on 1 or 2 heads, (b0 ^ b1) & ~b2: one LOP3 over b0..b2.
WIRE_KEY = ("-DRULE_BIRTH=0x6", "-DRULE_SURVIVE1=0x0", "-DRULE_STATES=4",
            "-DRULE_WIREWORLD=1", "-DRULE_COMBINE=0x8814")


@pytest.mark.parametrize(
    "tile,want",
    [
        (None, CONWAY_KEY),
        (packed_sweep.DEFAULT_TILE_ROWS, CONWAY_KEY),
        (64, (*CONWAY_KEY, "-DTILE_ROWS=64")),
        (300, (*CONWAY_KEY, "-DTILE_ROWS=300")),
    ],
)
def test_packed_tile_reaches_the_launcher(launches, tile, want):
    """The library key is the rule's masks and combine network, then the
    tile (none for the default one)."""
    fn = packed_sweep.packed_multi_step_fn("conway", 20, tile_rows=tile)
    fn(_meta((64, 2)))
    assert launches == [("packed_sweep", want)] * 2


@pytest.mark.parametrize(
    "tile,want",
    [
        (None, WIRE_KEY),
        (gen_sweep.DEFAULT_TILE_ROWS, WIRE_KEY),
        (128, (*WIRE_KEY, "-DTILE_ROWS=128")),
        (40, (*WIRE_KEY, "-DTILE_ROWS=40")),
    ],
)
def test_plane_tile_reaches_the_launcher(launches, tile, want):
    """The library key is the rule's masks, states, WireWorld flag and
    combine network, then the tile (none for the default one)."""
    gen_sweep.gen_multi_step_fn("wireworld", 10, tile_rows=tile)(_meta((2, 64, 2)))
    assert launches == [("gen_sweep", want)]


@pytest.mark.parametrize(
    "tile,want",
    [
        (None, ()),
        (ltl_sweep.DEFAULT_TILE_ROWS, ()),
        (16, ("-DTILE_ROWS=16",)),
        (200, ("-DTILE_ROWS=200",)),
    ],
)
def test_ltl_tile_reaches_the_launcher(launches, tile, want):
    ltl_sweep.ltl_multi_step_fn("bugs", 3, tile_rows=tile)(_meta((64, 64), torch.uint8))
    assert launches == [("ltl_sweep", want)] * 3


def test_defines_select_the_library(monkeypatch):
    """Each variant is its own library: the wrappers' lru-cached loaders ask
    ``_build.load`` for the source with exactly the variant's flags."""
    asked = []

    class Fn:
        def __init__(self, result=0):
            self.result = result

        def __call__(self, *args):
            return self.result

    class Variant(Fn):
        def __call__(self, birth, survive1, tile):  # byref arguments
            tile._obj.value = packed_sweep.DEFAULT_TILE_ROWS

    class GenVariant(Fn):
        def __call__(self, birth, survive1, states, wire, tile):
            tile._obj.value = gen_sweep.DEFAULT_TILE_ROWS

    def fake_load(name, defines=()):
        asked.append((name, defines))
        lib = types.SimpleNamespace(
            packed_sweep_launch=Fn(), packed_sweep_variant=Variant(), gen_sweep_launch=Fn(),
            gen_sweep_variant=GenVariant(),
            ltl_sweep_launch=Fn(), ltl_sweep_tile_rows=Fn(ltl_sweep.DEFAULT_TILE_ROWS),
        )
        return _build.Built(lib, 0.0, "")

    monkeypatch.setattr(_build, "load", fake_load)
    for loader in (packed_sweep._launcher, gen_sweep._launcher, ltl_sweep._library):
        loader.cache_clear()
    try:
        packed_sweep._launcher(packed_sweep.library_defines("conway", 64))
        packed_sweep._launcher(packed_sweep.library_defines("highlife"))
        gen_sweep._launcher(gen_sweep.library_defines("wireworld", 32))
        ltl_sweep._library(ltl_sweep.tile_defines(128))
    finally:
        for loader in (packed_sweep._launcher, gen_sweep._launcher, ltl_sweep._library):
            loader.cache_clear()
    assert asked == [
        ("packed_sweep", (*CONWAY_KEY, "-DTILE_ROWS=64")),
        ("packed_sweep", ("-DRULE_BIRTH=0x48", "-DRULE_SURVIVE1=0x18", "-DRULE_COMBINE=0xa0490836")),
        ("gen_sweep", (*WIRE_KEY, "-DTILE_ROWS=32")),
        ("ltl_sweep", ("-DTILE_ROWS=128",)),
    ]


@pytest.mark.parametrize(
    "kw,factory,kernel",
    [
        (dict(rule="conway"), "packed_multi_step_fn", "sweep"),
        (dict(rule="wireworld"), "gen_multi_step_fn", "gen_sweep"),
        (dict(rule="bugs"), "ltl_multi_step_fn", "ltl_sweep"),
    ],
    ids=["words", "planes", "ltl"],
)
@pytest.mark.parametrize("choice", ["pallas", "auto"])
def test_simulation_passes_pallas_block_rows(monkeypatch, kw, factory, kernel, choice):
    """kernel=pallas runs the configured tile; kernel=auto the kernel's own
    (MEASURED_TILE_ROWS), as the JAX package's auto sizes its own block."""
    module = {"sweep": packed_sweep, "gen_sweep": gen_sweep, "ltl_sweep": ltl_sweep}[kernel]
    real, tiles = getattr(module, factory), []

    def spy(rule, n, **kwargs):
        tiles.append(kwargs.get("tile_rows"))
        return real(rule, n, **kwargs)

    monkeypatch.setattr(module, factory, spy)
    cfg = SimulationConfig(height=64, width=64, seed=2, steps_per_call=4, kernel=choice,
                           pallas_block_rows=16, **kw)
    sim = tsim.Simulation(cfg, device="cpu")
    sim.advance(8)
    assert sim.kernel == kernel
    assert sim.tile_rows == (16 if choice == "pallas" else None)
    assert tiles and set(tiles) == {sim.tile_rows}


@pytest.mark.parametrize("rule,fn", [("conway", "sharded_sweep_step_fn"),
                                     ("wireworld", "sharded_gen_sweep_step_fn")])
def test_mesh_passes_pallas_block_rows(monkeypatch, rule, fn):
    real, tiles = getattr(tsim, fn), []

    def spy(mesh, rule, **kwargs):
        tiles.append(kwargs.get("tile_rows"))
        return real(mesh, rule, **kwargs)

    monkeypatch.setattr(tsim, fn, spy)
    cfg = SimulationConfig(height=64, width=64, seed=2, steps_per_call=4, kernel="pallas",
                           pallas_block_rows=24, mesh_shape=(2, 1), rule=rule)
    sim = tsim.Simulation(cfg, device=["cpu", "cpu"])
    sim.advance(8)
    assert sim.mesh is not None and tiles == [24]


@pytest.mark.parametrize(
    "kw,match",
    [
        # 70000 one-row tiles pass the grid's 65535 rows of blocks.
        (dict(rule="conway", pallas_block_rows=1, height=70_000), "does not fit the packed sweep"),
        (dict(rule="B2/S345/200", pallas_block_rows=1, height=70_000), "does not fit the plane sweep"),
        (dict(rule="bugs", pallas_block_rows=1, height=70_000), "does not fit the LtL kernel"),
    ],
)
def test_infeasible_tiles_raise_when_the_run_is_built(kw, match):
    kw = {"height": 64, **kw}
    cfg = SimulationConfig(width=64, steps_per_call=10, kernel="pallas", **kw)
    with pytest.raises(ValueError, match=match):
        tsim.Simulation(cfg, device="cpu")


def test_tile_rules_of_the_redesigned_kernels():
    """The packed and plane sweeps keep their levels in registers (the
    plane sweep's deepest levels at large m in a lane's own shared-memory
    ring, the same at every tile) and the LtL step a ring of 2R+1 rows per
    lane in shared memory (10.5 KB at R = 10, under 48 KB at any tile), so
    only the depth or radius and the grid's 65535 rows of tiles bound a
    variant, at every plane count."""
    assert gen_sweep.tile_fits(1, 31, 65535) and not gen_sweep.tile_fits(1, 31, 65536)
    assert gen_sweep.tile_fits(None, 31, 65535 * gen_sweep.DEFAULT_TILE_ROWS)
    assert gen_sweep.tile_fits(4096, 1) and not gen_sweep.tile_fits(0, 10)
    assert not gen_sweep.tile_fits(64, 32)
    with pytest.raises(ValueError, match="does not fit the plane sweep"):
        gen_sweep.gen_sweep(_meta((8, 65536, 1)), "B2/S345/200", 4, tile_rows=1)
    assert packed_sweep.tile_fits(1, 31, 65535) and not packed_sweep.tile_fits(1, 31, 65536)
    assert packed_sweep.tile_fits(2, 31, 65535 * 2) and not packed_sweep.tile_fits(2, 31, 65535 * 2 + 1)
    assert packed_sweep.tile_fits(None, 10, 65536) and packed_sweep.tile_fits(4096, 1)
    assert not packed_sweep.tile_fits(0, 10) and not packed_sweep.tile_fits(64, 32)
    with pytest.raises(ValueError, match="does not fit the packed sweep"):
        packed_sweep.packed_sweep(_meta((65536, 1)), "conway", 4, tile_rows=1)
    assert ltl_sweep.smem_bytes(10) == 21 * 32 * 16 < 48 * 1024
    assert ltl_sweep.smem_bytes(5) == 11 * 512
    assert ltl_sweep.tile_fits(1, 10, 65535) and not ltl_sweep.tile_fits(1, 5, 65536)
    assert not ltl_sweep.tile_fits(64, 11) and not ltl_sweep.tile_fits(0, 5)
    with pytest.raises(ValueError, match="does not fit the LtL kernel"):
        ltl_sweep.ltl_sweep(_meta((65536, 8), torch.uint8), "bugs", tile_rows=1)


def test_pallas_block_rows_config_checks():
    assert SimulationConfig().pallas_block_rows is None
    assert load_config(None, {"pallas_block_rows": 24}).pallas_block_rows == 24
    with pytest.raises(ValueError, match="pallas_block_rows"):
        load_config(None, {"pallas_block_rows": -8})
    with pytest.raises(ValueError, match="pallas_vmem_limit_mb"):
        load_config(None, {"pallas_vmem_limit_mb": 32})
    assert load_config(None, {"pallas_vmem_limit_mb": 0}).pallas_vmem_limit_mb == 0


@pytest.mark.parametrize(
    "args",
    [
        ["--pattern", "gosper-glider-gun", "--steps-per-call", "10"],
        ["--rule", "wireworld", "--pattern", "wireworld-clock", "--steps-per-call", "5"],
        ["--rule", "bugs", "--seed", "4", "--steps-per-call", "5"],
    ],
    ids=["conway", "wireworld", "bugs"],
)
def test_cli_pallas_block_rows_digests_match_jax(capsys, args):
    common = ["run", "--kernel", "pallas", "--pallas-block-rows", "16", "--height", "64",
              "--width", "64", "--max-epochs", "20", "--metrics-every", "10",
              "--obs-digest", *args]
    assert jmain([*common[:1], "--platform", "cpu", *common[1:]]) == 0
    jlines = _DIGEST.findall(capsys.readouterr().out)
    assert tcli.main([*common[:1], "--device", "cpu", *common[1:]]) == 0
    tlines = _DIGEST.findall(capsys.readouterr().out)
    assert len(jlines) == 2 and tlines == jlines


def test_tile_variants_agree_on_the_cpu():
    """On the CPU every tile runs the plain version: the same words for any
    feasible tile (the variants differ only on the card)."""
    rng = np.random.default_rng(5)
    words = torch.from_numpy(rng.integers(0, 2**31, size=(40, 3), dtype=np.int32))
    want = packed_sweep.packed_sweep(words, "conway", 7)
    for tile in (1, 17, 256, 800):
        assert torch.equal(packed_sweep.packed_sweep(words, "conway", 7, tile_rows=tile), want)
