"""The port's ``tune`` (TPU kernel #8) against the JAX package's, on the CPU.

Feasibility follows the CUDA kernels' own rules (no tile needs to divide the
board, no 8-row blocks, shared memory per block instead); the selection
(``best_point``) equals JAX's on the same records; the CLI prints the JAX
package's per-point keys, best first, and the same summary line structure
as ``tune --platform cpu --interpret``.  On the CPU the points run the
kernels' plain versions, so only structure is compared, never times.
"""

import json

import pytest

from akka_game_of_life_tpu.cli import main as jmain
from akka_game_of_life_tpu.runtime import autotune as jtune
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.ops import gen_sweep, ltl_sweep, packed_sweep
from akka_game_of_life_tpu_torch.runtime import autotune as ttune

POINT_KEYS = {"block_rows", "steps_per_sweep", "seconds", "cells_per_sec"}


def _records(text):
    recs = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    return [r for r in recs if "block_rows" in r], [r for r in recs if "tune" in r]


@pytest.mark.parametrize(
    "args",
    [(128, 4, 8, 0), (128, 4, 0, 1), (128, 4, -8, 1), (128, 4, 8, 32),
     (128, 4, 8, 3), (131072, 64, 1, 4)],
)
def test_feasible_guards(args):
    """k = 0 and b = 0 are refused (no divide by zero), k past the 31-step
    halo, k not dividing the chunk, and a tile too short for the grid's
    65535 rows of blocks (131072 one-row tiles)."""
    assert not ttune.feasible(*args)


def test_feasible_accepts_what_the_kernels_take():
    assert ttune.feasible(128, 4, 8, 4)
    assert ttune.feasible(128, 4, 12, 1)  # no 8-row rule
    assert ttune.feasible(100, 4, 24, 2)  # no size % b rule (the sweep wraps)
    # Registers, not shared memory: any tile height at any depth, as long as
    # the board is at most 65535 tiles tall.
    assert ttune.feasible(65536, 62, 4096, 31)
    assert ttune.feasible(65536, 62, 2, 31)
    assert not ttune.feasible(65536, 62, 1, 31)


def test_feasible_per_kernel_shared_memory():
    # Planes: registers (a lane's own shared-memory ring at large m and
    # depth), the same at every tile and every m, so only the grid's rows of
    # tiles bound a point, as for the packed sweep.
    assert ttune.feasible(64, 20, 400, 20, "wireworld")
    assert ttune.feasible(64, 20, 420, 20, "wireworld")
    assert ttune.feasible(65536, 62, 2, 31, "B2/S345/200")
    assert not ttune.feasible(65536, 62, 1, 31, "B2/S345/200")
    assert gen_sweep.tile_fits(None, 31)  # the default tile at the deepest sweep
    # LtL: one generation per launch; its ring fits at any tile, so only the
    # grid's rows of tiles bound it.
    assert ttune.feasible(64, 2, 16, 1, "bugs")
    assert not ttune.feasible(64, 2, 16, 2, "bugs")
    assert ttune.feasible(64, 2, 700, 1, "bugs")
    assert ttune.feasible(64, 2, 900, 1, "bugs")
    assert not ttune.feasible(131072, 2, 1, 1, "bugs")
    assert not ltl_sweep.tile_fits(1, 5, 65536 * 2)  # too many tiles down the board


# JAX's default grid (size 65536, 64 steps per call, blocks 64..256, sweeps
# 4/8/16): the points whose feasibility differs, and why.  Every other point
# is feasible in both packages.
JAX_GRID_DIFFERENCES = {
    (192, 4): "192 does not divide 65536; the CUDA sweep wraps modulo H",
    (192, 8): "192 does not divide 65536; the CUDA sweep wraps modulo H",
    (192, 16): "192 does not divide 65536; the CUDA sweep wraps modulo H",
}


def test_jax_default_grid_differences_are_listed():
    diff = {}
    for b in (64, 128, 192, 256):
        for k in (4, 8, 16):
            port = ttune.feasible(65536, 64, b, k)
            jax_ = jtune.feasible(65536, 64, b, k)
            if port != jax_:
                diff[(b, k)] = (port, jax_)
    assert set(diff) == set(JAX_GRID_DIFFERENCES)
    assert all(port and not jax_ for port, jax_ in diff.values())


SYNTHETIC = [
    {"block_rows": 128, "steps_per_sweep": 16, "seconds": 0.1, "cells_per_sec": 9.0},
    {"block_rows": 64, "steps_per_sweep": 8, "seconds": 0.2, "cells_per_sec": 5.0},
    {"block_rows": 256, "steps_per_sweep": 4, "error": "RuntimeError: boom"},
]


@pytest.mark.parametrize("results", [SYNTHETIC, SYNTHETIC[1:], SYNTHETIC[2:], []])
def test_best_point_selects_as_jax(results):
    assert ttune.best_point(results) == jtune.best_point(results)


@pytest.mark.parametrize(
    "rule,want",
    [
        ("conway", "tune --blocks 128 --sweeps 16; run --kernel pallas "
                   "--pallas-block-rows 128 (run auto-caps steps_per_sweep "
                   "at 10, so k=16 is tune-only)"),
        ("wireworld", "run --kernel pallas --pallas-block-rows 128 (run "
                      "auto-caps steps_per_sweep at 10, so k=16 is tune-only)"),
        ("bugs", "run --kernel pallas --pallas-block-rows 128 (run auto-caps "
                 "steps_per_sweep at 10, so k=16 is tune-only)"),
    ],
)
def test_best_flags_name_the_ports_cli(rule, want):
    assert ttune.best_flags(SYNTHETIC, rule=rule) == want
    assert ttune.best_flags(SYNTHETIC[1:], rule="conway") == (
        "tune --blocks 64 --sweeps 8; run --kernel pallas --pallas-block-rows 64"
    )
    assert ttune.best_flags(SYNTHETIC[2:], rule=rule) is None
    assert jtune.best_flags(SYNTHETIC[2:], rule=rule) is None


def _both(capsys, args, jax_only=(), port_only=()):
    rc_j = jmain(["tune", "--platform", "cpu", "--interpret", *args, *jax_only])
    jtext = capsys.readouterr().out
    rc_t = tcli.main(["tune", "--device", "cpu", *args, *port_only])
    ttext = capsys.readouterr().out
    return (rc_j, jtext), (rc_t, ttext)


@pytest.mark.parametrize(
    "args,port_combos,jax_combos",
    [
        # Conway: JAX drops 24 (not a divisor of 128); the port keeps it.
        (["--size", "128", "--steps-per-call", "4", "--blocks", "8,16,24",
          "--sweeps", "1,2,3", "--timed-calls", "1"],
         {(8, 1), (8, 2), (16, 1), (16, 2), (24, 1), (24, 2)},
         {(8, 1), (8, 2), (16, 1), (16, 2)}),
        (["--size", "64", "--steps-per-call", "4", "--blocks", "8,16",
          "--sweeps", "2", "--timed-calls", "1", "--rule", "wireworld"],
         {(8, 2), (16, 2)}, {(8, 2), (16, 2)}),
        # bugs: JAX drops 12 (not an 8-multiple); the port keeps it.
        (["--size", "64", "--steps-per-call", "2", "--blocks", "8,16,12",
          "--sweeps", "1", "--timed-calls", "1", "--rule", "bugs"],
         {(8, 1), (16, 1), (12, 1)}, {(8, 1), (16, 1)}),
    ],
    ids=["conway", "wireworld", "bugs"],
)
def test_cli_tune_matches_jax_structure(capsys, args, port_combos, jax_combos):
    (rc_j, jtext), (rc_t, ttext) = _both(capsys, args)
    assert rc_j == rc_t == 0
    jpoints, (jsum,) = _records(jtext)
    tpoints, (tsum,) = _records(ttext)
    assert {(p["block_rows"], p["steps_per_sweep"]) for p in tpoints} == port_combos
    assert {(p["block_rows"], p["steps_per_sweep"]) for p in jpoints} == jax_combos
    for points in (jpoints, tpoints):
        assert all(set(p) == POINT_KEYS for p in points)
        rates = [p["cells_per_sec"] for p in points]
        assert rates == sorted(rates, reverse=True)
    # The summary line: the same keys and sweep identity; best is the first
    # record; flags name the tuned point.
    assert set(tsum) == set(jsum) == {"tune", "best", "flags"}
    assert tsum["tune"] == jsum["tune"]
    assert tsum["best"] == tpoints[0] and jsum["best"] == jpoints[0]
    assert f"--pallas-block-rows {tsum['best']['block_rows']}" in tsum["flags"]
    assert ttext.splitlines()[-1] == f"best: {tsum['flags']}"


def test_failed_points_are_error_records_and_exit_1(capsys, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("variant refused")

    monkeypatch.setattr(ttune, "_step_fn", boom)
    rc = tcli.main(["tune", "--device", "cpu", "--size", "64", "--steps-per-call", "4",
                    "--blocks", "8,16", "--sweeps", "2", "--timed-calls", "1"])
    captured = capsys.readouterr()
    points, summary = _records(captured.out)
    assert rc == 1 and not summary
    assert [p["error"] for p in points] == ["RuntimeError: variant refused"] * 2
    assert "no feasible point succeeded" in captured.err


def test_one_failed_point_does_not_stop_the_tune(capsys, monkeypatch):
    real = ttune._step_fn

    def flaky(rule, kernel, spc, b, k):
        if b == 16:
            raise RuntimeError("nvcc failed")
        return real(rule, kernel, spc, b, k)

    monkeypatch.setattr(ttune, "_step_fn", flaky)
    results = ttune.sweep(64, steps_per_call=4, blocks=(8, 16), sweeps=(2,),
                          timed_calls=1, device="cpu")
    assert results[-1] == {"block_rows": 16, "steps_per_sweep": 2,
                           "error": "RuntimeError: nvcc failed"}
    assert "cells_per_sec" in results[0]
    assert ttune.planned_launches(results, 4, 1) == 3 * (4 // 2)


def test_tune_refuses_a_vmem_budget_and_the_diamond():
    with pytest.raises(ValueError, match="VMEM"):
        ttune.sweep(64, vmem_limit_mb=16, device="cpu")
    with pytest.raises(ValueError, match="box"):
        ttune.sweep(64, rule="R2,B3-5,S2-6,NN", device="cpu")


def test_tune_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["tune", "--size", "64"])


def test_measured_tiles_are_the_kernels_defaults():
    assert ttune.MEASURED_TILE_ROWS == {
        "packed_sweep": 192, "gen_sweep": 192, "ltl_sweep": 48,
    }
    assert ttune.default_tile_rows("conway") == packed_sweep.DEFAULT_TILE_ROWS
    assert ttune.default_tile_rows("wireworld") == gen_sweep.DEFAULT_TILE_ROWS == 192
    assert ttune.default_tile_rows("B2/S345/200") == gen_sweep.DEFAULT_TILE_ROWS
    assert ttune.default_tile_rows("bugs") == ltl_sweep.DEFAULT_TILE_ROWS
