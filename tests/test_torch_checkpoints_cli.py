"""The port's ``checkpoints`` and ``models`` subcommands against the JAX
package's: the same JSON lines on directories written by either package
(layouts 0-3 and per-tile epochs, with recorded digests and a corrupted
file), and the same rule registry.  Mirrors ``tests/test_checkpoint.py``
and ``tests/test_config.py``.
"""

import json

import numpy as np
import pytest

from akka_game_of_life_tpu.cli import main as jmain
from akka_game_of_life_tpu.ops.bitpack import pack_np
from akka_game_of_life_tpu.ops.bitpack_gen import pack_gen_np
from akka_game_of_life_tpu.runtime.checkpoint import CheckpointStore as JStore
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore as TStore
from akka_game_of_life_tpu_torch.runtime.checkpoint import describe_store


def _fill(store_cls, directory):
    """One epoch of each layout: dense uint8 (0), packbits (1), packed32 (2),
    gen planes (3) with a recorded digest, and a per-tile epoch."""
    from akka_game_of_life_tpu.ops import digest as jdigest

    store = store_cls(str(directory), keep=10)
    rng = np.random.default_rng(0)
    binary = (rng.random((32, 64)) < 0.5).astype(np.uint8)
    states = rng.integers(0, 3, size=(32, 64), dtype=np.uint8)
    store.save(10, states, "/2/3", meta={"height": 32, "width": 64})
    store.save(20, binary, "B3/S23", meta={"height": 32, "width": 64})
    digest = jdigest.format_digest(jdigest.value(jdigest.digest_dense_np(binary)))
    store.save_packed32(30, pack_np(binary), (32, 64), "B3/S23", meta={"digest": digest})
    store.save_packed32(40, pack_gen_np(states, 3), (32, 64), "/2/3")
    store.save_tile(50, (0, 0), binary[:16])
    store.save_tile(50, (1, 0), binary[16:])
    store.finalize_epoch(50, "B3/S23", (2, 1), (32, 64))
    return store


def _lines(main, capsys, *args):
    rc = main(["checkpoints", *args])
    return rc, [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("validate", [False, True], ids=["list", "validate"])
def test_checkpoints_lines_equal_jax(tmp_path, capsys, writer, validate):
    _fill(JStore if writer == "jax" else TStore, tmp_path)
    args = [str(tmp_path)] + (["--validate"] if validate else [])
    jrc, jlines = _lines(lambda a: jmain([a[0], "--platform", "cpu", *a[1:]]), capsys, *args)
    trc, tlines = _lines(tcli.main, capsys, *args)
    assert jrc == trc == 0
    assert tlines == jlines
    assert [i["layout"] for i in tlines] == [
        "dense-uint8", "packbits", "packed32", "gen-planes", "tiles"
    ]
    if validate:
        assert all(i["ok"] for i in tlines)
        assert tlines[2]["digest_ok"] is True


def test_checkpoints_flag_corruption_like_jax(tmp_path, capsys):
    store = TStore(str(tmp_path), keep=10)
    board = np.zeros((16, 32), np.uint8)
    store.save(5, board, "B3/S23")
    p = store.save(9, board, "B3/S23")
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])  # truncate epoch 9
    jrc, jlines = _lines(lambda a: jmain([a[0], "--platform", "cpu", *a[1:]]), capsys,
                         str(tmp_path), "--validate")
    trc, tlines = _lines(tcli.main, capsys, str(tmp_path), "--validate")
    assert jrc == trc == 1
    assert [(i["epoch"], i.get("ok"), "error" in i) for i in tlines] == [
        (i["epoch"], i.get("ok"), "error" in i) for i in jlines
    ] == [(5, True, False), (9, False, True)]


def test_checkpoints_digest_mismatch(tmp_path, capsys):
    store = TStore(str(tmp_path))
    store.save_packed32(3, np.zeros((8, 1), np.uint32), (8, 32), "B3/S23",
                        meta={"digest": "0123456789abcdef"})
    rc, (line,) = _lines(tcli.main, capsys, str(tmp_path), "--validate")
    assert rc == 1 and line["ok"] is False and line["digest_ok"] is False
    assert line["error"].startswith("digest mismatch: stored 0123456789abcdef")


def test_checkpoints_of_an_empty_directory_exit_1(tmp_path, capsys):
    assert tcli.main(["checkpoints", str(tmp_path)]) == 1
    assert "no checkpoints found" in capsys.readouterr().err
    assert list(describe_store(str(tmp_path / "missing"))) == []
    assert not (tmp_path / "missing").exists()


def test_checkpoints_of_a_run(tmp_path, capsys):
    """A run's own directory validates, digests included."""
    assert tcli.main(["run", "--device", "cpu", "--rule", "wireworld", "--pattern",
                      "wireworld-clock", "--height", "32", "--width", "64", "--max-epochs",
                      "20", "--steps-per-call", "5", "--checkpoint-dir", str(tmp_path),
                      "--checkpoint-every", "10", "--obs-digest", "--metrics-every",
                      "10"]) == 0
    capsys.readouterr()
    rc, lines = _lines(tcli.main, capsys, str(tmp_path), "--validate")
    assert rc == 0 and [i["epoch"] for i in lines] == [10, 20]
    assert all(i["layout"] == "gen-planes" and i["digest_ok"] for i in lines)


def test_models_lines_equal_jax(capsys):
    assert jmain(["models"]) == 0
    jlines = capsys.readouterr().out.splitlines()
    assert tcli.main(["models"]) == 0
    tlines = capsys.readouterr().out.splitlines()
    assert tlines == jlines
    by_name = {r["name"]: r for r in map(json.loads, tlines)}
    assert by_name["conway"]["rulestring"] == "B3/S23"
    assert by_name["bugs"]["radius"] == 5 and by_name["bugs"]["kind"] == "ltl"
