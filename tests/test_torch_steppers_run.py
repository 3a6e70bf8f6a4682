"""``run`` through the banded-matmul stencil, activity-gated stepping and the
linear-rule fast-forward, against the JAX package end to end on the CPU.

The two CLIs must print the same ``digest=`` lines (and ``fast-forwarded to
epoch E: digest=`` line) on the same flags, every refusal must carry the
JAX package's message, and a gated run's checkpoints must resume in either
package.
"""

import io
import json
import os
import re
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_game_of_life_tpu import cli as jcli
from akka_game_of_life_tpu.ops import ltl as jltl
from akka_game_of_life_tpu.ops.rules import resolve_rule as jrule
from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
from akka_game_of_life_tpu.runtime.render import BoardObserver as JObserver
from akka_game_of_life_tpu.runtime.simulation import Simulation as JSimulation
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.obs.metrics import MetricsRegistry
from akka_game_of_life_tpu_torch.ops import ltl, sparse
from akka_game_of_life_tpu_torch.runtime import selftest
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

_LINE = re.compile(r"^epoch (\d+): pop=(\d+) .*digest=([0-9a-f]{16})$", re.M)
_FF = re.compile(r"^fast-forwarded to epoch (\d+): digest=([0-9a-f]{16})$", re.M)

STEP = ["--steps-per-call", "8", "--metrics-every", "8", "--obs-digest"]
RUNS = {
    "matmul-conway": ["--height", "48", "--width", "96", "--seed", "3", "--max-epochs", "32",
                      "--kernel", "matmul", *STEP],
    "matmul-bugs": ["--rule", "bugs", "--height", "40", "--width", "48", "--seed", "1",
                    "--density", "0.5", "--max-epochs", "16", "--kernel", "matmul", *STEP],
    "matmul-wireworld": ["--rule", "wireworld", "--pattern", "wireworld-clock", "--height", "32",
                         "--width", "40", "--max-epochs", "24", "--kernel", "matmul", *STEP],
    "sparse-glider": ["--pattern", "glider", "--height", "96", "--width", "96", "--max-epochs",
                      "48", "--sparse-kernel", "on", "--sparse-block", "16", *STEP],
    "sparse-soup": ["--height", "64", "--width", "64", "--seed", "4", "--max-epochs", "32",
                    "--sparse-kernel", "on", "--sparse-block", "16", "--sparse-threshold", "0.3",
                    *STEP],
    "ff-words": ["--rule", "replicator", "--height", "48", "--width", "96", "--seed", "11",
                 "--fast-forward", "1000000", "--max-epochs", "1000016", *STEP],
    "ff-dense": ["--rule", "fredkin", "--height", "40", "--width", "60", "--seed", "2",
                 "--fast-forward", "65536", "--max-epochs", "65552", "--ff-certify-steps", "3",
                 *STEP],
    "ff-sparse": ["--rule", "replicator", "--height", "48", "--width", "48", "--seed", "5",
                  "--fast-forward", "4000", "--max-epochs", "4016", "--sparse-kernel", "on",
                  "--sparse-block", "16", *STEP],
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_lines_match_jax(name, capsys):
    args = RUNS[name]
    assert jcli.main(["run", "--platform", "cpu", *args]) == 0
    jtext = capsys.readouterr().out
    assert tcli.main(["run", "--device", "cpu", *args]) == 0
    ttext = capsys.readouterr().out
    assert _LINE.findall(jtext), jtext
    assert _LINE.findall(ttext) == _LINE.findall(jtext)
    assert _FF.findall(ttext) == _FF.findall(jtext)
    assert bool(_FF.findall(ttext)) == name.startswith("ff")
    kernel = {"matmul": "matmul", "sparse": "sparse"}.get(name.split("-")[0])
    if kernel is not None:
        assert f'"kernel": "{kernel}"' in ttext


def test_fast_forward_refusal_at_the_cli_matches_jax(capsys):
    args = ["--rule", "conway", "--height", "32", "--width", "32", "--fast-forward", "9"]
    with pytest.raises(SystemExit) as want:
        jcli.main(["run", "--platform", "cpu", *args])
    with pytest.raises(SystemExit) as got:
        tcli.main(["run", "--device", "cpu", *args])
    assert str(got.value) == str(want.value)
    assert "--fast-forward: rule" in str(got.value)


def _jax_error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


BASE = dict(height=64, width=64, steps_per_call=4)
REFUSALS = [
    dict(kernel="matmul", mesh_shape=(1, 1)),
    dict(kernel="matmul", rule="R2,B3-5,S2-6,NN"),
    dict(kernel="matmul", rule="bugs", height=8, width=40),
    dict(kernel="matmul", height=65536, width=65536),
    dict(sparse_kernel=True, rule="bugs"),
    dict(sparse_kernel=True, mesh_shape=(2, 2)),
    dict(sparse_kernel=True, obs_defer=True),
    dict(sparse_kernel=True, sparse_block=16, steps_per_call=32),
    dict(sparse_kernel=True, kernel="bitpack"),
    dict(sparse_kernel=True, kernel="pallas"),
]


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_refusals_match_jax(kw):
    cfg = {**BASE, **kw}
    want = _jax_error(lambda: JSimulation(JConfig(**cfg)))
    assert want is not None
    with pytest.raises(ValueError) as got:
        Simulation(SimulationConfig(**cfg), device="cpu")
    assert str(got.value) == want


@pytest.mark.parametrize(
    "kw,epochs",
    [(dict(ff_enabled=False), 5), (dict(rule="conway"), 5), (dict(), -1), (dict(), 2**62)],
)
def test_fast_forward_refusals_match_jax(kw, epochs):
    cfg = {**BASE, "rule": "replicator", **kw}
    want = _jax_error(lambda: JSimulation(JConfig(**cfg)).fast_forward(epochs))
    assert want is not None
    with pytest.raises(ValueError) as got:
        Simulation(SimulationConfig(**cfg), device="cpu").fast_forward(epochs)
    assert str(got.value) == want


@pytest.mark.parametrize(
    "key,value",
    [("ff_enabled", False), ("ff_certify_steps", 0), ("sparse_kernel", True),
     ("sparse_block", 64), ("sparse_threshold", 0.25)],
)
def test_ported_keys_load_as_in_jax(key, value, tmp_path):
    """The steppers' keys load from overrides and files with the JAX
    package's defaults, and out-of-range values are refused with its
    messages."""
    from akka_game_of_life_tpu.runtime.config import load_config as jload
    from akka_game_of_life_tpu_torch.runtime.config import load_config as tload

    assert getattr(tload(None, {key: value}), key) == value
    assert getattr(SimulationConfig(), key) == getattr(JConfig(), key)
    path = tmp_path / "c.toml"
    path.write_text(f"height = 64\n{key} = {str(value).lower()}\n")
    assert getattr(tload(str(path)), key) == getattr(jload(str(path)), key) == value
    bad = {"ff_certify_steps": -1, "sparse_block": 0, "sparse_threshold": 1.5}.get(key)
    if bad is not None:
        want = _jax_error(lambda: JConfig(**{key: bad}))
        with pytest.raises(ValueError) as got:
            SimulationConfig(**{key: bad})
        assert str(got.value) == want


def test_ltl_matmul_engine_matches_jax():
    board = (np.random.default_rng(7).random((40, 48)) < 0.5).astype(np.uint8)
    want = np.asarray(jltl.step_ltl(jnp.asarray(board), jrule("bugs"), engine="matmul"))
    got = ltl.step_ltl(torch.from_numpy(board), "bugs", engine="matmul").numpy()
    np.testing.assert_array_equal(got, want)


def test_selftest_matmul_passes():
    lines = []
    assert selftest.run_selftest(kernel="matmul", out=lines.append, device="cpu") == 0
    recs = {r["check"]: r for r in map(json.loads, lines)}
    assert recs["sharded"]["status"] == "skip"
    for name in ("gun-phase", "oracle", "checkpoint", "chaos", "obs-defer"):
        assert (recs[name]["status"], recs[name]["resolved"]) == ("pass", "matmul"), recs[name]


# -- the gated engine inside the run -------------------------------------------

SPARSE = dict(height=96, width=96, pattern="glider", steps_per_call=8, sparse_kernel=True,
              sparse_block=16, obs_digest=True)


def _port(tmp=None, **kw):
    cfg = {**SPARSE, **kw}
    if tmp is not None:
        cfg.update(checkpoint_dir=str(tmp), checkpoint_every=16)
    return Simulation(SimulationConfig(**cfg), observer=BoardObserver(out=io.StringIO()),
                      device="cpu", registry=MetricsRegistry())


def _jax(tmp=None, **kw):
    cfg = {**SPARSE, **kw}
    if tmp is not None:
        cfg.update(checkpoint_dir=str(tmp), checkpoint_every=16)
    return JSimulation(JConfig(**cfg), observer=JObserver(out=io.StringIO()))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("gated_reader", [True, False])
def test_sparse_checkpoints_resume_in_the_other_package(tmp_path, writer, gated_reader):
    want = _port(sparse_kernel=False)
    want.advance(48)
    first = (_port if writer == "port" else _jax)(tmp_path)
    first.advance(32)
    first.close()
    reader = (_jax if writer == "port" else _port)(tmp_path, sparse_kernel=gated_reader)
    assert reader.epoch == 32
    reader.advance(16)
    np.testing.assert_array_equal(np.asarray(reader.board_host()), want.board_host())


def test_sparse_snapshots_are_copies(tmp_path):
    """The writer thread and board_host get copies of the host board, which
    the next chunks write in place: each saved epoch equals the ungated
    run's board at that epoch."""
    from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore

    gated = _port(tmp_path / "gated", checkpoint_async=True)
    plain = _port(tmp_path / "plain", sparse_kernel=False)
    gated.advance(48)
    plain.advance(48)
    gated.close()
    plain.close()
    for epoch in (16, 32, 48):
        a = CheckpointStore(str(tmp_path / "gated")).load(epoch).board
        b = CheckpointStore(str(tmp_path / "plain")).load(epoch).board
        np.testing.assert_array_equal(a, b)
    host = gated.board_host()
    host[:] = 1
    assert int(gated.board_host().sum()) == 5


def test_sparse_gauges_count_the_blocks():
    sim = _port()
    sim.advance(48)
    sp, reg = sim._sparse, sim.metrics
    chunks = sp.dense_chunks + sp.sparse_chunks
    assert chunks == 6
    assert (reg.value("gol_sparse_blocks_stepped_total")
            + reg.value("gol_sparse_blocks_skipped_total")) == chunks * sp.total_blocks
    assert reg.value("gol_sparse_blocks_skipped_total") > 0
    assert reg.value("gol_sparse_dense_chunks_total") == sp.dense_chunks == 1
    assert reg.value("gol_sparse_active_blocks") == sp.last_active_blocks


def test_sparse_chunk_is_shielded_from_sigint(monkeypatch):
    """A ^C landing mid-chunk is held until the chunk has written the board
    and the epoch: the interrupt checkpoint never sees a torn board."""
    sim = _port()
    real = sparse.SparseStepper.step

    def step(self, board, steps):
        os.kill(os.getpid(), signal.SIGINT)
        return real(self, board, steps)

    monkeypatch.setattr(sparse.SparseStepper, "step", step)
    with pytest.raises(KeyboardInterrupt):
        sim.advance(16)
    assert sim.epoch == 8
    want = _port(sparse_kernel=False)
    want.advance(8)
    np.testing.assert_array_equal(sim.board_host(), want.board_host())
