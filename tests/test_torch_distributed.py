"""Two port processes over gloo on the CPU: one mesh across processes.

The counterpart of ``tests/test_distributed.py``.  One pair of worker
processes (this file run as a script; they import torch and numpy only)
joins a ``torch.distributed`` group and drives every case once, each rank
printing its results as one JSON line; the parent computes the JAX
package's answers on the same seeded numpy boards and compares.  Each
process has two ``cpu`` slots for a (2, 2) global mesh, or one (``--device
cpu``) for a (2, 1) one.  Every comparison is exact:

- the raw sharded paths (``halo.sharded_step_fn``, ``sharded_sweep_step_fn``
  and ``sharded_gen_sweep_step_fn``, plain versions on the CPU), fetched
  whole, equal JAX's ``multi_step`` of the board;
- ``Simulation(distributed=True)`` for packed Conway, Brian's Brain planes
  and the dense LtL ``bugs`` prints, on rank 0 alone, the JAX
  single-process run's lines (population, digest, frames and probe
  windows) at every cadence epoch;
- epoch-indexed chaos in lockstep reaches the uninjected digests, and
  wall-clock chaos is refused with the JAX package's text;
- an npz checkpoint of the two-rank run resumes in a one-process port run
  and in the JAX package, and a JAX checkpoint resumes in the two-rank run;
- ``run --distributed`` through the CLI prints its lines once, from rank 0.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
_LINE = re.compile(r"^epoch (\d+): pop=(\d+) .*digest=([0-9a-f]{16})$")

RAW = {  # name: (rule, board shape, seed, steps, states)
    "dense": ("conway", (16, 16), 3, 4, 2),
    "sweep": ("conway", (32, 64), 9, 8, 2),
    "gen_sweep": ("brians-brain", (32, 64), 5, 8, 3),
}
COMMON = dict(steps_per_call=4, metrics_every=4, render_every=8, obs_digest=True,
              render_max_cells=32, max_epochs=8)
SIMS = {
    "conway": dict(rule="conway", height=32, width=64, seed=6, probe_window=(0, 8, 0, 40)),
    "brians-brain": dict(rule="brians-brain", height=32, width=64, seed=6),
    "bugs": dict(rule="bugs", height=40, width=40, seed=1, density=0.4),
}
MESHES = {"2x2": (["cpu", "cpu"], (2, 2)), "2x1": ("cpu", None)}
CHAOS = dict(rule="conway", height=32, width=64, seed=6, steps_per_call=4, metrics_every=4,
             obs_digest=True, max_epochs=12, checkpoint_every=4)
RESUME = dict(rule="conway", height=32, width=64, seed=6, steps_per_call=4, metrics_every=4,
              obs_digest=True, checkpoint_every=8)


def _board(shape, seed, states=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, states, size=shape, dtype=np.uint8)


def normalize(text: str, epochs_only: bool = False):
    """Output lines with each metrics line cut to its epoch, population and
    digest (the rest is timing); ``epochs_only`` keeps the lines that start
    with ``epoch``."""
    out = []
    for line in text.splitlines():
        m = _LINE.match(line)
        out.append(f"epoch {m[1]}: pop={m[2]} digest={m[3]}" if m else line)
    return [line for line in out if line.startswith("epoch")] if epochs_only else out


# -- the worker ----------------------------------------------------------------


def _worker(port: int, rank: int, tmp: Path) -> None:
    from akka_game_of_life_tpu_torch import cli
    from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen
    from akka_game_of_life_tpu_torch.parallel import distributed, halo, make_grid_mesh
    from akka_game_of_life_tpu_torch.parallel.sweep_halo import (
        sharded_gen_sweep_step_fn,
        sharded_sweep_step_fn,
    )
    from akka_game_of_life_tpu_torch.runtime.config import (
        FaultInjectionConfig,
        SimulationConfig,
    )
    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    addr = f"127.0.0.1:{port}"
    assert distributed.initialize(addr, num_processes=2, process_id=rank)
    assert not distributed.initialize(addr, num_processes=2, process_id=rank)
    assert distributed.process_info() == (rank, 2)
    assert distributed.transport() == "gloo"
    out = {"rank": rank, "raw": {}, "sims": {}}

    # The raw sharded paths, fetched whole on every rank (and on rank 0).
    for label, (devices, _) in MESHES.items():
        mesh = make_grid_mesh(None, devices if isinstance(devices, list) else [devices])
        assert mesh.local_slots == [i for i in range(mesh.size) if mesh.owners[i] == rank]
        for name, (rule, shape, seed, steps, states) in RAW.items():
            board = _board(shape, seed, states)
            if name == "dense":
                layout, unpack = board, lambda x: x
                step = halo.sharded_step_fn(mesh, rule, steps_per_call=steps, halo_width=1)
            elif name == "sweep":
                layout, unpack = bitpack.pack_np(board), bitpack.unpack_np
                step = sharded_sweep_step_fn(mesh, rule, steps_per_call=steps)
            else:
                layout, unpack = bitpack_gen.pack_gen_np(board, states), bitpack_gen.unpack_gen_np
                step = sharded_gen_sweep_step_fn(mesh, rule, steps_per_call=steps)
            tiles = step(distributed.make_global_array(layout, mesh))
            assert [i for i, t in enumerate(tiles) if t is not None] == mesh.local_slots
            full = unpack(distributed.fetch(tiles, mesh))
            at_0 = distributed.fetch(tiles, mesh, dst=0)
            assert (at_0 is None) == (rank != 0)
            out["raw"][f"{label}/{name}"] = [list(full.shape), full.tobytes().hex(),
                                             list(mesh.shape)]

    # Simulation(distributed=True) on both meshes, three layouts.
    for label, (device, mesh_shape) in MESHES.items():
        for name, kw in SIMS.items():
            text = io.StringIO()
            cfg = SimulationConfig(**{**COMMON, **kw}, mesh_shape=mesh_shape,
                                   distributed=True)
            observer = BoardObserver(metrics_every=4, render_every=8, render_max_cells=32,
                                     out=text)
            with Simulation(cfg, observer=observer, device=device) as sim:
                sim.advance()
                shape, layout = list(sim.mesh.shape), sim.layout
                digest = sim.board_digest()
            out["sims"][f"{label}/{name}"] = [text.getvalue(), shape, layout, digest]

    # Epoch-indexed chaos in lockstep, from the shared store.
    chaos_dir = tmp / "chaos"
    if rank == 0 and chaos_dir.exists():
        shutil.rmtree(chaos_dir)
    distributed.barrier("chaos-dir-clean")
    text = io.StringIO()
    cfg = SimulationConfig(
        **CHAOS, distributed=True, checkpoint_dir=str(chaos_dir),
        fault_injection=FaultInjectionConfig(
            enabled=True, first_after_epochs=4, every_epochs=8, max_crashes=1
        ),
    )
    with Simulation(cfg, observer=BoardObserver(metrics_every=4, out=text), device="cpu") as sim:
        sim.advance()
        out["chaos"] = [text.getvalue(), list(sim.crash_log)]
    try:
        Simulation(SimulationConfig(
            **CHAOS, distributed=True, checkpoint_dir=str(tmp / "wall"),
            fault_injection=FaultInjectionConfig(enabled=True),
        ), device="cpu")
        out["wall_clock"] = None
    except ValueError as e:
        out["wall_clock"] = str(e)

    # npz: a two-rank save for the parent to resume, and the parent's JAX
    # checkpoint resumed here.
    cfg = SimulationConfig(**RESUME, max_epochs=8, distributed=True,
                           checkpoint_dir=str(tmp / "npz2"))
    with Simulation(cfg, observer=BoardObserver(out=io.StringIO()),
                    device=["cpu", "cpu"]) as sim:
        sim.advance()
    text = io.StringIO()
    cfg = SimulationConfig(**RESUME, max_epochs=16, distributed=True,
                           checkpoint_dir=str(tmp / "jaxck"))
    with Simulation(cfg, observer=BoardObserver(metrics_every=4, out=text),
                    device=["cpu", "cpu"]) as sim:
        out["jax_resume"] = [sim.epoch]
        sim.advance(16 - sim.epoch)
        out["jax_resume"].append(text.getvalue())

    # The CLI, as a user starts it on every rank.
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main([
            "run", "--distributed", "--coordinator", addr, "--num-processes", "2",
            "--process-id", str(rank), "--device", "cpu", "--height", "32", "--width", "64",
            "--seed", "6", "--max-epochs", "8", "--steps-per-call", "4",
            "--metrics-every", "4", "--obs-digest",
        ])
    out["cli"] = [rc, text.getvalue()]
    distributed.barrier("done")
    print("RESULT " + json.dumps(out), flush=True)
    distributed.shutdown()


def _dead_peer(port: int, rank: int) -> None:
    """Rank 1 dies after joining; rank 0's next collective must raise, not
    wait out the group's timeout."""
    import time

    from akka_game_of_life_tpu_torch.parallel import distributed

    distributed.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank)
    if rank == 1:
        os._exit(3)
    t0 = time.monotonic()
    try:
        for _ in range(10):
            distributed.barrier("after-death")
            time.sleep(0.5)
    except RuntimeError:
        print(f"DEAD-PEER-RAISED after {time.monotonic() - t0:.1f} s", flush=True)
        os._exit(0)
    os._exit(1)


if __name__ == "__main__":
    if sys.argv[4:] == ["dead-peer"]:
        _dead_peer(int(sys.argv[1]), int(sys.argv[2]))
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
    sys.exit(0)


# -- the parent ----------------------------------------------------------------

import pytest  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(script: Path, tmp: Path, *extra) -> list:
    """Run ``script <port> <rank> <tmp> extra...`` as ranks 0 and 1; each
    must exit 0 within the timeout.  Returns their outputs, rank order."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(rank), str(tmp), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp,
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
    return outs


def _jax_run(kw, tmp=None, epochs=None, resume_dir=None):
    """The JAX package's single-process run: (normalized lines, digest)."""
    import jax

    from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
    from akka_game_of_life_tpu.runtime.render import BoardObserver as JObserver
    from akka_game_of_life_tpu.runtime.simulation import Simulation as JSimulation

    real = jax.devices
    jax.devices = lambda *a: real(*a)[:1]
    try:
        text = io.StringIO()
        extra = {} if resume_dir is None else {"checkpoint_dir": str(resume_dir)}
        cfg = JConfig(**{**kw, **extra})
        sim = JSimulation(cfg, observer=JObserver(
            metrics_every=cfg.metrics_every, render_every=cfg.render_every,
            render_max_cells=cfg.render_max_cells, out=text))
        sim.advance((epochs or cfg.max_epochs) - sim.epoch)
        digest = sim.board_digest()
        sim.close()
    finally:
        jax.devices = real
    return normalize(text.getvalue(), epochs_only=resume_dir is not None), digest


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    # A JAX checkpoint at epoch 8 for the two-rank run to resume.
    _jax_run({k: v for k, v in RESUME.items()}, resume_dir=tmp / "jaxck", epochs=8)
    outs = run_pair(Path(__file__), tmp)
    results = []
    for text in outs:
        lines = [line for line in text.splitlines() if line.startswith("RESULT ")]
        assert len(lines) == 1, text[-4000:]
        results.append(json.loads(lines[0][len("RESULT "):]))
    return tmp, results


@pytest.mark.parametrize("case", [f"{m}/{n}" for m in MESHES for n in RAW])
def test_raw_sharded_paths_across_processes_match_jax(pair, case):
    import jax.numpy as jnp

    from akka_game_of_life_tpu.ops.stencil import multi_step

    _, results = pair
    rule, shape, seed, steps, states = RAW[case.split("/")[1]]
    want = np.asarray(multi_step(jnp.asarray(_board(shape, seed, states)), rule, steps))
    for rank, res in enumerate(results):
        got_shape, got, mesh = res["raw"][case]
        assert tuple(mesh) == ((2, 2) if case.startswith("2x2") else (2, 1))
        assert got_shape == list(want.shape)
        assert bytes.fromhex(got) == want.astype(np.uint8).tobytes(), (case, rank)


@pytest.mark.parametrize("case", [f"{m}/{n}" for m in MESHES for n in SIMS])
def test_distributed_simulation_prints_the_jax_lines(pair, case):
    label, name = case.split("/")
    _, results = pair
    want, digest = _jax_run({**COMMON, **SIMS[name]})
    text, shape, layout, d0 = results[0]["sims"][case]
    head, *lines = normalize(text)
    assert head.startswith("distributed: rank 0 of 2 processes, transport gloo, mesh")
    assert lines == want
    assert layout == {"conway": "words", "brians-brain": "planes", "bugs": "dense"}[name]
    assert tuple(shape) == ((2, 2) if label == "2x2" else (2, 1))
    assert d0 == digest
    text1, _, _, d1 = results[1]["sims"][case]
    assert text1 == "" and d1 == digest


def test_lockstep_chaos_reaches_the_uninjected_digests(pair):
    _, results = pair
    want, _ = _jax_run(CHAOS)
    text, crash_log = results[0]["chaos"]
    assert crash_log and results[1]["chaos"][1] == crash_log
    assert normalize(text, epochs_only=True) == want


def test_wall_clock_chaos_refused_with_the_jax_text(pair):
    _, results = pair
    for res in results:
        assert res["wall_clock"].startswith(
            "wall-clock fault_injection with distributed=True is unsupported"
        )


def test_npz_checkpoints_resume_across_packages_and_process_counts(pair, tmp_path):
    from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    tmp, results = pair
    want, digest = _jax_run({**RESUME, "max_epochs": 16})
    # The two-rank run's epoch-8 file in one port process and in JAX.
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        shutil.copytree(tmp / "npz2", d)
        if pkg == "jax":
            lines, got = _jax_run({**RESUME, "max_epochs": 16}, resume_dir=d)
        else:
            text = io.StringIO()
            with Simulation(SimulationConfig(**RESUME, max_epochs=16, checkpoint_dir=str(d)),
                            observer=BoardObserver(metrics_every=4, out=text),
                            device="cpu") as sim:
                assert sim.epoch == 8
                sim.advance(8)
                got = sim.board_digest()
            lines = normalize(text.getvalue(), epochs_only=True)
        assert got == digest, pkg
        assert lines == want[2:], pkg
    # The JAX checkpoint resumed by two ranks.
    epoch, text = results[0]["jax_resume"]
    assert epoch == 8 and results[1]["jax_resume"] == [8, ""]
    assert normalize(text, epochs_only=True) == want[2:]


def test_cli_run_distributed_prints_once_from_rank_zero(pair):
    _, results = pair
    want, _ = _jax_run({**RESUME, "max_epochs": 8})
    rc0, text0 = results[0]["cli"]
    rc1, text1 = results[1]["cli"]
    assert rc0 == rc1 == 0
    lines = normalize(text0)
    assert [line for line in lines if line.startswith("epoch")] == want
    assert any(line.startswith("distributed: rank 0 of 2 processes, transport gloo")
               for line in lines)
    assert sum(line.startswith("run summary: ") for line in lines) == 1
    assert text1 == ""


@pytest.mark.parametrize("facts,want", [
    ([{"host": "a", "cards": []}, {"host": "a", "cards": []}], "gloo"),
    ([{"host": "a", "cards": ["u0"]}, {"host": "a", "cards": ["u1"]}], "nccl"),
    ([{"host": "a", "cards": ["u0"]}, {"host": "b", "cards": ["u0"]}], "nccl"),
    ([{"host": "a", "cards": ["u0"]}, {"host": "a", "cards": ["u0"]}], "staged"),
    ([{"host": "a", "cards": ["u0", "u1"]}, {"host": "a", "cards": ["u1"]}], "staged"),
    ([{"host": "a", "cards": ["u0"]}, {"host": "a", "cards": []}], "staged"),
])
def test_the_transport_follows_the_ranks_cards(facts, want):
    """NCCL only where every rank drives cards and no card (host, UUID) is
    driven twice; gloo without cards; host staging otherwise."""
    from akka_game_of_life_tpu_torch.parallel.distributed import choose_transport

    assert choose_transport(facts) == want


def test_a_dead_peer_fails_the_collective(tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(port), str(rank), str(tmp_path), "dead-peer"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for rank in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[1].returncode == 3, outs[1][-2000:]
    assert procs[0].returncode == 0 and "DEAD-PEER-RAISED" in outs[0], outs[0][-2000:]
