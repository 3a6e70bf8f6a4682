"""Durability of the port's standalone ``run`` against the JAX package's.

The async checkpoint writer (one save in flight on a writer thread, errors
at the next wait, byte-equal files), the interrupt checkpoint on SIGINT and
SIGTERM (exit 130, resumable in both packages), and fault injection with
replay from the newest checkpoint (the JAX package's ``crash_log``, the
uninterrupted run's digest).  Mirrors ``tests/test_simulation.py``.
"""

import io
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from akka_game_of_life_tpu.runtime.config import FaultInjectionConfig as JFault
from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
from akka_game_of_life_tpu.runtime.render import BoardObserver as JObserver
from akka_game_of_life_tpu.runtime.simulation import Simulation as JSimulation
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore
from akka_game_of_life_tpu_torch.runtime.config import FaultInjectionConfig, SimulationConfig
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

REPO = Path(__file__).resolve().parent.parent


def _port(tmp_path=None, **kw):
    kw.setdefault("flight_dir", str(tmp_path) if tmp_path is not None else "")
    return Simulation(SimulationConfig(**kw), observer=BoardObserver(out=io.StringIO()),
                      device="cpu")


def _jax(**kw):
    return JSimulation(JConfig(**kw), observer=JObserver(out=io.StringIO()))


# -- the async writer ---------------------------------------------------------


def test_async_checkpoint_runs_off_main_thread_and_is_durable(tmp_path):
    cfg = dict(height=64, width=64, seed=3, steps_per_call=5,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=5)
    threads = []
    with _port(tmp_path, **cfg) as sim:
        orig = sim.store.save_packed32
        sim.store.save_packed32 = lambda *a, **k: (
            threads.append(threading.current_thread().name), orig(*a, **k)
        )
        sim.advance(20)
        want = sim.board_host()
    assert threads and all(t.startswith("ckpt") for t in threads)
    assert CheckpointStore(str(tmp_path / "ck")).latest_epoch() == 20
    with _port(tmp_path, **cfg) as sim2:
        assert sim2.epoch == 20
        assert np.array_equal(sim2.board_host(), want)


@pytest.mark.parametrize(
    "kw",
    [dict(rule="conway"), dict(rule="wireworld", pattern="wireworld-clock"),
     dict(rule="bugs", width=48), dict(rule="conway", mesh=True)],
    ids=["words", "planes", "dense", "mesh"],
)
def test_async_files_byte_equal_sync_and_jax(tmp_path, kw):
    """The writer thread saves the files a synchronous save writes, and the
    JAX package's writer the same bytes (layouts 2, 3 and 1; a mesh gathers
    its tiles on the host first)."""
    kw = dict(kw)
    mesh = kw.pop("mesh", False)
    base = {**dict(height=64, width=64, seed=6, steps_per_call=4, checkpoint_every=8,
                   obs_digest=True), **kw}
    dirs = {}
    for mode in ("async", "sync"):
        dirs[mode] = tmp_path / mode
        extra = dict(mesh_shape=(2, 1)) if mesh else {}
        sim = Simulation(
            SimulationConfig(checkpoint_dir=str(dirs[mode]), flight_dir="",
                             checkpoint_async=mode == "async", **base, **extra),
            observer=BoardObserver(out=io.StringIO()),
            device=["cpu", "cpu"] if mesh else "cpu",
        )
        sim.advance(24)
        sim.close()
    dirs["jax"] = tmp_path / "jax"
    jsim = _jax(checkpoint_dir=str(dirs["jax"]), kernel="bitpack" if kw["rule"] != "bugs"
                else "dense", **base)
    jsim.advance(24)
    jsim.close()
    names = sorted(p.name for p in dirs["async"].iterdir())
    assert names == ["ckpt_000000000008.npz", "ckpt_000000000016.npz", "ckpt_000000000024.npz"]
    for mode in ("sync", "jax"):
        assert sorted(p.name for p in dirs[mode].iterdir()) == names
        for name in names:
            assert (dirs[mode] / name).read_bytes() == (dirs["async"] / name).read_bytes(), (mode, name)


def test_async_checkpoint_matches_sync_trajectory(tmp_path):
    boards = {}
    for mode, use_async in (("async", True), ("sync", False)):
        with _port(tmp_path, height=48, width=64, seed=9, steps_per_call=4,
                   checkpoint_dir=str(tmp_path / mode), checkpoint_every=8,
                   checkpoint_async=use_async) as sim:
            sim.advance(24)
            boards[mode] = sim.board_host()
    assert np.array_equal(boards["async"], boards["sync"])


def test_crash_recovery_drains_pending_async_save(tmp_path):
    with _port(tmp_path, height=32, width=32, seed=5, steps_per_call=4,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4) as sim:
        sim.advance(8)
        sim.checkpoint()  # async save of epoch 8 in flight
        clean = sim.board_host()
        sim._crash_and_recover()  # must restore epoch 8, not an older one
        assert sim.epoch == 8
        assert np.array_equal(sim.board_host(), clean)


def test_async_checkpoint_write_errors_surface(tmp_path):
    sim = _port(tmp_path, height=32, width=32, seed=5, steps_per_call=4,
                checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=0)
    sim.advance(4)

    def boom(*a, **k):
        raise OSError("disk gone")

    sim.store.save_packed32 = boom
    sim.checkpoint()  # submits; the failure lands on the writer thread
    with pytest.raises(OSError, match="disk gone"):
        sim.close()
    assert sim._ckpt_executor is None and sim._ckpt_pending is None


def test_checkpoint_profile_lines(tmp_path):
    """The async writer's ``[profile] checkpoint@E (async write)`` line at
    the next wait, and the synchronous save's ``[profile] checkpoint@E``."""
    for use_async, tag in ((True, " (async write)"), (False, "")):
        out = io.StringIO()
        sim = Simulation(
            SimulationConfig(height=32, width=32, steps_per_call=4, metrics_every=4,
                             checkpoint_dir=str(tmp_path / str(use_async)),
                             checkpoint_every=8, checkpoint_async=use_async, flight_dir=""),
            observer=BoardObserver(out=out, metrics_every=4), device="cpu",
        )
        sim.advance(16)
        sim.close()
        lines = [line for line in out.getvalue().splitlines() if line.startswith("[profile]")]
        assert [line.split(":")[0] for line in lines] == [
            f"[profile] checkpoint@8{tag}", f"[profile] checkpoint@16{tag}"
        ]


# -- the interrupt checkpoint -------------------------------------------------

RUN = ["run", "--rule", "conway", "--height", "32", "--width", "32", "--seed", "3",
       "--steps-per-call", "1", "--checkpoint-every", "10000"]


def _interrupt(tmp_path, sig):
    progress = tmp_path / "progress.log"
    ck = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-m", "akka_game_of_life_tpu_torch", *RUN, "--device", "cpu",
         "--tick", "20ms", "--max-epochs", "100000", "--metrics-every", "5",
         "--log-file", str(progress), "--checkpoint-dir", str(ck), "--flight-dir", ""],
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    deadline = time.time() + 120
    while time.time() < deadline:
        if progress.exists() and "epoch" in progress.read_text():
            break
        if proc.poll() is not None:
            raise AssertionError(f"run exited early: {proc.communicate()}")
        time.sleep(0.1)
    else:
        proc.kill()
        raise AssertionError("run never made observable progress")
    proc.send_signal(sig)
    try:
        _, err = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 130, err
    epoch = CheckpointStore(str(ck)).latest_epoch()
    assert f"interrupted at epoch {epoch}; checkpoint written" in err
    assert epoch is not None and 0 < epoch < 100000
    return ck, epoch


@pytest.mark.parametrize("sig", [signal.SIGINT, signal.SIGTERM], ids=["sigint", "sigterm"])
def test_interrupt_checkpoints_and_resumes_in_both_packages(tmp_path, sig, capsys):
    ck, epoch = _interrupt(tmp_path, sig)
    end = epoch + 5
    clean = _port(height=32, width=32, seed=3, steps_per_call=1)
    clean.advance(end)
    want = clean.board_digest()
    # The port resumes from the interrupt epoch ...
    import shutil

    shutil.copytree(ck, tmp_path / "jax-ck")
    assert tcli.main([*RUN, "--device", "cpu", "--max-epochs", str(end),
                      "--checkpoint-dir", str(ck), "--checkpoint-every", "1",
                      "--render-every", "0", "--metrics-every", "0",
                      "--flight-dir", ""]) == 0
    capsys.readouterr()
    resumed = _port(height=32, width=32, seed=3, steps_per_call=1, checkpoint_dir=str(ck))
    assert resumed.epoch == end and resumed.board_digest() == want
    # ... and so does the JAX package.
    jsim = _jax(height=32, width=32, seed=3, steps_per_call=1, kernel="bitpack",
                checkpoint_dir=str(tmp_path / "jax-ck"))
    assert jsim.epoch == epoch
    jsim.advance(end - epoch)
    assert jsim.board_digest() == want


def test_jax_interrupt_checkpoint_resumes_in_the_port(tmp_path):
    """The reverse direction: a JAX run stopped mid-run (its interrupt
    checkpoint is an ordinary checkpoint at the stop epoch) resumes in the
    port to the uninterrupted digest."""
    jsim = _jax(height=32, width=32, seed=3, steps_per_call=1, kernel="bitpack",
                checkpoint_dir=str(tmp_path))
    jsim.advance(7)
    jsim.checkpoint()
    jsim.flush()
    jsim.close()
    sim = _port(height=32, width=32, seed=3, steps_per_call=1, checkpoint_dir=str(tmp_path))
    assert sim.epoch == 7
    sim.advance(5)
    clean = _port(height=32, width=32, seed=3, steps_per_call=1)
    clean.advance(12)
    assert sim.board_digest() == clean.board_digest()


def test_shield_defers_an_interrupt_to_the_end_of_the_swap():
    from akka_game_of_life_tpu_torch.runtime.simulation import _shield_sigint

    before = signal.getsignal(signal.SIGINT)
    with pytest.raises(KeyboardInterrupt):
        with _shield_sigint():
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.05)
            reached = True
    assert reached
    assert signal.getsignal(signal.SIGINT) is before


# -- fault injection ----------------------------------------------------------


def test_fault_injection_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _port(height=16, width=16, fault_injection=FaultInjectionConfig(enabled=True))


@pytest.mark.parametrize("kw", [dict(rule="conway"), dict(rule="wireworld", pattern="wireworld-clock"),
                                dict(rule="bugs")], ids=["words", "planes", "dense"])
def test_epoch_indexed_injection_matches_jax_and_clean_run(tmp_path, kw):
    base = dict(height=32, width=32, seed=8, steps_per_call=4, **kw)
    fi = dict(enabled=True, first_after_epochs=8, every_epochs=8, max_crashes=2)
    chaotic = _port(tmp_path, checkpoint_dir=str(tmp_path / "port"), checkpoint_every=4,
                    fault_injection=FaultInjectionConfig(**fi), **base)
    chaotic.advance(24)
    jsim = _jax(checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=4,
                fault_injection=JFault(**fi), flight_dir="",
                kernel="dense" if kw["rule"] == "bugs" else "bitpack", **base)
    jsim.advance(24)
    assert chaotic.crash_log == jsim.crash_log == [8, 16]
    clean = _port(**base)
    clean.advance(24)
    assert chaotic.board_digest() == jsim.board_digest() == clean.board_digest()


def test_wall_clock_crashes_replay_to_the_clean_trajectory(tmp_path):
    mk = dict(height=48, width=64, pattern="gosper-glider-gun", steps_per_call=10,
              checkpoint_every=20)
    clean = _port(tmp_path, checkpoint_dir=str(tmp_path / "clean"), **mk)
    clean.advance(120)
    chaotic = _port(
        tmp_path, checkpoint_dir=str(tmp_path / "chaos"),
        fault_injection=FaultInjectionConfig(enabled=True, first_after_s=0.0, every_s=0.0,
                                             max_crashes=5),
        **mk,
    )
    chaotic.advance(120)
    assert chaotic.injector.crashes == len(chaotic.crash_log) == 5
    assert np.array_equal(chaotic.board_host(), clean.board_host())


def test_mesh_crash_replays_on_the_mesh(tmp_path):
    cfg = SimulationConfig(
        height=64, width=64, seed=4, steps_per_call=4, checkpoint_dir=str(tmp_path),
        checkpoint_every=4, mesh_shape=(2, 2), flight_dir="",
        fault_injection=FaultInjectionConfig(enabled=True, first_after_epochs=10,
                                             every_epochs=100, max_crashes=1),
    )
    sim = Simulation(cfg, observer=BoardObserver(out=io.StringIO()), device=["cpu"] * 4)
    sim.advance(20)
    assert sim.crash_log == [12] and sim.mesh is not None
    clean = _port(height=64, width=64, seed=4, steps_per_call=4)
    clean.advance(20)
    assert sim.board_digest() == clean.board_digest()


def test_cli_inject_faults(tmp_path, capsys):
    conf = tmp_path / "fi.toml"
    conf.write_text("[fault_injection]\nfirst_after_epochs = 20\nevery_epochs = 100\n"
                    "max_crashes = 1\n")
    args = ["run", "--device", "cpu", "--pattern", "gosper-glider-gun", "--height", "64",
            "--width", "64", "--max-epochs", "40", "--steps-per-call", "10",
            "--metrics-every", "20", "--obs-digest", "--flight-dir", str(tmp_path / "fl")]
    assert tcli.main([*args, "--config", str(conf), "--inject-faults",
                      "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "10",
                      "--metrics-file", str(tmp_path / "m.prom"),
                      "--log-events", str(tmp_path / "ev.jsonl")]) == 0
    chaotic = capsys.readouterr().out
    assert tcli.main(args) == 0
    clean = capsys.readouterr().out
    digests = [line.split("digest=")[1] for line in chaotic.splitlines() if "digest=" in line]
    assert digests and digests == [
        line.split("digest=")[1] for line in clean.splitlines() if "digest=" in line
    ]
    events = (tmp_path / "ev.jsonl").read_text()
    assert '"event":"crash_injected"' in events and '"event":"crash_recovered"' in events
    prom = (tmp_path / "m.prom").read_text().splitlines()
    (recovered,) = [line for line in prom if line.startswith("gol_chaos_recovered_total ")]
    assert float(recovered.split()[1]) >= 1
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tcli.main([*args, "--config", str(conf), "--inject-faults"])


def test_tick_paces_the_run():
    sim = _port(height=32, width=32, steps_per_call=1, tick_s=0.02)
    t0 = time.perf_counter()
    sim.advance(6)
    assert time.perf_counter() - t0 >= 0.09
