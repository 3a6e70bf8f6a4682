"""Observation and observability of the port's standalone ``run``, against
the JAX package's.

``obs_defer`` (records dispatched on the device, read one chunk later) ≡
synchronous observation ≡ the JAX package's deferred run: history, probe
windows and final board, also across an injected crash and on a mesh.
``--dump-rle`` files are byte-equal to the JAX package's; ``--metrics-file``
and ``--log-events`` carry the JAX run's metric names and event kinds; the
registry, tracer and trace file are wired as in the JAX ``Simulation``.
Mirrors ``tests/test_obs_defer.py``.
"""

import io
import json
import re

import numpy as np
import pytest

from akka_game_of_life_tpu.cli import main as jmain
from akka_game_of_life_tpu.runtime.config import load_config as jload
from akka_game_of_life_tpu.runtime.render import BoardObserver as JObserver
from akka_game_of_life_tpu.runtime.simulation import Simulation as JSimulation
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.obs import FlightRecorder, MetricsRegistry, Tracer
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig, load_config
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation


def _overrides(tmp_path, tag, obs_defer, chaos, **kw):
    out = {
        "height": 64, "width": 64, "pattern": "gosper-glider-gun",
        "steps_per_call": 10, "max_epochs": 120, "metrics_every": 20,
        "render_every": 60, "probe_window": (2, 11, 2, 38), "obs_defer": obs_defer,
        "obs_digest": True, "flight_dir": "", **kw,
    }
    if chaos:
        out.update({
            "checkpoint_dir": str(tmp_path / f"ck-{tag}"), "checkpoint_every": 20,
            "fault_injection": {"enabled": True, "first_after_epochs": 30,
                                "every_epochs": 40, "max_crashes": 2},
        })
    return out


def _observer(cls, out, cfg):
    return cls(out=out, render_every=cfg.render_every, metrics_every=cfg.metrics_every,
               render_max_cells=cfg.render_max_cells)


def _run_port(tmp_path, tag, *, obs_defer, chaos=False, devices="cpu", **kw):
    out = io.StringIO()
    cfg = load_config(overrides=_overrides(tmp_path, tag, obs_defer, chaos, **kw))
    sim = Simulation(cfg, observer=_observer(BoardObserver, out, cfg), device=devices)
    sim.advance()
    sim.close()
    return sim, out.getvalue()


def _run_jax(tmp_path, tag, *, obs_defer, chaos=False, **kw):
    out = io.StringIO()
    cfg = jload(overrides=_overrides(tmp_path, tag, obs_defer, chaos, kernel="bitpack", **kw))
    sim = JSimulation(cfg, observer=_observer(JObserver, out, cfg))
    sim.advance()
    sim.close()
    return sim, out.getvalue()


def _history(sim):
    return [(m.epoch, m.population) for m in sim.observer.history]


def _obs_lines(text):
    """The cadence lines without their timings: epoch, population, digest,
    and the window and frame rows."""
    keep = []
    for line in text.splitlines():
        m = re.match(r"^epoch (\d+): pop=(\d+) .*digest=([0-9a-f]{16})$", line)
        if m:
            keep.append(m.groups())
        elif "window" in line or re.fullmatch(r"[.#ox*+=%?]+", line):
            keep.append(line)
    return keep


@pytest.mark.parametrize("chaos", [False, True], ids=["plain", "chaos"])
def test_defer_matches_sync_and_jax(tmp_path, chaos):
    sim_s, text_s = _run_port(tmp_path, "sync", obs_defer=False, chaos=chaos)
    sim_d, text_d = _run_port(tmp_path, "defer", obs_defer=True, chaos=chaos)
    jsim, jtext = _run_jax(tmp_path, "jax", obs_defer=True, chaos=chaos)
    assert _history(sim_s) == _history(sim_d) == _history(jsim)
    assert len(_history(sim_s)) == 6
    assert _obs_lines(text_s) == _obs_lines(text_d) == _obs_lines(jtext)
    assert any("window" in line for line in _obs_lines(text_d))
    assert sim_d.epoch == sim_s.epoch == 120
    np.testing.assert_array_equal(sim_d.board_host(), jsim.board_host())
    np.testing.assert_array_equal(sim_s.board_host(), sim_d.board_host())
    assert sim_d._pending_obs == []
    if chaos:
        assert sim_d.crash_log == jsim.crash_log == [30, 70]


@pytest.mark.parametrize(
    "kw",
    [dict(kernel="dense"), dict(rule="wireworld", pattern="wireworld-clock",
                                probe_window=(0, 12, 0, 40))],
    ids=["dense", "planes"],
)
def test_defer_other_layouts(tmp_path, kw):
    sim_s, text_s = _run_port(tmp_path, "s", obs_defer=False, **kw)
    sim_d, text_d = _run_port(tmp_path, "d", obs_defer=True, **kw)
    assert _history(sim_s) == _history(sim_d)
    assert _obs_lines(text_s) == _obs_lines(text_d)
    np.testing.assert_array_equal(sim_s.board_host(), sim_d.board_host())


def test_defer_on_a_mesh(tmp_path):
    sim_one, text_one = _run_port(tmp_path, "one", obs_defer=False)
    sim_mesh, text_mesh = _run_port(tmp_path, "mesh", obs_defer=True, mesh_shape=(2, 2),
                                    devices=["cpu"] * 4)
    assert sim_mesh.mesh is not None
    assert _obs_lines(text_one) == _obs_lines(text_mesh)


def test_defer_emits_final_cadence_point(tmp_path):
    sim, text = _run_port(tmp_path, "final", obs_defer=True)
    assert sim.observer.history[-1].epoch == 120
    assert any(line.startswith("epoch 120: window") for line in text.splitlines())


def test_defer_lines_appear_one_chunk_late(tmp_path):
    """A deferred record is read after the next chunk ran: the epoch-20 line
    is written while the board is already at epoch 30."""
    out = io.StringIO()
    cfg = load_config(overrides=_overrides(tmp_path, "late", True, False))
    sim = Simulation(cfg, observer=_observer(BoardObserver, out, cfg), device="cpu")
    seen = []
    real = sim.observer.observe_summary
    sim.observer.observe_summary = lambda epoch, *a, **k: (
        seen.append((epoch, sim.epoch)), real(epoch, *a, **k)
    )
    sim.advance(40)
    assert seen == [(20, 30), (40, 40)]  # the last one at the final flush


def test_defer_broken_window_write_consumes_record(tmp_path):
    out = io.StringIO()
    cfg = load_config(overrides=_overrides(tmp_path, "broken", True, False))
    observer = BoardObserver(out=out, render_every=60, metrics_every=20)
    sim = Simulation(cfg, observer=observer, device="cpu")
    sim._pending_obs.append(sim._obs_dispatch(True))  # epoch 0: a window due

    def broken(*a, **k):
        raise OSError("stream gone")

    observer.observe_window = broken
    with pytest.raises(OSError):
        sim._obs_resolve()
    assert sim._pending_obs == []  # consumed, not requeued
    text = out.getvalue()
    assert text.count("epoch 0:") == 1
    sim._obs_resolve()
    assert out.getvalue() == text
    sim.close()


def test_dump_rle_byte_equal_to_jax(tmp_path, capsys):
    args = ["--pattern", "gosper-glider-gun", "--height", "48", "--width", "64",
            "--max-epochs", "30", "--steps-per-call", "10"]
    assert jmain(["run", "--platform", "cpu", *args, "--dump-rle", str(tmp_path / "j.rle")]) == 0
    assert tcli.main(["run", "--device", "cpu", *args, "--dump-rle",
                      str(tmp_path / "t.rle")]) == 0
    out = capsys.readouterr().out
    assert f"wrote {tmp_path / 't.rle'}" in out
    assert (tmp_path / "t.rle").read_bytes() == (tmp_path / "j.rle").read_bytes()


def test_dump_rle_checked_before_the_run(tmp_path):
    with pytest.raises(SystemExit, match="RLE's alphabet"):
        tcli.main(["run", "--device", "cpu", "--rule", "B2/S345/200", "--dump-rle",
                   str(tmp_path / "x.rle")])
    with pytest.raises(SystemExit, match="cannot write"):
        tcli.main(["run", "--device", "cpu", "--dump-rle", str(tmp_path / "no" / "x.rle")])


def _names(prom: str):
    return {line.split()[2] for line in prom.splitlines() if line.startswith("# TYPE ")}


def test_metrics_file_and_events_match_jax_names(tmp_path, capsys):
    common = ["--pattern", "gosper-glider-gun", "--height", "64", "--width", "64",
              "--max-epochs", "40", "--steps-per-call", "10", "--metrics-every", "20",
              "--checkpoint-every", "20"]
    runs = {}
    for pkg, main, flag in (("jax", jmain, ["--platform", "cpu"]),
                            ("port", tcli.main, ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        assert main(["run", *flag, *common, "--checkpoint-dir", str(d / "ck"),
                     "--metrics-file", str(d / "m.prom"),
                     "--log-events", str(d / "ev.jsonl"), "--trace-file",
                     str(d / "trace.json")]) == 0
        events = [json.loads(line) for line in (d / "ev.jsonl").read_text().splitlines()]
        spans = {e["name"] for e in json.loads((d / "trace.json").read_text())["traceEvents"]
                 if e.get("ph") == "X"}
        runs[pkg] = (_names((d / "m.prom").read_text()), [e["event"] for e in events], spans)
    capsys.readouterr()
    (jnames, jkinds, jspans), (tnames, tkinds, tspans) = runs["jax"], runs["port"]
    for name in ("gol_epochs_advanced_total", "gol_chunks_total", "gol_step_seconds",
                 "gol_obs_seconds", "gol_epoch", "gol_checkpoint_saves_total",
                 "gol_population"):
        assert name in tnames and name in jnames
    assert set(tkinds) == set(jkinds) and tkinds.count("checkpoint_requested") == 2
    assert {"sim.advance", "sim.chunk", "checkpoint.save"} <= tspans & jspans


def test_registry_and_tracer_arguments():
    registry = MetricsRegistry()
    tracer = Tracer(node="t", recorder=FlightRecorder(directory=None))
    sim = Simulation(SimulationConfig(height=32, width=32, steps_per_call=4, metrics_every=8,
                                      obs_digest=True),
                     observer=BoardObserver(out=io.StringIO(), metrics_every=8),
                     device="cpu", registry=registry, tracer=tracer)
    sim.advance(16)
    sim.close()
    text = registry.render()
    assert "gol_epochs_advanced_total 16" in text
    assert "gol_chunks_total 4" in text
    assert "gol_digest_checks_total 2" in text
    names = [s["name"] for s in tracer.finished()]
    assert names.count("sim.chunk") == 4 and "sim.advance" in names
    assert names.count("obs.digest") == 2
