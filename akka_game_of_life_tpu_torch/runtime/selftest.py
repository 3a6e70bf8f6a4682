"""Product self-test: the checks to run on a new machine before a long job.

Counterpart of ``akka_game_of_life_tpu/runtime/selftest.py``.
``python -m akka_game_of_life_tpu_torch selftest`` drives the public
``Simulation`` (the code path of ``run``) on the card, or on the CPU where
the caller asks for it, prints one JSON line per check and exits non-zero on
any failure.  Each line names the kernel the run resolved to (``sweep``,
``gen_sweep`` and ``ltl_sweep`` are the CUDA kernels on a card; ``bitpack``
and ``dense`` the plain steppers).  ``kernel="matmul"`` is not ported: every
check then fails by name.

Checks:
  gun-phase        Gosper gun period-30 phase on the selected kernel
  oracle           selected kernel ≡ the plain dense stepper on a random board
  checkpoint       save → close → resume → replay ≡ uninterrupted run
  chaos            injected crash mid-run leaves the trajectory bit-identical
  sharded          (two or more devices) meshed stepping ≡ dense oracle
  families         wireworld clock phase + LtL-R1 ≡ classic (cross-unit)
  obs-defer        deferred observation ≡ synchronous on this hardware
"""

from __future__ import annotations

import io
import json
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch


def _sim(device, tmp=None, observer_out=None, **kw):
    from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    # The JAX package's board: 1024 rows shard evenly over 1-8 devices.
    base = dict(height=1024, width=512, rule="conway", seed=9, steps_per_call=6)
    if tmp is not None:
        base.update(checkpoint_dir=str(tmp), checkpoint_every=12)
    base.update(kw)
    return Simulation(
        SimulationConfig(**base),
        observer=BoardObserver(out=observer_out or io.StringIO()),
        device=device,
    )


def _dense(board: np.ndarray, steps: int, device, rule="conway") -> np.ndarray:
    """The oracle: the plain dense stepper of ``models/registry.py``."""
    from akka_game_of_life_tpu_torch.models.registry import get_model
    from akka_game_of_life_tpu_torch.runtime.simulation import resolve_devices

    x = torch.from_numpy(np.ascontiguousarray(board)).to(resolve_devices(device)[0])
    return get_model(rule).run(steps)(x).cpu().numpy()


def _check_gun_phase(kernel: str, device) -> str:
    sim = _sim(
        device,
        pattern="gosper-glider-gun",
        pattern_offset=(4, 4),
        kernel=kernel,
        steps_per_call=15,
    )
    g0 = sim.board_window(4, 13, 4, 40)
    pop0 = int(sim.board_host().sum())
    sim.advance(15)  # mid-period: the window must differ (frozen-stepper guard)
    assert not np.array_equal(sim.board_window(4, 13, 4, 40), g0), (
        "board did not evolve (stepper frozen?)"
    )
    sim.advance(45)  # epoch 60 = two periods
    assert np.array_equal(sim.board_window(4, 13, 4, 40), g0), (
        "gun out of phase after two periods"
    )
    assert int(sim.board_host().sum()) == pop0 + 10, (
        "gun did not emit two gliders over two periods"
    )
    sim.close()
    return sim.kernel


def _check_oracle(kernel: str, device) -> str:
    sim = _sim(device, kernel=kernel)
    start = sim.board_host()
    sim.advance(36)
    want = _dense(start, 36, device)
    assert np.array_equal(sim.board_host(), want), "kernel diverged from dense oracle"
    sim.close()
    return sim.kernel


def _check_checkpoint(kernel: str, device) -> str:
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(device, tmp=tmp, kernel=kernel)
        start = sim.board_host()
        sim.advance(24)
        sim.close()  # durable
        resumed = _sim(device, tmp=tmp, kernel=kernel)
        assert resumed.epoch == 24, f"resume found epoch {resumed.epoch}, want 24"
        resumed.advance(12)
        assert np.array_equal(resumed.board_host(), _dense(start, 36, device)), (
            "post-resume trajectory diverged"
        )
        resumed.close()
        return resumed.kernel


def _check_chaos(kernel: str, device) -> str:
    from akka_game_of_life_tpu_torch.runtime.config import FaultInjectionConfig

    with tempfile.TemporaryDirectory() as tmp:
        chaotic = _sim(
            device,
            tmp=tmp,
            kernel=kernel,
            flight_dir=tmp,  # the crash's flight dump stays with the check
            fault_injection=FaultInjectionConfig(
                enabled=True, first_after_epochs=12, every_epochs=24, max_crashes=1
            ),
        )
        start = chaotic.board_host()
        chaotic.advance(36)
        assert chaotic.crash_log, "injector never fired"
        assert np.array_equal(chaotic.board_host(), _dense(start, 36, device)), (
            "crash+replay diverged from uninterrupted trajectory"
        )
        chaotic.close()
        return chaotic.kernel


def _check_sharded(kernel: str, device) -> str:
    from akka_game_of_life_tpu_torch.runtime.simulation import resolve_devices

    devices = resolve_devices(device)
    if len(devices) < 2:
        raise _Skip(f"single device ({devices[0]})")
    sim = _sim(device, kernel=kernel)  # auto mesh over all devices
    if sim.mesh is None:
        raise _Skip("kernel resolved to an unmeshed path")
    start = sim.board_host()
    sim.advance(36)
    assert np.array_equal(sim.board_host(), _dense(start, 36, device)), (
        "meshed trajectory diverged from dense oracle"
    )
    sim.close()
    return sim.kernel


def _check_families(kernel: str, device) -> str:
    """The wireworld clock holds its period-10 phase on the kernel this
    machine resolves (the plane sweep on a card), and a radius-1 LtL Conway
    is bit-identical to the classic stepper."""
    from akka_game_of_life_tpu_torch.ops.rules import Rule
    from akka_game_of_life_tpu_torch.utils.patterns import pattern_board

    ww = _sim(device, rule="wireworld", pattern="wireworld-clock",
              pattern_offset=(8, 8), height=64, width=64, steps_per_call=5)
    ww_kernel = ww.kernel
    start = ww.board_window(8, 12, 8, 13)
    assert start.sum() > 0
    ww.advance(10)
    assert np.array_equal(ww.board_window(8, 12, 8, 13), start), (
        "wireworld clock lost phase"
    )
    ww.close()

    board = pattern_board("acorn", (128, 128), (60, 60))
    classic = _dense(board, 32, device)
    as_ltl = Rule(frozenset({3}), frozenset({2, 3}), kind="ltl")
    via_ltl = _dense(board, 32, device, rule=as_ltl)
    assert np.array_equal(via_ltl, classic), "ltl path diverged from classic"
    return f"wireworld={ww_kernel}, ltl=dense"


def _check_obs_defer(kernel: str, device) -> str:
    """Deferred observation ≡ synchronous: the same cadence epochs,
    populations, probe-window cells and final board."""
    outs = {}
    for defer in (False, True):
        out = io.StringIO()
        sim = _sim(
            device,
            observer_out=out,
            pattern="gosper-glider-gun",
            pattern_offset=(4, 4),
            kernel=kernel,
            metrics_every=12,
            render_every=30,
            probe_window=(4, 13, 4, 40),
            obs_defer=defer,
        )
        sim.advance(60)
        sim.close()
        history = [(m.epoch, m.population) for m in sim.observer.history]
        windows = [line for line in out.getvalue().splitlines() if "window" in line]
        outs[defer] = (history, windows, sim.board_host(), sim.kernel)
    assert outs[False][0] == outs[True][0], "metrics history diverged"
    assert outs[False][0], "no cadence points observed"
    assert outs[False][1], "no probe windows observed"
    assert outs[False][1] == outs[True][1], "probe windows diverged"
    assert np.array_equal(outs[False][2], outs[True][2]), "final board diverged"
    return outs[True][3]


class _Skip(Exception):
    pass


CHECKS: List[tuple] = [
    ("gun-phase", _check_gun_phase),
    ("oracle", _check_oracle),
    ("checkpoint", _check_checkpoint),
    ("chaos", _check_chaos),
    ("sharded", _check_sharded),
    ("families", _check_families),
    ("obs-defer", _check_obs_defer),
]


def run_selftest(
    kernel: str = "auto",
    out: Optional[Callable[[str], None]] = None,
    device=None,
) -> int:
    """Run every check on ``device`` (default: every visible card; raises
    without CUDA); print one JSON line each; return the failure count."""
    from akka_game_of_life_tpu_torch.runtime.simulation import resolve_devices

    backend = resolve_devices(device)[0].type
    emit = out or (lambda s: print(s, flush=True))
    failures = 0
    for name, check in CHECKS:
        t0 = time.perf_counter()
        line = {"check": name, "kernel": kernel, "backend": backend}
        try:
            # The kernel the Simulation resolved to: what a green selftest
            # establishes on new hardware.
            line["resolved"] = check(kernel, device)
            line["status"] = "pass"
        except _Skip as s:
            line["status"] = "skip"
            line["reason"] = str(s)
        except Exception as e:  # noqa: BLE001 — a selftest reports, never raises
            line["status"] = "fail"
            line["error"] = f"{type(e).__name__}: {e}"
            failures += 1
        line["seconds"] = round(time.perf_counter() - t0, 3)
        emit(json.dumps(line))
    return failures
