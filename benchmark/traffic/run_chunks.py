"""Driver of the standalone run: ``Simulation.advance`` in chunks of
``steps_per_call`` generations for the whole window, with the
configuration's observation cadence -- the path ``python -m
akka_game_of_life_tpu_torch run`` drives.

Input: a soup made on the device from ``--seed`` (every bit of the packed
words an independent fair coin: density 0.5), handed to the run in place
of its configured start board.  Set-up builds the run, places the soup and
warms up through the window's own call; the first call's board is kept for
the start check.  The window ends in ``torch.cuda.synchronize()``, so only
finished generations count.

What ``correct`` compares, once the window has closed and the run is
freed (a window steps ~10**5 generations of the board, far past what a
plain reference can redo, so it follows the run from the run's own state):

- the start: the reference steps the soup through the first call's
  generations and must equal the run's board after its first call;
- the last call: the reference steps the run's board from before the
  window's last call and must equal the board the run ended on;
- the observation of the last call (population, the sampled view, the
  probe window and, where the run digests, the digest) must equal what
  the reference reads off its own board.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark.core import window
from benchmark.core.harness import Check, Outcome, Readings, Run
from benchmark.core.trace import Tracer


def soup(height: int, width: int, seed: int, device) -> torch.Tensor:
    """The seed's board as ``[height, width / 32]`` int32 words, made on
    the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-(2 ** 31), 2 ** 31, (height, width // 32), generator=gen,
                         device=device, dtype=torch.int32)


def _observer_class():
    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver

    class Recorder(BoardObserver):
        """The run's own observer, writing to the null device, that keeps
        the last cadence point's readings."""

        last: dict = {}

        def observe_summary(self, epoch, population, board_shape, view=None,
                            strides=(1, 1), obs_seconds=0.0, digest=None):
            super().observe_summary(epoch, population, board_shape, view, strides,
                                    obs_seconds, digest)
            self.last = {"epoch": epoch, "population": population, "view": view,
                         "strides": strides, "digest": digest}

        def observe_window(self, epoch, window, bbox):
            super().observe_window(epoch, window, bbox)
            self.last_window = {"epoch": epoch, "window": np.array(window), "bbox": bbox}

    return Recorder


def _programs_snapshot() -> dict:
    from akka_game_of_life_tpu_torch.obs.programs import get_programs

    return {(p["family"], p["key"]): {"calls": p["calls"], "seconds": p["seconds"]}
            for p in get_programs().snapshot()["programs"]}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(run: Run) -> Outcome:
    from akka_game_of_life_tpu_torch.obs import get_registry
    from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    cell = run.cell
    cfg = SimulationConfig(**{**cell.config["run"], **cell.mix.get("run", {})})
    h, w, k = cfg.height, cfg.width, cfg.steps_per_call
    registry = get_registry()
    with open(os.devnull, "w") as null:
        observer = _observer_class()(
            render_every=cfg.render_every, render_max_cells=cfg.render_max_cells,
            metrics_every=cfg.metrics_every, out=null, registry=registry)
        sim = Simulation(cfg, observer=observer, device=run.device, registry=registry)
        try:
            sim.board = soup(h, w, run.seed, run.device)
            sim.advance(k)
            first = sim.board.cpu()
            for _ in range(cell.mix["warm_calls"] - 1):
                sim.advance(k)
            _sync(run.device)
            before = (registry.snapshot(nonzero_only=False), _programs_snapshot())
            # A traced run traces the window's last trace_seconds, for as
            # long from the profiler's start; the counters are read over
            # the part before, which the profiler does not slow.
            tracer = Tracer() if run.trace else None
            trace_seconds = min(cell.mix["trace_seconds"], run.seconds / 2)
            after, traced_from, calls, traced_since = None, 0, 0, None
            t0 = time.perf_counter()
            t_counted = None
            setup_s = t0 - run.started
            while True:
                prev = sim.board
                sim.advance(k)
                calls += 1
                now = time.perf_counter()
                if tracer and after is None and now - t0 >= run.seconds - trace_seconds:
                    _sync(run.device)
                    t_counted = time.perf_counter()
                    after = (registry.snapshot(nonzero_only=False), _programs_snapshot())
                    traced_since, traced_from = tracer.start(), calls
                if now - t0 >= run.seconds and (traced_since is None or now - traced_since >= trace_seconds):
                    break
            if tracer:
                tracer.stop()
            _sync(run.device)
            t1 = time.perf_counter()
            if after is None:
                t_counted = t1
                after = (registry.snapshot(nonzero_only=False), _programs_snapshot())
            peak = torch.cuda.max_memory_allocated() if torch.device(run.device).type == "cuda" else 0
            last, last_window, epoch = observer.last, getattr(observer, "last_window", None), sim.epoch
            final = sim.board
        finally:
            sim.close()
    del sim
    trace = tracer.summary() if tracer else None
    t = time.perf_counter()
    checks = compare(run, cfg, first, prev, final, epoch, last, last_window)
    reference_s = time.perf_counter() - t
    readings = Readings(
        config=cell.config, mix=cell.mix, window=(t0, t_counted), trace=trace,
        registry=(before[0], after[0]), programs=(before[1], after[1]), spans=run.spans,
        counts={"calls": calls, "traced_calls": calls - traced_from if tracer else 0},
    )
    return Outcome(
        setup_s=setup_s,
        values={"run_cell_updates_per_s": window.rate(h * w * calls * k, t1 - t0)},
        readings=readings, attempted=calls, failed=0, checks=checks,
        memory_peak_bytes=peak, notes={"reference seconds": reference_s},
    )


def control(run: Run) -> list:
    """The comparison with the control in the run's place: the reference
    with the torus broken (cells past the edges dead) steps the soup
    through one call; its board, population, view, probe window and digest
    stand for the run's."""
    import types

    ref = run.cell.reference()
    cfg = types.SimpleNamespace(**{**run.cell.config["run"], **run.cell.mix.get("run", {})})
    dev = torch.device(run.device)
    words = soup(cfg.height, cfg.width, run.seed, dev)
    bad = ref.run(ref.unpack_words(words)[None], cfg.steps_per_call, [cfg.rule], torus=False)[0]
    sy, sx = (-(-cfg.height // cfg.render_max_cells), -(-cfg.width // cfg.render_max_cells))
    y0, y1, x0, x1 = cfg.probe_window
    epoch = cfg.steps_per_call
    last = {"epoch": epoch, "population": int((bad == 1).sum()), "strides": (sy, sx),
            "view": bad[::sy, ::sx].cpu().numpy(), "digest": int(ref.digest(bad[None])[0])}
    last_window = {"epoch": epoch, "window": bad[y0:y1, x0:x1].cpu().numpy()}
    packed = ref.pack_words(bad)
    del bad
    return compare(run, cfg, packed, words, packed, epoch, last, last_window)


def compare(run: Run, cfg, first, prev, final, epoch, last, last_window):
    """The checks: every number has the limit 0 (the runs are exact)."""
    ref = run.cell.reference()
    rules = [cfg.rule]
    k = cfg.steps_per_call
    dev = final.device
    start = ref.unpack_words(soup(cfg.height, cfg.width, run.seed, dev))[None]
    want = ref.run(start, k, rules)[0]
    checks = [Check("start_mismatch_cells", _mismatch(want, ref.unpack_words(first.to(dev))), 0)]
    del start, want
    want = ref.run(ref.unpack_words(prev)[None], k, rules)[0]
    got = ref.unpack_words(final)
    checks.append(Check("final_mismatch_cells", _mismatch(want, got), 0))
    del got, prev, final
    checks.append(Check("observed_epoch_gap", abs(last.get("epoch", -1) - epoch), 0))
    checks.append(Check("population_gap", abs(int(last["population"]) - int((want == 1).sum())), 0))
    sy, sx = last["strides"]
    view = last["view"]
    if view is not None:
        sampled = want[::sy, ::sx].cpu().numpy()
        checks.append(Check("view_mismatch_cells", _np_mismatch(sampled, view), 0))
    if cfg.probe_window is not None:
        y0, y1, x0, x1 = cfg.probe_window
        probe = want[y0:y1, x0:x1].cpu().numpy()
        got_window = None if last_window is None or last_window["epoch"] != epoch else last_window["window"]
        checks.append(Check("probe_mismatch_cells", _np_mismatch(probe, got_window), 0))
    if cfg.obs_digest:
        digest = int(ref.digest(want[None])[0])
        checks.append(Check("digest_mismatch", int(last.get("digest") != digest), 0))
    return checks


def _mismatch(want: torch.Tensor, got: torch.Tensor) -> int:
    if want.shape != got.shape:
        return want.numel()
    return int((want != got).sum())


def _np_mismatch(want: np.ndarray, got) -> int:
    if got is None or np.shape(got) != want.shape:
        return int(want.size)
    return int((want != np.asarray(got)).sum())
