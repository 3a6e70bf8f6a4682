#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from ``csrc/``
(one ``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card, bit for bit, and drives the port's four main
paths through its CLI:

- the headline (``examples/headline-65536.toml``: a 65536² Conway torus
  with a Gosper gun, 240 epochs) through the packed sweep, with digests,
  probe windows and a checkpoint resume checked against a CPU reference;
- WireWorld (``examples/wireworld-16384.toml``: the ``wireworld-clock`` on a
  16384² torus, 100 epochs) through the plane sweep, with digests, probe
  windows, the conserved head count and a layout-3 resume checked against a
  CPU reference;
- Larger-than-Life (``bugs`` on a random 16384² torus, 60 epochs) through
  the LtL step, with digests equal to the plain dense run on the card and a
  resume;
- the cluster (a random 16384² Conway torus, 120 epochs in 10-epoch
  exchanges): the in-process harness with two ``torch`` workers on the card,
  each binary chunk through the packed sweep, then the ``frontend`` and two
  ``backend`` processes with one backend killed after the epoch-30
  checkpoint; both end on the digests of the plain packed ``run`` on the
  card.

Then it times each kernel at its main-path shape, and the worker's chunk
engine step by step at the cluster's slab.  Each phase prints one
JSON line; the ``kernels`` line and the card's name and power limit come
before the last line, which is ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero; without CUDA, or without the
rest of the repository, it exits non-zero before printing any result.  Long
output goes to ``chiprun_out/``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import queue
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEADLINE = ROOT / "examples" / "headline-65536.toml"
WIREWORLD = ROOT / "examples" / "wireworld-16384.toml"
OUT = ROOT / "chiprun_out"
KERNELS = ("packed_sweep", "gen_sweep", "ltl_sweep")
# The cluster worker's chunk engine steps through the packed sweep's source.
KERNEL_SOURCE = {"worker_chunk": "packed_sweep"}

RULES = ["conway", "highlife", "day-and-night", "seeds", "life-without-death"]
SMALL_SHAPES = [(1, 1), (3, 1), (37, 3), (64, 2), (1000, 33)]
FULL_SHAPE = (65536, 2048)
REFERENCE_SIDE = 256  # gliders cross no edge of a 256² board in 240 epochs

# The plane sweep: m = 2 (Brian's Brain, Star Wars, WireWorld), 3 (B2/S/7)
# and 8 (a 200-state rule); full size is Brian's Brain's 1 GiB of planes, and
# the WireWorld run's own 2 x 16384 x 512 words.
GEN_RULES = ["brians-brain", "star-wars", "B2/S/7", "wireworld", "B2/S345/200"]
GEN_FULL_RULE = "brians-brain"
GEN_WIRE_SHAPE = (16384, 512)
WIREWORLD_REFERENCE_SIDE = 32  # the clock never leaves its loop

# The LtL step: radii 1, 2, 5 (bugs) and 10, and a sparse count set.
LTL_SHAPES = [(1, 1), (3, 5), (37, 19), (64, 300), (1000, 333)]
LTL_FULL_SHAPE = (16384, 16384)
LTL_RUN = [
    "--rule", "bugs", "--height", "16384", "--width", "16384", "--seed", "0",
    "--max-epochs", "60", "--steps-per-call", "10", "--metrics-every", "10",
    "--obs-digest", "--checkpoint-every", "30", "--device", "cuda",
]
LTL_RESUME_FROM = 30

# The cluster: the JAX package's own cluster scale (16384², two workers, one
# 8192 x 16384 tile each), 10-epoch exchanges, digests every 30 epochs.
CLUSTER_TOML = """\
height = 16384
width = 16384
rule = "conway"
seed = 0
density = 0.5
max_epochs = 120
exchange_width = 10
metrics_every = 30
checkpoint_every = 30
obs_digest = true
failure_timeout_s = 10
"""
CLUSTER_EPOCHS = [30, 60, 90, 120]
CLUSTER_WORKERS = 2
CLUSTER_TICK = "200ms"  # the node-loss run lasts >= 120 x 0.2 s
CLUSTER_KILL_AFTER = 30  # epoch whose checkpoint must be final before the kill
CLUSTER_DEVICE = "cuda"
WAIT_S = 240  # bound on every wait of the multi-process run
_DIGEST_LINE = re.compile(r"^epoch (\d+): digest=([0-9a-f]{16})$", re.M)

_METRICS = re.compile(r"^epoch (\d+): pop=(\d+) .* digest=([0-9a-f]{16})$", re.M)
_WINDOW = re.compile(
    r"^epoch (\d+): window \[[^\]]*\] pop=\d+\n((?:[.#ox*+=%?]+\n?)+)", re.M
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def ltl_rules():
    """Box LtL rules at R = 1, 2, 5, 10 with thresholds that keep soups
    alive, bugs, and a count set of several runs."""
    from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

    def band(r):
        top = (2 * r + 1) ** 2 - 1
        lo = r * (r + 1)
        return Rule(
            frozenset(n for n in range(lo, lo + 8) if n <= top),
            frozenset(n for n in range(max(0, lo - 2), lo + 11) if n <= top),
            radius=r, kind="ltl", name=f"band-r{r}",
        )

    sparse = Rule(
        frozenset({3, 4, 5, 9}), frozenset({2, 3, 8}), radius=2, kind="ltl",
        name="sparse-r2",
    )
    return [band(1), band(2), resolve_rule("bugs"), band(10), sparse]


def run_cli(argv, log_name: str):
    """The port's CLI in-process; returns (stdout text, wall seconds)."""
    import torch

    from akka_game_of_life_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    (OUT / log_name).write_text(buf.getvalue())
    check(rc == 0, f"run {argv} exited {rc}")
    return buf.getvalue(), seconds


def parse_run(text: str):
    metrics = {int(e): (int(p), d) for e, p, d in _METRICS.findall(text)}
    windows = {int(e): rows.strip() for e, rows in _WINDOW.findall(text)}
    return metrics, windows


def cadence(config):
    return list(range(config.metrics_every, config.max_epochs + 1, config.metrics_every))


def planned_sweeps(config, start: int, end: int) -> int:
    """Sweep launches of epochs (start, end]: each chunk of
    ``steps_per_call`` takes the sweeps ``plan_sweeps`` gives it."""
    from akka_game_of_life_tpu_torch.ops.packed_sweep import plan_sweeps

    spc = config.steps_per_call
    return sum(len(plan_sweeps(min(spc, end - e))) for e in range(start, end, spc))


def reference(config, side: int):
    """Per cadence epoch: (population, digest, window text at render
    cadence) of a pattern run, from the port's plain CPU path on a small
    torus with the global width, which is exact while the pattern touches no
    edge of the small board.  Both patterns are periodic with the metrics
    cadence, so the probe window must be back in phase at every point."""
    from akka_game_of_life_tpu_torch.ops import digest
    from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver, ascii_rows
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    small = SimulationConfig(
        height=side, width=side, rule=config.rule,
        pattern=config.pattern, pattern_offset=config.pattern_offset,
        steps_per_call=config.steps_per_call, kernel="bitpack",
    )
    sim = Simulation(small, observer=BoardObserver(out=io.StringIO()), device="cpu")
    lanes = digest.digest_packed if sim.layout == "words" else digest.digest_planes
    out = {}
    first = None
    for epoch in range(0, config.max_epochs + 1, config.metrics_every):
        sim.advance(epoch - sim.epoch)
        win = sim.board_window(*config.probe_window)
        first = win if first is None else first
        check((win == first).all(), f"reference pattern out of phase at {epoch}")
        out[epoch] = (
            int((sim.board_host() == 1).sum()),
            digest.format_digest(digest.value(lanes(sim.board, config.width))),
            ascii_rows(win) if epoch % config.render_every == 0 else None,
        )
    return out


class Errors:
    """The largest |kernel - plain| seen per kernel, as uint32 words or
    uint8 cells."""

    def __init__(self):
        self.max = {name: 0 for name in KERNELS}
        self.checks = {name: 0 for name in KERNELS}

    def hold(self, name: str, got, plain, what: str) -> None:
        import torch

        torch.cuda.synchronize()
        err = int(((got.long() & 0xFFFFFFFF) - (plain.long() & 0xFFFFFFFF)).abs().max())
        self.max[name] = max(self.max[name], err)
        self.checks[name] += 1
        check(torch.equal(got, plain), f"{name} != plain at {what}")


def build_all(card):
    """Each kernel's library, built from its source by one nvcc each, all
    started together."""
    from akka_game_of_life_tpu_torch.ops import _build

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(_build.load, KERNELS)))
    (OUT / "nvcc.log").write_text(
        "".join(f"== {name} ({b.seconds:.2f} s)\n{b.log}\n" for name, b in built.items())
    )
    import torch

    emit(
        "device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_s={name: b.seconds for name, b in built.items()},
    )


def check_packed_sweep(errors, rng):
    """PR 1's checks: 6 shapes x 5 rules x 4 depths; returns the full-size
    words for the timing phase."""
    import numpy as np

    from akka_game_of_life_tpu_torch.ops import bitpack, packed_sweep

    depths = sorted({1, 7, packed_sweep.DEFAULT_STEPS_PER_SWEEP, packed_sweep.MAX_STEPS_PER_SWEEP})
    for shape in SMALL_SHAPES + [FULL_SHAPE]:
        x = bitpack.words_from_numpy(
            rng.integers(0, 2**32, size=shape, dtype=np.uint32), "cuda"
        )
        for rule in RULES:
            for k in depths:
                errors.hold(
                    "packed_sweep",
                    packed_sweep.packed_sweep(x, rule, k),
                    packed_sweep.packed_sweep_reference(x, rule, k),
                    f"{shape} {rule} k={k}",
                )
    emit(
        "kernel_vs_plain", kernel="packed_sweep",
        replaces="akka_game_of_life_tpu/ops/pallas_stencil.py:236",
        check_launches=errors.checks["packed_sweep"],
        shapes=SMALL_SHAPES + [FULL_SHAPE], rules=RULES, depths=depths,
        max_abs_err=errors.max["packed_sweep"],
    )
    return x


def check_gen_sweep(errors, rng, card):
    """The plane sweep on random planes (invalid encodings included) at
    small ragged shapes for every rule, at the WireWorld run's 2 x 16384 x
    512 words for WireWorld and at 2 x 65536 x 2048 for Brian's Brain, at
    depths 1, 7, the default and the deepest; then the launcher's refusal of
    a depth past the deepest.  Returns the two large plane stacks, by rule
    name, for the timing phase."""
    import ctypes

    import numpy as np
    import torch

    from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen, gen_sweep
    from akka_game_of_life_tpu_torch.ops.packed_sweep import (
        DEFAULT_STEPS_PER_SWEEP,
        MAX_STEPS_PER_SWEEP,
    )
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    def planes(m, shape):
        return bitpack_gen.planes_from_numpy(
            rng.integers(0, 2**32, size=(m, *shape), dtype=np.uint32), "cuda"
        )

    depths = sorted({1, 7, DEFAULT_STEPS_PER_SWEEP, MAX_STEPS_PER_SWEEP})
    for name in GEN_RULES:
        rule = resolve_rule(name)
        m = bitpack_gen.n_planes(rule.states)
        for shape in SMALL_SHAPES:
            x = planes(m, shape)
            for k in depths:
                errors.hold(
                    "gen_sweep", gen_sweep.gen_sweep(x, rule, k),
                    gen_sweep.gen_sweep_reference(x, rule, k),
                    f"{m}x{shape} {name} k={k}",
                )
    large = {"wireworld": planes(2, GEN_WIRE_SHAPE), GEN_FULL_RULE: planes(2, FULL_SHAPE)}
    for name, x in large.items():
        for k in depths:
            errors.hold(
                "gen_sweep", gen_sweep.gen_sweep(x, name, k),
                gen_sweep.gen_sweep_reference(x, name, k),
                f"2x{tuple(x.shape[1:])} {name} k={k}",
            )
            torch.cuda.empty_cache()
    # The launcher itself refuses a depth past the deepest and a plane
    # count that does not match the rule; nothing is launched.
    lib = gen_sweep._library()
    x = planes(2, (8, 2))
    out = torch.empty_like(x)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    refused = [
        lib.gen_sweep_launch(x.data_ptr(), out.data_ptr(), 2, 8, 2,
                             MAX_STEPS_PER_SWEEP + 1, 4, 0, 3, 0, stream),
        lib.gen_sweep_launch(x.data_ptr(), out.data_ptr(), 2, 8, 2, 1, 4, 0, 5, 0, stream),
    ]
    check(all(rc != 0 for rc in refused), f"gen_sweep launcher accepted bad arguments: {refused}")
    emit(
        "kernel_vs_plain", kernel="gen_sweep",
        replaces="akka_game_of_life_tpu/ops/pallas_gen.py:50",
        check_launches=errors.checks["gen_sweep"],
        shapes=SMALL_SHAPES, rules=GEN_RULES,
        large={name: list(x.shape) for name, x in large.items()},
        depths=depths, refused_codes=refused, max_abs_err=errors.max["gen_sweep"],
        card=card["name_power"],
    )
    return large


def check_ltl_sweep(errors, rng, card):
    """The LtL step on random 0/1 boards at small ragged shapes and at
    16384² for every radius and count set; then the launcher's refusal of
    R = 11.  Returns the full-size board for the timing phase."""
    import ctypes

    import numpy as np
    import torch

    from akka_game_of_life_tpu_torch.ops import ltl_sweep

    rules = ltl_rules()
    for shape in LTL_SHAPES + [LTL_FULL_SHAPE]:
        board = torch.from_numpy(
            (rng.random(shape, dtype=np.float32) < 0.4).astype(np.uint8)
        ).to("cuda")
        for rule in rules:
            errors.hold(
                "ltl_sweep", ltl_sweep.ltl_sweep(board, rule),
                ltl_sweep.ltl_sweep_reference(board, rule),
                f"{shape} {rule.name} R={rule.radius}",
            )
            torch.cuda.empty_cache()
    birth, survive = ((ctypes.c_uint * ltl_sweep.RULE_WORDS)() for _ in range(2))
    out = torch.empty_like(board)
    rc = ltl_sweep._library().ltl_sweep_launch(
        board.data_ptr(), out.data_ptr(), *LTL_FULL_SHAPE, 11, birth, survive,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
    )
    check(rc != 0, "ltl_sweep launcher accepted R = 11")
    emit(
        "kernel_vs_plain", kernel="ltl_sweep",
        replaces="akka_game_of_life_tpu/ops/pallas_ltl.py:66",
        check_launches=errors.checks["ltl_sweep"],
        shapes=LTL_SHAPES + [LTL_FULL_SHAPE],
        rules=[r.rulestring() for r in rules], refused_code=rc,
        max_abs_err=errors.max["ltl_sweep"], card=card["name_power"],
    )
    return board


def zero_counts():
    from akka_game_of_life_tpu_torch.ops import gen_sweep, ltl_sweep, packed_sweep

    for fn in (packed_sweep.packed_sweep, gen_sweep.gen_sweep, ltl_sweep.ltl_sweep):
        fn.launches = 0


def read_counts():
    from akka_game_of_life_tpu_torch.ops import gen_sweep, ltl_sweep, packed_sweep

    return {
        "packed_sweep": packed_sweep.packed_sweep.launches,
        "gen_sweep": gen_sweep.gen_sweep.launches,
        "ltl_sweep": ltl_sweep.ltl_sweep.launches,
    }


def pattern_path(path: Path, kernel: str, tmp: Path, card, *,
                 reference_side: int, conserved: bool):
    """Run a pattern config through the CLI with a checkpoint directory,
    check its launches, digests and windows against the CPU reference, then
    resume from the middle checkpoint and check the last digest."""
    from akka_game_of_life_tpu_torch.runtime.config import load_config

    config = load_config(str(path))
    expected = reference(config, reference_side)
    name = path.stem
    sweeps = planned_sweeps(config, 0, config.max_epochs)
    ckpt = tmp / f"{name}-ckpt"
    zero_counts()
    text, run_s = run_cli(
        ["run", "--config", str(path), "--obs-digest",
         "--checkpoint-dir", str(ckpt), "--device", "cuda"],
        f"{name}_run.log",
    )
    counts = read_counts()
    check(counts[kernel] == sweeps, f"{name}: {counts[kernel]} {kernel} launches, expected {sweeps}")
    check(sum(counts.values()) == counts[kernel], f"{name}: other kernels launched: {counts}")
    metrics, windows = parse_run(text)
    epochs = cadence(config)
    check(sorted(metrics) == epochs, f"{name}: metrics epochs {sorted(metrics)}")
    for epoch in epochs:
        pop, dig, win = expected[epoch]
        check(metrics[epoch] == (pop, dig),
              f"{name} epoch {epoch}: run {metrics[epoch]} != reference {(pop, dig)}")
        if win is not None:
            check(windows.get(epoch) == win, f"{name} epoch {epoch}: probe window differs")
    if conserved:
        check(len({metrics[e][0] for e in epochs} | {expected[0][0]}) == 1,
              f"{name}: head count not conserved")
    summary = json.loads(text.split("run summary: ", 1)[1].splitlines()[0])

    resume = tmp / f"{name}-resume"
    resume.mkdir()
    mid = config.checkpoint_every
    shutil.copy(ckpt / f"ckpt_{mid:012d}.npz", resume)
    zero_counts()
    text2, _ = run_cli(
        ["run", "--config", str(path), "--obs-digest",
         "--checkpoint-dir", str(resume), "--device", "cuda"],
        f"{name}_resume.log",
    )
    resumed, _ = parse_run(text2)
    last = config.max_epochs
    check(sorted(resumed) == [e for e in epochs if e > mid],
          f"{name}: resumed metrics epochs {sorted(resumed)}")
    check(resumed[last] == metrics[last],
          f"{name}: resume from {mid}: {resumed[last]} != {metrics[last]}")
    check(read_counts()[kernel] == planned_sweeps(config, mid, last), f"{name}: resume launches")
    cells = config.height * config.width
    emit(
        "main_path", config=str(path.relative_to(ROOT)), kernel=kernel,
        epochs=config.max_epochs, launches=counts, expected_launches=sweeps,
        digests={e: metrics[e][1] for e in epochs},
        populations={e: metrics[e][0] for e in epochs},
        windows_checked=[e for e in epochs if expected[e][2] is not None],
        resumed_from=mid, resumed_digest=resumed[last][1],
        run_s=run_s, run_cell_updates_per_s=cells * config.max_epochs / run_s,
        observer_cell_updates_per_s=summary["cell_updates_per_sec"],
        card=card["name_power"],
    )
    return counts[kernel]


def ltl_path(tmp: Path, card):
    """bugs at 16384² through the LtL step and through the plain dense
    stencil on the card: equal digests at every cadence epoch, 60 launches
    against none, a live board at the end, and a resume from epoch 30."""
    epochs = list(range(10, 61, 10))
    runs = {}
    for kernel in ("auto", "dense"):
        zero_counts()
        text, run_s = run_cli(
            ["run", *LTL_RUN, "--kernel", kernel,
             "--checkpoint-dir", str(tmp / f"ltl-{kernel}")],
            f"ltl_{kernel}_run.log",
        )
        metrics, _ = parse_run(text)
        check(sorted(metrics) == epochs, f"ltl {kernel}: metrics epochs {sorted(metrics)}")
        runs[kernel] = (metrics, read_counts(), run_s)
    (auto, auto_counts, auto_s), (dense, dense_counts, dense_s) = runs["auto"], runs["dense"]
    check(auto == dense, "ltl: the kernel's digests differ from the plain dense run's")
    check(auto_counts == {"packed_sweep": 0, "gen_sweep": 0, "ltl_sweep": 60},
          f"ltl auto launches {auto_counts}")
    check(sum(dense_counts.values()) == 0, f"ltl dense launches {dense_counts}")
    check(auto[60][0] > 0, "ltl: the board died out")

    resume = tmp / "ltl-resume"
    resume.mkdir()
    shutil.copy(tmp / "ltl-auto" / f"ckpt_{LTL_RESUME_FROM:012d}.npz", resume)
    zero_counts()
    text, _ = run_cli(
        ["run", *LTL_RUN, "--kernel", "auto", "--checkpoint-dir", str(resume)],
        "ltl_resume.log",
    )
    resumed, _ = parse_run(text)
    check(resumed.get(60) == auto[60], f"ltl resume from 30: {resumed.get(60)} != {auto[60]}")
    check(read_counts()["ltl_sweep"] == 30, "ltl resume launches")
    cells = LTL_FULL_SHAPE[0] * LTL_FULL_SHAPE[1]
    emit(
        "main_path", config="run " + " ".join(LTL_RUN), kernel="ltl_sweep",
        epochs=60, launches=auto_counts, dense_launches=dense_counts,
        digests={e: auto[e][1] for e in epochs},
        populations={e: auto[e][0] for e in epochs},
        resumed_from=LTL_RESUME_FROM, resumed_digest=resumed[60][1],
        run_s=auto_s, dense_run_s=dense_s,
        run_cell_updates_per_s=cells * 60 / auto_s,
        dense_run_cell_updates_per_s=cells * 60 / dense_s,
        card=card["name_power"],
    )
    return auto_counts["ltl_sweep"]


def cluster_reference(toml: Path):
    """The plain packed ``run`` on the card (``--kernel bitpack``): the
    cluster's digests at every cadence epoch, with no hand kernel launched."""
    from akka_game_of_life_tpu_torch.runtime.config import load_config

    config = load_config(str(toml))
    zero_counts()
    text, run_s = run_cli(
        ["run", "--rule", config.rule, "--height", str(config.height),
         "--width", str(config.width), "--seed", str(config.seed),
         "--density", str(config.density), "--max-epochs", str(config.max_epochs),
         "--steps-per-call", str(config.exchange_width),
         "--metrics-every", str(config.metrics_every), "--obs-digest",
         "--kernel", "bitpack", "--device", CLUSTER_DEVICE],
        "cluster_reference.log",
    )
    check(sum(read_counts().values()) == 0, f"reference launched kernels: {read_counts()}")
    metrics, _ = parse_run(text)
    check(sorted(metrics) == CLUSTER_EPOCHS, f"reference epochs {sorted(metrics)}")
    return {e: metrics[e][1] for e in CLUSTER_EPOCHS}, run_s


def cluster_in_process(toml: Path, want, tmp: Path, card):
    """``ClusterHarness`` with two torch workers on the card, free-running:
    the frontend's merged digests equal the reference's, and the packed
    sweep launched exactly tiles x chunks x sweeps per chunk times."""
    from akka_game_of_life_tpu_torch.ops.packed_sweep import plan_sweeps
    from akka_game_of_life_tpu_torch.runtime.config import load_config
    from akka_game_of_life_tpu_torch.runtime.harness import ClusterHarness
    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver

    config = load_config(str(toml), {"checkpoint_dir": str(tmp / "cluster-inproc")})
    out = io.StringIO()
    observer = BoardObserver(metrics_every=config.metrics_every, out=out)
    chunks = config.max_epochs // config.exchange_width
    expected = CLUSTER_WORKERS * chunks * len(plan_sweeps(config.exchange_width))
    zero_counts()
    h = ClusterHarness(
        config, CLUSTER_WORKERS, observer=observer, engine="torch", device=CLUSTER_DEVICE
    )
    try:
        check(h.frontend.wait_for_backends(timeout=60), "in-process workers did not join")
        t0 = time.perf_counter()
        h.frontend.start_simulation()
        check(h.frontend.done.wait(WAIT_S), "in-process cluster did not finish")
        wall = time.perf_counter() - t0
        check(h.frontend.error is None, f"in-process cluster: {h.frontend.error}")
        digests = {e: f"{v:016x}" for e, v in h.frontend.epoch_digests.items()}
        tiles = len(h.frontend.layout.tile_ids)
    finally:
        h.shutdown()
    counts = read_counts()
    (OUT / "cluster_inproc.log").write_text(out.getvalue())
    check(tiles == CLUSTER_WORKERS, f"{tiles} tiles")
    for e in CLUSTER_EPOCHS:
        check(digests.get(e) == want[e], f"in-process epoch {e}: {digests.get(e)} != {want[e]}")
    check(counts["packed_sweep"] == expected,
          f"in-process: {counts['packed_sweep']} packed_sweep launches, expected {expected}")
    check(sum(counts.values()) == counts["packed_sweep"], f"other kernels launched: {counts}")
    cells = config.height * config.width * config.max_epochs
    emit(
        "main_path", config=f"ClusterHarness(2 torch workers, {CLUSTER_DEVICE}), " + toml.name,
        kernel="packed_sweep", epochs=config.max_epochs, launches=counts,
        expected_launches=expected, digests={e: digests[e] for e in CLUSTER_EPOCHS},
        run_s=wall, run_cell_updates_per_s=cells / wall, card=card["name_power"],
    )
    return counts["packed_sweep"]


def _port_cli(*args) -> list:
    return [sys.executable, "-m", "akka_game_of_life_tpu_torch", *args]


def _reader(proc, log_path: Path, lines: "queue.Queue[str]"):
    """Copy a child's output to its log file, line by line, into a queue."""
    with open(log_path, "w") as log:
        for line in proc.stdout:
            log.write(line)
            log.flush()
            lines.put(line)


def _await_line(lines, pattern, deadline: float, what: str):
    while True:
        left = deadline - time.monotonic()
        check(left > 0, f"timed out waiting for {what}")
        try:
            line = lines.get(timeout=min(left, 1.0))
        except queue.Empty:
            continue
        m = re.search(pattern, line)
        if m:
            return m


def cluster_node_loss(toml: Path, want, tmp: Path, card):
    """The ``frontend`` and two ``backend --device cuda`` processes, paced at
    one epoch per tick: once the epoch-30 checkpoint is final one backend is
    killed (SIGKILL); the frontend must redeploy its tile, exit 0, and print
    the reference's digests, and the checkpoint directory's epoch-120 digest
    must equal them too."""
    from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore

    ckpt = tmp / "cluster-ckpt"
    metrics_file = tmp / "frontend.prom"
    env = {
        **os.environ,
        "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
        # A child still running at the end gets SIGABRT first: its thread
        # stacks land in its log under chiprun_out/.
        "PYTHONFAULTHANDLER": "1",
    }
    procs = []
    try:
        fe = subprocess.Popen(
            _port_cli("frontend", "--config", str(toml), "--port", "0",
                      "--min-backends", str(CLUSTER_WORKERS), "--wait-for-backends", f"{WAIT_S}s",
                      "--tick", CLUSTER_TICK, "--checkpoint-dir", str(ckpt),
                      "--metrics-file", str(metrics_file), "--flight-dir", str(tmp / "flight")),
            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append(fe)
        fe_lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=_reader, args=(fe, OUT / "cluster_frontend.log", fe_lines),
                         daemon=True).start()
        t0 = time.perf_counter()
        port = int(_await_line(fe_lines, r"frontend listening on \S+:(\d+)",
                               time.monotonic() + WAIT_S, "the frontend's port").group(1))
        backends = []
        for i in range(CLUSTER_WORKERS):
            be = subprocess.Popen(
                _port_cli("backend", "--port", str(port), "--name", f"gpu{i}",
                          "--device", CLUSTER_DEVICE, "--flight-dir", str(tmp / "flight")),
                cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            procs.append(be)
            backends.append(be)
            threading.Thread(target=_reader, args=(be, OUT / f"cluster_backend{i}.log", queue.Queue()),
                             daemon=True).start()
        marker = ckpt / f"ckpt_{CLUSTER_KILL_AFTER:012d}.d" / "COMPLETE.json"
        deadline = time.monotonic() + WAIT_S
        while not marker.exists():
            check(time.monotonic() < deadline, "no epoch-30 checkpoint before the kill")
            check(fe.poll() is None, f"frontend exited early ({fe.returncode})")
            time.sleep(0.1)
        victim = backends[0]
        victim.send_signal(signal.SIGKILL)
        killed_at = time.perf_counter() - t0
        rc = fe.wait(timeout=WAIT_S)
        wall = time.perf_counter() - t0
        check(rc == 0, f"frontend exited {rc}")
        for be in backends[1:]:
            check(be.wait(timeout=60) == 0, f"surviving backend exited {be.returncode}")
    finally:
        stuck = [p for p in procs if p.poll() is None]
        for p in stuck:
            p.send_signal(signal.SIGABRT)
        for p in stuck:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=5)
        for p in procs:
            if p.poll() is None:
                p.kill()
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=30)
    text = (OUT / "cluster_frontend.log").read_text()
    digests = {int(e): d for e, d in _DIGEST_LINE.findall(text)}
    for e in CLUSTER_EPOCHS:
        check(digests.get(e) == want[e], f"node-loss epoch {e}: {digests.get(e)} != {want[e]}")
    redeploys = [
        float(line.split()[-1]) for line in metrics_file.read_text().splitlines()
        if line.startswith("gol_redeploys_total")
    ]
    check(redeploys and redeploys[0] >= 1, f"no redeploy recorded: {redeploys}")
    store = CheckpointStore(str(ckpt))
    check(store.latest_epoch() == CLUSTER_EPOCHS[-1], f"latest checkpoint {store.latest_epoch()}")
    stored = store.tile_meta(CLUSTER_EPOCHS[-1]).get("digest")
    check(stored == want[CLUSTER_EPOCHS[-1]], f"checkpoint digest {stored} != {want[CLUSTER_EPOCHS[-1]]}")
    emit(
        "main_path", config=f"frontend --tick {CLUSTER_TICK} + {CLUSTER_WORKERS} x backend "
        f"--device {CLUSTER_DEVICE}, "
        + toml.name, killed="gpu0", killed_at_s=killed_at, redeploys=redeploys[0],
        digests={e: digests[e] for e in CLUSTER_EPOCHS}, checkpoint_digest=stored,
        run_s=wall, card=card["name_power"],
    )


def chunk_timing(card, rng):
    """The worker's chunk engine at the cluster's own slab (an 8192 x 16384
    tile with a 10-wide halo, 10 steps): held against its plain version on
    the card and timed step by step with CUDA events (host pad on the host
    clock).  Returns (max_abs_err, ms per sweep, plain ms, bound, chunk ms)."""
    import numpy as np
    import torch

    from akka_game_of_life_tpu_torch import bench
    from akka_game_of_life_tpu_torch.ops import bitpack, packed_sweep
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
    from akka_game_of_life_tpu_torch.runtime.backend import _np_chunk, _torch_engine
    from akka_game_of_life_tpu_torch.runtime.boundary import Halo

    conway = resolve_rule("conway")
    k = 10
    th, tw = 16384 // CLUSTER_WORKERS, 16384
    tile = (rng.random((th, tw), dtype=np.float32) < 0.5).astype(np.uint8)
    halo = Halo(
        top=np.ascontiguousarray(np.concatenate([tile[-k:, -k:], tile[-k:], tile[-k:, :k]], 1)),
        bottom=np.ascontiguousarray(np.concatenate([tile[:k, -k:], tile[:k], tile[:k, :k]], 1)),
        left=np.ascontiguousarray(tile[:, -k:]), right=np.ascontiguousarray(tile[:, :k]),
    )
    engine = _torch_engine(conway, device="cuda")
    plain_engine = _torch_engine(conway, pallas="off", device="cuda")
    padded = halo.pad(tile)
    got = engine(padded, k, k)
    plain = plain_engine(padded, k, k)
    err = int(np.abs(got.astype(np.int16) - plain.astype(np.int16)).max())
    check(err == 0, "worker chunk != its plain version at the cluster slab")
    # The JAX engine's awkward slabs against the host oracle.
    for h, w, steps, hw in [(40, 40, 4, 4), (120, 56, 8, 8), (250, 70, 2, 5)]:
        small = (rng.random((h + 2 * hw, w + 2 * hw)) < 0.5).astype(np.uint8)
        check(np.array_equal(engine(small, steps, hw), _np_chunk(small, steps, hw, conway)),
              f"worker chunk != _np_chunk at {h}x{w}")
    # One chunk, step by step, as the engine runs it.
    reps = 5
    split = {p: 0.0 for p in ("host_pad", "h2d", "pack", "sweep", "unpack", "slice", "d2h")}
    col_pad = (-padded.shape[1]) % 32
    for rep in range(reps + 1):
        t0 = time.perf_counter()
        padded = halo.pad(tile)
        host_pad = time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        torch.cuda.synchronize()
        ev[0].record()
        x = torch.from_numpy(padded).to("cuda")
        ev[1].record()
        words = bitpack.pack(torch.nn.functional.pad(x, (0, col_pad)))
        ev[2].record()
        words = packed_sweep.packed_multi_step_fn(conway, k)(words)
        ev[3].record()
        out = bitpack.unpack(words)
        ev[4].record()
        out = out[:, :-col_pad][k:-k, k:-k].contiguous()
        ev[5].record()
        stepped = out.cpu().numpy()
        ev[6].record()
        torch.cuda.synchronize()
        if rep == 0:
            continue  # warm-up
        split["host_pad"] += host_pad * 1e3 / reps
        for name, a, b in zip(list(split)[1:], ev[:-1], ev[1:]):
            split[name] += a.elapsed_time(b) / reps
    check(np.array_equal(stepped, got), "step-by-step chunk != engine chunk")
    chunk_ms = 0.0
    for rep in range(reps + 1):
        t0 = time.perf_counter()
        engine(halo.pad(tile), k, k)
        if rep:
            chunk_ms += (time.perf_counter() - t0) * 1e3 / reps
    # The worker's other host work on the same tile: the ring it publishes
    # every chunk, and at cadence epochs the digest lanes, the population and
    # the packed checkpoint payload.
    from akka_game_of_life_tpu_torch.ops.digest import digest_dense_np
    from akka_game_of_life_tpu_torch.runtime.tiles import Ring
    from akka_game_of_life_tpu_torch.runtime.wire import encode_ring, pack_tile

    host = {}
    for name, fn in (
        ("ring", lambda: encode_ring(Ring.of(got, k), True)),
        ("digest", lambda: digest_dense_np(got, (th, 0), tw)),
        ("population", lambda: int((got == 1).sum())),
        ("pack_tile", lambda: pack_tile(got)),
    ):
        t0 = time.perf_counter()
        fn()
        host[name] = (time.perf_counter() - t0) * 1e3
    x = bitpack.pack(torch.nn.functional.pad(torch.from_numpy(padded).to("cuda"), (0, col_pad)))
    h, nw = x.shape
    ms = bench.time_ms(lambda: packed_sweep._launch(x, conway, k), reps=20)
    plain_ms = bench.time_ms(lambda: packed_sweep.packed_sweep_reference(x, conway, k), reps=3, warmup=1)
    bound = bench.sweep_bound(h, nw, k, conway, card["int32_ops_per_s"])
    emit(
        "timing", kernel="worker_chunk", slab=list(padded.shape), words=[h, nw], k=k,
        rule="conway", max_abs_err=err, chunk_ms=chunk_ms, split_ms=split,
        worker_host_ms=host,
        ms_per_sweep=ms, plain_ms=plain_ms, **bound, share_of_bound=bound["bound_ms"] / ms,
        sweep_share_of_chunk=ms / chunk_ms, library_ms=None,
        library_note="no single PyTorch call computes this packed step",
        card=card["name_power"],
    )
    return err, ms, plain_ms, bound, chunk_ms


def timings(card, words, gen_planes, ltl_board):
    """Each kernel at its main-path shape (and the plane sweep also at
    Brian's Brain's 65536²), on the inputs it was checked on, with its bound
    and its plain version's time."""
    from akka_game_of_life_tpu_torch import bench
    from akka_game_of_life_tpu_torch.ops import gen_sweep, ltl_sweep, packed_sweep
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    rate = card["int32_ops_per_s"]
    k = packed_sweep.DEFAULT_STEPS_PER_SWEEP
    out = {}

    conway = resolve_rule("conway")
    h, nw = FULL_SHAPE
    ms = bench.time_ms(lambda: packed_sweep._launch(words, conway, k), reps=20)
    plain = bench.time_ms(lambda: packed_sweep.packed_sweep_reference(words, conway, k), reps=3, warmup=1)
    bound = bench.sweep_bound(h, nw, k, conway, rate)
    out["packed_sweep"] = (ms, plain, bound)
    emit("timing", kernel="packed_sweep", shape=FULL_SHAPE, k=k, rule="conway",
         ms_per_sweep=ms, cell_updates_per_s=h * nw * 32 * k / (ms / 1e3),
         plain_ms=plain, **bound, share_of_bound=bound["bound_ms"] / ms,
         library_ms=None, library_note="no single PyTorch call computes this packed step",
         card=card["name_power"])

    for name, x in gen_planes.items():
        rule = resolve_rule(name)
        m, h, nw = x.shape
        ms = bench.time_ms(lambda: gen_sweep._launch(x, rule, k), reps=20)
        plain = bench.time_ms(lambda: gen_sweep.gen_sweep_reference(x, rule, k), reps=3, warmup=1)
        bound = bench.gen_sweep_bound(m, h, nw, k, rule, rate)
        if name == "wireworld":
            out["gen_sweep"] = (ms, plain, bound)
        emit("timing", kernel="gen_sweep", shape=list(x.shape), k=k, rule=name,
             ops_per_word_step=gen_sweep.ops_per_word_step(rule),
             ms_per_sweep=ms, cell_updates_per_s=h * nw * 32 * k / (ms / 1e3),
             plain_ms=plain, **bound, share_of_bound=bound["bound_ms"] / ms,
             library_ms=None, library_note="no single PyTorch call computes this plane step",
             card=card["name_power"])

    bugs = resolve_rule("bugs")
    h, w = ltl_board.shape
    board = ltl_board
    ms = bench.time_ms(lambda: ltl_sweep._launch(board, bugs), reps=20)
    plain = bench.time_ms(lambda: ltl_sweep.ltl_sweep_reference(board, bugs), reps=3, warmup=1)
    bound = bench.ltl_bound(h, w, bugs, rate)
    out["ltl_sweep"] = (ms, plain, bound)
    emit("timing", kernel="ltl_sweep", shape=[h, w], rule="bugs",
         ops_per_cell=ltl_sweep.ops_per_cell(bugs),
         ms_per_generation=ms, cell_updates_per_s=h * w / (ms / 1e3),
         plain_ms=plain, **bound, share_of_bound=bound["bound_ms"] / ms,
         library_ms=None,
         library_note="no single PyTorch call computes this step (a box filter "
         "convolution gives the counts but not the rule)",
         card=card["name_power"])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "akka_game_of_life_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from akka_game_of_life_tpu_torch import bench

    OUT.mkdir(exist_ok=True)
    card = bench.card()
    t_start = time.perf_counter()

    # -- 1. device and build ---------------------------------------------------
    build_all(card)

    # -- 2. each kernel against its plain version on the card ------------------
    rng = np.random.default_rng(0)
    errors = Errors()
    words = check_packed_sweep(errors, rng)
    gen_planes = check_gen_sweep(errors, rng, card)
    ltl_board = check_ltl_sweep(errors, rng, card)
    torch.cuda.empty_cache()

    # -- 3. the main paths at full size -----------------------------------------
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        launches["packed_sweep"] = pattern_path(
            HEADLINE, "packed_sweep", tmp, card,
            reference_side=REFERENCE_SIDE, conserved=False,
        )
        launches["gen_sweep"] = pattern_path(
            WIREWORLD, "gen_sweep", tmp, card,
            reference_side=WIREWORLD_REFERENCE_SIDE, conserved=True,
        )
        launches["ltl_sweep"] = ltl_path(tmp, card)
        torch.cuda.empty_cache()
        toml = tmp / "cluster-16384.toml"
        toml.write_text(CLUSTER_TOML)
        want, ref_s = cluster_reference(toml)
        emit("cluster_reference", digests=want, run_s=ref_s, card=card["name_power"])
        torch.cuda.empty_cache()
        launches["worker_chunk"] = cluster_in_process(toml, want, tmp, card)
        torch.cuda.empty_cache()
        cluster_node_loss(toml, want, tmp, card)
    torch.cuda.empty_cache()

    # -- 4. times on the card at the main paths' shapes ------------------------
    times = timings(card, words, gen_planes, ltl_board)
    del words, gen_planes, ltl_board
    torch.cuda.empty_cache()
    err, ms, plain_ms, bound, chunk_ms = chunk_timing(card, rng)
    errors.max["worker_chunk"] = err
    times["worker_chunk"] = (ms, plain_ms, bound)
    emit("done", seconds=time.perf_counter() - t_start, card=card["name_power"])

    sources = {
        "packed_sweep": "akka_game_of_life_tpu/ops/pallas_stencil.py:236",
        "gen_sweep": "akka_game_of_life_tpu/ops/pallas_gen.py:50",
        "ltl_sweep": "akka_game_of_life_tpu/ops/pallas_ltl.py:66",
        "worker_chunk": "akka_game_of_life_tpu/runtime/backend.py:128",
    }
    entries = [
        {
            "name": name,
            "route": "cuda",
            "source": f"akka_game_of_life_tpu_torch/csrc/{KERNEL_SOURCE.get(name, name)}.cu",
            "replaces": sources[name],
            "launches": launches[name],
            "max_abs_err": errors.max[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": times[name][2]["bound_ms"],
            "bound_by": times[name][2]["bound_by"],
            "library_ms": None,
        }
        for name in (*KERNELS, "worker_chunk")
    ]
    entries[-1]["chunk_ms"] = chunk_ms
    print(json.dumps({"kernels": entries}), flush=True)
    print(card["name_power"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
