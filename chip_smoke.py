#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the CUDA kernels from ``csrc/``
(one ``nvcc`` per source, all at once), reads the plane sweep's code with
``cuobjdump`` (no spill at the main path's depths, no fewer LOP3/SHF per
word than its bound counts), holds each kernel against its plain PyTorch
version on the card, bit for bit, and drives the port's four main paths
through its CLI:

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
- the mesh: the board sharded over four mesh slots (four cards where the
  machine has them, else four slots on one card) through ``Simulation(cfg,
  device=[...])``: the headline on (4, 1) and (2, 2) and WireWorld on (2, 2)
  through the sharded sweeps, ``bugs`` on (2, 2) through the sharded dense
  step, each reaching the single-device runs' digests at every cadence
  epoch, with resumes from a meshed checkpoint on one device and from a
  single-device checkpoint on the mesh; the sharded sweeps are held
  bit-exact against the plain sharded steppers on the card;
- the cluster (a random 16384² Conway torus, 120 epochs in 10-epoch
  exchanges): the in-process harness with two ``torch`` workers on the card,
  each binary chunk through the packed sweep, then the ``frontend`` and two
  ``backend`` processes with one backend killed after the epoch-30
  checkpoint; both end on the digests of the plain packed ``run`` on the
  card;
- several processes: this script started twice more (``--dist-rank R
  --dist-spec FILE``), two ranks of a ``torch.distributed`` group with two
  slots of card 0 each, so their strips are staged through host memory
  over gloo: the headline on (4, 1) (the single-card digests and windows,
  48 packed-sweep launches a rank, rank 0's npz saves resumed by one
  process, a lockstep crash at 180 replayed from the epoch-120 file),
  WireWorld on (2, 2) through the plane sweep, the headline with the orbax
  store (each rank saving its own tiles, resumed by one process, which
  saves and resumes a step of its own), and the staged exchange's times;
  then the 16384² cluster with each worker's chunks spread over
  ``["cuda:0"] * 2`` (the meshed worker), against the plain packed run.

- ``tune`` (the tile autotuner) through the CLI: Conway at 65536² on the
  JAX package's default grid, WireWorld and ``bugs`` at 16384², every point
  a tile variant of the packed, plane or LtL kernel, every variant held
  bit-exact against its plain version; the headline then runs with the
  tuned tile and reaches the default tile's digests;
- ``selftest --kernel auto``, ``--kernel pallas`` and ``--kernel matmul`` on
  the card;
- the serving plane: the ``serve`` role on ``cuda:0`` at the JAX package's
  defaults, 1024 sessions (128 at 256², 384 at 128², 384 at 64², 128 at
  32², some smaller than their class or not square; five rules and eight
  replicators) created and stepped 64 epochs through ``/boards`` by
  concurrent clients, every digest against the batched step on the CPU;
  64 boards of 32² at the 1024-step bound and the replicators past it
  (the fast-forward) against ``step_np``; the batched call per class timed
  on the card; the memo router on 64 tenants of one gun board against the
  memo-off router; ``serve --serve-canary on`` with no failed probe; then
  SIGTERM drains each process (exit 130);
- the serving cluster: ``serve --serve-cluster on`` at the same defaults
  (64 shards, resident tiled sessions, replication) with three ``backend
  --device cuda`` processes on card 0: the same 1024 sessions stepped 64
  epochs (every digest equal to the single-process plane's), a 4096²
  mega-board in 256 resident chunks stepped 64 epochs in barrier rounds of
  8 (its digest against the packed sweep's, its bytes per round no more
  than the chunks' halo strips), a worker SIGKILLed in round 2 (no 404,
  every op answered, promoted boards and the mega-board certified at their
  resume epochs) and another SIGTERM-drained in round 3 (exit 0, no
  admitted job lost, resident chunks re-homed digest-certified; the
  drain's seconds and moves read from the frontend's event log);
- the frontend federation: three ``serve --serve-cluster on
  --frontend-seeds`` processes at the same defaults, one ``backend --device
  cuda`` each on card 0: they converge with no unowned slice, the 1024
  sessions are created round-robin (each id in its frontend's slices: no
  op forwarded) and stepped 64 epochs (every digest equal to the
  single-process plane's), 64 of them step once through a frontend that
  does not own them (forwarded, counted exactly, digests held), a foreign
  GET answers 307 to the owner's HTTP port, and a frontend SIGKILLed
  mid-round costs no session (only 200s and retryable 429s, the standby
  adopts its slices, its worker re-homes there, every board certified at
  epoch 128, none lost after the re-home grace);
- the host engines: ``run --backend actor-native`` at 256² against the
  packed run's digests, and in-process clusters of ``swar`` workers at
  4096² and ``actor-native`` workers at 512² against the torch engine's;
- the banded-matmul stencil: one generation on each lane (f32, int8, bf16)
  of Conway and ``bugs`` at 16384² and a radius-10 box rule at 12288², bit
  for bit against the plain dense step (the f32 lane once more with TF32
  switched on globally), timed beside the packed sweep or the LtL step;
  ``run --kernel matmul`` reaching the ``bugs`` run's digests and a Conway
  run's under ``--kernel pallas`` (with a resume), launching no CUDA
  kernel, and refused by the guard at 65536²;
- the fast-forward: replicator at 12288² jumped to T = 2³⁰ + 2¹⁴ − 1 (every
  factor non-trivial), equal to the jump to T − 60 plus 60 epochs of the
  packed sweep, and Fredkin's matmul jump on each lane against the roll
  jump;
- activity-gated stepping: a glider on a dead 16384² torus, gated and
  ungated, with equal digests, skipped blocks and a gated checkpoint
  resumed ungated;
- the program ledger, run last: the headline (120 epochs), WireWorld at 16384² (20)
  and ``bugs`` at 16384² (10), each run twice in process behind a
  ``MetricsServer`` with ``/programs`` and ``/cost``: the second run's key,
  calls, launches and cells as planned, each call's seconds at least 0.9×
  the event time of its launches back to back, its rate no more than 1.05×
  the rate at the kernel's bound, and its seconds within the run's wall;
- the headline with the rest of ``run``: an injected crash replayed from
  the epoch-120 checkpoint (with ``--metrics-file`` and ``--log-events``),
  ``--obs-defer``, ``--checkpoint-sync`` against the default writer thread,
  SIGINT after the first checkpoint (exit 130, an interrupt checkpoint, a
  resume, ``checkpoints --validate``), and ``--trace-dir`` (the device-busy
  share and the top device operations, read from the trace).

The single-device runs name ``cuda:0``, so they stay on one card on a
machine with several.  Then it times each kernel at its main-path shape
(beside the previous design's time), the mesh's halo exchange and per-tile
sweeps, and the worker's chunk engine step by step at the cluster's slab.  Each phase prints one
JSON line; the ``kernels`` line and the card's name and power limit come
before the last line, which is ``{"ok": true, "device": {...}}``.  Any failed
check raises, so the script exits non-zero; without CUDA, or without the
rest of the repository, it exits non-zero before printing any result.  Long
output goes to ``chiprun_out/``; a failed serve phase first prints the
last lines of each of its processes' logs.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import io
import json
import multiprocessing
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
# The cluster worker's chunk engine and the sharded sweeps step through the
# packed and plane sweeps' sources.
KERNEL_SOURCE = {
    "worker_chunk": "packed_sweep",
    "sharded_sweep": "packed_sweep",
    "sharded_gen_sweep": "gen_sweep",
}
WIRINGS = ("worker_chunk", "sharded_sweep", "sharded_gen_sweep")
SINGLE = "cuda:0"  # the single-device runs' device
SELFTEST_DEVICE = "cuda"  # every visible card: ``sharded`` needs two

RULES = ["conway", "highlife", "day-and-night", "seeds", "life-without-death"]
SMALL_SHAPES = [(1, 1), (3, 1), (37, 3), (64, 2), (1000, 33)]
# The packed sweep's ragged shapes: H < 2k at the deepest sweeps, the
# worker's 8212 x 513-word slab, and word counts a warp's span (62 words
# at k <= 12, 30 deeper) plus or minus one.
PACKED_RAGGED = [(5, 61), (9, 62), (13, 63), (40, 29), (33, 30), (17, 31), (8212, 513)]
FULL_SHAPE = (65536, 2048)
# The previous designs' times on an H100 80GB HBM3 at 700 W (PERF.md rows
# 2, 4 and 5), printed beside this run's: the packed sweep and LtL step
# before their redesign (as ``pr5_ms``), the plane sweep before its own (as
# ``previous_ms``: WireWorld's 2 x 16384 x 512 words and Brian's Brain's
# 2 x 65536 x 2048, both at k = 10).
PREVIOUS_MS = {"packed_sweep": 8.9694, "ltl_sweep": 1.2457,
               "gen_sweep": {"wireworld": 0.4787, "brians-brain": 8.0578}}
REFERENCE_SIDE = 256  # gliders cross no edge of a 256² board in 240 epochs

# The plane sweep: m = 2 (Brian's Brain, Star Wars, WireWorld), 3 (B2/S/7)
# and 8 (a 200-state rule); full size is Brian's Brain's 1 GiB of planes, and
# the WireWorld run's own 2 x 16384 x 512 words.
GEN_RULES = ["brians-brain", "star-wars", "B2/S/7", "wireworld", "B2/S345/200"]
GEN_FULL_RULE = "brians-brain"
GEN_WIRE_SHAPE = (16384, 512)
# The plane sweep's ragged shapes, at every m of GEN_RULES: H < 2k at the
# deepest sweeps and word counts of one and two warps' spans (30 words a
# warp) plus or minus one.
GEN_RAGGED = [(5, 29), (9, 30), (13, 31), (40, 59), (33, 60), (17, 61), (61, 4)]
WIREWORLD_REFERENCE_SIDE = 32  # the clock never leaves its loop

# The LtL step: radii 1, 2, 5 (bugs) and 10, and a sparse count set.
LTL_SHAPES = [(1, 1), (3, 5), (37, 19), (64, 300), (1000, 333)]
# Ragged: W < 2R+1 and W a lane's 16-cell run x 256 plus or minus one, at
# every radius 1..10.
LTL_RAGGED = [(41, 7), (70, 4095), (37, 4096), (29, 4097)]
LTL_FULL_SHAPE = (16384, 16384)
LTL_RUN = [
    "--rule", "bugs", "--height", "16384", "--width", "16384", "--seed", "0",
    "--max-epochs", "60", "--steps-per-call", "10", "--metrics-every", "10",
    "--obs-digest", "--checkpoint-every", "30", "--device", SINGLE,
]
LTL_RESUME_FROM = 30
# The banded-matmul stencil: every lane at Conway and bugs at 16384² and a
# radius-10 box LtL at the 3-smooth 12288² (where bf16 rounding would show).
MATMUL_LANES = ("f32", "int8", "bf16")
MATMUL_CASES = [("conway", 16384), ("bugs", 16384), ("band-r10", 12288)]
MATMUL_CONWAY_RUN = [
    "--height", "16384", "--width", "16384", "--seed", "3", "--max-epochs", "60",
    "--steps-per-call", "10", "--metrics-every", "10", "--obs-digest", "--device", SINGLE,
]
MATMUL_RESUME_FROM = 40  # one dense save (at 40), not two
# The fast-forward at the 3-smooth 12288², where no factor of T cancels:
# T = 2^30 + 2^14 - 1 has 15 factors of 8 rolls each (on 16384² the same T
# jumps to the zero map).
FF_SIDE = 12288
FF_T = 2**30 + 2**14 - 1
FF_ITERATE = 60
FF_MATMUL_T = (2**10, 2**20 + 3)
# Activity-gated stepping: one glider on a dead 16384² torus (the JAX
# bench's sparse-dilute traffic), 64 epochs, 8 a call, 128-cell blocks.
SPARSE_RUN = [
    "--pattern", "glider", "--height", "16384", "--width", "16384", "--max-epochs", "64",
    "--steps-per-call", "8", "--metrics-every", "8", "--obs-digest", "--sparse-block", "128",
    "--device", SINGLE,
]
SPARSE_CHECKPOINT = 48

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

# The mesh: four slots, the headline on (4, 1) and (2, 2), WireWorld and
# bugs on (2, 2); the sharded sweeps against the plain sharded steppers on
# these meshes, at 10, 31 and 60 generations per call.
# The tune phase: JAX's default grid for Conway at the headline's width;
# WireWorld and bugs at 16384² (every point of each grid is feasible under
# the port's rules, so none is dropped; LtL runs k = 1).
TUNE_RUNS = {
    "conway": dict(size=65536, spc=64, blocks=(64, 128, 192, 256), sweeps=(4, 8, 16)),
    "wireworld": dict(size=16384, spc=60, blocks=(32, 64, 192, 256), sweeps=(5, 10, 20)),
    "bugs": dict(size=16384, spc=10, blocks=(32, 64, 128), sweeps=(4, 8, 16)),
}
TUNE_TIMED_CALLS = 2
# The injected crash: due at the first chunk start past epoch 150 (epoch
# 180), after the epoch-120 checkpoint; replayed from it.
CHAOS_TOML = """
[fault_injection]
first_after_epochs = 150
every_epochs = 1000
max_crashes = 1
"""
INTERRUPT_TICK = "4s"  # paces the SIGINT run: one 60-epoch chunk per 4 s

MESH_SLOTS = 4
MESH_PARITY_SHAPES = [(1, 1), (4, 1), (2, 2), (1, 4)]
MESH_PARITY_STEPS = [10, 31, 60]
# The main path's own tiles, random: (layout, mesh, board words, steps per call).
MESH_MAIN_CASES = [
    ("words", (4, 1), FULL_SHAPE, 60),
    ("words", (2, 2), FULL_SHAPE, 60),
    ("planes", (2, 2), GEN_WIRE_SHAPE, 10),
]
# Two processes, one mesh: each rank drives two slots of card 0 (so their
# strips are staged through host memory over gloo), four slots in all.
DIST_RANKS = 2
DIST_SLOTS = 2
DIST_CRASH = {"enabled": True, "first_after_epochs": 150, "every_epochs": 1000,
              "max_crashes": 1}
DIST_WAIT_S = 420  # bound on the pair of processes of the distributed phases
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


def ltl_band(r):
    """A box LtL rule at radius r with thresholds that keep soups alive."""
    from akka_game_of_life_tpu_torch.ops.rules import Rule

    top = (2 * r + 1) ** 2 - 1
    lo = r * (r + 1)
    return Rule(
        frozenset(n for n in range(lo, lo + 8) if n <= top),
        frozenset(n for n in range(max(0, lo - 2), lo + 11) if n <= top),
        radius=r, kind="ltl", name=f"band-r{r}",
    )


def ltl_rules():
    """Box LtL rules at R = 1, 2, 5, 10 with thresholds that keep soups
    alive, bugs, and a count set of several runs."""
    from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

    sparse = Rule(
        frozenset({3, 4, 5, 9}), frozenset({2, 3, 8}), radius=2, kind="ltl",
        name="sparse-r2",
    )
    return [ltl_band(1), ltl_band(2), resolve_rule("bugs"), ltl_band(10), sparse]


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
        self.max = {name: 0 for name in KERNELS + WIRINGS + ("tune",)}
        self.checks = {name: 0 for name in KERNELS + WIRINGS + ("tune",)}

    def hold(self, name: str, got, plain, what: str) -> None:
        import torch

        torch.cuda.synchronize()
        err = int(((got.long() & 0xFFFFFFFF) - (plain.long() & 0xFFFFFFFF)).abs().max())
        self.max[name] = max(self.max[name], err)
        self.checks[name] += 1
        check(torch.equal(got, plain), f"{name} != plain at {what}")


def tune_libraries():
    """(kernel, defines) of every tile variant the tune phase runs."""
    from akka_game_of_life_tpu_torch.runtime import autotune

    libs = set()
    for rule, grid in TUNE_RUNS.items():
        kernel = autotune.kernel_of(rule)
        for b in grid["blocks"]:
            libs.add((kernel, autotune.variant_defines(rule, b)))
    return sorted(libs)


def build_all(card):
    """Each kernel's library (the packed and plane sweeps' for every rule
    they are held at) and every tile variant of the tune phase, built from
    its source by one nvcc each, all started together."""
    from akka_game_of_life_tpu_torch.ops import _build, gen_sweep, packed_sweep

    libs = sorted(
        {("ltl_sweep", ())}
        | {("gen_sweep", gen_sweep.library_defines(rule)) for rule in GEN_RULES}
        | {("packed_sweep", packed_sweep.library_defines(rule))
           for rule in RULES + ["replicator"]}
        | set(tune_libraries())
    )
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        built = dict(zip(libs, pool.map(lambda lib: _build.load(*lib), libs)))
    (OUT / "nvcc.log").write_text(
        "".join(f"== {name} {defines} ({b.seconds:.2f} s)\n{b.log}\n"
                for (name, defines), b in built.items())
    )
    import torch

    emit(
        "device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_s={f"{name}{''.join(defines)}": b.seconds for (name, defines), b in built.items()},
        libraries=len(libs),
    )


# cuobjdump's reports of the plane sweep's depth-k kernel: its resource line
# and its code's opcodes.
_RES_USAGE = re.compile(r"Function \S*gen_sweep_kernelILi(\d+)E\S*:\s+REG:(\d+) STACK:(\d+)")
_SASS_OP = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")


def _cuobjdump(*args) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, *args], capture_output=True, text=True, check=True).stdout


def check_plane_build(card):
    """The plane sweep's code, read from each rule's library: registers
    and stack frame of every depth's kernel (no stack, so no spill, at the
    main path's m = 2 points, k = 10 and 31), and the LOP3/SHF
    instructions of the k = 10 kernel per word and generation (its three
    unrolled rows of ten levels), which must be no fewer than the bound's
    count (``ops_per_word_step``)."""
    from akka_game_of_life_tpu_torch.ops import _build, bitpack_gen, gen_sweep
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    report = {}
    for name in GEN_RULES:
        m = bitpack_gen.n_planes(resolve_rule(name).states)
        lib = _build.load("gen_sweep", gen_sweep.library_defines(name)).lib._name
        usage = {int(k): (int(reg), int(stack))
                 for k, reg, stack in _RES_USAGE.findall(_cuobjdump("-res-usage", lib))}
        check(sorted(usage) == list(range(1, 32)), f"gen_sweep {name}: depths {sorted(usage)}")
        entry = {"planes": m, "registers": {k: usage[k][0] for k in (10, 31)},
                 "stack_bytes": {k: st for k, (_, st) in usage.items() if st}}
        if m == 2:
            check(usage[10][1] == 0 and usage[31][1] == 0,
                  f"gen_sweep {name} spills at k = 10 or 31: {usage[10]}, {usage[31]}")
            ops, inside = {}, False
            for line in _cuobjdump("-sass", lib).splitlines():
                if "Function :" in line:
                    inside = "gen_sweep_kernelILi10E" in line
                    continue
                op = _SASS_OP.match(line)
                if inside and op:
                    ops[op.group(1)] = ops.get(op.group(1), 0) + 1
            issued = (ops.get("LOP3", 0) + ops.get("SHF", 0)) / (3 * 10)
            count = gen_sweep.ops_per_word_step(name)
            check(issued >= count, f"gen_sweep {name}: issues {issued} < the bound's {count}")
            entry.update(lop3_shf_per_word_step_k10=issued, ops_per_word_step=count,
                         shfl_k10=ops.get("SHFL", 0))
        report[name] = entry
    emit("plane_build", kernel="gen_sweep", libraries=report, card=card["name_power"])


def check_packed_sweep(errors, rng):
    """13 shapes (the ragged ones included) x 5 rules x 4 depths, each
    rule through its own library; returns the full-size words for the
    timing phase."""
    import numpy as np

    from akka_game_of_life_tpu_torch.ops import bitpack, packed_sweep

    depths = sorted({1, 7, packed_sweep.DEFAULT_STEPS_PER_SWEEP, packed_sweep.MAX_STEPS_PER_SWEEP})
    for shape in SMALL_SHAPES + PACKED_RAGGED + [FULL_SHAPE]:
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
        shapes=SMALL_SHAPES + PACKED_RAGGED + [FULL_SHAPE], rules=RULES, depths=depths,
        max_abs_err=errors.max["packed_sweep"],
    )
    return x


def check_gen_sweep(errors, rng, card):
    """The plane sweep on random planes (invalid encodings included) at
    small and ragged shapes for every rule (each through its own library),
    at the WireWorld run's 2 x 16384 x 512 words for WireWorld and at 2 x
    65536 x 2048 for Brian's Brain, at depths 1, 7, the default and the
    deepest; then a library's refusal of another rule and the launcher's
    refusals (a depth past the deepest, a plane count not its rule's, a
    board of more than 65535 strips).  Returns the two large plane stacks,
    by rule name, for the timing phase."""
    import ctypes

    import numpy as np
    import torch

    from akka_game_of_life_tpu_torch.ops import bitpack_gen, gen_sweep
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
        for shape in SMALL_SHAPES + GEN_RAGGED:
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
    # A library built for one rule refuses a launch of another; the
    # launcher itself refuses a depth past the deepest, a plane count that
    # does not match its rule and a board of more than 65535 strips, and
    # launches nothing.
    x = planes(2, (8, 2))
    for other in ("star-wars", "wireworld"):
        try:
            gen_sweep._launch(x, resolve_rule(other), 2, gen_sweep.library_defines("brians-brain"))
        except RuntimeError as e:
            check("built for rule" in str(e), f"gen_sweep library refusal: {e}")
        else:
            raise AssertionError(f"the brians-brain plane library launched {other}")
    launch = gen_sweep._launcher(gen_sweep.library_defines("brians-brain")).launch
    tall = planes(2, (65535 * gen_sweep.DEFAULT_TILE_ROWS + 1, 1))
    out = torch.empty_like(tall)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    refused = [
        launch(x.data_ptr(), out.data_ptr(), 2, 8, 2, MAX_STEPS_PER_SWEEP + 1, stream),
        launch(x.data_ptr(), out.data_ptr(), 3, 8, 2, 1, stream),
        launch(tall.data_ptr(), out.data_ptr(), 2, tall.shape[1], 1, 1, stream),
    ]
    check(all(rc != 0 for rc in refused), f"gen_sweep launcher accepted bad arguments: {refused}")
    del tall, out
    emit(
        "kernel_vs_plain", kernel="gen_sweep",
        replaces="akka_game_of_life_tpu/ops/pallas_gen.py:50",
        check_launches=errors.checks["gen_sweep"],
        shapes=SMALL_SHAPES + GEN_RAGGED, rules=GEN_RULES,
        libraries={name: list(gen_sweep.library_defines(name)) for name in GEN_RULES},
        large={name: list(x.shape) for name, x in large.items()},
        depths=depths, refused_codes=refused, max_abs_err=errors.max["gen_sweep"],
        card=card["name_power"],
    )
    return large


def check_ltl_sweep(errors, rng, card):
    """The LtL step on random 0/1 boards at small ragged shapes and at
    16384² for every count set; at the ragged widths (W < 2R+1, a lane's
    run x 256 +- 1) for every radius 1..10, once with cells of other states
    (2, 255) among them; then the launcher's refusals (R = 11, a 16-byte
    path for a width that is not a multiple of 16).  Returns the full-size
    board for the timing phase."""
    import ctypes

    import numpy as np
    import torch

    from akka_game_of_life_tpu_torch.ops import ltl_sweep
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    def hold(board, rules):
        for rule in rules:
            errors.hold(
                "ltl_sweep", ltl_sweep.ltl_sweep(board, rule),
                ltl_sweep.ltl_sweep_reference(board, rule),
                f"{tuple(board.shape)} {rule.name} R={rule.radius}",
            )
            torch.cuda.empty_cache()

    rules = ltl_rules()
    every_radius = [ltl_band(r) for r in range(1, 11)] + rules[2:3] + rules[4:]
    for shape in LTL_SHAPES + LTL_RAGGED + [LTL_FULL_SHAPE]:
        board = torch.from_numpy(
            (rng.random(shape, dtype=np.float32) < 0.4).astype(np.uint8)
        ).to("cuda")
        hold(board, every_radius if shape in LTL_RAGGED else rules)
    states = rng.choice(np.array([0, 1, 2, 255], np.uint8), size=LTL_RAGGED[2], p=[0.5, 0.4, 0.05, 0.05])
    hold(torch.from_numpy(states).to("cuda"), every_radius)
    board = torch.from_numpy(
        (rng.random(LTL_FULL_SHAPE, dtype=np.float32) < 0.4).astype(np.uint8)
    ).to("cuda")
    out = torch.empty_like(board)
    ranges = ltl_sweep._ranges_on(resolve_rule("bugs"), board.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    launch = ltl_sweep._library().ltl_sweep_launch
    refused = [
        launch(board.data_ptr(), out.data_ptr(), *LTL_FULL_SHAPE, 11, ranges.data_ptr(), 1, stream),
        launch(board.data_ptr(), out.data_ptr(), 16384, 16383, 5, ranges.data_ptr(), 1, stream),
    ]
    check(all(rc != 0 for rc in refused), f"ltl_sweep launcher accepted bad arguments: {refused}")
    emit(
        "kernel_vs_plain", kernel="ltl_sweep",
        replaces="akka_game_of_life_tpu/ops/pallas_ltl.py:66",
        check_launches=errors.checks["ltl_sweep"],
        shapes=LTL_SHAPES + LTL_RAGGED + [LTL_FULL_SHAPE],
        rules=[r.rulestring() for r in rules],
        ragged_radii=list(range(1, 11)), refused_codes=refused,
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
         "--checkpoint-dir", str(ckpt), "--device", SINGLE],
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
         "--checkpoint-dir", str(resume), "--device", SINGLE],
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
    return {"launches": counts[kernel], "expected": expected, "run_s": run_s, "ckpt": ckpt,
            "metrics": metrics, "windows": windows, "sweeps": sweeps, "text": text}


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
    return auto_counts["ltl_sweep"], dense, dense_s


# -- the program ledger ------------------------------------------------------------

# (family, kernel, config file or None, overrides): the three hand-written
# kernels' programs as ``run`` registers them, each run twice in process.
PROGRAMS_RUNS = [
    ("pallas", "packed_sweep", HEADLINE, {"max_epochs": 120}),
    ("pallas_gen", "gen_sweep", WIREWORLD, {"max_epochs": 20}),
    ("pallas_ltl", "ltl_sweep", None, {
        "rule": "bugs", "height": LTL_FULL_SHAPE[0], "width": LTL_FULL_SHAPE[1], "seed": 0,
        "max_epochs": 10, "steps_per_call": 5, "metrics_every": 5,
    }),
]
# A call's seconds may not fall below this share of the event time of the
# launches it made, timed back to back: an event pair around its own
# launches cannot read less than their kernel time, where timing of the
# dispatch alone reads about 1/50 of it on the headline.
PROGRAMS_UNDER_LAUNCHES = 0.9
# Nor may the ledger's rate pass the rate at the kernel's bound by more than
# this: a higher reading is impossible on the card.
PROGRAMS_OVER_BOUND = 1.05


def _ledger_run(config, log_name: str):
    """One in-process run of ``config`` on ``SINGLE``, as ``run`` drives
    it; returns the Simulation's last board, its kernel and tile, and the
    wall seconds from just before ``advance`` to a synchronise after it."""
    import torch

    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    buf = io.StringIO()
    observer = BoardObserver(
        render_every=config.render_every, render_max_cells=config.render_max_cells,
        metrics_every=config.metrics_every, out=buf,
    )
    with Simulation(config, observer=observer, device=SINGLE) as sim:
        t0 = time.perf_counter()
        sim.advance(config.max_epochs)
        torch.cuda.synchronize(SINGLE)
        seconds = time.perf_counter() - t0
        board, kernel, tile = sim.board, sim.kernel, sim.tile_rows
    (OUT / log_name).write_text(buf.getvalue())
    return board, kernel, tile, seconds


def _ledger_plan(kernel: str, config, board, tile, rate: float):
    """What a run of ``config`` through ``kernel`` puts on the ledger: the
    program's key, the depth of every launch, the bound of those launches
    in ms, and one bare launch of the first depth on ``board`` through the
    library the run used."""
    from akka_game_of_life_tpu_torch import bench
    from akka_game_of_life_tpu_torch.ops import gen_sweep, ltl_sweep, packed_sweep
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    rule = resolve_rule(config.rule)
    h, w, spc = config.height, config.width, config.steps_per_call
    if kernel == "ltl_sweep":
        depths = [1] * config.max_epochs
        key = ("multi_step", rule.name, spc, ltl_sweep.DEFAULT_TILE_ROWS if tile is None else tile)
        bound_ms = bench.ltl_bound(h, w, rule, rate)["bound_ms"] * len(depths)
        defines = ltl_sweep.tile_defines(tile)
        return key, depths, bound_ms, lambda: ltl_sweep._launch(board, rule, defines)
    chunks = -(-config.max_epochs // spc)
    depths = [k for _ in range(chunks) for k in packed_sweep.plan_sweeps(spc)]
    if kernel == "gen_sweep":
        key = ("multi_step", rule.name, spc, gen_sweep.DEFAULT_TILE_ROWS if tile is None else tile)
        m, _, nw = board.shape
        bound_ms = sum(bench.gen_sweep_bound(m, h, nw, k, rule, rate)["bound_ms"] for k in depths)
        defines = gen_sweep.library_defines(rule, tile)
        return key, depths, bound_ms, lambda: gen_sweep._launch(board, rule, depths[0], defines)
    key = ("packed_multi_step", rule.name, spc,
           packed_sweep.DEFAULT_TILE_ROWS if tile is None else tile)
    _, nw = board.shape
    bound_ms = sum(bench.sweep_bound(h, nw, k, rule, rate)["bound_ms"] for k in depths)
    defines = packed_sweep.library_defines(rule, tile)
    return key, depths, bound_ms, lambda: packed_sweep._launch(board, rule, depths[0], defines)


def programs_phase(card):
    """The program ledger of the three hand-written kernels on the card,
    read over HTTP: the headline (65536², 120 epochs: 2 calls of 6 sweeps),
    WireWorld at 16384² (20 epochs: 2 calls of 1 sweep) and bugs at 16384²
    (10 epochs: 2 calls of 5 generations), each run twice in process behind
    a ``MetricsServer`` with ``/programs`` and ``/cost``.  The first run
    shows each family's compile bill; the ledger is then reset and the
    second run checked: the key and one call per chunk, the launches of the
    plan, cells = board × epochs, the device-seconds counter equal to the
    family's seconds; each call's seconds at least 0.9× the event time of
    its launches timed back to back, the rate at most 1.05× the rate at the
    kernel's bound, and the seconds within the run's wall.  The ratio to the
    bare launches' event rate is printed, not checked: for a call of one
    launch it depends on the host's dispatch latency."""
    import dataclasses

    from akka_game_of_life_tpu_torch import bench
    from akka_game_of_life_tpu_torch.obs import MetricsServer
    from akka_game_of_life_tpu_torch.obs.catalog import install
    from akka_game_of_life_tpu_torch.obs.metrics import MetricsRegistry
    from akka_game_of_life_tpu_torch.obs.programs import get_programs, http_routes
    from akka_game_of_life_tpu_torch.runtime.config import load_config

    programs = get_programs()
    metrics = install(MetricsRegistry())
    seconds_c = metrics.counter("gol_program_device_seconds_total", "", ("family",))
    server = MetricsServer(metrics, port=0, host="127.0.0.1",
                           routes=http_routes(registry=programs))
    base = f"http://127.0.0.1:{server.port}"
    try:
        for family, kernel, path, overrides in PROGRAMS_RUNS:
            config = dataclasses.replace(
                load_config(None if path is None else str(path), overrides), checkpoint_dir=None
            )
            epochs = config.max_epochs
            chunks = -(-epochs // config.steps_per_call)
            runs = {}
            for rep in ("first", "checked"):
                programs.reset()
                programs.configure(node="chip_smoke", metrics=metrics)
                counted_before = seconds_c.labels(family=family).value
                zero_counts()
                board, sim_kernel, tile, run_s = _ledger_run(config, f"programs_{family}_{rep}.log")
                counts = read_counts()
                status, listing = _http(base, "GET", "/programs")
                check(status == 200, f"/programs answered {status}")
                status, cost = _http(base, "GET", "/cost")
                check(status == 200, f"/cost answered {status}")
                runs[rep] = dict(
                    counts=counts, run_s=run_s,
                    records=[p for p in listing["programs"] if p["family"] == family],
                    families=sorted({p["family"] for p in listing["programs"]}),
                    cost=cost["families"].get(family, {}),
                    counted=seconds_c.labels(family=family).value - counted_before,
                )
            key, depths, bound_ms, launch = _ledger_plan(
                kernel, config, board, tile, card["int32_ops_per_s"])
            launch_ms = bench.time_ms(launch, reps=20)
            del board, launch
            h, w = config.height, config.width
            for rep, run in runs.items():
                what = f"programs {family} ({rep} run)"
                check(run["families"] == [family], f"{what}: families {run['families']}")
                check([r["key"] for r in run["records"]] == [repr(key)],
                      f"{what}: keys {[r['key'] for r in run['records']]}, expected {key!r}")
                check(run["records"][0]["calls"] == chunks,
                      f"{what}: {run['records'][0]['calls']} calls, expected {chunks}")
                check(run["counts"][kernel] == len(depths) == sum(run["counts"].values()),
                      f"{what}: launches {run['counts']}, expected {len(depths)} {kernel}")
                check(run["cost"]["cells"] == float(h * w * epochs),
                      f"{what}: cells {run['cost']['cells']} != {h * w * epochs}")
                check(abs(run["counted"] - run["cost"]["seconds"]) <= 1e-9 + 1e-6 * run["cost"]["seconds"],
                      f"{what}: device seconds counter {run['counted']} != {run['cost']['seconds']}")
            got = runs["checked"]
            seconds = got["cost"]["seconds"]
            call_ms = seconds * 1e3 / chunks
            launches_ms = len(depths) // chunks * launch_ms
            check(call_ms >= PROGRAMS_UNDER_LAUNCHES * launches_ms,
                  f"programs {family}: {call_ms:.4f} ms a call, under {PROGRAMS_UNDER_LAUNCHES} x "
                  f"the {launches_ms:.4f} ms of its launches back to back: dispatch-only timing")
            ledger_rate = got["cost"]["cell_updates_per_s"]
            bound_rate = h * w * epochs / (bound_ms / 1e3)
            check(ledger_rate <= PROGRAMS_OVER_BOUND * bound_rate,
                  f"programs {family}: /cost rate {ledger_rate:.4g} over {PROGRAMS_OVER_BOUND} x "
                  f"the rate at the bound, {bound_rate:.4g}")
            check(seconds <= got["run_s"],
                  f"programs {family}: {seconds:.6f} device seconds over the run's "
                  f"{got['run_s']:.6f} s of wall")
            kernel_rate = h * w * depths[0] / (launch_ms / 1e3)
            emit(
                "programs", family=family, kernel=kernel, simulation_kernel=sim_kernel,
                config=f"{'' if path is None else path.name} {overrides}".strip(),
                key=repr(key), calls=got["records"][0]["calls"], launches=got["counts"][kernel],
                cells=got["cost"]["cells"], bytes=got["cost"]["bytes"], flops=got["cost"]["flops"],
                compile_seconds_first_run=runs["first"]["records"][0]["compile_seconds"],
                compile_seconds=got["records"][0]["compile_seconds"],
                device_seconds=seconds, device_ms_per_call=call_ms,
                device_seconds_first_run=runs["first"]["cost"]["seconds"],
                kernel_ms_per_launch=launch_ms, launches_ms_per_call=launches_ms,
                cell_updates_per_s=ledger_rate,
                first_run_cell_updates_per_s=runs["first"]["cost"]["cell_updates_per_s"],
                kernel_cell_updates_per_s=kernel_rate, share_of_kernel_rate=ledger_rate / kernel_rate,
                bound_cell_updates_per_s=bound_rate, share_of_bound=ledger_rate / bound_rate,
                run_s={rep: run["run_s"] for rep, run in runs.items()},
                card=card["name_power"],
            )
    finally:
        server.close()
        programs.reset()


# -- the banded-matmul stencil, the fast-forward, sparse stepping ----------------


@contextlib.contextmanager
def tf32_everywhere():
    """TF32 switched on globally for float32 products, as a caller might."""
    import torch

    prev = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _random_board(side: int, seed: int):
    import torch

    g = torch.Generator(device=SINGLE).manual_seed(seed)
    return torch.randint(0, 2, (side, side), generator=g, device=SINGLE, dtype=torch.uint8)


def matmul_lanes(card):
    """One generation on each lane against the plain dense step on the
    card, bit for bit (the f32 lane once more with TF32 on globally), with
    each lane's time and bound beside the packed sweep's or the LtL step's
    at the same size."""
    import torch

    from akka_game_of_life_tpu_torch import bench
    from akka_game_of_life_tpu_torch.ops import (
        bitpack, ltl_sweep, matmul_stencil as ms, packed_sweep, stencil,
    )
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    # A float32 product of 2^20 + 1 by ones: what TF32 does to a packed word.
    x = torch.full((64, 64), float(2**20 + 1), device=SINGLE)
    with tf32_everywhere():
        tf32_sum = float(torch.mm(x, torch.ones_like(x))[0, 0])
    out = {}
    for seed, (name, side) in enumerate(MATMUL_CASES):
        rule = ltl_band(10) if name == "band-r10" else resolve_rule(name)
        board = _random_board(side, seed)
        plain = stencil.step(board, rule)
        plain_ms = bench.time_ms(lambda: stencil.step(board, rule), reps=2, warmup=1)
        lanes = {}
        for lane in MATMUL_LANES:
            plan = ms.plan_matmul((side, side), rule.radius, lane, "box", "cuda")
            got = ms.step_matmul(board, rule, lane)
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"matmul {lane} lane, {name} {side}²: != the plain step")
            lanes[lane] = {
                "ms": bench.time_ms(lambda: ms.step_matmul(board, rule, lane), reps=5, warmup=1),
                "plan": {"digits": plan.digits, "base": plan.base, "row_tile": plan.row_tile,
                         "col_tile": plan.col_tile, "est_bytes": plan.est_bytes},
                **bench.matmul_bound(plan),
            }
            del got
        with tf32_everywhere():
            got = ms.step_matmul(board, rule, "f32")
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"matmul f32 lane with TF32 on, {name}: != the plain step")
        del got
        if rule.kind == "ltl":
            kernel = "ltl_sweep"
            kernel_ms = bench.time_ms(lambda: ltl_sweep._launch(board, rule), reps=10)
        else:
            kernel = "packed_sweep"
            words = bitpack.pack(board)
            k = packed_sweep.DEFAULT_STEPS_PER_SWEEP
            kernel_ms = bench.time_ms(lambda: packed_sweep._launch(words, rule, k), reps=10) / k
            del words
        out[name] = {"side": side, "lanes": lanes, "kernel": kernel,
                     "kernel_ms_per_generation": kernel_ms, "plain_ms": plain_ms}
        emit("matmul_lanes", rule=name, radius=rule.radius, side=side, lanes=lanes,
             f32_with_tf32_exact=True, kernel=kernel, kernel_ms_per_generation=kernel_ms,
             plain_ms=plain_ms, auto_cuda_lane=ms.AUTO_CUDA_MODE,
             tf32_rounds_a_packed_word=tf32_sum != 64.0 * (2**20 + 1),
             card=card["name_power"])
        del board, plain
        torch.cuda.empty_cache()
    return out


def matmul_run(tmp: Path, ltl_dense, card):
    """``run --kernel matmul``: bugs reaches the bugs phase's digests; a
    random Conway board reaches the packed sweep's, and resumes from its
    epoch-40 checkpoint; no CUDA kernel launches; the guard refuses the
    65536² board by name."""
    from akka_game_of_life_tpu_torch import cli

    zero_counts()
    text, bugs_s = run_cli(["run", *LTL_RUN, "--kernel", "matmul"], "ltl_matmul_run.log")
    check(parse_run(text)[0] == ltl_dense, "bugs --kernel matmul: digests differ from the bugs phase")
    check(sum(read_counts().values()) == 0, f"bugs --kernel matmul launched {read_counts()}")
    runs = {}
    for kernel in ("pallas", "matmul"):
        zero_counts()
        extra = ["--checkpoint-dir", str(tmp / "conway-matmul"), "--checkpoint-every",
                 str(MATMUL_RESUME_FROM)] if kernel == "matmul" else []
        text, run_s = run_cli(["run", *MATMUL_CONWAY_RUN, "--kernel", kernel, *extra],
                              f"conway_{kernel}_run.log")
        runs[kernel] = (parse_run(text)[0], read_counts(), run_s)
    (want, sweep_counts, sweep_s), (got, mm_counts, mm_s) = runs["pallas"], runs["matmul"]
    check(sorted(want) == list(range(10, 61, 10)), f"conway pallas metrics {sorted(want)}")
    check(got == want, "conway --kernel matmul: digests differ from --kernel pallas")
    check(sweep_counts["packed_sweep"] == 6, f"conway pallas launches {sweep_counts}")
    check(sum(mm_counts.values()) == 0, f"conway --kernel matmul launched {mm_counts}")
    resume = tmp / "conway-matmul-resume"
    resume.mkdir()
    shutil.copy(tmp / "conway-matmul" / f"ckpt_{MATMUL_RESUME_FROM:012d}.npz", resume)
    text, _ = run_cli(["run", *MATMUL_CONWAY_RUN, "--kernel", "matmul",
                       "--checkpoint-dir", str(resume)], "conway_matmul_resume.log")
    resumed = parse_run(text)[0]
    check(resumed.get(60) == want[60],
          f"matmul resume from {MATMUL_RESUME_FROM}: {resumed.get(60)} != {want[60]}")
    # The guard at the headline's size: refused when the run is built (the
    # CLI exits non-zero on this ValueError).
    try:
        cli.main(["run", "--height", "65536", "--width", "65536", "--max-epochs", "1",
                  "--kernel", "matmul", "--device", SINGLE])
        refusal = None
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None and "kernel=matmul" in refusal
          and "GOL_INTERMEDIATE_CAP_MB" in refusal, f"65536² matmul not refused: {refusal}")
    emit("matmul_run", bugs_digests={e: d for e, (_, d) in ltl_dense.items()},
         conway_digests={e: d for e, (_, d) in want.items()}, resumed_from=MATMUL_RESUME_FROM,
         bugs_run_s=bugs_s, conway_run_s=mm_s, conway_pallas_run_s=sweep_s,
         refusal_65536=refusal, card=card["name_power"])
    return {"bugs_run_s": bugs_s, "conway_run_s": mm_s, "conway_pallas_run_s": sweep_s}


_FF_LINE = re.compile(r"^fast-forwarded to epoch (\d+): digest=([0-9a-f]{16})$", re.M)


def _prom_value(text: str, name: str) -> float:
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    check(m is not None, f"metrics file lacks {name}")
    return float(m.group(1))


def _seconds_sum(name: str) -> float:
    """A histogram's running sum in this process's registry (every in-process
    run adds to it: read it before and after a run)."""
    from akka_game_of_life_tpu_torch.obs import get_registry

    return get_registry().histogram(name).labels().snapshot()["sum"]


def fast_forward_phase(tmp: Path, card):
    """The replicator jump to T at 12288² (certified on 8 steps), against
    the jump to T - 60 plus 60 epochs of the packed sweep; the matmul jump
    of Fredkin on each lane against the roll jump."""
    import torch

    from akka_game_of_life_tpu_torch import bench
    from akka_game_of_life_tpu_torch.ops import fastforward, packed_sweep

    plan = fastforward.jump_plan("replicator", FF_T, (FF_SIDE, FF_SIDE))
    check(all(n > 1 for n in plan["factor_rolls"]), f"a trivial factor: {plan}")
    ff = ["--rule", "replicator", "--height", str(FF_SIDE), "--width", str(FF_SIDE),
          "--device", SINGLE]
    ff_before, cert_before = _seconds_sum("gol_ff_seconds"), _seconds_sum("gol_digest_seconds")
    zero_counts()
    text, jump_run_s = run_cli(
        ["run", *ff, "--fast-forward", str(FF_T), "--max-epochs", str(FF_T),
         "--ff-certify-steps", "8"], "ff_jump.log")
    landed = _FF_LINE.findall(text)
    check(len(landed) == 1 and int(landed[0][0]) == FF_T, f"fast-forward landed {landed}")
    check(sum(read_counts().values()) == 0, f"the jump launched {read_counts()}")
    # The jump's seconds (unpack, certification, jump, repack) and the
    # certification's share of them.
    ff_s = _seconds_sum("gol_ff_seconds") - ff_before
    cert_s = _seconds_sum("gol_digest_seconds") - cert_before
    # One chunk of 60 through the packed sweep; a metrics line prints only at
    # a multiple of the cadence, so the cadence is T itself.
    zero_counts()
    text, iterate_run_s = run_cli(
        ["run", *ff, "--fast-forward", str(FF_T - FF_ITERATE), "--max-epochs", str(FF_T),
         "--steps-per-call", str(FF_ITERATE), "--metrics-every", str(FF_T),
         "--obs-digest"], "ff_iterate.log")
    iterated, _ = parse_run(text)
    check(iterated.get(FF_T, (None, None))[1] == landed[0][1],
          f"jump(T) {landed[0][1]} != jump(T - {FF_ITERATE}) + {FF_ITERATE} epochs {iterated}")
    check(read_counts()["packed_sweep"] == FF_ITERATE // packed_sweep.DEFAULT_STEPS_PER_SWEEP,
          f"iterate launches {read_counts()}")

    board = _random_board(FF_SIDE, 7)
    lanes = {}
    for t in FF_MATMUL_T:
        want = fastforward.fast_forward(board, "fredkin", t)
        roll_ms = bench.time_ms(lambda: fastforward.fast_forward(board, "fredkin", t), reps=2)
        for lane in MATMUL_LANES:
            fn = fastforward.jump_matmul_fn("fredkin", t, (FF_SIDE, FF_SIDE), lane, "cuda")
            got = fn(board)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"matmul jump {lane} at t={t} != the roll jump")
            lanes[f"{lane}@{t}"] = bench.time_ms(lambda: fn(board), reps=2)
            del got, fn
        lanes[f"rolls@{t}"] = roll_ms
        del want
    fastforward.jump_matmul_fn.cache_clear()
    del board
    emit("fast_forward", side=FF_SIDE, t=FF_T, jump_plan=plan, digest=landed[0][1],
         ff_seconds=ff_s, certify_seconds=cert_s, jump_run_s=jump_run_s,
         iterate_run_s=iterate_run_s, fredkin_jump_ms=lanes, card=card["name_power"])
    return {"ff_seconds": ff_s, "certify_seconds": cert_s, "jump_plan": plan}


def sparse_phase(tmp: Path, card):
    """A glider on a dead 16384² torus with activity-gated stepping on and
    off: equal digests at every cadence epoch, skipped blocks, no CUDA
    kernel in the gated run, and its checkpoint resumed with gating off."""
    runs = {}
    for mode in ("on", "off"):
        zero_counts()
        prom = tmp / f"sparse-{mode}.prom"
        extra = ["--checkpoint-dir", str(tmp / "sparse-on"), "--checkpoint-every",
                 str(SPARSE_CHECKPOINT)] if mode == "on" else []
        text, run_s = run_cli(["run", *SPARSE_RUN, "--sparse-kernel", mode,
                               "--metrics-file", str(prom), *extra], f"sparse_{mode}.log")
        runs[mode] = (parse_run(text)[0], read_counts(), run_s, prom.read_text())
    (on, on_counts, on_s, on_prom), (off, off_counts, off_s, _) = runs["on"], runs["off"]
    check(sorted(on) == list(range(8, 65, 8)), f"sparse metrics epochs {sorted(on)}")
    check(on == off, "sparse on: digests differ from the ungated run")
    check(sum(on_counts.values()) == 0, f"the gated run launched {on_counts}")
    # The only run of this process that gates, so the file's totals are its.
    check(off_counts["packed_sweep"] > 0, f"the ungated run launched {off_counts}")
    skipped = _prom_value(on_prom, "gol_sparse_blocks_skipped_total")
    stepped = _prom_value(on_prom, "gol_sparse_blocks_stepped_total")
    dense_chunks = _prom_value(on_prom, "gol_sparse_dense_chunks_total")
    check(skipped > 0, "sparse on skipped no block")
    resume = tmp / "sparse-resume"
    resume.mkdir()
    shutil.copy(tmp / "sparse-on" / f"ckpt_{SPARSE_CHECKPOINT:012d}.npz", resume)
    text, _ = run_cli(["run", *SPARSE_RUN, "--sparse-kernel", "off",
                       "--checkpoint-dir", str(resume)], "sparse_resume.log")
    check(parse_run(text)[0].get(64) == on[64], "sparse checkpoint resumed ungated: last digest differs")
    emit("sparse", digests={e: d for e, (_, d) in on.items()}, on_run_s=on_s, off_run_s=off_s,
         blocks_skipped=skipped, blocks_stepped=stepped, dense_chunks=dense_chunks,
         resumed_from=SPARSE_CHECKPOINT, card=card["name_power"])
    return {"on_run_s": on_s, "off_run_s": off_s}


# -- the tune phase, the tuned tile, selftest -----------------------------------


def _tune_argv(rule, grid):
    return ["tune", "--rule", rule, "--size", str(grid["size"]),
            "--steps-per-call", str(grid["spc"]),
            "--blocks", ",".join(map(str, grid["blocks"])),
            "--sweeps", ",".join(map(str, grid["sweeps"])),
            "--timed-calls", str(TUNE_TIMED_CALLS), "--device", SINGLE]


def hold_variants(errors, rng, rule, grid):
    """Every tile variant of a tune grid against the plain version through
    the ops API: at the tune's own board size and at the small ragged
    shapes, at every depth of the grid."""
    import numpy as np
    import torch

    from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen, gen_sweep, ltl_sweep, packed_sweep
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
    from akka_game_of_life_tpu_torch.runtime import autotune

    kernel, size = autotune.kernel_of(rule), grid["size"]
    if kernel == "ltl_sweep":
        for shape in LTL_SHAPES + [(size, size)]:
            board = torch.from_numpy(
                (rng.random(shape, dtype=np.float32) < 0.4).astype(np.uint8)).to(SINGLE)
            plain = ltl_sweep.ltl_sweep_reference(board, rule)
            for b in grid["blocks"]:
                errors.hold("tune", ltl_sweep.ltl_sweep(board, rule, tile_rows=b), plain,
                            f"{rule} tile {b} {shape}")
            del board, plain
            torch.cuda.empty_cache()
        return
    m = 1 if kernel == "packed_sweep" else bitpack_gen.n_planes(resolve_rule(rule).states)
    for shape in SMALL_SHAPES + [(size, size // 32)]:
        raw = rng.integers(0, 2**32, size=(m, *shape), dtype=np.uint32)
        x = (bitpack.words_from_numpy(raw[0], SINGLE) if m == 1
             else bitpack_gen.planes_from_numpy(raw, SINGLE))
        for k in grid["sweeps"]:
            if kernel == "packed_sweep":
                plain = packed_sweep.packed_sweep_reference(x, rule, k)
                run = lambda b: packed_sweep.packed_sweep(x, rule, k, tile_rows=b)
            else:
                plain = gen_sweep.gen_sweep_reference(x, rule, k)
                run = lambda b: gen_sweep.gen_sweep(x, rule, k, tile_rows=b)
            for b in grid["blocks"]:
                errors.hold("tune", run(b), plain, f"{rule} tile {b} k={k} {shape}")
            del plain
        del x
        torch.cuda.empty_cache()


def tune_phase(errors, rng, card):
    """``tune`` through the CLI for each grid: no point errs, the summary
    line is printed, the counters saw the planned launches, and every
    variant the tune built is bit-exact against its plain version."""
    from akka_game_of_life_tpu_torch.runtime import autotune

    out = {}
    for rule, grid in TUNE_RUNS.items():
        kernel = autotune.kernel_of(rule)
        zero_counts()
        text, run_s = run_cli(_tune_argv(rule, grid), f"tune_{rule}.log")
        counts = read_counts()
        lines = text.splitlines()
        recs = [json.loads(line) for line in lines if line.startswith("{")]
        points = [r for r in recs if "block_rows" in r]
        summary = [r for r in recs if "tune" in r]
        depths = [1] if kernel == "ltl_sweep" else grid["sweeps"]
        grid_points = {(b, k) for b in grid["blocks"] for k in depths
                       if autotune.feasible(grid["size"], grid["spc"], b, k, rule)}
        check(not [p for p in points if "error" in p], f"tune {rule}: error points {points}")
        check({(p["block_rows"], p["steps_per_sweep"]) for p in points} == grid_points,
              f"tune {rule}: points {points}")
        check(len(summary) == 1 and summary[0]["best"] == points[0],
              f"tune {rule}: summary {summary}")
        check(lines[-1] == f"best: {summary[0]['flags']}", f"tune {rule}: last line {lines[-1]}")
        plan = autotune.planned_launches(points, grid["spc"], TUNE_TIMED_CALLS, rule)
        check(counts[kernel] == plan and sum(counts.values()) == plan,
              f"tune {rule}: launches {counts}, planned {plan} of {kernel}")
        before = errors.checks["tune"]
        hold_variants(errors, rng, rule, grid)
        emit("tune", rule=rule, kernel=kernel, grid=grid, points=points,
             summary=summary[0], launches=counts[kernel], planned_launches=plan,
             variant_checks=errors.checks["tune"] - before,
             max_abs_err=errors.max["tune"], run_s=run_s, card=card["name_power"])
        out[rule] = {"points": points, "launches": counts[kernel], "grid": grid}
    return out


def tuned_headline(tune, headline, tmp: Path, card):
    """The headline under ``--kernel pallas --pallas-block-rows B``, B the
    Conway tune's best tile that is not the default: every library the
    launches go through (``_checked_library``, which the multi-step callable
    and ``_launch`` both take theirs from) is that variant's, and the
    digests at every cadence epoch equal the default tile's."""
    from akka_game_of_life_tpu_torch.ops import packed_sweep
    from akka_game_of_life_tpu_torch.runtime import autotune

    default = autotune.default_tile_rows("conway")
    points = tune["conway"]["points"]
    b = next(p["block_rows"] for p in points if p["block_rows"] != default)
    defines = []
    real = packed_sweep._checked_library

    def spy(rule, variant):
        defines.append(variant)
        return real(rule, variant)

    packed_sweep._checked_library = spy
    try:
        zero_counts()
        text, run_s = run_cli(
            ["run", "--config", str(HEADLINE), "--obs-digest", "--kernel", "pallas",
             "--pallas-block-rows", str(b), "--checkpoint-dir", str(tmp / "tuned-ckpt"),
             "--device", SINGLE],
            "headline_tuned_tile.log",
        )
    finally:
        packed_sweep._checked_library = real
    counts = read_counts()
    check(counts["packed_sweep"] == headline["sweeps"], f"tuned headline launches {counts}")
    check(set(defines) == {packed_sweep.library_defines("conway", b)},
          f"tuned headline variants {set(defines)}")
    metrics, windows = parse_run(text)
    check(metrics == headline["metrics"], "tuned headline digests differ from the default tile's")
    check(windows == headline["windows"], "tuned headline windows differ")
    emit("tuned_tile", config=str(HEADLINE.relative_to(ROOT)), tile_rows=b,
         default_tile_rows=default, winner=points[0], launches=counts,
         digests={e: metrics[e][1] for e in metrics}, run_s=run_s,
         default_run_s=headline["run_s"], card=card["name_power"])
    return b


def selftest_phase(card):
    """``selftest`` for auto and pallas: every check passes, ``sharded``
    skips on one card and passes on more, and each line names the CUDA
    path."""
    import torch

    cards = torch.cuda.device_count()
    for kernel in ("auto", "pallas", "matmul"):
        text, run_s = run_cli(["selftest", "--kernel", kernel, "--device", SELFTEST_DEVICE],
                              f"selftest_{kernel}.log")
        recs = {r["check"]: r for r in
                (json.loads(line) for line in text.splitlines() if line.startswith("{"))}
        check(len(recs) == 7, f"selftest {kernel}: {sorted(recs)}")
        for name, rec in recs.items():
            # The banded products have no sharded form: matmul never meshes.
            want = "skip" if name == "sharded" and (cards < 2 or kernel == "matmul") else "pass"
            check(rec["status"] == want, f"selftest {kernel} {name}: {rec}")
            check(rec["backend"] == SELFTEST_DEVICE, f"selftest {kernel} {name}: {rec}")
        want = "matmul" if kernel == "matmul" else "sweep"
        for name in ("gun-phase", "oracle", "checkpoint", "chaos", "obs-defer"):
            check(recs[name]["resolved"] == want, f"selftest {kernel} {name}: {recs[name]}")
        check(recs["families"]["resolved"] == "wireworld=gen_sweep, ltl=dense",
              f"selftest {kernel} families: {recs['families']}")
        emit("selftest", kernel=kernel, checks=list(recs.values()), run_s=run_s,
             cards=cards, card=card["name_power"])


# -- the headline with the rest of run -------------------------------------------


def _headline_run(args, log_name, tmp: Path, tag: str):
    """The headline through the CLI with extra flags and its own checkpoint
    directory; returns (text, wall s, launches, metrics, windows)."""
    zero_counts()
    text, run_s = run_cli(
        ["run", "--config", str(HEADLINE), "--obs-digest", "--device", SINGLE,
         "--checkpoint-dir", str(tmp / f"{tag}-ckpt"), *args],
        log_name,
    )
    metrics, windows = parse_run(text)
    return text, run_s, read_counts(), metrics, windows


def _checkpoint_lines(text):
    return re.findall(r"^\[profile\] (checkpoint@\d+(?: \(async write\))?): ([\d.]+) ms$",
                      text, re.M)


def headline_machinery(headline, tmp: Path, card):
    """The headline with an injected crash (and the metrics file and event
    log), with deferred observation, and with synchronous checkpoints: each
    against the default run's digests (and windows)."""
    from akka_game_of_life_tpu_torch.obs import CATALOG
    from akka_game_of_life_tpu_torch.runtime.checkpoint import describe_store

    want, windows_want, sweeps = headline["metrics"], headline["windows"], headline["sweeps"]
    # An injected crash after the epoch-120 checkpoint, replayed from it.
    chaos_toml = tmp / "headline-chaos.toml"
    chaos_toml.write_text(HEADLINE.read_text() + CHAOS_TOML)
    prom, events_path = tmp / "chaos.prom", tmp / "chaos-events.jsonl"
    text, chaos_s, counts, metrics, _ = _headline_run(
        ["--config", str(chaos_toml), "--inject-faults", "--metrics-file", str(prom),
         "--log-events", str(events_path), "--flight-dir", str(tmp / "flight")],
        "headline_chaos.log", tmp, "chaos",
    )
    check(metrics == want, "headline with an injected crash: digests differ")
    events = [json.loads(line) for line in events_path.read_text().splitlines()]
    crashes = [e for e in events if e["event"] == "crash_injected"]
    recovered = [e for e in events if e["event"] == "crash_recovered"]
    check([e["epoch"] for e in crashes] == [180], f"crashes {crashes}")
    check([(e["restored_from"], e["replayed"]) for e in recovered] == [(120, 60)],
          f"recoveries {recovered}")
    check(counts["packed_sweep"] == sweeps + 6, f"chaos launches {counts} (replay: 6 sweeps)")
    names = {line.split()[2] for line in prom.read_text().splitlines()
             if line.startswith("# TYPE ")}
    missing = sorted(name for name, *_ in CATALOG if name not in names)
    check(not missing, f"--metrics-file lacks {missing}")
    emit("headline_chaos", crash_epochs=[e["epoch"] for e in crashes],
         restored_from=recovered[0]["restored_from"], replayed=recovered[0]["replayed"],
         launches=counts, metric_names=len(names), run_s=chaos_s, card=card["name_power"])

    # Deferred observation: the same digests and probe windows.
    text, defer_s, counts, metrics, windows = _headline_run(
        ["--obs-defer"], "headline_obs_defer.log", tmp, "defer")
    check(metrics == want and windows == windows_want, "--obs-defer: digests or windows differ")
    check(counts["packed_sweep"] == sweeps, f"--obs-defer launches {counts}")
    emit("headline_obs_defer", run_s=defer_s, default_run_s=headline["run_s"],
         windows_checked=sorted(windows), card=card["name_power"])

    # Synchronous checkpoints against the default writer thread.
    text, sync_s, counts, metrics, _ = _headline_run(
        ["--checkpoint-sync"], "headline_checkpoint_sync.log", tmp, "sync")
    check(metrics == want, "--checkpoint-sync: digests differ")
    default_ck = {i["epoch"]: i for i in describe_store(str(headline["ckpt"]))}
    sync_ck = {i["epoch"]: i for i in describe_store(str(tmp / "sync-ckpt"))}
    check(sorted(default_ck) == sorted(sync_ck) == [120, 240], f"checkpoints {sorted(sync_ck)}")
    for epoch in (120, 240):
        check(default_ck[epoch]["digest"] == sync_ck[epoch]["digest"]
              and default_ck[epoch]["bytes"] == sync_ck[epoch]["bytes"],
              f"checkpoint {epoch}: async {default_ck[epoch]} != sync {sync_ck[epoch]}")
    emit("headline_checkpoint_writer", async_run_s=headline["run_s"], sync_run_s=sync_s,
         async_lines=_checkpoint_lines(headline["text"]), sync_lines=_checkpoint_lines(text),
         digests={e: sync_ck[e]["digest"] for e in sync_ck}, card=card["name_power"])


def headline_interrupt(headline, tmp: Path, card):
    """SIGINT to a paced headline process once it has printed epoch 180 and
    its epoch-120 checkpoint is on disk: exit 130 and an interrupt
    checkpoint at epoch 180; a resume from it reaches the default run's
    epoch-240 digest; ``checkpoints --validate`` passes."""
    from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore

    ckpt = tmp / "interrupt-ckpt"
    env = {**os.environ,
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        _port_cli("run", "--config", str(HEADLINE), "--obs-digest", "--device", SINGLE,
                  "--tick", INTERRUPT_TICK, "--checkpoint-dir", str(ckpt),
                  "--flight-dir", str(tmp / "flight")),
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        lines: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=_reader, args=(proc, OUT / "headline_interrupt.log", lines),
                         daemon=True).start()
        _await_line(lines, r"^epoch 180: pop=", time.monotonic() + WAIT_S, "epoch 180", proc)
        first = ckpt / f"ckpt_{120:012d}.npz"
        deadline = time.monotonic() + WAIT_S
        while not first.exists():
            check(time.monotonic() < deadline, "no epoch-120 checkpoint")
            time.sleep(0.05)
        signalled_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=WAIT_S)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    (OUT / "headline_interrupt.stderr").write_text(err)
    check(proc.returncode == 130, f"interrupted run exited {proc.returncode}")
    m = re.search(r"interrupted at epoch (\d+); checkpoint written", err)
    check(m is not None, "no interrupt checkpoint line")
    epoch = int(m.group(1))
    check(epoch == 180 and CheckpointStore(str(ckpt)).latest_epoch() == epoch,
          f"interrupt checkpoint at {epoch}")
    zero_counts()
    text, resume_s = run_cli(
        ["run", "--config", str(HEADLINE), "--obs-digest", "--device", SINGLE,
         "--checkpoint-dir", str(ckpt)],
        "headline_interrupt_resume.log",
    )
    resumed, _ = parse_run(text)
    check(resumed.get(240) == headline["metrics"][240],
          f"resume from the interrupt checkpoint: {resumed.get(240)}")
    text, validate_s = run_cli(["checkpoints", str(ckpt), "--validate"],
                               "headline_interrupt_checkpoints.log")
    infos = [json.loads(line) for line in text.splitlines()]
    check(infos and all(i.get("ok") and i.get("digest_ok") for i in infos),
          f"checkpoints --validate: {infos}")
    emit("headline_interrupt", signalled_after_s=signalled_s, interrupt_epoch=epoch,
         resumed_digest=resumed[240][1], checkpoints=infos, resume_run_s=resume_s,
         validate_s=validate_s, card=card["name_power"])


def _device_busy(trace_path: Path):
    """The device-busy share of a ``torch.profiler`` Chrome trace: the union
    of the device intervals (kernels, copies, sets) over the traced window,
    and the device operations by total time."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    busy, reach = 0.0, start
    for e in sorted(device, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], reach), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
            reach = hi
    by_name = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_ms": (end - start) / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / (end - start),
        "device_events": len(device),
        "top_device_ops_ms": [(name[:120], dur / 1e3) for name, dur in top],
    }


def headline_trace(headline, tmp: Path, card):
    """The headline under ``--trace-dir``: the device-busy share of the
    traced wall and the top device operations, read from the trace."""
    from akka_game_of_life_tpu_torch.runtime import profiling

    trace_dir = tmp / "trace"
    text, run_s, counts, metrics, _ = _headline_run(
        ["--trace-dir", str(trace_dir)], "headline_trace.log", tmp, "trace")
    check(metrics == headline["metrics"], "--trace-dir: digests differ")
    check(re.search(r"^\[profile\] cuda:0: \{", text, re.M) is not None,
          "no end-of-run [profile] device line")
    busy = _device_busy(trace_dir / profiling.TRACE_FILE)
    check(busy["device_events"] > 0, "the trace holds no device operation")
    emit("headline_trace", **busy, run_s=run_s, default_run_s=headline["run_s"],
         trace_mib=(trace_dir / profiling.TRACE_FILE).stat().st_size / 2**20,
         card=card["name_power"])
    return busy


# -- the mesh ---------------------------------------------------------------


def mesh_devices(card):
    """Four distinct cards where the machine has them, else four slots on
    card 0."""
    import torch

    n = torch.cuda.device_count()
    if n >= MESH_SLOTS:
        devices = [f"cuda:{i}" for i in range(MESH_SLOTS)]
        which = f"{MESH_SLOTS} distinct cards"
    else:
        devices = [SINGLE] * MESH_SLOTS
        which = f"{SINGLE} in all {MESH_SLOTS} slots ({n} card(s) visible)"
    emit("mesh_devices", devices=devices, which=which, card=card["name_power"])
    return devices


def mesh_sweeps(config, mesh_shape, start: int, end: int) -> int:
    """Sweep launches of epochs (start, end] on a mesh, from the design: the
    mesh's tiles hold a whole call's generations in their halos (p = s rows;
    on two mesh columns hw = 2 words, good for 63 generations), so each call
    is one exchange and every tile runs the single-device sweeps of the
    call."""
    return mesh_shape[0] * mesh_shape[1] * planned_sweeps(config, start, end)


def run_sim(config, devices, log_name: str):
    """The port's Simulation as ``run`` drives it, on ``devices``: advance
    to ``max_epochs``; returns (output text, wall seconds, mesh shape)."""
    import torch

    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    buf = io.StringIO()
    observer = BoardObserver(
        render_every=config.render_every, render_max_cells=config.render_max_cells,
        metrics_every=config.metrics_every, out=buf,
    )
    t0 = time.perf_counter()
    with Simulation(config, observer=observer, device=devices) as sim:
        sim.advance(max(0, config.max_epochs - sim.epoch))
        for dev in set(devices):
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        mesh = None if sim.mesh is None else sim.mesh.shape
    (OUT / log_name).write_text(buf.getvalue())
    return buf.getvalue(), seconds, mesh


def _check_pattern_run(name, text, expected, epochs):
    metrics, windows = parse_run(text)
    check(sorted(metrics) == epochs, f"{name}: metrics epochs {sorted(metrics)}")
    for epoch in epochs:
        pop, dig, win = expected[epoch]
        check(metrics[epoch] == (pop, dig),
              f"{name} epoch {epoch}: {metrics[epoch]} != reference {(pop, dig)}")
        if win is not None:
            check(windows.get(epoch) == win, f"{name} epoch {epoch}: probe window differs")
    return metrics


def mesh_headline(devices, single, tmp: Path, card):
    """The headline on (4, 1) with checkpoints, resumed from its middle
    checkpoint on one card, the single-device run's middle checkpoint
    resumed on the mesh, then the headline on (2, 2): every digest equal to
    the CPU reference, launches equal to the plan."""
    import dataclasses

    from akka_game_of_life_tpu_torch.runtime.config import load_config

    base = load_config(str(HEADLINE), {"obs_digest": True})
    expected, epochs = single["expected"], cadence(base)
    last, mid = base.max_epochs, base.checkpoint_every
    cells = base.height * base.width * base.max_epochs
    runs = {}
    for shape in ((4, 1), (2, 2)):
        ckpt = tmp / f"mesh{shape[0]}{shape[1]}-ckpt" if shape == (4, 1) else None
        config = dataclasses.replace(
            base, mesh_shape=shape, checkpoint_dir=None if ckpt is None else str(ckpt)
        )
        want = mesh_sweeps(config, shape, 0, last)
        zero_counts()
        text, run_s, got_shape = run_sim(config, devices, f"mesh{shape[0]}x{shape[1]}_headline.log")
        counts = read_counts()
        check(got_shape == shape, f"headline mesh {got_shape} != {shape}")
        check(counts == {"packed_sweep": want, "gen_sweep": 0, "ltl_sweep": 0},
              f"headline on {shape}: launches {counts}, expected {want}")
        metrics = _check_pattern_run(f"headline on {shape}", text, expected, epochs)
        runs[shape] = (metrics, counts, run_s)

    # The meshed run's middle checkpoint resumed on one card (the CLI).
    resume = tmp / "mesh-resume-single"
    resume.mkdir()
    shutil.copy(tmp / "mesh41-ckpt" / f"ckpt_{mid:012d}.npz", resume)
    zero_counts()
    text, _ = run_cli(
        ["run", "--config", str(HEADLINE), "--obs-digest",
         "--checkpoint-dir", str(resume), "--device", SINGLE],
        "mesh_resume_single.log",
    )
    resumed, _ = parse_run(text)
    check(resumed.get(last) == runs[(4, 1)][0][last],
          f"meshed checkpoint resumed on one card: {resumed.get(last)}")
    check(read_counts()["packed_sweep"] == planned_sweeps(base, mid, last),
          "meshed checkpoint resumed on one card: launches")
    # The single-device run's middle checkpoint resumed on the mesh.
    resume = tmp / "single-resume-mesh"
    resume.mkdir()
    shutil.copy(single["ckpt"] / f"ckpt_{mid:012d}.npz", resume)
    config = dataclasses.replace(base, mesh_shape=(4, 1), checkpoint_dir=str(resume))
    zero_counts()
    text, _, _ = run_sim(config, devices, "single_resume_mesh.log")
    on_mesh, _ = parse_run(text)
    check(on_mesh.get(last) == runs[(4, 1)][0][last],
          f"single-device checkpoint resumed on the mesh: {on_mesh.get(last)}")
    check(read_counts()["packed_sweep"] == mesh_sweeps(config, (4, 1), mid, last),
          "single-device checkpoint resumed on the mesh: launches")
    for shape, (metrics, counts, run_s) in runs.items():
        emit(
            "main_path", config=f"Simulation({HEADLINE.name}, mesh_shape={shape})",
            kernel="sharded_sweep", devices=devices, epochs=last, launches=counts,
            digests={e: metrics[e][1] for e in epochs},
            run_s=run_s, run_cell_updates_per_s=cells / run_s,
            single_device_run_s=single["run_s"],
            single_device_run_cell_updates_per_s=cells / single["run_s"],
            resumed_from=mid if shape == (4, 1) else None,
            card=card["name_power"],
        )
    return runs[(4, 1)][1]["packed_sweep"]


def mesh_wireworld(devices, single, card):
    """WireWorld on (2, 2) through the sharded plane sweep: the CPU
    reference's digests, windows and head count at every cadence epoch."""
    import dataclasses

    from akka_game_of_life_tpu_torch.runtime.config import load_config

    config = dataclasses.replace(
        load_config(str(WIREWORLD), {"obs_digest": True}), mesh_shape=(2, 2),
        checkpoint_dir=None,
    )
    want = mesh_sweeps(config, (2, 2), 0, config.max_epochs)
    zero_counts()
    text, run_s, shape = run_sim(config, devices, "mesh2x2_wireworld.log")
    counts = read_counts()
    check(shape == (2, 2), f"wireworld mesh {shape}")
    check(counts == {"packed_sweep": 0, "gen_sweep": want, "ltl_sweep": 0},
          f"wireworld on (2, 2): launches {counts}, expected {want}")
    epochs = cadence(config)
    metrics = _check_pattern_run("wireworld on (2, 2)", text, single["expected"], epochs)
    cells = config.height * config.width * config.max_epochs
    emit(
        "main_path", config=f"Simulation({WIREWORLD.name}, mesh_shape=(2, 2))",
        kernel="sharded_gen_sweep", devices=devices, epochs=config.max_epochs,
        launches=counts, digests={e: metrics[e][1] for e in epochs},
        run_s=run_s, run_cell_updates_per_s=cells / run_s,
        single_device_run_s=single["run_s"], card=card["name_power"],
    )
    return counts["gen_sweep"]


def mesh_bugs(devices, dense, dense_s, card):
    """bugs at 16384² on (2, 2) through the sharded dense step (the LtL
    kernel has no sharded form): the plain dense run's digests, no kernel
    launched."""
    from akka_game_of_life_tpu_torch.runtime.config import load_config

    config = load_config(None, {
        "rule": "bugs", "height": LTL_FULL_SHAPE[0], "width": LTL_FULL_SHAPE[1],
        "seed": 0, "max_epochs": 60, "steps_per_call": 10, "metrics_every": 10,
        "obs_digest": True, "mesh_shape": (2, 2),
    })
    zero_counts()
    text, run_s, shape = run_sim(config, devices, "mesh2x2_bugs.log")
    counts = read_counts()
    metrics, _ = parse_run(text)
    check(shape == (2, 2), f"bugs mesh {shape}")
    check(sum(counts.values()) == 0, f"bugs on (2, 2) launched kernels: {counts}")
    check(metrics == dense, "bugs on (2, 2): digests differ from the plain dense run's")
    cells = config.height * config.width * config.max_epochs
    emit(
        "main_path", config="Simulation(bugs 16384², mesh_shape=(2, 2))",
        kernel="dense (halo.sharded_step_fn)", devices=devices, epochs=60,
        launches=counts, digests={e: metrics[e][1] for e in sorted(metrics)},
        run_s=run_s, run_cell_updates_per_s=cells / run_s,
        single_device_dense_run_s=dense_s, card=card["name_power"],
    )


def mesh_parity(errors, rng, devices, card):
    """The sharded sweeps against the plain sharded steppers on the card,
    bit for bit, tile by tile, on random words and planes, and against the
    plain step of the whole torus on one card (which shares no exchange
    code with either): every parity mesh at 10, 31 and 60 generations per
    call; (2, 2) one-word, 31-row tiles at 31 (the row halo fills the tile
    and s = 32·hw − 1); and the main path's own tiles (random, so every halo
    carries set bits): the headline's words on (4, 1) and (2, 2) at 60,
    WireWorld's planes on (2, 2) at 10."""
    import numpy as np
    import torch

    from akka_game_of_life_tpu_torch import parallel
    from akka_game_of_life_tpu_torch.ops import bitpack, bitpack_gen

    cases = [
        (kind, shape, (1024 * shape[0], 64 * shape[1]), steps)
        for shape in MESH_PARITY_SHAPES for steps in MESH_PARITY_STEPS
        for kind in ("words", "planes")
    ] + [(kind, (2, 2), (62, 2), 31) for kind in ("words", "planes")] + MESH_MAIN_CASES
    for kind, shape, (h, nw), steps in cases:
        n = shape[0] * shape[1]
        mesh = parallel.make_grid_mesh(shape, devices[:n])
        if kind == "words":
            name, lead, rule = "sharded_sweep", (), "conway"
            fast = parallel.sharded_sweep_step_fn(mesh, rule, steps_per_call=steps)
            plain = parallel.sharded_packed2d_step_fn(mesh, rule, steps_per_call=steps)
            torus = bitpack.packed_multi_step
        else:
            name, lead, rule = "sharded_gen_sweep", (2,), "wireworld"
            fast = parallel.sharded_gen_sweep_step_fn(mesh, rule, steps_per_call=steps)
            plain = parallel.sharded_gen_step_fn(mesh, rule, steps_per_call=steps)
            torus = bitpack_gen.gen_multi_step
        host = rng.integers(0, 2**32, size=(*lead, h, nw), dtype=np.uint32)
        x = parallel.shard_board(host, mesh)
        got, want = fast(x), plain(x)
        whole = torus(torch.from_numpy(host.view(np.int32)).to(devices[0]), rule, steps)
        th, tw = h // shape[0], nw // shape[1]
        for i, (a, b) in enumerate(zip(got, want)):
            r, c = mesh.coords(i)
            what = f"{shape} {(*lead, h, nw)} s={steps} tile {i}"
            errors.hold(name, a, b, what)
            cut = whole[..., r * th : (r + 1) * th, c * tw : (c + 1) * tw]
            errors.hold(name, a, cut.to(a.device), f"{what} vs the whole torus")
        del host, x, got, want, whole
        torch.cuda.empty_cache()
    emit(
        "kernel_vs_plain", kernel="sharded_sweep + sharded_gen_sweep",
        replaces="akka_game_of_life_tpu/parallel/pallas_halo.py:163,216",
        cases=[[c[0], list(c[1]), list(c[2]), c[3]] for c in cases],
        tile_checks={k: errors.checks[k] for k in ("sharded_sweep", "sharded_gen_sweep")},
        max_abs_err={k: errors.max[k] for k in ("sharded_sweep", "sharded_gen_sweep")},
        card=card["name_power"],
    )


def mesh_timing(card, rng, devices, two_process):
    """On the headline's (4, 1) and (2, 2) tiles and WireWorld's (2, 2)
    tiles: one halo exchange, one sweep of one padded tile (against its
    bound and its plain version), and one 60-generation call of the
    sharded stepper over all four tiles; then the two-process (4, 1) call
    and staged exchange (``two_process``, from the distributed pair)
    beside the one-process numbers."""
    import numpy as np
    import torch

    from akka_game_of_life_tpu_torch import bench, parallel
    from akka_game_of_life_tpu_torch.ops import gen_sweep, packed_sweep
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
    from akka_game_of_life_tpu_torch.parallel.packed_halo2d import refresh_halos

    rate, k = card["int32_ops_per_s"], packed_sweep.DEFAULT_STEPS_PER_SWEEP
    conway, wire = resolve_rule("conway"), resolve_rule("wireworld")
    out = {}
    for label, shape, m, rule, board_words, spc in (
        ("headline", (4, 1), 1, conway, FULL_SHAPE, 60),
        ("headline", (2, 2), 1, conway, FULL_SHAPE, 60),
        ("wireworld", (2, 2), 2, wire, GEN_WIRE_SHAPE, 10),
    ):
        mesh = parallel.make_grid_mesh(shape, devices)
        th, tw = board_words[0] // shape[0], board_words[1] // shape[1]
        step = (parallel.sharded_sweep_step_fn if m == 1 else parallel.sharded_gen_sweep_step_fn)(
            mesh, rule, steps_per_call=spc)
        plan = step.plan((th, tw))
        p, hw = plan.halo_rows, plan.halo_words
        lead = () if m == 1 else (m,)
        padded = [
            torch.from_numpy(rng.integers(0, 2**32, size=(*lead, th + 2 * p, tw + 2 * hw),
                                          dtype=np.uint32).view(np.int32)).to(dev)
            for dev in mesh.devices
        ]
        exchange_ms = bench.time_ms(lambda: refresh_halos(padded, mesh, p, hw), reps=20)
        moved = 0  # bytes of halo strips each exchange reads and writes
        if shape[1] > 1:
            moved += mesh.size * 2 * m * th * hw * 4
        moved += mesh.size * 2 * m * p * (tw + 2 * hw) * 4
        tile = padded[0]
        h_pad, nw_pad = tile.shape[-2:]
        if m == 1:
            ms = bench.time_ms(lambda: packed_sweep._launch(tile, rule, k), reps=20)
            plain = bench.time_ms(lambda: packed_sweep.packed_sweep_reference(tile, rule, k), reps=3, warmup=1)
            bound = bench.sweep_bound(h_pad, nw_pad, k, rule, rate)
        else:
            ms = bench.time_ms(lambda: gen_sweep._launch(tile, rule, k), reps=20)
            plain = bench.time_ms(lambda: gen_sweep.gen_sweep_reference(tile, rule, k), reps=3, warmup=1)
            bound = bench.gen_sweep_bound(m, h_pad, nw_pad, k, rule, rate)
        tiles = [t[..., p : p + th, hw : hw + tw].contiguous() for t in padded]
        call_ms = bench.time_ms(lambda: step(tiles), reps=5, warmup=1)
        del padded, tiles
        torch.cuda.empty_cache()
        name = "sharded_sweep" if m == 1 else "sharded_gen_sweep"
        emit(
            "timing", kernel=name, config=label, mesh=list(shape), devices=devices,
            tile_words=[th, tw], padded_tile=[h_pad, nw_pad], planes=m, k=k,
            plan={"depths": list(plan.depths), "halo_rows": p, "halo_words": hw},
            exchange_ms=exchange_ms, exchange_bytes=moved,
            exchange_bound_ms=2 * moved / bench.HBM_BYTES_PER_S * 1e3,
            ms_per_tile_sweep=ms, plain_ms=plain, **bound,
            share_of_bound=bound["bound_ms"] / ms,
            call_ms=call_ms, steps_per_call=spc, library_ms=None,
            library_note="no single PyTorch call computes this step",
            card=card["name_power"],
        )
        if (label, shape) in (("headline", (4, 1)), ("wireworld", (2, 2))):
            out[name] = (ms, plain, bound)
        if (label, shape) == ("headline", (4, 1)):
            one = {"exchange_ms": exchange_ms, "call_ms": call_ms}
    emit(
        "timing", kernel="sharded_sweep", config="headline", mesh=[4, 1],
        processes=DIST_RANKS, slots_per_process=DIST_SLOTS, transport="staged over gloo",
        two_process={r["rank"]: {k: r[k] for k in ("exchange_ms", "call_ms")}
                     for r in two_process},
        cross_process_bytes_per_exchange=two_process[0]["cross_process_bytes"],
        one_process=one, steps_per_call=60, card=card["name_power"],
    )
    return out


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
         "--kernel", "bitpack", "--device", SINGLE],
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


def _await_line(lines, pattern, deadline: float, what: str, proc=None):
    """The first line matching ``pattern``.  With the child ``proc`` given,
    fail as soon as it has exited without printing it, and at the deadline
    abort it (SIGABRT: the faulthandler writes its threads' stacks into its
    log) before failing."""
    while True:
        left = deadline - time.monotonic()
        if left <= 0 and proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGABRT)
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(timeout=10)
            time.sleep(1.0)  # the reader copies the stacks to the log
        check(left > 0, f"timed out waiting for {what}")
        try:
            line = lines.get(timeout=min(left, 1.0))
        except queue.Empty:
            check(proc is None or proc.poll() is None,
                  f"{what}: the process exited {proc and proc.returncode} first")
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
                               time.monotonic() + WAIT_S, "the frontend's port", fe).group(1))
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


# -- the serving plane and the host engines --------------------------------------

# The serve mix: (boards, class side); every eighth board of a class is
# smaller than its class or not square, and the 32² class carries
# SERVE_REPLICATORS replicator boards for the linear-rule fast-forward.
SERVE_MIX = [(128, 256), (384, 128), (384, 64), (128, 32)]
SERVE_RAGGED = {256: (200, 256), 128: (128, 100), 64: (50, 60), 32: (20, 32)}
SERVE_RULES = ["conway", "highlife", "seeds", "brians-brain", "star-wars"]
SERVE_REPLICATORS = 8
SERVE_EPOCHS = 64  # round 1: every board
SERVE_LONG = 1024  # round 2: the step bound, on a sample of the 32² class
SERVE_SAMPLE = 64
SERVE_FF = 2048  # past the bound: the replicators' fast-forward
SERVE_THREADS = 64  # concurrent HTTP clients
# The memo plane's design traffic: tenants on one board (a Gosper gun and
# its eater, period 30), 16 macro-rounds of the default 64-cell block.
MEMO_TENANTS = 64
MEMO_SIDE = 256
MEMO_EPOCHS = 256
CANARY_INTERVAL = "0.5s"
CANARY_WAIT_S = 5.0
# Host engines: run --backend actor-native, and in-process clusters of swar
# workers at 4096² and of actor-native workers.  The per-cell engine steps
# about 0.6 M cell-epochs/s on one host core, so its cluster runs at 512²,
# 8 epochs (4096² x 40 epochs would take ~20 minutes).
ACTOR_RUN = dict(side=256, epochs=32, spc=8)
SWAR_CLUSTER = dict(side=4096, epochs=40, width=10)
ACTOR_CLUSTER = dict(side=512, epochs=8, width=1)


def _http(base, method, path, doc=None, timeout=120):
    import urllib.error
    import urllib.request

    data = json.dumps(doc).encode() if doc is not None else None
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read()
            return resp.status, (json.loads(body) if path != "/metrics" else body.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _histogram(text: str, name: str):
    """(cumulative buckets [(le, count)], sum, count) of a histogram in a
    Prometheus exposition."""
    buckets = [
        (float(m.group(1)), float(m.group(2)))
        for m in re.finditer(rf'^{name}_bucket{{le="([^"]+)"}} (\S+)$', text, re.M)
    ]
    total = float(re.search(rf"^{name}_sum (\S+)$", text, re.M).group(1))
    count = float(re.search(rf"^{name}_count (\S+)$", text, re.M).group(1))
    return buckets, total, count


def _quantile_bound(buckets, count, q):
    """The upper bound of the bucket holding quantile ``q``."""
    for le, cum in buckets:
        if cum >= q * count:
            return le
    return float("inf")


def serve_specs():
    """The 1024 sessions of the serve mix: (rule, height, width, seed, class)."""
    specs = []
    for boards, side in SERVE_MIX:
        for i in range(boards):
            h, w = SERVE_RAGGED[side] if i % 8 == 7 else (side, side)
            rule = SERVE_RULES[i % len(SERVE_RULES)]
            if side == 32 and i % 16 == 3 and sum(s[0] == "replicator" for s in specs) < SERVE_REPLICATORS:
                rule = "replicator"
            specs.append((rule, h, w, 1000 + len(specs), side))
    return specs


def _class_batches(specs, steps, pad: bool):
    """Per size class: (indices, the batch operands of ``batch_step_fn``
    with every board at ``steps``), boards made as the server makes them,
    the batch padded to a power of two as the server pads it or not."""
    import numpy as np

    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
    from akka_game_of_life_tpu_torch.serve import batch as sbatch
    from akka_game_of_life_tpu_torch.utils.patterns import random_grid

    out = {}
    for _, side in SERVE_MIX:
        idx = [i for i, s in enumerate(specs) if s[4] == side]
        b = sbatch.next_pow2(len(idx)) if pad else len(idx)
        boards = np.zeros((b, side, side), np.uint8)
        ops = [np.zeros(b, np.uint32), np.zeros(b, np.uint32), np.full(b, 2, np.int32)]
        hs, ws, ns = np.ones(b, np.int32), np.ones(b, np.int32), np.zeros(b, np.int32)
        for j, i in enumerate(idx):
            rule, h, w, seed, _ = specs[i]
            boards[j, :h, :w] = random_grid((h, w), density=0.5, seed=seed)
            ops[0][j], ops[1][j], ops[2][j] = sbatch.rule_operands(resolve_rule(rule))
            hs[j], ws[j], ns[j] = h, w, steps
        out[side] = (idx, (boards, *ops, hs, ws, ns))
    return out


def _start_serve(tmp: Path, name: str, *flags):
    """A ``serve --device cuda:0`` process on an ephemeral port; returns
    (process, base URL, lines queue)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        _port_cli("serve", "--device", SINGLE, "--metrics-port", "0", *flags),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp,
    )
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=_reader, args=(proc, OUT / f"{name}.log", lines), daemon=True).start()
    m = _await_line(lines, r"on :(\d+)", time.monotonic() + WAIT_S, f"{name} banner", proc)
    return proc, f"http://127.0.0.1:{m.group(1)}", lines


@contextlib.contextmanager
def _serving(tmp: Path, name: str, *flags):
    """A ``serve`` process for the block; on a clean exit SIGTERM must
    drain its router and exit 130, on an error it is killed."""
    proc, base, lines = _start_serve(tmp, name, *flags)
    try:
        yield base
    except BaseException:
        proc.kill()
        proc.wait(timeout=30)
        raise
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    check(rc == 130, f"{name} exited {rc} on SIGTERM, expected 130")
    text = (OUT / f"{name}.log").read_text()
    check("serve: drained" in text, f"{name} did not drain")


TAIL_LINES = 40  # of each process's log, printed when a serve phase fails


def _tails_on_failure(*logs):
    """Decorate a phase: when it fails, print the last TAIL_LINES lines of
    each named process log (``chiprun_out/<name>.log``) before the error,
    so the failure reads from this script's own output."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except BaseException:
                for name in logs:
                    path = OUT / f"{name}.log"
                    tail = (path.read_text(errors="replace").splitlines()[-TAIL_LINES:]
                            if path.exists() else ["(no log)"])
                    print(f"--- {fn.__name__} failed: the last {len(tail)} lines of "
                          f"{path.name} ---", *tail, sep="\n", flush=True)
                raise
        return run
    return wrap


def _steps_ok(results, epoch, what):
    for status, doc in results:
        check(status == 200, f"{what}: {status} {doc}")
        check(doc["epoch"] == epoch, f"{what}: epoch {doc['epoch']} != {epoch}")


def _timed(pool, fn, items):
    """``fn`` over ``items`` on the pool: (results, wall s, per-call s)."""
    def one(item):
        t0 = time.perf_counter()
        res = fn(item)
        return res, time.perf_counter() - t0

    t0 = time.perf_counter()
    got = list(pool.map(one, items))
    return [g[0] for g in got], time.perf_counter() - t0, sorted(g[1] for g in got)


def _oracle_digest(spec):
    """The numpy oracle's digest of a served board after ``steps`` epochs
    (a process pool's task: ``step_np`` is single-threaded numpy)."""
    from akka_game_of_life_tpu_torch.ops import digest as odigest
    from akka_game_of_life_tpu_torch.ops.npkernel import step_np
    from akka_game_of_life_tpu_torch.utils.patterns import random_grid

    rule, h, w, seed, steps = spec
    board = random_grid((h, w), density=0.5, seed=seed)
    for _ in range(steps):
        board = step_np(board, rule)
    return odigest.format_digest(odigest.value(odigest.digest_dense_np(board)))


@_tails_on_failure("serve")
def serve_phase(tmp: Path, card):
    """The ``serve`` role on the card at the JAX package's defaults: 1024
    sessions (16,384,000 cells at most) created and stepped through
    ``/boards`` by concurrent clients, every board's digest held against a
    CPU reference.  Returns round 1's digests, in ``serve_specs()`` order."""
    import numpy as np

    from akka_game_of_life_tpu_torch import bench
    from akka_game_of_life_tpu_torch.ops import digest as odigest
    from akka_game_of_life_tpu_torch.serve import batch as sbatch

    specs = serve_specs()
    cells = sum(h * w for _, h, w, _, _ in specs)
    check(len(specs) == sum(n for n, _ in SERVE_MIX) and cells <= 16_777_216,
          f"{len(specs)} sessions, {cells} cells")
    with _serving(tmp, "serve") as base, concurrent.futures.ThreadPoolExecutor(SERVE_THREADS) as pool:
        created, create_s, _ = _timed(pool, lambda s: _http(base, "POST", "/boards", {
            "tenant": f"t{s[3] % 16}", "rule": s[0], "height": s[1], "width": s[2], "seed": s[3],
        }), specs)
        for status, doc in created:
            check(status == 201, f"create: {status} {doc}")
        sids = [doc["id"] for _, doc in created]
        before = _http(base, "GET", "/metrics")[1]
        stepped, round1_s, lat1 = _timed(
            pool, lambda sid: _http(base, "POST", f"/boards/{sid}/step", {"steps": SERVE_EPOCHS}), sids)
        _steps_ok(stepped, SERVE_EPOCHS, "round 1")
        after = _http(base, "GET", "/metrics")[1]

        # Round 1 against the batched step on the CPU, class by class; the
        # same batches timed on the card (CUDA events).
        padded = _class_batches(specs, SERVE_EPOCHS, pad=True)
        batch_ms, ref_s = {}, 0.0
        for side, (idx, ops) in _class_batches(specs, SERVE_EPOCHS, pad=False).items():
            t0 = time.perf_counter()
            _, lanes = sbatch.batch_step_fn(side, SERVE_EPOCHS, "cpu")(*ops)
            ref_s += time.perf_counter() - t0
            ops = padded[side][1]
            fn = sbatch.batch_step_fn(side, SERVE_EPOCHS, SINGLE)
            _, card_lanes = fn(*ops)
            check(np.array_equal(card_lanes[: len(idx)].cpu().numpy(), lanes.numpy()),
                  f"class {side}: the card's lanes differ from the CPU's")
            for j, i in enumerate(idx):
                want = odigest.format_digest(odigest.value(lanes[j].numpy()))
                check(stepped[i][1]["digest"] == want,
                      f"round 1 board {i} {specs[i][:3]}: {stepped[i][1]['digest']} != {want}")
            batch_ms[side] = bench.time_ms(lambda: fn(*ops), reps=3, warmup=1)
        tick_b, tick_sum1, tick_n1 = _histogram(after, "gol_serve_tick_seconds")
        _, tick_sum0, tick_n0 = _histogram(before, "gol_serve_tick_seconds")
        size_b, _, size_n = _histogram(after, "gol_serve_batch_boards")
        step_b, step_sum, step_n = _histogram(after, "gol_serve_step_seconds")
        tick_s = tick_sum1 - tick_sum0
        device_s = sum(batch_ms.values()) / 1e3

        # Round 2: a sample of the 32² class at the step bound, and the
        # replicators past it (the fast-forward), against the numpy oracle.
        small = [i for i, s in enumerate(specs) if s[4] == 32 and s[0] != "replicator"][:SERVE_SAMPLE]
        reps = [i for i, s in enumerate(specs) if s[0] == "replicator"]
        long_, round2_s, lat2 = _timed(
            pool, lambda i: _http(base, "POST", f"/boards/{sids[i]}/step", {"steps": SERVE_LONG}), small)
        _steps_ok(long_, SERVE_EPOCHS + SERVE_LONG, "round 2")
        jumped, ff_s, _ = _timed(
            pool, lambda i: _http(base, "POST", f"/boards/{sids[i]}/step", {"steps": SERVE_FF}), reps)
        _steps_ok(jumped, SERVE_EPOCHS + SERVE_FF, "fast-forward")
        ff_count = float(re.search(r"^gol_serve_ff_jumps_total (\S+)$",
                                   _http(base, "GET", "/metrics")[1], re.M).group(1))
        check(ff_count == len(reps), f"{ff_count} fast-forward jumps, expected {len(reps)}")

        t0 = time.perf_counter()
        tasks = [(*specs[i][:4], SERVE_EPOCHS + SERVE_LONG) for i in small]
        tasks += [(*specs[i][:4], SERVE_EPOCHS + SERVE_FF) for i in reps]
        spawn = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(os.cpu_count() or 4, mp_context=spawn) as procs:
            wants = list(procs.map(_oracle_digest, tasks))
        ref_s += time.perf_counter() - t0
        for (status, doc), want, i in zip(long_ + jumped, wants, small + reps):
            check(doc["digest"] == want, f"board {i} {specs[i][:3]}: {doc['digest']} != {want}")
    emit(
        "serve", config=f"serve --device {SINGLE} (JAX defaults: 1024 sessions, 16777216 cells, "
        "classes 32,64,128,256, max_steps 1024)", sessions=len(specs), cells=cells,
        mix={side: n for n, side in SERVE_MIX}, rules=SERVE_RULES + ["replicator"],
        create_s=create_s, round1_s=round1_s, round1_boards_per_s=len(sids) / round1_s,
        round1_cell_updates_per_s=cells * SERVE_EPOCHS / round1_s,
        round1_client_p50_s=lat1[len(lat1) // 2], round1_client_p99_s=lat1[int(len(lat1) * 0.99)],
        batch_ms_per_class={str(k): v for k, v in batch_ms.items()},
        batch_sizes_cumulative={str(le): c for le, c in size_b}, batches=size_n,
        tick_seconds_round1=tick_s, ticks_round1=tick_n1 - tick_n0,
        step_seconds_p50_le=_quantile_bound(step_b, step_n, 0.5),
        step_seconds_p99_le=_quantile_bound(step_b, step_n, 0.99),
        step_seconds_mean=step_sum / step_n,
        host_share_est=1.0 - device_s / tick_s if tick_s > 0 else None,
        round2_boards=len(small), round2_s=round2_s, round2_client_p99_s=lat2[int(len(lat2) * 0.99)],
        ff_boards=len(reps), ff_s=ff_s, cpu_reference_s=ref_s, card=card["name_power"],
    )
    return [doc["digest"] for _, doc in stepped]


def _gun_board():
    import numpy as np

    from akka_game_of_life_tpu_torch.utils.patterns import get_pattern

    gun, eater = get_pattern("gosper-glider-gun"), get_pattern("eater")
    board = np.zeros((MEMO_SIDE, MEMO_SIDE), np.uint8)
    board[10 : 10 + gun.shape[0], 10 : 10 + gun.shape[1]] = gun
    board[50 : 50 + eater.shape[0], 63 : 63 + eater.shape[1]] = eater
    return board


def memo_phase(card):
    """``serve --serve-memo on``'s router on the card: MEMO_TENANTS tenants
    stepping the same gun board from concurrent clients; digests equal to
    the memo-off router's."""
    from akka_game_of_life_tpu_torch.obs.programs import get_programs
    from akka_game_of_life_tpu_torch.ops import digest as odigest
    from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
    from akka_game_of_life_tpu_torch.serve import SessionRouter

    board = _gun_board()
    got, walls, hit_rate = {}, {}, None
    for memo in (True, False):
        router = SessionRouter(SimulationConfig(role="serve", serve_memo=memo), device=SINGLE)
        with router:
            sids = [router.create(tenant=f"m{i}", height=MEMO_SIDE, width=MEMO_SIDE, seed=0,
                                  density=0.0, with_board=False)["id"] for i in range(MEMO_TENANTS)]
            with router._lock:  # the API seeds random boards; this traffic is one board
                for sid in sids:
                    sess = router._sessions[sid]
                    sess.board = board.copy()
                    sess.lanes = odigest.digest_dense_np(board)
                    sess.population = int(board.sum())
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(MEMO_TENANTS) as pool:
                got[memo] = list(pool.map(lambda sid: router.step(sid, MEMO_EPOCHS), sids))
            walls[memo] = time.perf_counter() - t0
            if memo:
                hit_rate = router.metrics.value("gol_serve_memo_hit_rate")
                epochs = sum(router.metrics.value("gol_serve_memo_epochs_total", tenant=f"m{i}") or 0
                             for i in range(MEMO_TENANTS))
                check(epochs > 0, "the memo plane carried no epochs")
    check(got[True] == got[False], "memo digests differ from memo-off")
    check(len(set(got[True])) == 1, "tenants of one board diverged")
    families = get_programs().family_summary()
    emit("serve_memo", tenants=MEMO_TENANTS, side=MEMO_SIDE, epochs=MEMO_EPOCHS,
         digest=f"{got[True][0][1]:016x}", memo_wall_s=walls[True], dense_wall_s=walls[False],
         hit_rate=hit_rate, memo_epochs=epochs,
         programs={f: families.get(f, {}).get("programs") for f in ("serve_batch", "serve_memo")},
         card=card["name_power"])


def canary_phase(tmp: Path, card):
    """``serve --serve-canary on`` for a few seconds: probes certified, none
    failed."""
    with _serving(tmp, "serve_canary", "--serve-canary", "on",
                  "--serve-canary-interval-s", CANARY_INTERVAL) as base:
        time.sleep(CANARY_WAIT_S)
        text = _http(base, "GET", "/metrics")[1]
    probes = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^gol_canary_probes_total{outcome="([^"]+)"} (\S+)$', text, re.M)}
    failures = re.search(r"^gol_canary_failures_total (\S+)$", text, re.M)
    check(probes.get("ok", 0) >= 3, f"canary probes {probes}")
    check(failures is None or float(failures.group(1)) == 0, f"canary failures: {failures.group(1)}")
    check(set(probes) == {"ok"}, f"canary outcomes {probes}")
    emit("serve_canary", probes=probes, seconds=CANARY_WAIT_S, card=card["name_power"])


# -- the serving cluster ---------------------------------------------------------
#
# ``serve --serve-cluster on`` at the JAX package's serve defaults (64
# shards, tile chunk 8, resident tiled sessions and replication on) with
# SC_WORKERS ``backend --device cuda`` workers on card 0: the serve mix of
# the single-process phase, then the runbook's 4096² mega-board
# (docs/OPERATIONS.md, ``bench_serve.py --mega-side 4096``), a SIGKILL in
# round 2 and a SIGTERM drain in round 3.  The session cap and the cell
# budget are the defaults' plus room for the mega-board (1024 + 8 sessions,
# 2^24 + 4096² cells), as bench_serve.py raises them for its drills, and
# the planner polls every 50 ms as bench_serve.py's does; the failure
# timeout is the JAX tests' 5 s.
SC_WORKERS = 3
SC_DEVICE = "cuda"  # each worker's --device
SC_MEGA_SIDE = 4096
SC_MEGA_SEED = 4096
SC_ROUND_EPOCHS = 64  # each traffic round steps every board this far
SC_CHUNK = 8  # serve_tile_chunk: one mega-board request = one barrier round
SC_TOML = """\
failure_timeout_s = "5s"
wait_for_backends_s = "240s"
rebalance_interval_s = "50ms"
serve_max_sessions = 1032
serve_max_cells = 33554432
"""


def _prom_family(text: str, name: str) -> float:
    """Sum of every series of ``name`` in a Prometheus exposition (0 when
    absent)."""
    return sum(float(m.group(1)) for m in re.finditer(
        rf"^{name}(?:{{[^}}]*}})? (\S+)$", text, re.M))


def _prom_label(text: str, name: str, label: str, value: str) -> float:
    m = re.search(rf'^{name}{{[^}}]*{label}="{re.escape(value)}"[^}}]*}} (\S+)$', text, re.M)
    return float(m.group(1)) if m else 0.0


def _sessions_reference(specs, steps):
    """Every serve-mix board's digest after ``steps`` epochs, by the batched
    step on the card from the seeds (checked against the CPU's at 64 epochs
    in the serve phase)."""
    from akka_game_of_life_tpu_torch.ops import digest as odigest
    from akka_game_of_life_tpu_torch.serve import batch as sbatch

    out = [None] * len(specs)
    for side, (idx, ops) in _class_batches(specs, steps, pad=True).items():
        _, lanes = sbatch.batch_step_fn(side, steps, SINGLE)(*ops)
        lanes = lanes.cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = odigest.format_digest(odigest.value(lanes[j]))
    return out


class _MegaReference:
    """The mega-board's digest at any epoch: its start board, packed on the
    card and advanced by the packed sweep (the cluster phase's reference)."""

    def __init__(self, side, seed):
        import torch

        from akka_game_of_life_tpu_torch.ops import bitpack
        from akka_game_of_life_tpu_torch.utils.patterns import random_grid

        self.side = side
        self.words0 = bitpack.pack(torch.from_numpy(random_grid((side, side), density=0.5,
                                                                seed=seed)).to(SINGLE))
        self.cache = {}

    def __call__(self, epoch: int) -> str:
        from akka_game_of_life_tpu_torch.ops import digest as odigest
        from akka_game_of_life_tpu_torch.ops import packed_sweep

        if epoch not in self.cache:
            words = self.words0
            if epoch:
                words = packed_sweep.packed_multi_step_fn("conway", epoch)(self.words0)
            lanes = odigest.digest_packed(words, self.side).cpu().numpy()
            self.cache[epoch] = odigest.format_digest(odigest.value(lanes))
        return self.cache[epoch]


class _Traffic:
    """One traffic round's client ledger: answers by status, the 404s on
    admitted sessions, the resume points read in a failover window and the
    client-observed promotion latency (first 429 ``failover`` to the next
    200) per session, and the seconds of each mega-board step request."""

    def __init__(self):
        self.lock = threading.Lock()
        self.answered = 0
        self.status = {}
        self.not_found = []
        self.resumed = {}  # key -> [(epoch, digest)] read in a failover window
        self.latency = []
        self.failures = []
        self.mega_s = []

    def note(self, status):
        with self.lock:
            self.answered += 1
            self.status[status] = self.status.get(status, 0) + 1


def _step_through_failover(base, key, sid, start, target, chunk, traffic, mega=False):
    """Step ``sid`` from ``start`` to the absolute epoch ``target`` in steps
    of at most ``chunk``, the tiled client contract: a 429 ``failover``
    means the board resumed at a certified epoch, read it back and step on
    from there.  Every call has a timeout, so a hang fails the phase."""
    epoch, t_fail = start, None
    while epoch < target:
        t0 = time.perf_counter()
        status, doc = _http(base, "POST", f"/boards/{sid}/step",
                            {"steps": min(chunk, target - epoch)})
        if mega:
            with traffic.lock:
                traffic.mega_s.append(time.perf_counter() - t0)
        traffic.note(status)
        if status == 200:
            epoch = int(doc["epoch"])
            if t_fail is not None:
                with traffic.lock:
                    traffic.latency.append(time.monotonic() - t_fail)
                t_fail = None
            continue
        if status == 404:
            with traffic.lock:
                traffic.not_found.append(sid)
            return
        if status != 429:
            with traffic.lock:
                traffic.failures.append((sid, status, doc))
            return
        if doc.get("reason") != "failover":
            time.sleep(0.05)  # a full queue: back off and retry
            continue
        t_fail = t_fail if t_fail is not None else time.monotonic()
        while True:  # the resume point, once the promotion has landed
            time.sleep(float(doc.get("retry_after_s", 0.1)))
            if mega:
                status, listed = _http(base, "GET", "/boards")
                row = next((r for r in listed.get("boards", []) if r["id"] == sid), None)
                if status == 200 and row is not None:
                    status, got = 200, row
                else:
                    status, got = 404, {}
            else:
                status, got = _http(base, "GET", f"/boards/{sid}")
            traffic.note(status)
            if status == 200:
                break
            if status == 404:
                with traffic.lock:
                    traffic.not_found.append(sid)
                return
            if status != 429:
                with traffic.lock:
                    traffic.failures.append((sid, status, got))
                return
            doc = got
        epoch = int(got["epoch"])
        with traffic.lock:
            traffic.resumed.setdefault(key, []).append((epoch, got["digest"]))


def _start_proc(argv, name, tmp):
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "PYTHONFAULTHANDLER": "1"}
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=tmp)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=_reader, args=(proc, OUT / f"{name}.log", lines), daemon=True).start()
    return proc, lines


def _traffic_round(base, pool, sids, starts, target, mega, mega_start, action, trigger):
    """One round: every session from its start to ``target`` and the mega
    board in SC_CHUNK requests, from the pool; ``action`` fires once
    ``trigger`` of the session steps have been answered.  Returns the
    ledger and the round's wall seconds."""
    traffic = _Traffic()
    fired = threading.Event()

    def watch():
        while not fired.is_set():
            with traffic.lock:
                due = traffic.answered >= trigger
            if due:
                action()
                fired.set()
            time.sleep(0.01)

    t0 = time.perf_counter()
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    # The mega-board first, so its rounds run while the sessions' do.
    futs = [pool.submit(_step_through_failover, base, "mega", mega, mega_start,
                        mega_start + SC_ROUND_EPOCHS, SC_CHUNK, traffic, True)]
    futs += [pool.submit(_step_through_failover, base, i, sid, starts[i], target,
                         target, traffic) for i, sid in enumerate(sids)]
    for f in futs:
        f.result()
    wall = time.perf_counter() - t0
    check(fired.is_set(), f"the round ended before its action fired ({traffic.answered} answers)")
    watcher.join(timeout=5)
    return traffic, wall


def _catch_up(base, pool, sids, mega, target, traffic):
    """After a round's promotions settle: a board the index rolled back to
    its certified epoch (its last step ran on the lost worker past what was
    replicated) has resumed there; record that resume point and step it on
    to ``target``.  Returns the listing at the end."""
    listed = {r["id"]: r for r in _http(base, "GET", "/boards")[1]["boards"]}
    behind = [(i, sid) for i, sid in enumerate(sids) if listed[sid]["epoch"] < target]
    behind += [("mega", mega)] if listed[mega]["epoch"] < target else []
    for key, sid in behind:
        with traffic.lock:
            traffic.resumed.setdefault(key, []).append(
                (listed[sid]["epoch"], listed[sid]["digest"]))
    list(pool.map(lambda ks: _step_through_failover(
        base, ks[0], ks[1], listed[ks[1]]["epoch"], target,
        SC_CHUNK if ks[0] == "mega" else target, traffic, ks[0] == "mega"), behind))
    return {r["id"]: r for r in _http(base, "GET", "/boards")[1]["boards"]}


def _worker_metrics(ports):
    return {name: _http(f"http://127.0.0.1:{port}", "GET", "/metrics")[1]
            for name, port in ports.items()}


def spread(seconds) -> dict:
    """p50, max and count of a list of request seconds."""
    xs = sorted(seconds)
    return {"p50_s": xs[len(xs) // 2] if xs else None, "max_s": xs[-1] if xs else None,
            "n": len(xs)}


def drain_split(events: Path, member: str) -> dict:
    """A drain of ``member`` read from the cluster frontend's event log:
    seconds from its DRAIN_REQUEST to its DRAIN_COMPLETE (None if it never
    completed), then per kind of move off it (session shards, resident
    chunks) the commits and aborts, the protocol rounds that carried them
    (a chunk event names its round's ``batch``), in all and per
    destination, the seconds from the request to the first and last
    commit, the longest gap between commits, and the sums over rounds
    (``sum_s``), the longest of each timed part (``max_s``) and the
    longest round (``seconds`` from the planner's start or the previous
    round's end to the commit, and its phases: ``hold_s`` is a chunk
    round's hold of the session's steplock; the fields the port's frontend
    adds to ``serve_shard_migrated`` / ``serve_tiled_chunk_migrated``; a
    log without them gives counts and gaps only)."""
    rows = [json.loads(line) for line in events.read_text().splitlines() if line.strip()]
    t0 = next((r["t_mono"] for r in rows if r["event"] == "drain_requested"
               and r.get("member") == member), None)
    t1 = next((r["t_mono"] for r in rows if r["event"] == "member_drained"
               and r.get("member") == member), None)
    out = {"member": member, "seconds": None if t0 is None or t1 is None else t1 - t0}
    for kind, done, aborted in (
        ("shard", "serve_shard_migrated", "serve_shard_migration_aborted"),
        ("chunk", "serve_tiled_chunk_migrated", "serve_tiled_chunk_migration_aborted"),
    ):
        mine = [r for r in rows if t0 is not None and r["t_mono"] >= t0
                and r.get("source") == member]
        moves = [r for r in mine if r["event"] == done]
        reasons = {}
        for r in mine:
            if r["event"] == aborted:
                reasons[str(r.get("reason"))[:60]] = reasons.get(str(r.get("reason"))[:60], 0) + 1
        # A round of n chunks logs n events with the round's times: each
        # counts 1/n toward the sums.
        share = [1.0 / r.get("batch", 1) for r in moves]
        d = {"moves": len(moves), "rounds": round(sum(share), 6), "aborts": reasons,
             "by_dest": {}}
        for r, w in zip(moves, share):
            to = d["by_dest"].setdefault(r.get("dest"), {"moves": 0, "rounds": 0.0})
            to["moves"] += 1
            to["rounds"] += w
        for to in d["by_dest"].values():
            to["rounds"] = round(to["rounds"], 6)
        if moves:
            times = [t0] + [r["t_mono"] for r in moves]
            timed = sorted({k for r in moves for k in r if k == "seconds" or k.endswith("_s")})
            d.update(first_s=times[1] - t0, last_s=times[-1] - t0,
                     max_gap_s=max(b - a for a, b in zip(times, times[1:])),
                     sum_s={k: sum(r.get(k, 0.0) * w for r, w in zip(moves, share))
                            for k in timed},
                     max_s={k: max(r.get(k, 0.0) for r in moves) for k in timed})
            if "seconds" in timed:
                longest = max(moves, key=lambda r: r.get("seconds", 0.0))
                d["longest"] = {k: longest[k] for k in timed if k in longest}
        out[kind] = d
    return out


@_tails_on_failure("serve_cluster", *(f"serve_cluster_sw{i}" for i in range(SC_WORKERS)))
def serve_cluster_phase(tmp: Path, card, single):
    """The serving cluster on the card: a ``serve --serve-cluster on``
    frontend process and SC_WORKERS ``backend --device cuda`` processes.
    Round 1 steps the serve mix (the single-process phase's digests must
    come back); the 4096² mega-board takes 64 epochs in 8 barrier rounds
    (its digest against the packed sweep's, its bytes per round
    O(perimeter)); round 2 SIGKILLs a worker (zero 404s, every op answered,
    promoted sessions certified at their resume epochs, the mega-board
    resumed at its certified epoch); round 3 SIGTERM-drains another (rc 0,
    no admitted job lost, resident chunks re-homed digest-certified in
    rounds of at most TILED_MOVE_ROUND_CHUNKS).  The mega-board's step
    requests are timed in each round."""
    from akka_game_of_life_tpu_torch.serve.cluster import TILED_MOVE_ROUND_CHUNKS

    specs = serve_specs()
    cells = sum(h * w for _, h, w, _, _ in specs)
    check(len(single) == len(specs), "the serve phase's digests")
    toml = tmp / "serve-cluster.toml"
    # The frontend's event log (drains, moves, promotions) beside its output.
    events = OUT / "serve_cluster.events.jsonl"
    events.unlink(missing_ok=True)
    toml.write_text(SC_TOML + f'log_events = "{events}"\n')
    procs, reserved = {}, {}
    try:
        t_boot = time.perf_counter()
        fe, fe_lines = _start_proc(_port_cli(
            "serve", "--serve-cluster", "on", "--config", str(toml), "--port", "0",
            "--metrics-port", "0", "--min-backends", str(SC_WORKERS)), "serve_cluster", tmp)
        procs["frontend"] = fe
        deadline = time.monotonic() + WAIT_S
        port = _await_line(fe_lines, r"listening on \S+:(\d+)", deadline, "the cluster port",
                           fe).group(1)
        names = [f"sw{i}" for i in range(SC_WORKERS)]
        # Each worker's /metrics, held until the worker has bound it.
        reserved.update((name, _reserve_port()) for name in names)
        ports = {name: sock.getsockname()[1] for name, sock in reserved.items()}
        worker_lines = {}
        for name in names:
            procs[name], worker_lines[name] = _start_proc(_port_cli(
                "backend", "--port", port, "--name", name, "--device", SC_DEVICE,
                "--metrics-port", str(ports[name])), f"serve_cluster_{name}", tmp)
        for name, lines in worker_lines.items():
            _await_line(lines, r"metrics on :(\d+)", deadline, f"{name} metrics", procs[name])
            reserved.pop(name).close()
        http_port = _await_line(fe_lines, r"on :(\d+) ", deadline, "the /boards port",
                                fe).group(1)
        base = f"http://127.0.0.1:{http_port}"
        boot_s = time.perf_counter() - t_boot
        health = _http(base, "GET", "/healthz")[1]["serve"]
        check(health["shards_total"] == 64 and health["tiled_resident"]["enabled"]
              and health["replication"]["enabled"], f"not the JAX defaults: {health}")
        while True:  # the late joiners' shards flip before any session lands
            by = _http(base, "GET", "/healthz")[1]["serve"]["shards_by_worker"]
            if len(by) == SC_WORKERS and max(by.values()) - min(by.values()) <= 2:
                break
            check(time.monotonic() < deadline, f"the shards never spread: {by}")
            time.sleep(0.05)

        with concurrent.futures.ThreadPoolExecutor(SERVE_THREADS) as pool:
            # -- round 1: the serve mix, against the single-process plane ---------
            created, create_s, _ = _timed(pool, lambda s: _http(base, "POST", "/boards", {
                "tenant": f"t{s[3] % 16}", "rule": s[0], "height": s[1], "width": s[2],
                "seed": s[3]}), specs)
            for status, doc in created:
                check(status == 201, f"cluster create: {status} {doc}")
            sids = [doc["id"] for _, doc in created]
            w_before = _worker_metrics(ports)
            stepped, round1_s, lat1 = _timed(pool, lambda sid: _http(
                base, "POST", f"/boards/{sid}/step", {"steps": SC_ROUND_EPOCHS}), sids)
            _steps_ok(stepped, SC_ROUND_EPOCHS, "cluster round 1")
            w_after = _worker_metrics(ports)
            for i, (_, doc) in enumerate(stepped):
                check(doc["digest"] == single[i], f"cluster round 1 board {i} {specs[i][:3]}: "
                      f"{doc['digest']} != the single-process plane's {single[i]}")
            per_worker = {name: {
                "tick_s": _prom_family(w_after[name], "gol_serve_tick_seconds_sum")
                - _prom_family(w_before[name], "gol_serve_tick_seconds_sum"),
                "ticks": _prom_family(w_after[name], "gol_serve_tick_seconds_count")
                - _prom_family(w_before[name], "gol_serve_tick_seconds_count"),
                "batched_call_s": _prom_label(w_after[name], "gol_program_device_seconds_total",
                                              "family", "serve_batch")
                - _prom_label(w_before[name], "gol_program_device_seconds_total",
                              "family", "serve_batch"),
            } for name in names}
            sessions_by_worker = _http(base, "GET", "/healthz")[1]["serve"]["sessions_by_worker"]
            check(len(sessions_by_worker) == SC_WORKERS, f"sessions on {sessions_by_worker}")

            # -- the mega-board: 256 resident chunks, 8 rounds of 8 ---------------
            ref = _MegaReference(SC_MEGA_SIDE, SC_MEGA_SEED)
            t0 = time.perf_counter()
            status, mega = _http(base, "POST", "/boards", {
                "rule": "conway", "height": SC_MEGA_SIDE, "width": SC_MEGA_SIDE,
                "seed": SC_MEGA_SEED})
            mega_create_s = time.perf_counter() - t0
            check(status == 201 and mega.get("kind") == "tiled" and mega.get("resident")
                  and mega.get("tiles") == (SC_MEGA_SIDE // 256) ** 2, f"mega create: {status} {mega}")
            check(mega["digest"] == ref(0), "the mega-board's start digest")
            chunks = _http(base, "GET", "/healthz")[1]["serve"]["tiled_resident"]["chunks_by_worker"]
            check(sorted(chunks) == names, f"mega chunks on {chunks}")
            m_before = _http(base, "GET", "/metrics")[1]
            round_s = []
            for r in range(SC_ROUND_EPOCHS // SC_CHUNK):
                t0 = time.perf_counter()
                status, doc = _http(base, "POST", f"/boards/{mega['id']}/step", {"steps": SC_CHUNK})
                round_s.append(time.perf_counter() - t0)
                check(status == 200 and doc["epoch"] == (r + 1) * SC_CHUNK, f"mega round {r}: {doc}")
            check(doc["digest"] == ref(SC_ROUND_EPOCHS),
                  f"mega-board at {SC_ROUND_EPOCHS}: {doc['digest']} != {ref(SC_ROUND_EPOCHS)}")
            m_after = _http(base, "GET", "/metrics")[1]
            n_rounds = _prom_family(m_after, "gol_serve_tiled_bytes_round_count") - _prom_family(
                m_before, "gol_serve_tiled_bytes_round_count")
            round_bytes = (_prom_family(m_after, "gol_serve_tiled_bytes_round_sum") - _prom_family(
                m_before, "gol_serve_tiled_bytes_round_sum")) / max(n_rounds, 1)
            # Every chunk's eight strips, k = 8 cells deep, one bit a cell.
            side, k = 256, SC_CHUNK
            perimeter_bytes = (SC_MEGA_SIDE // side) ** 2 * (4 * side * k + 4 * k * k) / 8
            area_bytes = SC_MEGA_SIDE * SC_MEGA_SIDE / 8
            check(n_rounds == SC_ROUND_EPOCHS // SC_CHUNK, f"{n_rounds} tiled rounds observed")
            check(0 < round_bytes <= perimeter_bytes * 1.01,
                  f"{round_bytes} B a round, over the perimeter's {perimeter_bytes}")
            tiled_w = _worker_metrics(ports)

            # -- round 2: SIGKILL a worker mid-round ------------------------------
            ref128 = _sessions_reference(specs, 2 * SC_ROUND_EPOCHS)
            victim = names[0]
            kill_t = {}

            def kill():
                kill_t["t"] = time.monotonic()
                procs[victim].kill()

            r2, round2_s = _traffic_round(
                base, pool, sids, [SC_ROUND_EPOCHS] * len(sids), 2 * SC_ROUND_EPOCHS,
                mega["id"], SC_ROUND_EPOCHS, kill, len(sids) // 3)
            procs[victim].wait(timeout=30)

            def settled(alive):
                doc = _http(base, "GET", "/healthz")[1]
                s = doc["serve"]
                return (doc["members_alive"] == alive
                        and s["replication"]["promotions_inflight"] == 0
                        and s["tiled_resident"]["promotions_inflight"] == 0)

            deadline = time.monotonic() + WAIT_S
            while not settled(SC_WORKERS - 1):
                check(time.monotonic() < deadline, "the promotions never settled")
                time.sleep(0.1)
            listed = _catch_up(base, pool, sids, mega["id"], 2 * SC_ROUND_EPOCHS, r2)
            check(not r2.not_found, f"404 on admitted sessions: {r2.not_found[:5]}")
            check(not r2.failures, f"round 2 failures: {r2.failures[:3]}")
            promoted = {k: v for k, v in r2.resumed.items() if k != "mega"}
            check(promoted, "no session resumed through a failover window")
            for i, seen in promoted.items():
                for epoch, digest in seen:
                    want = {SC_ROUND_EPOCHS: single[i], 2 * SC_ROUND_EPOCHS: ref128[i]}.get(epoch)
                    check(digest == want, f"promoted board {i} at {epoch}: {digest} != {want}")
            mega_resumes = r2.resumed.get("mega", [])
            check(mega_resumes, "the mega-board never resumed through the kill")
            for epoch, digest in mega_resumes:
                check(digest == ref(epoch), f"mega-board resumed at {epoch}: {digest} != {ref(epoch)}")
            check(len(listed) == len(sids) + 1, f"{len(listed)} sessions listed after the kill")
            for i, sid in enumerate(sids):
                check(listed[sid]["epoch"] == 2 * SC_ROUND_EPOCHS
                      and listed[sid]["digest"] == ref128[i], f"board {i} after round 2: {listed[sid]}")
            check(listed[mega["id"]]["epoch"] == 2 * SC_ROUND_EPOCHS
                  and listed[mega["id"]]["digest"] == ref(2 * SC_ROUND_EPOCHS),
                  f"mega-board after round 2: {listed[mega['id']]}")
            fe_metrics = _http(base, "GET", "/metrics")[1]
            check(_prom_family(fe_metrics, "gol_serve_promotions_total") >= 1, "no promotion")
            check(_prom_family(fe_metrics, "gol_serve_sessions_lost_total") == 0, "sessions lost")
            lat = sorted(r2.latency)
            check(lat, "no client saw a failover window close")
            promo = {"p50_s": lat[len(lat) // 2], "p99_s": lat[int(len(lat) * 0.99)], "n": len(lat)}
            print(f"serve_cluster promotion latency (client, first 429 failover to the next "
                  f"200): p50 {promo['p50_s']} s, p99 {promo['p99_s']} s over {len(lat)} "
                  f"sessions; {card['name_power']}", flush=True)

            # -- round 3: SIGTERM-drain a second worker mid-round -----------------
            ref192 = _sessions_reference(specs, 3 * SC_ROUND_EPOCHS)
            drained = names[1]
            held = _http(base, "GET", "/healthz")[1]["serve"]["tiled_resident"]["chunks_by_worker"]
            moved_before = _prom_family(fe_metrics, "gol_serve_tiled_chunk_migrations_total")
            r3, round3_s = _traffic_round(
                base, pool, sids, [2 * SC_ROUND_EPOCHS] * len(sids), 3 * SC_ROUND_EPOCHS,
                mega["id"], 2 * SC_ROUND_EPOCHS, lambda: procs[drained].send_signal(signal.SIGTERM),
                len(sids) // 3)
            rc = procs[drained].wait(timeout=WAIT_S)
            split = drain_split(events, drained)
            print(f"serve_cluster drain of {drained}: rc {rc}, {json.dumps(split)}; "
                  f"{card['name_power']}", flush=True)
            # Round 1: the mega-board's rounds alone; 2: the kill; 3: the drain.
            mega_requests = {"round1": spread(round_s), "round2": spread(r2.mega_s),
                             "round3": spread(r3.mega_s)}
            print("serve_cluster mega-board step requests (client s): " + ", ".join(
                f"{r} p50 {d['p50_s']} max {d['max_s']} (n {d['n']})"
                for r, d in mega_requests.items()) + f"; {card['name_power']}", flush=True)
            check(rc == 0, f"the drained worker exited {rc}")
            # A chunk round carries at most TILED_MOVE_ROUND_CHUNKS chunks,
            # and the drain plans all of the drainer's chunks in one pass.
            for to, d in split["chunk"]["by_dest"].items():
                want = -(-d["moves"] // TILED_MOVE_ROUND_CHUNKS)
                check(round(d["rounds"]) == want and abs(d["rounds"] - want) < 1e-6,
                      f"{d['moves']} chunks to {to} in {d['rounds']} rounds, not {want}")
            deadline = time.monotonic() + WAIT_S
            while not settled(SC_WORKERS - 2):
                check(time.monotonic() < deadline, "the drain never settled")
                time.sleep(0.1)
            check(not r3.not_found and not r3.failures and not r3.resumed,
                  f"round 3: 404s {r3.not_found[:3]}, failures {r3.failures[:3]}, "
                  f"resumed {list(r3.resumed)[:3]}")
            listed = {r["id"]: r for r in _http(base, "GET", "/boards")[1]["boards"]}
            for i, sid in enumerate(sids):
                check(listed[sid]["epoch"] == 3 * SC_ROUND_EPOCHS
                      and listed[sid]["digest"] == ref192[i], f"board {i} after the drain: {listed[sid]}")
            check(listed[mega["id"]]["digest"] == ref(3 * SC_ROUND_EPOCHS),
                  f"mega-board after the drain: {listed[mega['id']]}")
            health = _http(base, "GET", "/healthz")[1]["serve"]
            survivor = names[2]
            check(health["tiled_resident"]["chunks_by_worker"] == {survivor: mega["tiles"]},
                  f"chunks after the drain: {health['tiled_resident']['chunks_by_worker']}")
            check(health["sessions_by_worker"] == {survivor: len(sids)},
                  f"sessions after the drain: {health['sessions_by_worker']}")
            single_copy = health["replication"]["single_copy_shards"]
            check(single_copy == sum(health["shards_by_worker"].values()) and single_copy > 0,
                  f"single-copy shards {single_copy} on the one survivor")
            fe_metrics = _http(base, "GET", "/metrics")[1]
            moved = _prom_family(fe_metrics, "gol_serve_tiled_chunk_migrations_total") - moved_before
            check(moved >= held.get(drained, 0), f"{moved} chunks re-homed, {drained} held {held}")
            check(_prom_family(fe_metrics, "gol_digest_mismatches_total") == 0, "digest mismatch")
            check(_prom_family(fe_metrics, "gol_serve_sessions_lost_total") == 0, "sessions lost")

        # -- shutdown: SIGTERM drains the frontend (130), the survivor leaves 0 --
        fe.send_signal(signal.SIGTERM)
        check(fe.wait(timeout=60) == 130, f"the frontend exited {fe.returncode} on SIGTERM")
        check(procs[survivor].wait(timeout=60) == 0,
              f"the surviving worker exited {procs[survivor].returncode}")
    finally:
        for sock in reserved.values():
            sock.close()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
    emit(
        "serve_cluster",
        config=f"serve --serve-cluster on + {SC_WORKERS} backend --device cuda on card 0 (JAX "
        "defaults: 64 shards, tile chunk 8, resident tiles and replication on; sessions 1032, "
        "cells 2^25)",
        sessions=len(specs), cells=cells, boot_s=boot_s, create_s=create_s,
        round1_s=round1_s, round1_boards_per_s=len(sids) / round1_s,
        round1_cell_updates_per_s=cells * SC_ROUND_EPOCHS / round1_s,
        round1_client_p50_s=lat1[len(lat1) // 2], round1_client_p99_s=lat1[int(len(lat1) * 0.99)],
        round1_per_worker=per_worker, sessions_by_worker=sessions_by_worker,
        mega={"side": SC_MEGA_SIDE, "chunks": mega["tiles"], "chunks_by_worker": chunks,
              "create_s": mega_create_s, "round_s": round_s, "bytes_per_round": round_bytes,
              "perimeter_bytes": perimeter_bytes, "area_bytes": area_bytes,
              "worker_serve_tiled_s": {n: _prom_label(tiled_w[n], "gol_program_device_seconds_total",
                                                      "family", "serve_tiled") for n in names}},
        kill={"worker": victim, "round_s": round2_s, "answers": r2.status,
              "promoted_sessions": len(promoted), "mega_resumed_at": [e for e, _ in mega_resumes],
              "promotion_latency": promo, "not_found": len(r2.not_found)},
        drain={"worker": drained, "rc": rc, "round_s": round3_s, "answers": r3.status,
               "chunks_held": held.get(drained, 0), "chunks_rehomed": moved,
               "single_copy_shards": single_copy, "seconds": split["seconds"],
               "chunk_rounds": split["chunk"]["rounds"],
               "hold_max_s": split["chunk"].get("max_s", {}).get("hold_s"),
               "hold_sum_s": split["chunk"].get("sum_s", {}).get("hold_s"),
               "split": split},
        mega_requests=mega_requests,
        card=card["name_power"],
    )


SF_FRONTENDS = 3
SF_SAMPLE = 64  # the wrong-frontend burst: one epoch each through a non-owner
SF_RETRYABLE = ("failover", "partitioned")
# A kill-round request's client timeout: on the H100 host a request in
# flight to the SIGKILLed frontend got no reset and waited the timeout out
# (60 s at first); a load balancer's client gives up sooner and moves on.
SF_REQUEST_TIMEOUT_S = 10.0
SF_TOML = """\
failure_timeout_s = "5s"
wait_for_backends_s = "240s"
rebalance_interval_s = "50ms"
"""


def _http_no_redirect(base, path, timeout=60):
    """A GET whose 307 is answered, not followed: (status, body, headers)."""
    import http.client
    import urllib.parse

    url = urllib.parse.urlsplit(base)
    conn = http.client.HTTPConnection(url.hostname, url.port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, (json.loads(body) if body else {}), dict(resp.getheaders())
    finally:
        conn.close()


def _fed_health(base):
    status, doc = _http(base, "GET", "/healthz", timeout=30)
    check(status == 200, f"{base}/healthz: {status}")
    return doc


def _step_federated(bases, home, sid, start, target, traffic):
    """Step ``sid`` from ``start`` to the absolute epoch ``target`` through
    the frontend ``bases[home]``, the load balancer's client: when a
    frontend refuses or drops the connection the client moves to another
    and reads the epoch back before stepping on; a retryable 429
    (``failover`` / ``partitioned``) is read back and retried.  Each 200
    must land exactly on ``target`` from the epoch the client knew.  404s,
    5xx and other answers are recorded, not retried.  Every connection
    error and timeout is recorded with the frontend it came from and its
    time, a 307's target included, for the phase to hold them to the
    killed frontend after the kill."""
    import http.client
    import urllib.error

    at, epoch, t_fail, t_429, known, gone, err = home, start, None, None, True, set(), None
    while epoch < target:
        if at in gone:
            live = [i for i in range(len(bases)) if i not in gone]
            check(bool(live), f"{sid}: no frontend answers ({err!r})")
            at = live[(home + 1) % len(live)]
        t_req = time.monotonic()
        try:
            if known:
                status, doc = _http(bases[at], "POST", f"/boards/{sid}/step",
                                    {"steps": target - epoch}, timeout=SF_REQUEST_TIMEOUT_S)
            else:  # the epoch after an answer that may or may not have landed
                status, doc, headers = _http_no_redirect(
                    bases[at], f"/boards/{sid}", timeout=SF_REQUEST_TIMEOUT_S)
        except (urllib.error.URLError, http.client.HTTPException, OSError) as e:
            err = e
            now = time.monotonic()
            with traffic.lock:
                traffic.errors.append((round(now - t_req, 3), sid, at, now, repr(e)[:120]))
            gone.add(at)
            known = False
            t_fail = t_fail if t_fail is not None else t_req
            continue
        if status == 307:
            # The owner's own port: it may be the frontend that just died,
            # before this one has seen it go; then ask this one again.
            owner = next((j for j, b in enumerate(bases)
                          if headers.get("Location", "").startswith(b + "/")), None)
            check(owner is not None, f"{sid}: a 307 to {headers.get('Location')}, "
                  "no frontend's HTTP port")
            try:
                status, doc = _http(headers["Location"], "GET", "",
                                    timeout=SF_REQUEST_TIMEOUT_S)
            except (urllib.error.URLError, http.client.HTTPException, OSError) as e:
                err = e
                now = time.monotonic()
                with traffic.lock:
                    traffic.errors.append(
                        (round(now - t_req, 3), sid, owner, now, repr(e)[:120]))
                time.sleep(0.1)
                continue
        took = time.monotonic() - t_req
        with traffic.lock:
            if took > traffic.slowest[0]:
                traffic.slowest = (took, sid, at, status, "step" if known else "get")
        traffic.note(status)
        if status == 200:
            if known and doc["epoch"] != target:
                with traffic.lock:
                    traffic.failures.append((sid, "discontinuous", epoch, doc["epoch"]))
                return
            epoch, known = int(doc["epoch"]), True
            now = time.monotonic()
            with traffic.lock:
                traffic.last_200 = now
                if t_fail is not None:
                    traffic.latency.append(now - t_fail)
                if t_429 is not None:
                    traffic.latency_429.append(now - t_429)
            t_fail = t_429 = None
            continue
        if status == 429 and doc.get("reason") in SF_RETRYABLE:
            t_fail = t_fail if t_fail is not None else time.monotonic()
            t_429 = t_429 if t_429 is not None else time.monotonic()
            known = False
            time.sleep(float(doc.get("retry_after_s", 0.1)))
            continue
        if status == 429 and doc.get("reason") == "queue_full":
            time.sleep(0.05)
            continue
        with traffic.lock:
            (traffic.not_found if status == 404 else traffic.failures).append(
                (sid, status, doc))
        return


def _fed_listing(bases, dead):
    """Every live frontend's ``/boards`` (each lists its own slices)."""
    out = {}
    for i, base in enumerate(bases):
        if i in dead:
            continue
        for row in _http(base, "GET", "/boards")[1]["boards"]:
            check(row["id"] not in out, f"{row['id']} listed by two frontends")
            out[row["id"]] = row
    return out


@_tails_on_failure(*(f"serve_federation_{role}{i}" for role in ("fe", "w")
                     for i in range(SF_FRONTENDS)))
def serve_federation_phase(tmp: Path, card, single):
    """The frontend federation on the card: SF_FRONTENDS ``serve
    --serve-cluster on --frontend-seeds ...`` processes at the JAX serve
    defaults, each with one ``backend --device cuda`` worker on card 0.
    Round 1 creates the serve mix round-robin (each sid mined into its
    frontend's slices, so no op is forwarded) and steps it 64 epochs from
    sticky clients (the single-process phase's digests); a burst steps a
    sample through frontends that do not own it (forwarded, counted
    exactly); a foreign GET answers 307 to the owner's HTTP port; round 2
    SIGKILLs a frontend mid-round (only 200s and retryable 429s, the
    standby adopts the dead frontend's slices, its worker re-homes and
    announces its sessions, every board certified at epoch 128, none
    lost)."""
    specs = serve_specs()
    n_fe = SF_FRONTENDS
    check(len(single) == len(specs), "the serve phase's digests")
    # Each frontend's cluster and HTTP ports and each worker's /metrics,
    # held until the process that serves them has bound them.
    held = [_reserve_port() for _ in range(3 * n_fe)]
    cports, hports, wports = (
        [sock.getsockname()[1] for sock in held[i * n_fe:(i + 1) * n_fe]] for i in range(3))
    seeds = ",".join(f"127.0.0.1:{p}" for p in cports)
    bases = [f"http://127.0.0.1:{p}" for p in hports]
    names = [f"127.0.0.1:{p}" for p in cports]
    procs = {}
    try:
        t_boot = time.perf_counter()
        fe_lines = {}
        for i in range(n_fe):
            # Each frontend's event log (promotions, SHARD_HOME, peers) lands
            # in chiprun_out/ beside its output.
            toml = tmp / f"serve-federation-{i}.toml"
            toml.write_text(SF_TOML + f'log_events = "{OUT}/serve_federation_fe{i}.events.jsonl"\n')
            procs[f"fe{i}"], fe_lines[i] = _start_proc(_port_cli(
                "serve", "--serve-cluster", "on", "--config", str(toml), "--host", "127.0.0.1",
                "--port", str(cports[i]), "--metrics-port", str(hports[i]), "--min-backends", "1",
                "--frontend-seeds", seeds), f"serve_federation_fe{i}", tmp)
        deadline = time.monotonic() + WAIT_S
        for i in range(n_fe):
            _await_line(fe_lines[i], r"listening on \S+:(\d+)", deadline, f"frontend {i}'s port",
                        procs[f"fe{i}"])
        w_lines = {}
        for i in range(n_fe):
            procs[f"w{i}"], w_lines[i] = _start_proc(_port_cli(
                "backend", "--port", str(cports[i]), "--name", f"fw{i}", "--device", SC_DEVICE,
                "--metrics-port", str(wports[i])), f"serve_federation_w{i}", tmp)
        for i in range(n_fe):
            _await_line(w_lines[i], r"joined", deadline, f"worker {i} joined", procs[f"w{i}"])
        for i in range(n_fe):  # each frontend's /boards is bound before its first join
            _await_line(fe_lines[i], r" on :(\d+) ", deadline, f"frontend {i}'s HTTP port",
                        procs[f"fe{i}"])
        for sock in held:
            sock.close()
        boot_s = time.perf_counter() - t_boot

        # -- convergence: every frontend sees the others and no slice unowned --
        t0 = time.perf_counter()
        while True:
            docs = [_fed_health(b) for b in bases]
            feds = [d["federation"] for d in docs]
            if (all(len(f["peers"]) == n_fe - 1 and f["slices"]["unowned"] == 0 for f in feds)
                    and all(f["slices"]["by_frontend"] == feds[0]["slices"]["by_frontend"]
                            for f in feds)
                    and all(len(d["serve"]["shards_by_worker"]) == 1 for d in docs)):
                break
            check(time.monotonic() < deadline, f"the federation never converged: {feds}")
            for name, proc in procs.items():
                check(proc.poll() is None, f"{name} exited {proc.returncode} while booting")
            time.sleep(0.1)
        converge_s = time.perf_counter() - t0
        for d in docs:
            s = d["serve"]
            check(s["shards_total"] == 64 and s["tiled_resident"]["enabled"]
                  and s["replication"]["enabled"], f"not the JAX defaults: {s}")
        owned = {f["name"]: f["slices"]["owned"] for f in feds}
        check(sorted(owned) == sorted(names) and sum(owned.values()) == 64, f"slices {owned}")

        def forwarded():
            return sum(_prom_family(_http(b, "GET", "/metrics")[1],
                                    "gol_frontend_forwarded_ops_total") for b in live_bases())

        dead = set()

        def live_bases():
            return [b for i, b in enumerate(bases) if i not in dead]

        with concurrent.futures.ThreadPoolExecutor(SERVE_THREADS) as pool:
            # -- round 1: the serve mix, round-robin, sticky clients ------------
            home = [i % n_fe for i in range(len(specs))]
            created, create_s, _ = _timed(pool, lambda i: _http(bases[home[i]], "POST", "/boards", {
                "tenant": f"t{specs[i][3] % 16}", "rule": specs[i][0], "height": specs[i][1],
                "width": specs[i][2], "seed": specs[i][3]}), range(len(specs)))
            for status, doc in created:
                check(status == 201, f"federated create: {status} {doc}")
            sids = [doc["id"] for _, doc in created]
            stepped, round1_s, lat1 = _timed(pool, lambda i: _http(
                bases[home[i]], "POST", f"/boards/{sids[i]}/step", {"steps": SC_ROUND_EPOCHS}),
                range(len(sids)))
            _steps_ok(stepped, SC_ROUND_EPOCHS, "federated round 1")
            for i, (_, doc) in enumerate(stepped):
                check(doc["digest"] == single[i], f"federated round 1 board {i} {specs[i][:3]}: "
                      f"{doc['digest']} != the single-process plane's {single[i]}")
            check(forwarded() == 0, "round 1 forwarded an op: a sid outside its frontend's slices")
            by_fe = [_fed_health(b)["serve"]["sessions"] for b in bases]
            check(sum(by_fe) == len(sids), f"sessions per frontend {by_fe}")

            # -- the wrong-frontend burst: forwarded, counted exactly -------------
            sample = list(range(0, len(sids), len(sids) // SF_SAMPLE))[:SF_SAMPLE]
            ref65 = dict(zip(sample, _sessions_reference([specs[i] for i in sample],
                                                         SC_ROUND_EPOCHS + 1)))
            fwd0 = forwarded()
            burst, burst_s, lat_fwd = _timed(pool, lambda i: _http(
                bases[(home[i] + 1) % n_fe], "POST", f"/boards/{sids[i]}/step", {"steps": 1}),
                sample)
            _steps_ok(burst, SC_ROUND_EPOCHS + 1, "forwarded burst")
            for i, (_, doc) in zip(sample, burst):
                check(doc["digest"] == ref65[i], f"forwarded board {i}: {doc['digest']} != {ref65[i]}")
            fwd_n = forwarded() - fwd0
            check(fwd_n == len(sample), f"{fwd_n} forwarded ops counted for {len(sample)}")

            # -- a foreign GET: 307 to the owner's HTTP port, and it serves -------
            i = sample[1]
            status, doc, headers = _http_no_redirect(
                bases[(home[i] + 1) % n_fe], f"/boards/{sids[i]}")
            want = f"{bases[home[i]]}/boards/{sids[i]}"
            check(status == 307 and headers.get("Location") == want,
                  f"foreign GET: {status} {headers.get('Location')} (want 307 {want})")
            status, got = _http(want, "GET", "")
            check(status == 200 and got["id"] == sids[i] and got["epoch"] == SC_ROUND_EPOCHS + 1
                  and got["digest"] == ref65[i], f"the redirect's target: {status} {got}")

            # -- round 2: SIGKILL a frontend mid-round ----------------------------
            ref128 = _sessions_reference(specs, 2 * SC_ROUND_EPOCHS)
            victim = 0
            victim_slices = owned[names[victim]]
            promos0 = {j: _prom_family(_http(b, "GET", "/metrics")[1],
                                       "gol_frontend_slice_promotions_total")
                       for j, b in enumerate(bases) if j != victim}
            traffic = _Traffic()
            traffic.slowest = (0.0,)
            traffic.latency_429 = []
            traffic.errors = []
            kill_t = {}

            survivors = [b for j, b in enumerate(bases) if j != victim]
            seen = {}

            def monitor():
                # From the kill: when the survivors' windows are all closed,
                # and when the orphaned worker's re-home line appears.
                while "windows" not in seen:
                    docs = [_fed_health(b) for b in survivors]
                    if all(names[victim] in d["federation"]["dead"] for d in docs) and all(
                            d["serve"]["replication"]["promotions_inflight"] == 0 for d in docs):
                        seen["windows"] = time.monotonic() - kill_t["t"]
                    time.sleep(0.05)

            def rehomed():
                m = _await_line(w_lines[victim], r"re-homed control channel to (\S+)",
                                time.monotonic() + WAIT_S, "the orphaned worker's re-home")
                seen["rehome"] = (time.monotonic() - kill_t["t"], m.group(1))

            def kill():
                kill_t["t"] = time.monotonic()
                procs[f"fe{victim}"].kill()
                for fn in (monitor, rehomed):
                    threading.Thread(target=fn, daemon=True).start()

            fired = threading.Event()

            def watch():
                while not fired.is_set():
                    with traffic.lock:
                        due = traffic.answered >= len(sids) // 3
                    if due:
                        kill()
                        fired.set()
                    time.sleep(0.01)

            starts = [SC_ROUND_EPOCHS + (i in ref65) for i in range(len(sids))]
            watcher = threading.Thread(target=watch, daemon=True)
            t0 = time.perf_counter()
            watcher.start()
            list(pool.map(lambda i: _step_federated(
                bases, home[i], sids[i], starts[i], 2 * SC_ROUND_EPOCHS, traffic),
                range(len(sids))))
            round2_s = time.perf_counter() - t0
            check(fired.is_set(), f"round 2 ended before the kill ({traffic.answered} answers)")
            procs[f"fe{victim}"].wait(timeout=30)
            dead.add(victim)
            check(not traffic.not_found, f"404 on admitted sessions: {traffic.not_found[:3]}")
            check(not traffic.failures, f"round 2 failures: {traffic.failures[:3]}")
            check(set(traffic.status) <= {200, 429}, f"round 2 answers {traffic.status}")
            # A survivor that hangs or refuses a client fails the round: only
            # the killed frontend may drop a connection, and only after the kill.
            stray = [e for e in traffic.errors if e[2] != victim or e[3] < kill_t["t"]]
            check(not stray, f"connection errors not from the killed frontend after "
                  f"the kill: {len(stray)}, e.g. {stray[:3]}")

            # The windows close by SHARD_HOME, the grace expires with no loss.
            deadline = time.monotonic() + WAIT_S
            while not ("windows" in seen and all(
                    _fed_health(b)["federation"]["promotions_inflight"] == 0 for b in survivors)):
                check(time.monotonic() < deadline, f"the federation promotions never settled: {seen}")
                time.sleep(0.2)
            windows_s = seen["windows"]
            grace = max(10.0, 6.0 * 3.0)
            check(windows_s < grace, f"the windows closed {windows_s} s after the kill, "
                  f"past the re-home grace of {grace} s (round 2 {round2_s} s, "
                  f"answers {traffic.status}, slowest request {traffic.slowest}, {seen})")
            listed = _fed_listing(bases, dead)
            check(len(listed) == len(sids), f"{len(listed)} sessions listed after the kill")
            for i, sid in enumerate(sids):
                row = listed[sid]
                check(row["epoch"] == 2 * SC_ROUND_EPOCHS and row["digest"] == ref128[i],
                      f"board {i} after the kill: {row}")
            metrics = {j: _http(b, "GET", "/metrics")[1]
                       for j, b in enumerate(bases) if j not in dead}
            promoted = {names[j]: _prom_family(m, "gol_frontend_slice_promotions_total")
                        - promos0[j] for j, m in metrics.items()}
            check(sum(promoted.values()) == victim_slices,
                  f"slices promoted {promoted}, the victim owned {victim_slices}")
            check(sum(_prom_family(m, "gol_serve_sessions_lost_total")
                      for m in metrics.values()) == 0, "sessions lost")
            feds = [_fed_health(b)["federation"] for b in survivors]
            check(all(f["slices"]["unowned"] == 0 and names[victim] in f["dead"] for f in feds),
                  f"after the kill: {feds}")
            check("rehome" in seen, "the orphaned worker never re-homed")
            standby = max(promoted, key=promoted.get)
            check(seen["rehome"][1] == standby,
                  f"the orphaned worker re-homed to {seen['rehome'][1]}, the standby is {standby}")
            # The victim's clients lost their frontend mid-round: each saw a
            # refused or dropped connection, or a 429, before its next 200.
            lat = sorted(traffic.latency)
            check(lat, f"no client saw the failover ({traffic.status}, {seen})")
            lat429 = sorted(traffic.latency_429)
            # The standby's windows, on its own clock: adopted (the
            # promotion event) to closed (the worker's SHARD_HOME).
            events = [json.loads(line) for line in open(
                OUT / f"serve_federation_fe{names.index(standby)}.events.jsonl")]
            t_adopt = [e["t_mono"] for e in events if e["event"] == "serve_federation_promotion"]
            t_home = [e["t_mono"] for e in events if e["event"] == "serve_shard_home"]
            check(t_adopt and t_home, "the standby logged no adoption or no SHARD_HOME")
            window_s = t_home[0] - t_adopt[0]
            for j in range(n_fe):  # every worker stepped on the card
                text = _http(f"http://127.0.0.1:{wports[j]}", "GET", "/metrics")[1]
                check(_prom_label(text, "gol_device_peak_bytes_in_use", "device", "cuda:0") > 0
                      if SC_DEVICE.startswith("cuda") else True,
                      f"worker {j} holds nothing on the card")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
    def quantiles(xs):
        return {"p50_s": xs[len(xs) // 2] if xs else None,
                "p99_s": xs[int(len(xs) * 0.99)] if xs else None, "n": len(xs)}

    promo, promo429, fwd = quantiles(lat), quantiles(lat429), quantiles(lat_fwd)
    print(f"serve_federation: boot {boot_s:.3f} s, convergence {converge_s:.3f} s, round 1 "
          f"{len(sids) / round1_s:.1f} boards/s, forwarded op p50 {fwd['p50_s']:.4f} s p99 "
          f"{fwd['p99_s']:.4f} s, failover (client: first failed request to the next 200) "
          f"p50 {promo['p50_s']:.3f} s p99 {promo['p99_s']:.3f} s over {promo['n']}, "
          f"first 429 to the next 200 over {promo429['n']}: p50 {promo429['p50_s']} s "
          f"p99 {promo429['p99_s']} s, the standby's windows open {window_s:.4f} s; "
          f"{card['name_power']}", flush=True)
    emit(
        "serve_federation",
        config=f"{n_fe} x serve --serve-cluster on --frontend-seeds (all three) + one backend "
        f"--device {SC_DEVICE} each, on card 0 (JAX defaults: 64 shards, resident tiles and "
        "replication on; gossip 0.5 s, suspect 3 s, replication 0.25 s)",
        sessions=len(specs), boot_s=boot_s, converge_s=converge_s, slices_owned=owned,
        create_s=create_s, round1_s=round1_s, round1_boards_per_s=len(sids) / round1_s,
        round1_client_p50_s=lat1[len(lat1) // 2], round1_client_p99_s=lat1[int(len(lat1) * 0.99)],
        sessions_by_frontend=by_fe, forwarded_ops=fwd_n, forwarded_burst_s=burst_s,
        forwarded_latency=fwd, redirect={"status": 307, "location": want},
        kill={"frontend": names[victim], "slices": victim_slices, "round_s": round2_s,
              "answers": traffic.status, "failover_latency": promo,
              "promotion_latency_429": promo429, "standby_window_s": window_s,
              "windows_closed_s": windows_s, "slices_promoted": promoted,
              "rehomed_to": seen["rehome"][1], "rehome_s": seen["rehome"][0],
              "slowest_request": traffic.slowest, "not_found": len(traffic.not_found),
              "last_200_after_kill_s": traffic.last_200 - kill_t["t"],
              "connection_errors": len(traffic.errors),
              "timed_out": sum(1 for e in traffic.errors if "timed out" in e[4]),
              "slowest_errors": sorted(traffic.errors, reverse=True)[:3]},
        card=card["name_power"],
    )


def _harness_run(config, engine, device=None):
    from akka_game_of_life_tpu_torch.runtime.harness import ClusterHarness

    h = ClusterHarness(config, 2, engine=engine, device=device)
    try:
        check(h.frontend.wait_for_backends(timeout=60), f"{engine} workers did not join")
        t0 = time.perf_counter()
        h.frontend.start_simulation()
        check(h.frontend.done.wait(WAIT_S), f"{engine} cluster did not finish")
        wall = time.perf_counter() - t0
        check(h.frontend.error is None, f"{engine} cluster: {h.frontend.error}")
        return dict(h.frontend.epoch_digests), wall
    finally:
        h.shutdown()


def host_engines_phase(card):
    """The host engines on the card's machine (host-CPU walls): ``run
    --backend actor-native`` against the packed run, and in-process clusters
    of swar and actor-native workers against the torch engine's on the
    card."""
    from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig

    r = ACTOR_RUN
    argv = ["run", "--height", str(r["side"]), "--width", str(r["side"]), "--seed", "3",
            "--max-epochs", str(r["epochs"]), "--steps-per-call", str(r["spc"]),
            "--metrics-every", str(r["spc"]), "--obs-digest", "--device", SINGLE]
    packed_text, packed_s = run_cli(argv, "actor_packed.log")
    actor_text, actor_s = run_cli(argv + ["--backend", "actor-native"], "actor_native.log")
    packed, _ = parse_run(packed_text)
    actor, _ = parse_run(actor_text)
    check(sorted(actor) == list(range(r["spc"], r["epochs"] + 1, r["spc"])), f"actor epochs {sorted(actor)}")
    check(actor == packed, f"run --backend actor-native digests {actor} != packed {packed}")
    check('"kernel": "actor-native"' in actor_text, "the run summary does not name the engine")
    walls = {}
    for name, c, engines in (("swar", SWAR_CLUSTER, ("swar",)),
                             ("actor", ACTOR_CLUSTER, ("actor-native",))):
        config = lambda: SimulationConfig(  # noqa: E731 - a fresh config per cluster
            height=c["side"], width=c["side"], seed=7, max_epochs=c["epochs"],
            exchange_width=c["width"], metrics_every=c["epochs"] // 2 if c["width"] == 1 else c["width"],
            obs_digest=True)
        want, walls[f"torch_{name}"] = _harness_run(config(), "torch", SINGLE)
        check(len(want) >= 2, f"torch cluster digests {want}")
        for engine in engines:
            got, walls[engine] = _harness_run(config(), engine)
            check(got == want, f"{engine} cluster digests {got} != torch {want}")
    emit("host_engines", host_cpu_walls_s=dict(walls, actor_run=actor_s, packed_run=packed_s),
         actor_run=r, swar_cluster=SWAR_CLUSTER, actor_cluster=ACTOR_CLUSTER,
         note="actor/swar walls are host-CPU numbers of the card's machine",
         card=card["name_power"])



# -- several processes ----------------------------------------------------------


def _wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean host-clock ms of ``fn`` between card synchronisations (the staged
    exchange waits on the host, so CUDA events alone would miss it)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _dist_run(job, rank: int, coordinator: str):
    """One job of a rank: ``Simulation`` over this rank's slots of the
    two-process mesh, with launch counts set to 0 just before and read just
    after; returns its output, walls and counts."""
    import torch

    from akka_game_of_life_tpu_torch.runtime.config import load_config
    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    from akka_game_of_life_tpu_torch.parallel import distributed

    seed = job.get("seed_from")
    if seed is not None and rank == 0:
        shutil.copy(seed, job["overrides"]["checkpoint_dir"])
    distributed.barrier(f"seed-{job['name']}")
    config = load_config(job["config"], {
        **job["overrides"], "obs_digest": True, "distributed": True,
        "coordinator_address": coordinator, "num_processes": DIST_RANKS, "process_id": rank,
    })
    buf = io.StringIO()
    observer = BoardObserver(
        render_every=config.render_every, render_max_cells=config.render_max_cells,
        metrics_every=config.metrics_every, out=buf,
    )
    zero_counts()
    t0 = time.perf_counter()
    sim = Simulation(config, observer=observer, device=[SINGLE] * DIST_SLOTS)
    start = sim.epoch
    with sim:
        sim.advance(config.max_epochs - sim.epoch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        info = {"mesh": list(sim.mesh.shape), "local_slots": sim.mesh.local_slots,
                "kernel": sim.kernel, "crash_log": sim.crash_log,
                "tiles_on": sorted({str(t.device) for t in sim.board if t is not None})}
    run_s = time.perf_counter() - t0
    counts = read_counts()
    text = buf.getvalue()
    (OUT / f"dist_{job['name']}_rank{rank}.log").write_text(text)
    return {"text": text, "counts": counts, "start": start, "run_s": run_s,
            "run_s_before_close": step_s, **info}


def _dist_timing(job, rank: int):
    """The headline's (4, 1) tiles over the two processes: one staged halo
    exchange and one 60-generation call of the sharded sweep, host clock."""
    import numpy as np
    import torch

    from akka_game_of_life_tpu_torch import parallel
    from akka_game_of_life_tpu_torch.parallel.packed_halo2d import refresh_halos

    mesh = parallel.make_grid_mesh((4, 1), [SINGLE] * DIST_SLOTS)
    th, tw = FULL_SHAPE[0] // 4, FULL_SHAPE[1]
    step = parallel.sharded_sweep_step_fn(mesh, "conway", steps_per_call=60)
    plan = step.plan((th, tw))
    p, hw = plan.halo_rows, plan.halo_words
    rng = np.random.default_rng(rank)
    padded = [
        None if not mesh.is_local(i) else torch.from_numpy(
            rng.integers(0, 2**32, size=(th + 2 * p, tw + 2 * hw), dtype=np.uint32)
            .view(np.int32)).to(SINGLE)
        for i in range(mesh.size)
    ]
    exchange_ms = _wall_ms(lambda: refresh_halos(padded, mesh, p, hw), reps=20, warmup=2)
    tiles = [None if t is None else t[p : p + th].contiguous() for t in padded]
    del padded
    call_ms = _wall_ms(lambda: step(tiles), reps=5)
    # Bytes that cross between the processes per exchange: each rank sends
    # and receives two strips of p rows (the (4, 1) ring crosses twice).
    crossed = 2 * DIST_RANKS * p * tw * 4
    return {"exchange_ms": exchange_ms, "call_ms": call_ms, "halo_rows": p,
            "cross_process_bytes": crossed, "tile_words": [th, tw]}


def dist_worker(rank: int, spec_path: Path) -> int:
    """A rank of the distributed phases (``chip_smoke.py --dist-rank R
    --dist-spec FILE``, started by :func:`dist_phases`): join the group, run
    each job of the spec, print one ``DIST {...}`` line per job."""
    sys.path.insert(0, str(ROOT))
    from akka_game_of_life_tpu_torch.parallel import distributed

    spec = json.loads(spec_path.read_text())
    distributed.initialize(spec["coordinator"], DIST_RANKS, rank, local_device_ids=[0])
    for job in spec["jobs"]:
        if job["kind"] == "timing":
            result = _dist_timing(job, rank)
        else:
            result = _dist_run(job, rank, spec["coordinator"])
        result.update(job=job["name"], rank=rank, transport=distributed.transport())
        print("DIST " + json.dumps(result), flush=True)
    distributed.barrier("done")
    distributed.shutdown()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _reserve_port():
    """A free port held for a child's server until :meth:`close`: bound with
    SO_REUSEADDR and not listening, so the child's server (which sets
    SO_REUSEADDR) binds it while no bind to port 0 or outgoing connection
    on this host can take it first.  ``.getsockname()[1]`` is the port."""
    import socket

    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", 0))
    return sock


def _run_pair(jobs, tmp: Path):
    """Both ranks of the distributed phases, each a ``chip_smoke.py
    --dist-rank`` process on card 0; returns {job: [rank 0's, rank 1's]}."""
    spec = tmp / "dist-spec.json"
    spec.write_text(json.dumps({"coordinator": f"127.0.0.1:{_free_port()}", "jobs": jobs}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONFAULTHANDLER": "1"}
    procs, logs = [], []
    try:
        for rank in range(DIST_RANKS):
            log = OUT / f"dist_rank{rank}.log"
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--dist-rank", str(rank),
                 "--dist-spec", str(spec)],
                cwd=tmp, env=env, stdout=log.open("w"), stderr=subprocess.STDOUT,
            ))
        deadline = time.monotonic() + DIST_WAIT_S
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        stuck = [p for p in procs if p.poll() is None]
        for p in stuck:
            p.send_signal(signal.SIGABRT)  # thread stacks into the logs
        for p in stuck:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=10)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0,
              f"distributed rank {rank} exited {proc.returncode}: {log.read_text()[-3000:]}")
    out = {}
    for log in logs:
        for line in log.read_text().splitlines():
            if line.startswith("DIST "):
                got = json.loads(line[5:])
                out.setdefault(got["job"], [None] * DIST_RANKS)[got["rank"]] = got
    return out


def dist_phases(headline, wireworld, tmp: Path, card):
    """The two-process phases in one pair of processes: the headline on
    (4, 1) with npz checkpoints, its epoch-120 checkpoint replayed through a
    lockstep crash at 180, WireWorld on (2, 2), the headline with the orbax
    store, and the staged exchange's times.  Returns the pair's results."""
    from akka_game_of_life_tpu_torch.runtime.config import load_config

    base = load_config(str(HEADLINE))
    clean, crash, orbax = (tmp / f"dist-{n}" for n in ("npz", "crash", "orbax"))
    crash.mkdir()
    jobs = [
        {"name": "headline", "kind": "run", "config": str(HEADLINE),
         "overrides": {"mesh_shape": [4, 1], "checkpoint_dir": str(clean)}},
        {"name": "crash", "kind": "run", "config": str(HEADLINE),
         "seed_from": str(clean / f"ckpt_{base.checkpoint_every:012d}.npz"),
         "overrides": {"mesh_shape": [4, 1], "checkpoint_dir": str(crash),
                       "fault_injection": DIST_CRASH}},
        {"name": "wireworld", "kind": "run", "config": str(WIREWORLD),
         "overrides": {"mesh_shape": [2, 2], "checkpoint_dir": None}},
        {"name": "orbax", "kind": "run", "config": str(HEADLINE),
         "overrides": {"mesh_shape": [4, 1], "checkpoint_dir": str(orbax),
                       "checkpoint_format": "orbax"}},
        {"name": "timing", "kind": "timing"},
    ]
    t0 = time.perf_counter()
    got = _run_pair(jobs, tmp)
    emit("dist_pair", jobs=[j["name"] for j in jobs], wall_s=time.perf_counter() - t0,
         card=card["name_power"])
    check(sorted(got) == sorted(j["name"] for j in jobs), f"jobs reported: {sorted(got)}")
    for name, ranks in got.items():
        check(all(r is not None for r in ranks), f"{name}: a rank reported nothing")
        check(all(r["transport"] == "staged" for r in ranks), f"{name}: transport "
              f"{[r['transport'] for r in ranks]}, expected staged (two ranks on one card)")
        if name != "timing":
            check(ranks[1]["text"] == "", f"{name}: rank 1 printed lines")
            check(all(r["tiles_on"] == [SINGLE] for r in ranks),
                  f"{name}: tiles on {[r['tiles_on'] for r in ranks]}")
    return got


def dist_headline(got, headline, tmp: Path, card):
    """The two-rank headline: the single-card run's digests and windows at
    every cadence epoch, 48 packed-sweep launches per rank (96 in all),
    rank 0's npz saves resumed by one process, and the lockstep crash at 180
    replayed from the epoch-120 file on both ranks."""
    from akka_game_of_life_tpu_torch.runtime.config import load_config

    base = load_config(str(HEADLINE))
    last, mid = base.max_epochs, base.checkpoint_every
    epochs = cadence(base)
    runs = got["headline"]
    per_rank = mesh_sweeps(base, (4, 1), 0, last) // DIST_RANKS
    for r in runs:
        check(r["mesh"] == [4, 1] and r["kernel"] == "sweep", f"dist headline {r['mesh']}")
        check(r["counts"] == {"packed_sweep": per_rank, "gen_sweep": 0, "ltl_sweep": 0},
              f"dist headline rank {r['rank']}: launches {r['counts']}, expected {per_rank}")
    metrics = _check_pattern_run("two-rank headline", runs[0]["text"], headline["expected"],
                                 epochs)
    check(metrics == headline["metrics"], "two-rank headline != the single-card run")
    saves = _checkpoint_lines(runs[0]["text"])
    check([n for n, _ in saves] == [f"checkpoint@{mid}", f"checkpoint@{last}"],
          f"rank 0's saves {saves}")
    # Rank 0's epoch-120 file in one process on the card.
    resume = tmp / "dist-resume-single"
    resume.mkdir()
    shutil.copy(tmp / "dist-npz" / f"ckpt_{mid:012d}.npz", resume)
    zero_counts()
    text, resume_s = run_cli(
        ["run", "--config", str(HEADLINE), "--obs-digest", "--checkpoint-dir", str(resume),
         "--device", SINGLE], "dist_resume_single.log")
    resumed, _ = parse_run(text)
    check(resumed.get(last) == metrics[last], f"two-rank npz resumed in one process: "
          f"{resumed.get(last)} != {metrics[last]}")
    check(read_counts()["packed_sweep"] == planned_sweeps(base, mid, last),
          "two-rank npz resumed in one process: launches")
    # The lockstep crash: both ranks crash at 180, restore 120, replay 60.
    crash = got["crash"]
    replay = mesh_sweeps(base, (4, 1), mid, mid + 60) // DIST_RANKS
    for r in crash:
        check(r["start"] == mid and r["crash_log"] == [180],
              f"crash rank {r['rank']}: start {r['start']}, crashes {r['crash_log']}")
        check(r["counts"]["packed_sweep"] == mesh_sweeps(base, (4, 1), mid, last) // DIST_RANKS
              + replay, f"crash rank {r['rank']}: launches {r['counts']}")
    crashed, _ = parse_run(crash[0]["text"])
    check(crashed == {e: metrics[e] for e in epochs if e > mid},
          f"lockstep crash: {crashed} != the clean run's")
    cells = base.height * base.width * last
    emit(
        "main_path", config=f"2 processes x Simulation({HEADLINE.name}, mesh_shape=(4, 1), "
        f"device=[{SINGLE!r}] * {DIST_SLOTS}, distributed=True)",
        kernel="sharded_sweep", transport=runs[0]["transport"],
        launches_per_rank=[r["counts"] for r in runs], expected_launches=2 * per_rank,
        digests={e: metrics[e][1] for e in epochs},
        run_s=[r["run_s"] for r in runs], run_cell_updates_per_s=cells / runs[0]["run_s"],
        npz_save_ms=dict(saves), single_card_run_s=headline["run_s"],
        one_process_resume={"from": mid, "digest": resumed[last][1], "run_s": resume_s},
        lockstep_crash={"at": 180, "restored_from": mid, "replayed": 60,
                        "launches_per_rank": [r["counts"]["packed_sweep"] for r in crash],
                        "run_s": [r["run_s"] for r in crash]},
        card=card["name_power"],
    )
    return sum(r["counts"]["packed_sweep"] for r in runs)


def dist_wireworld(got, wireworld, card):
    """WireWorld on (2, 2) over two ranks through the plane sweep: the
    single-card run's digests, windows and head count."""
    from akka_game_of_life_tpu_torch.runtime.config import load_config

    config = load_config(str(WIREWORLD))
    runs = got["wireworld"]
    per_rank = mesh_sweeps(config, (2, 2), 0, config.max_epochs) // DIST_RANKS
    for r in runs:
        check(r["mesh"] == [2, 2] and r["kernel"] == "gen_sweep", f"dist wireworld {r['mesh']}")
        check(r["counts"] == {"packed_sweep": 0, "gen_sweep": per_rank, "ltl_sweep": 0},
              f"dist wireworld rank {r['rank']}: launches {r['counts']}, expected {per_rank}")
    epochs = cadence(config)
    metrics = _check_pattern_run("two-rank wireworld", runs[0]["text"], wireworld["expected"],
                                 epochs)
    cells = config.height * config.width * config.max_epochs
    emit(
        "main_path", config=f"2 processes x Simulation({WIREWORLD.name}, mesh_shape=(2, 2))",
        kernel="sharded_gen_sweep", transport=runs[0]["transport"],
        launches_per_rank=[r["counts"] for r in runs],
        digests={e: metrics[e][1] for e in epochs},
        run_s=[r["run_s"] for r in runs], run_cell_updates_per_s=cells / runs[0]["run_s"],
        single_card_run_s=wireworld["run_s"], card=card["name_power"],
    )
    return sum(r["counts"]["gen_sweep"] for r in runs)


def dist_orbax(got, headline, tmp: Path, card):
    """The two-rank headline with the orbax store (each rank saves its own
    tiles; the dispatch is timed): the single-card digests; its epoch-120
    step resumed by one process, which saves epoch 240 itself; both steps
    validated (digest re-derived) and the single-process save resumed."""
    from akka_game_of_life_tpu_torch.runtime.checkpoint import describe_store
    from akka_game_of_life_tpu_torch.runtime.config import load_config
    from akka_game_of_life_tpu_torch.runtime.orbax_store import OrbaxCheckpointStore
    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    base = load_config(str(HEADLINE))
    last, mid = base.max_epochs, base.checkpoint_every
    runs = got["orbax"]
    per_rank = mesh_sweeps(base, (4, 1), 0, last) // DIST_RANKS
    for r in runs:
        check(r["counts"]["packed_sweep"] == per_rank,
              f"orbax rank {r['rank']}: launches {r['counts']}, expected {per_rank}")
    metrics, _ = parse_run(runs[0]["text"])
    check(metrics == headline["metrics"], "two-rank orbax headline != the single-card run")
    store = OrbaxCheckpointStore(str(tmp / "dist-orbax"))
    check(store.epochs() == [mid, last], f"orbax steps {store.epochs()}")
    step = store.step_meta(mid)
    check(step["mesh"] == [4, 1] and step["layout"] == "packed32", f"orbax step meta {step}")
    shards = sorted(p.name for p in (tmp / "dist-orbax" / str(mid) / "state").glob("*.distcp"))
    check(len(shards) == DIST_RANKS, f"orbax shards {shards}: one file per rank expected")
    store.close()
    dispatch = _checkpoint_lines(runs[0]["text"])
    # One process resumes the two-rank step 120 and saves 240 itself.
    resume = tmp / "orbax-resume-single"
    shutil.copytree(tmp / "dist-orbax" / str(mid), resume / str(mid))
    zero_counts()
    text, resume_s = run_cli(
        ["run", "--config", str(HEADLINE), "--obs-digest", "--checkpoint-dir", str(resume),
         "--checkpoint-format", "orbax", "--device", SINGLE], "orbax_resume_single.log")
    resumed, _ = parse_run(text)
    check(resumed.get(last) == metrics[last],
          f"two-rank orbax step resumed in one process: {resumed.get(last)} != {metrics[last]}")
    check(read_counts()["packed_sweep"] == planned_sweeps(base, mid, last),
          "orbax resume launches")
    infos = list(describe_store(str(resume), validate=True))
    check([i["epoch"] for i in infos] == [mid, last]
          and all(i["ok"] and i.get("digest_ok") for i in infos),
          f"orbax steps validated: {infos}")
    check(infos[-1]["digest"] == metrics[last][1], "single-process orbax save: digest")
    config = load_config(str(HEADLINE), {"checkpoint_dir": str(resume),
                                         "checkpoint_format": "orbax", "max_epochs": last})
    with Simulation(config, observer=BoardObserver(out=io.StringIO()), device=SINGLE) as sim:
        check(sim.epoch == last, f"single-process orbax save resumed at {sim.epoch}")
        check(f"{sim.board_digest():016x}" == metrics[last][1], "orbax 240 resumed: digest")
    emit(
        "dist_orbax", config=f"2 processes x Simulation({HEADLINE.name}, mesh_shape=(4, 1), "
        "checkpoint_format='orbax')", launches_per_rank=[r["counts"] for r in runs],
        digests={e: metrics[e][1] for e in sorted(metrics)},
        dispatch_ms=dict(dispatch), run_s=[r["run_s"] for r in runs],
        run_s_before_close=[r["run_s_before_close"] for r in runs],
        npz_run_s=[r["run_s"] for r in got["headline"]], shards_per_step=len(shards),
        one_process_resume={"from": mid, "digest": resumed[last][1], "run_s": resume_s,
                            "saves": _checkpoint_lines(text)},
        steps_validated=[{k: i[k] for k in ("epoch", "bytes", "digest_ok")} for i in infos],
        card=card["name_power"],
    )


def worker_mesh(toml: Path, want, card, rng):
    """The in-process cluster with each worker's chunks spread over
    [cuda:0] x 2 (the meshed engine, through the sharded packed sweep): the
    reference's digests and the planned launches; then the meshed chunk at
    the cluster's slab against the single-device engine, timed."""
    import numpy as np

    from akka_game_of_life_tpu_torch.ops.packed_sweep import plan_sweeps
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
    from akka_game_of_life_tpu_torch.runtime.backend import _torch_engine
    from akka_game_of_life_tpu_torch.runtime.config import load_config
    from akka_game_of_life_tpu_torch.runtime.harness import ClusterHarness
    from akka_game_of_life_tpu_torch.runtime.render import BoardObserver

    devices = [SINGLE] * 2
    config = load_config(str(toml))
    out = io.StringIO()
    chunks = config.max_epochs // config.exchange_width
    expected = CLUSTER_WORKERS * chunks * len(devices) * len(plan_sweeps(config.exchange_width))
    zero_counts()
    h = ClusterHarness(config, CLUSTER_WORKERS, observer=BoardObserver(
        metrics_every=config.metrics_every, out=out), engine="torch", device=devices)
    try:
        check(h.frontend.wait_for_backends(timeout=60), "meshed workers did not join")
        t0 = time.perf_counter()
        h.frontend.start_simulation()
        check(h.frontend.done.wait(WAIT_S), "meshed-worker cluster did not finish")
        wall = time.perf_counter() - t0
        check(h.frontend.error is None, f"meshed-worker cluster: {h.frontend.error}")
        digests = {e: f"{v:016x}" for e, v in h.frontend.epoch_digests.items()}
    finally:
        h.shutdown()
    counts = read_counts()
    (OUT / "worker_mesh.log").write_text(out.getvalue())
    for e in CLUSTER_EPOCHS:
        check(digests.get(e) == want[e], f"meshed workers epoch {e}: {digests.get(e)} != {want[e]}")
    check(counts == {"packed_sweep": expected, "gen_sweep": 0, "ltl_sweep": 0},
          f"meshed workers: launches {counts}, expected {expected}")
    # One chunk at the cluster's slab (an 8192 x 16384 tile, 10-wide halo).
    k, conway = config.exchange_width, resolve_rule("conway")
    slab = (rng.random((16384 // CLUSTER_WORKERS + 2 * k, 16384 + 2 * k), dtype=np.float32)
            < 0.5).astype(np.uint8)
    meshed, single = _torch_engine(conway, device=devices), _torch_engine(conway, device=SINGLE)
    got = meshed(slab, k, k)
    check(np.array_equal(got, single(slab, k, k)), "meshed chunk != single-device chunk")
    ms = {}
    for name, engine in (("meshed", meshed), ("single", single)):
        engine(slab, k, k)
        t0 = time.perf_counter()
        for _ in range(5):
            engine(slab, k, k)
        ms[name] = (time.perf_counter() - t0) * 1e3 / 5
    emit(
        "main_path", config=f"ClusterHarness(2 torch workers, device={devices}), " + toml.name,
        kernel="worker_chunk (meshed: sharded_sweep)", epochs=config.max_epochs,
        launches=counts, expected_launches=expected,
        digests={e: digests[e] for e in CLUSTER_EPOCHS}, run_s=wall,
        chunk_slab=list(slab.shape), meshed_chunk_ms=ms["meshed"],
        single_chunk_ms=ms["single"], card=card["name_power"],
    )
    return counts["packed_sweep"], ms["meshed"]


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
         pr5_ms=PREVIOUS_MS["packed_sweep"],
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
             previous_ms=PREVIOUS_MS["gen_sweep"][name],
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
         pr5_ms=PREVIOUS_MS["ltl_sweep"],
         plain_ms=plain, **bound, share_of_bound=bound["bound_ms"] / ms,
         library_ms=None,
         library_note="no single PyTorch call computes this step (a box filter "
         "convolution gives the counts but not the rule)",
         card=card["name_power"])
    return out


def tune_timing(card, tune):
    """The ``tune`` entry of the kernels line: the Conway tune's best point
    in ms per steps_per_call-generation call (CUDA events, as the tune timed
    it), the plain version of the same call, and the bound of its sweeps."""
    import numpy as np

    from akka_game_of_life_tpu_torch import bench
    from akka_game_of_life_tpu_torch.ops import bitpack
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    grid, best = TUNE_RUNS["conway"], tune["conway"]["points"][0]
    k, spc, h = best["steps_per_sweep"], grid["spc"], grid["size"]
    nw = h // 32
    conway = resolve_rule("conway")
    words = bitpack.words_from_numpy(
        np.random.default_rng(1).integers(0, 2**32, size=(h, nw), dtype=np.uint32), SINGLE
    )
    plain = bench.time_ms(lambda: bitpack.packed_multi_step(words, conway, spc), reps=1, warmup=0)
    one = bench.sweep_bound(h, nw, k, conway, card["int32_ops_per_s"])
    sweeps = spc // k
    bound = {**one, "bound_ms": one["bound_ms"] * sweeps, "bytes_ms": one["bytes_ms"] * sweeps,
             "ops_ms": one["ops_ms"] * sweeps}
    # From cells_per_sec, which the tune does not round (its seconds keep
    # the JAX package's four decimals).
    ms = h * h * spc / best["cells_per_sec"] * 1e3
    emit("timing", kernel="tune", rule="conway", shape=[h, nw], steps_per_call=spc,
         best_point=best, ms_per_call=ms, plain_ms=plain, **bound,
         share_of_bound=bound["bound_ms"] / ms, library_ms=None,
         library_note="no single PyTorch call computes this packed step",
         card=card["name_power"])
    return (ms, plain, bound), best


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--dist-rank"]:
        return dist_worker(int(sys.argv[2]), Path(sys.argv[4]))
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
    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            phase_s[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()

    # -- 1. device and build ---------------------------------------------------
    phase("build", build_all, card)
    phase("plane_build", check_plane_build, card)

    # -- 2. each kernel against its plain version on the card ------------------
    rng = np.random.default_rng(0)
    errors = Errors()
    words = phase("check_packed_sweep", check_packed_sweep, errors, rng)
    gen_planes = phase("check_gen_sweep", check_gen_sweep, errors, rng, card)
    ltl_board = phase("check_ltl_sweep", check_ltl_sweep, errors, rng, card)

    # -- 3. the tile autotuner --------------------------------------------------
    tune = phase("tune", tune_phase, errors, rng, card)

    # -- 4. the main paths at full size -----------------------------------------
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        headline = phase("headline", lambda: pattern_path(
            HEADLINE, "packed_sweep", tmp, card,
            reference_side=REFERENCE_SIDE, conserved=False,
        ))
        phase("tuned_tile", tuned_headline, tune, headline, tmp, card)
        phase("headline_machinery", headline_machinery, headline, tmp, card)
        phase("headline_interrupt", headline_interrupt, headline, tmp, card)
        busy = phase("headline_trace", headline_trace, headline, tmp, card)
        wireworld = phase("wireworld", lambda: pattern_path(
            WIREWORLD, "gen_sweep", tmp, card,
            reference_side=WIREWORLD_REFERENCE_SIDE, conserved=True,
        ))
        launches["packed_sweep"] = headline["launches"]
        launches["gen_sweep"] = wireworld["launches"]
        launches["ltl_sweep"], ltl_dense, ltl_dense_s = phase("bugs", ltl_path, tmp, card)
        phase("matmul_lanes", matmul_lanes, card)
        phase("matmul_run", matmul_run, tmp, ltl_dense, card)
        phase("fast_forward", fast_forward_phase, tmp, card)
        phase("sparse", sparse_phase, tmp, card)
        phase("selftest", selftest_phase, card)
        devices = mesh_devices(card)
        launches["sharded_sweep"] = phase("mesh_headline", mesh_headline, devices, headline, tmp, card)
        launches["sharded_gen_sweep"] = phase("mesh_wireworld", mesh_wireworld, devices, wireworld, card)
        phase("mesh_bugs", mesh_bugs, devices, ltl_dense, ltl_dense_s, card)
        phase("mesh_parity", mesh_parity, errors, rng, devices, card)
        toml = tmp / "cluster-16384.toml"
        toml.write_text(CLUSTER_TOML)
        want, ref_s = phase("cluster_reference", cluster_reference, toml)
        emit("cluster_reference", digests=want, run_s=ref_s, card=card["name_power"])
        launches["worker_chunk"] = phase("cluster_in_process", cluster_in_process, toml, want, tmp, card)
        phase("cluster_node_loss", cluster_node_loss, toml, want, tmp, card)
        dist = phase("dist_pair", dist_phases, headline, wireworld, tmp, card)
        launches["dist_sweep"] = phase("dist_headline", dist_headline, dist, headline, tmp, card)
        launches["dist_gen_sweep"] = phase("dist_wireworld", dist_wireworld, dist, wireworld, card)
        phase("dist_orbax", dist_orbax, dist, headline, tmp, card)
        launches["worker_mesh"], meshed_chunk_ms = phase(
            "worker_mesh", worker_mesh, toml, want, card, rng)
        # The serving plane and the host engines: no hand kernel on these
        # paths (the batched step is PyTorch on the card, as the JAX
        # package's is XLA), so they add no line to the kernels table.
        round1 = phase("serve", serve_phase, tmp, card)
        phase("serve_cluster", serve_cluster_phase, tmp, card, round1)
        phase("serve_federation", serve_federation_phase, tmp, card, round1)
        phase("serve_memo", memo_phase, card)
        phase("serve_canary", canary_phase, tmp, card)
        phase("host_engines", host_engines_phase, card)
    torch.cuda.empty_cache()

    # -- 5. times on the card at the main paths' shapes ------------------------
    times = phase("timings", timings, card, words, gen_planes, ltl_board)
    del words, gen_planes, ltl_board
    torch.cuda.empty_cache()
    err, ms, plain_ms, bound, chunk_ms = phase("chunk_timing", chunk_timing, card, rng)
    errors.max["worker_chunk"] = err
    times["worker_chunk"] = (ms, plain_ms, bound)
    times.update(phase("mesh_timing", mesh_timing, card, rng, devices, dist["timing"]))
    times["tune"], tune_best = phase("tune_timing", tune_timing, card, tune)
    launches["tune"] = sum(run["launches"] for run in tune.values())
    # Last: no later phase reads what the ledger's checks leave, and a
    # failed check still fails the run once every other phase has run.
    phase("programs", programs_phase, card)
    emit("done", seconds=time.perf_counter() - t_start, phase_seconds=phase_s,
         device_busy_share=busy["device_busy_share"], card=card["name_power"])

    sources = {
        "packed_sweep": "akka_game_of_life_tpu/ops/pallas_stencil.py:236",
        "gen_sweep": "akka_game_of_life_tpu/ops/pallas_gen.py:50",
        "ltl_sweep": "akka_game_of_life_tpu/ops/pallas_ltl.py:66",
        "worker_chunk": "akka_game_of_life_tpu/runtime/backend.py:128",
        "sharded_sweep": "akka_game_of_life_tpu/parallel/pallas_halo.py:163",
        "sharded_gen_sweep": "akka_game_of_life_tpu/parallel/pallas_halo.py:216",
        "tune": "akka_game_of_life_tpu/runtime/autotune.py:30",
    }
    entries = [
        {
            "name": name,
            "route": "cuda",
            "source": (
                "akka_game_of_life_tpu_torch/runtime/autotune.py" if name == "tune"
                else f"akka_game_of_life_tpu_torch/csrc/{KERNEL_SOURCE.get(name, name)}.cu"
            ),
            "replaces": sources[name],
            "launches": launches[name],
            "max_abs_err": errors.max[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": times[name][2]["bound_ms"],
            "bound_by": times[name][2]["bound_by"],
            "library_ms": None,
        }
        for name in (*KERNELS, *WIRINGS, "tune")
    ]
    entries[len(KERNELS)]["chunk_ms"] = chunk_ms
    # This slice's paths through the same kernels: two processes on one card
    # (staged over gloo) and the meshed cluster worker.
    timing = dist["timing"][0]
    entries[len(KERNELS)].update(launches_meshed_worker=launches["worker_mesh"],
                                 meshed_chunk_ms=meshed_chunk_ms)
    entries[len(KERNELS) + 1].update(
        launches_two_processes=launches["dist_sweep"],
        two_process_call_ms=timing["call_ms"], two_process_exchange_ms=timing["exchange_ms"],
        two_process_transport="staged over gloo")
    entries[len(KERNELS) + 2]["launches_two_processes"] = launches["dist_gen_sweep"]
    entries[-1]["best_point"] = tune_best
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
