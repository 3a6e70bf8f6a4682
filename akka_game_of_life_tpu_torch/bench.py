"""Card facts, CUDA-event timing and the kernels' bounds, plus a tile sweep.

``python -m akka_game_of_life_tpu_torch.bench [--depths 2,3,...]`` builds the
packed-sweep kernel once per tile variant (``TILE_ROWS`` x ``STRIPS`` below,
given to ``nvcc`` as ``-D`` flags), times each variant at 65536² for every
sweep depth k, checks each bit-exact against the plain version, and prints
one JSON line per configuration (and writes them to
``chiprun_out/sweep_tiles.jsonl``).  It needs an NVIDIA GPU and fails
without one.  ``chip_smoke.py`` uses the helpers here for its timings.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0: 64 results per clock per SM for 32-bit integer add, shift
# and bitwise logic; a LOP3 (any three-input logic function) or a funnel
# shift is one such result.
INT32_OPS_PER_CLOCK_PER_SM = 64

# The tile sweep's grid and board.
TILE_ROWS = (32, 64, 128, 256, 512)
STRIPS = (4, 8, 16)
SWEEP_SHAPE = (65536, 2048)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card() -> Dict:
    """Name, power limit, max SM clock and SM count of GPU 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: card facts come only from a GPU")
    name_power = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {
        "name_power": name_power,
        "kind": torch.cuda.get_device_name(0),
        "max_sm_clock_mhz": clock_mhz,
        "sms": sms,
        "int32_ops_per_s": sms * INT32_OPS_PER_CLOCK_PER_SM * clock_mhz * 1e6,
    }


def time_ms(fn: Callable[[], object], reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call on the card's clock (CUDA events around
    ``reps`` calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sweep_bound(h: int, nw: int, k: int, rule, int32_ops_per_s: float) -> Dict:
    """The least time one k-generation sweep of an (h, nw) board could take:
    one read and one write of the words over HBM, or the step's LOP3/SHF
    instructions (``ops_per_word_step``) over the integer rate, whichever is
    larger."""
    from akka_game_of_life_tpu_torch.ops.packed_sweep import ops_per_word_step

    bytes_ms = 2 * h * nw * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_per_word_step(rule) * h * nw * k / int32_ops_per_s * 1e3
    return _bound(bytes_ms, ops_ms)


def gen_sweep_bound(m: int, h: int, nw: int, k: int, rule, int32_ops_per_s: float) -> Dict:
    """The least time one k-generation plane sweep of m (h, nw) planes
    could take: one read and one write of every plane over HBM, or the
    plane step's LOP3/SHF instructions (``gen_sweep.ops_per_word_step``)
    over the integer rate, whichever is larger."""
    from akka_game_of_life_tpu_torch.ops.gen_sweep import ops_per_word_step

    bytes_ms = 2 * m * h * nw * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_per_word_step(rule) * h * nw * k / int32_ops_per_s * 1e3
    return _bound(bytes_ms, ops_ms)


def ltl_bound(h: int, w: int, rule, int32_ops_per_s: float) -> Dict:
    """The least time one LtL generation of an (h, w) uint8 board could
    take: 2 B per cell (one read, one write) over HBM, or the step's
    integer operations per cell (``ltl_sweep.ops_per_cell``) over the
    integer rate, whichever is larger."""
    from akka_game_of_life_tpu_torch.ops.ltl_sweep import ops_per_cell

    bytes_ms = 2 * h * w / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_per_cell(rule) * h * w / int32_ops_per_s * 1e3
    return _bound(bytes_ms, ops_ms)


def _bound(bytes_ms: float, ops_ms: float) -> Dict:
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
    }


def main(argv=None) -> int:
    from akka_game_of_life_tpu_torch.ops import _build, bitpack, packed_sweep
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    p = argparse.ArgumentParser(prog="akka_game_of_life_tpu_torch.bench")
    p.add_argument("--depths", default="2,3,4,5,6,10,12,15,20,30")
    args = p.parse_args(argv)

    info = card()
    variants = {
        (tb, ny): (f"-DTILE_ROWS={tb}", f"-DSTRIPS={ny}")
        for tb in TILE_ROWS for ny in STRIPS
    }
    build_s = {
        f"{tb}x{ny}": _build.load("packed_sweep", defines).seconds
        for (tb, ny), defines in variants.items()
    }
    print(json.dumps({"card": info, "build_s": build_s}), flush=True)
    rule = resolve_rule("conway")
    h, nw = SWEEP_SHAPE
    x = bitpack.words_from_numpy(
        np.random.default_rng(0).integers(0, 2**32, size=(h, nw), dtype=np.uint32),
        "cuda",
    )
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    rows = []
    for k in (int(v) for v in args.depths.split(",")):
        plain = packed_sweep.packed_sweep_reference(x, rule, k)
        bound = sweep_bound(h, nw, k, rule, info["int32_ops_per_s"])
        for (tb, ny), defines in variants.items():
            run = lambda: packed_sweep._launch(x, rule, k, defines)
            if not torch.equal(run(), plain):
                raise SystemExit(f"mismatch at k={k} tile_rows={tb} strips={ny}")
            ms = time_ms(run, reps=10)
            row = {
                "k": k, "tile_rows": tb, "strips": ny,
                "ms_per_sweep": ms, "ms_per_generation": ms / k,
                "cell_updates_per_s": h * nw * 32 * k / (ms / 1e3),
                "share_of_bound": bound["bound_ms"] / ms, **bound,
                "card": info["name_power"],
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
        del plain
    with open(out_dir / "sweep_tiles.jsonl", "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    best = min(rows, key=lambda r: r["ms_per_generation"])
    print(json.dumps({"best": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
