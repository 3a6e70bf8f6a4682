"""Card facts, CUDA-event timing and the kernels' bounds.

``chip_smoke.py`` uses these helpers for its timings.  The tile sweep that
lived here is ``python -m akka_game_of_life_tpu_torch tune`` now
(``runtime/autotune.py``), for all three kernels.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Dict

import torch

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s.
HBM_BYTES_PER_S = 3.35e12
# CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0: 64 results per clock per SM for 32-bit integer add, shift
# and bitwise logic; a LOP3 (any three-input logic function) or a funnel
# shift is one such result.
INT32_OPS_PER_CLOCK_PER_SM = 64
# NVIDIA H100 SXM data sheet, dense (no sparsity): int8 and bf16 on the
# tensor cores; float32 outside them (the f32 matmul lane runs at full
# float32, never TF32).
GEMM_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


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


def digest_bound(h: int, nw: int, int32_ops_per_s: float) -> Dict:
    """The least time one digest of an (h, nw) packed board could take:
    one read of the words over HBM, or the kernel's integer-pipe
    instructions per cell (``digest.ALU_OPS_PER_CELL``) over the integer
    rate, whichever is larger."""
    from akka_game_of_life_tpu_torch.ops.digest import ALU_OPS_PER_CELL

    bytes_ms = h * nw * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = ALU_OPS_PER_CELL * h * nw * 32 / int32_ops_per_s * 1e3
    return _bound(bytes_ms, ops_ms)


def matmul_bound(plan) -> Dict:
    """The least time one banded-matmul generation (``MatmulPlan``) could
    take: the board read and written once (uint8) over HBM, or the two
    passes' multiply-adds (two operations each) at the lane's dense peak,
    whichever is larger."""
    h, r, wd = plan.height, plan.radius, plan.packed_width
    macs = h * (plan.row_tile + 2 * r) * (wd + 2 * r) + h * (plan.col_tile + 2 * r) * wd
    bytes_ms = 2 * h * plan.width / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * macs / GEMM_OPS_PER_S[plan.mode] * 1e3
    return _bound(bytes_ms, ops_ms)


def _bound(bytes_ms: float, ops_ms: float) -> Dict:
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
    }
