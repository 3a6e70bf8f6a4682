"""Share of its roofline that the packed sweep kernel reaches, in %.

Device time: every ``packed_sweep_kernel`` launch inside the traced
slice, by name from ``torch.profiler``.  Bound: one read and one write of
the packed board per ``steps_per_call`` generations, over HBM's published
rate (``core/peaks.py``), whatever implements the step; the board is
``height * width / 8`` bytes.  No operations side: an instruction count
taken from today's kernel would move with the kernel (PERF.md).
"""

from benchmark.core import peaks

KERNEL = "packed_sweep_kernel"


def read(r):
    if r.trace is None or not r.counts.get("traced_calls"):
        return None
    kernel_s = r.trace.op_seconds(KERNEL)
    if kernel_s <= 0:
        return None
    run = r.config["run"]
    board_bytes = run["height"] * run["width"] / 8
    bound_s = r.counts["traced_calls"] * 2 * board_bytes / peaks.HBM_BYTES_PER_S
    return 100.0 * bound_s / kernel_s
