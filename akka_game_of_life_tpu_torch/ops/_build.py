"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds).  Libraries go into ``build/kernels/`` at
the root of the checkout, named by a hash of the source and the flags, and are
built at first use: importing this module needs no ``nvcc``.  ``load`` is safe
across threads (the cluster's in-process workers reach it together at their
first chunk): one lock per library serializes the builds of the same source
and flags while different libraries build side by side, and the temporary
file is named per process and thread, so concurrent builds from other
processes do not collide either.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_LOCKS_LOCK = threading.Lock()
_LOCKS: Dict[Path, threading.Lock] = {}


class Built(NamedTuple):
    lib: ctypes.CDLL
    seconds: float  # spent in nvcc by this process; 0.0 if already built
    log: str  # nvcc's output, with ptxas's register and shared-memory report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.lru_cache(maxsize=None)
def load(name: str, defines: Tuple[str, ...] = ()) -> Built:
    """The library of ``csrc/<name>.cu`` built with the extra ``defines``
    (``-D`` flags), compiled first if no build of this source and these
    flags exists."""
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *defines)
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    lib = BUILD_DIR / f"{name}-{key[:16]}.so"
    seconds, log = 0.0, ""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(lib, threading.Lock())
    with lock:
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            seconds, log = time.perf_counter() - t0, proc.stdout
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
            os.replace(tmp, lib)
        return Built(ctypes.CDLL(str(lib)), seconds, log)
