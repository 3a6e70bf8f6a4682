"""Native (C++) host engines, loaded with ctypes.

Counterpart of ``akka_game_of_life_tpu/native/__init__.py``, over the port's
own copies of the sources: the per-cell actor engine (``actor_engine.cpp``,
the CPU parity backend, BASELINE config 1) and the SWAR chunk stepper
(``swar_kernel.cpp``, 64 cells per uint64 lane, the host twin of the packed
sweep).  They are host machine code, not device kernels, so they stay C++
built with g++.

Build: the sources are compiled together at first use with ``g++ -O2
-std=c++17 -shared -fPIC -pthread`` into one library under ``build/native/``
at the root of the checkout, named by a hash of the sources and the compiler
argv, written under a temporary name and moved into place with
``os.replace`` (concurrent builders race safely).  Importing this module
builds nothing.  A missing compiler or a failed build raises
``RuntimeError`` with the compiler's stderr: no caller falls back to the
Python actor engine or to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRCS = [
    str(Path(__file__).resolve().parent / "actor_engine.cpp"),
    str(Path(__file__).resolve().parent / "swar_kernel.cpp"),
]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ae_create.restype = ctypes.c_void_p
    lib.ae_create.argtypes = [
        ctypes.c_int32, ctypes.c_int32, u8p,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.ae_destroy.argtypes = [ctypes.c_void_p]
    lib.ae_advance_to.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ae_crash_cell.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    lib.ae_feed_halo.argtypes = [ctypes.c_void_p, ctypes.c_int32, u8p]
    lib.ae_get_board.argtypes = [ctypes.c_void_p, u8p]
    lib.ae_min_epoch.restype = ctypes.c_int32
    lib.ae_min_epoch.argtypes = [ctypes.c_void_p]
    lib.ae_messages.restype = ctypes.c_int64
    lib.ae_messages.argtypes = [ctypes.c_void_p]
    lib.ae_prune_below.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.swar_chunk.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_uint32, u8p,
    ]
    lib.swar_wire_chunk.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, u8p,
    ]
    lib.swar_gen_chunk.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32, u8p,
    ]
    return lib


def library_path() -> Path:
    """Where the library of these sources and flags lives (built or not)."""
    hasher = hashlib.sha256()
    # The key spans the compiler argv as well as the sources: a flag-only
    # change must not load a binary built under the old flags.
    hasher.update(" ".join(FLAGS).encode())
    for src in _SRCS:
        with open(src, "rb") as f:
            hasher.update(f.read())
    return BUILD_DIR / f"gol_native_{hasher.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The native engine library, compiled first if no build of these
    sources and flags exists.  Raises ``RuntimeError`` with the compiler's
    stderr when g++ is missing or the build fails (a later call tries
    again)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so_path = library_path()
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                subprocess.run(
                    [*FLAGS, *_SRCS, "-o", str(tmp)],
                    check=True, capture_output=True, timeout=300,
                )
            except (OSError, subprocess.SubprocessError) as e:
                tmp.unlink(missing_ok=True)
                stderr = getattr(e, "stderr", b"") or b""
                raise RuntimeError(
                    f"native engine unavailable: the g++ build failed "
                    f"({type(e).__name__}: {e})\n"
                    f"{stderr.decode(errors='replace')}"
                ) from e
            os.replace(tmp, so_path)
        _lib = _configure(ctypes.CDLL(str(so_path)))
        return _lib
