"""The kernel build and the launch count are safe across threads.

The cluster's in-process workers reach ``_build.load`` together at their
first chunk.  Two threads racing through it must leave exactly one library
and no temporary file; ``nvcc`` (here a stand-in that writes its output
slowly) runs once.  Their launches must all be counted.
"""

import sys
import threading
import time
from pathlib import Path

from akka_game_of_life_tpu_torch.ops import _build, packed_sweep


def test_two_threads_build_one_library(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "race.cu").write_text("// a kernel\n")
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    calls = []

    def fake_nvcc(cmd, **kw):
        target = Path(cmd[cmd.index("-o") + 1])
        calls.append(target.name)
        with open(target, "wb") as f:  # written slowly, as a real build is
            for _ in range(5):
                f.write(b"\0" * 64)
                f.flush()
                time.sleep(0.01)

        class Done:
            returncode = 0
            stdout = "ptxas info: 0 bytes smem"

        return Done()

    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    _build.load.cache_clear()
    start = threading.Barrier(2)
    results, errors = [], []

    def worker():
        start.wait()
        try:
            results.append(_build.load("race", ("-DTILE_ROWS=64",)))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        _build.load.cache_clear()
    assert not errors, errors
    assert len(results) == 2 and len(calls) == 1
    libs = sorted(p.name for p in out.iterdir())
    assert len(libs) == 1 and libs[0].startswith("race-") and libs[0].endswith(".so")
    assert {r.lib[1] for r in results} == {str(out / libs[0])}
    assert (out / libs[0]).stat().st_size == 320


def test_launch_count_loses_no_increment():
    threads, per_thread = 8, 5000
    before = packed_sweep.packed_sweep.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [
            threading.Thread(
                target=lambda: [packed_sweep._count_launch() for _ in range(per_thread)]
            )
            for _ in range(threads)
        ]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(interval)
    assert packed_sweep.packed_sweep.launches - before == threads * per_thread
    packed_sweep.packed_sweep.launches = before
