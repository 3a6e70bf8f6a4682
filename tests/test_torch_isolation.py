"""The PyTorch port stands alone: it never imports JAX, Orbax or the JAX package.

The machine with the GPU has no JAX, so neither the port nor its scripts
(``chip_smoke.py``, ``node_loss_drill.py``, ``serve_drain_drill.py``) may import ``jax`` or
``akka_game_of_life_tpu``, even a numpy-only module of it.  Importing the port must not build a kernel either.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "akka_game_of_life_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "node_loss_drill.py", REPO / "serve_drain_drill.py",
]
FORBIDDEN = ("jax", "jaxlib", "orbax", "akka_game_of_life_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value


def test_sources_exist():
    assert (PORT / "__init__.py").exists() and (REPO / "chip_smoke.py").exists()
    assert len(SOURCES) > 10


def test_parallel_modules_are_covered():
    parallel = PORT / "parallel"
    names = {p.stem for p in parallel.glob("*.py")}
    assert {"mesh", "halo", "packed_halo", "packed_halo2d", "sweep_halo", "digest",
            "distributed"} <= names
    assert all(parallel / f"{name}.py" in SOURCES for name in names)


def test_runtime_modules_are_covered():
    runtime = PORT / "runtime"
    names = {p.stem for p in runtime.glob("*.py")}
    assert {"autotune", "selftest", "profiling", "simulation", "checkpoint",
            "orbax_store"} <= names
    assert all(runtime / f"{name}.py" in SOURCES for name in names)


def test_serve_native_and_host_engine_modules_are_covered():
    """The serving plane, the native host engines and their helpers are
    the port's own copies, checked like every other module."""
    expected = [
        *(PORT / "serve" / f"{n}.py" for n in ("__init__", "api", "batch", "canary", "cluster",
                                               "federation", "memo", "sessions",
                                               "worker")),
        *(PORT / "native" / f"{n}.py" for n in ("__init__", "engine")),
        PORT / "obs" / "slo.py", PORT / "ops" / "macroblock.py", PORT / "runtime" / "actor_engine.py",
    ]
    assert all(path in SOURCES for path in expected)
    assert sorted((PORT / "native").glob("*.cpp")) == [
        PORT / "native" / "actor_engine.cpp", PORT / "native" / "swar_kernel.cpp",
    ]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {mod}"


def test_import_leaves_jax_out():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__main__.py"
    )
    code = (
        "import sys\n"
        f"for m in {modules!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
