"""The program ledger (``obs/programs.py``) in both packages, on the CPU.

Three parts:

- **the contract**: the cases of ``tests/test_programs.py`` (wrap counts
  and prices, callable costs, the disabled pass-through, one storm per new
  post-warm program, federation reclaiming every label, device gauges, the
  ``/programs`` and ``/cost`` HTTP contract, ``registered_jit`` reaching the
  global registry), each run on the JAX package's ledger and on the port's;
  the JAX package's TPU anchor (``vs_r3b_headline``,
  ``headline_cells_per_s``) is left out, since the port carries none;
- **the sites**: the set of family names passed to ``registered_jit(`` in
  the port equals the JAX package's, read from the sources, with the
  port's own ``digest`` (its board digest is a program of the ledger; the
  JAX package's is not registered);
- **the same ledger**: each registered program factory on ``run``'s paths
  runs in both packages at 64² or less, through ``Simulation`` or the CLI
  (the sweeps with JAX in interpret mode) or, for the factories no ``run``
  reaches in either package, called directly; both ledgers must hold the
  same ``(family, key)`` set and, per family, the same ``calls``, ``cells``,
  ``bytes`` and ``flops``, the port's own families aside (checked on their
  own).  On the CPU the port's seconds are host wall time.

Plus the port's own timing rule, with stand-in events: a call on the card
leaves its event pair pending, the record's next call resolves it without
waiting, and every report waits for what is left.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import io
import json
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import akka_game_of_life_tpu.obs.catalog as j_catalog
import akka_game_of_life_tpu.obs.httpd as j_httpd
import akka_game_of_life_tpu.obs.metrics as j_metrics
import akka_game_of_life_tpu.obs.programs as j_programs
import akka_game_of_life_tpu.runtime.profiling as j_profiling
import akka_game_of_life_tpu_torch.obs.catalog as t_catalog
import akka_game_of_life_tpu_torch.obs.httpd as t_httpd
import akka_game_of_life_tpu_torch.obs.metrics as t_metrics
import akka_game_of_life_tpu_torch.obs.programs as t_programs
import akka_game_of_life_tpu_torch.runtime.profiling as t_profiling
from akka_game_of_life_tpu import cli as jcli
from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
from akka_game_of_life_tpu.runtime.render import BoardObserver as JObserver
from akka_game_of_life_tpu.runtime.simulation import Simulation as JSimulation
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver
from akka_game_of_life_tpu_torch.runtime.simulation import Simulation
from test_torch_steppers_run import RUNS

ROOT = Path(__file__).resolve().parent.parent

PKGS = {
    "jax": types.SimpleNamespace(
        programs=j_programs, catalog=j_catalog, httpd=j_httpd,
        metrics=j_metrics, profiling=j_profiling,
    ),
    "torch": types.SimpleNamespace(
        programs=t_programs, catalog=t_catalog, httpd=t_httpd,
        metrics=t_metrics, profiling=t_profiling,
    ),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _fresh(pkg, **kw):
    reg = pkg.programs.ProgramRegistry(node=kw.pop("node", "test"))
    reg.configure(metrics=pkg.catalog.install(pkg.metrics.MetricsRegistry()), **kw)
    return reg


class _RecEvents:
    def __init__(self):
        self.events = []

    def emit(self, name, **fields):
        self.events.append((name, fields))


class _RecFlight:
    def __init__(self):
        self.dumps = []

    def dump(self, reason, **fields):
        self.dumps.append(reason)
        return f"/tmp/{reason}"


# -- the contract, on both ledgers ----------------------------------------------


def test_wrap_times_counts_and_prices(pkg):
    reg = _fresh(pkg)
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2

    want = pkg.programs.stencil_cost(64, 64, steps=4)
    wrapped = reg.wrap("stencil", ("step", "B3/S23", 64), fn, cost=want)
    assert wrapped is not fn and wrapped.__wrapped__ is fn
    assert wrapped(3) == 6 and wrapped(5) == 10
    assert calls == [3, 5]

    snap = reg.snapshot()
    assert snap["node"] == "test" and not snap["warm"]
    (rec,) = snap["programs"]
    assert rec["family"] == "stencil"
    assert rec["key"] == repr(("step", "B3/S23", 64))
    assert rec["calls"] == 2
    assert rec["compile_seconds"] is not None
    assert rec["seconds"] >= rec["compile_seconds"] >= 0.0
    assert rec["cells"] == pytest.approx(2 * want["cells"])
    assert rec["bytes"] == pytest.approx(2 * want["bytes"])
    assert rec["flops"] == pytest.approx(2 * want["flops"])

    fams = reg.family_summary()
    assert fams["stencil"]["programs"] == 1 and fams["stencil"]["calls"] == 2
    st = reg.cost_doc()["families"]["stencil"]
    assert st["cell_updates_per_s"] > 0
    assert st["arithmetic_intensity"] == pytest.approx(want["flops"] / want["bytes"])


def test_wrap_callable_cost_prices_from_call_args(pkg):
    reg = _fresh(pkg)

    class Board:
        shape = (8, 16, 16)

    wrapped = reg.wrap(
        "serve_batch", (16, 4), lambda b: b,
        cost=lambda b: pkg.programs.stencil_cost(16, 16, 4, boards=b.shape[0]),
    )
    wrapped(Board())
    (rec,) = reg.snapshot()["programs"]
    assert rec["cells"] == pytest.approx(8 * 16 * 16 * 4)


def test_disabled_registry_is_passthrough(pkg):
    reg = _fresh(pkg)
    reg.configure(enabled=False)

    def fn():
        return 1

    assert reg.wrap("stencil", "k", fn) is fn
    assert reg.snapshot()["programs"] == []


def test_storm_fires_once_per_novel_post_warm_program(pkg):
    events, flight = _RecEvents(), _RecFlight()
    reg = _fresh(pkg, node="stormy", events=events, flight=flight)

    pre = reg.wrap("serve_batch", (16, 2), lambda: "pre")
    pre()
    reg.mark_warm()
    assert reg.warm and reg.storms == 0
    pre()  # a warmed program re-running is steady state
    assert reg.storms == 0

    post = reg.wrap("serve_batch", (64, 2), lambda: "post")
    assert reg.storms == 0  # registration alone is not a compile
    post()
    post()
    assert reg.storms == 1

    (name, fields), = events.events
    assert name == "compile_storm"
    assert fields["family"] == "serve_batch" and fields["node"] == "stormy"
    assert fields["compile_seconds"] is not None
    assert flight.dumps == ["compile_storm"]
    summary = reg.summary()
    assert summary["storms"] == 1 and summary["warm"]
    assert summary["families"]["serve_batch"]["programs"] == 2


def _cost_frame():
    return {
        "node": "w1",
        "warm": True,
        "storms": 2,
        "families": {
            "bitpack": {
                "programs": 3, "compile_seconds": 1.5, "calls": 10,
                "seconds": 2.0, "cells": 4.0e9, "bytes": 1.0e9, "flops": 7.2e10,
            }
        },
        "devices": {"cuda:0": {"bytes_in_use": 512, "peak_bytes_in_use": 640}},
    }


def _labels(metrics, name, label):
    gauge = metrics.gauge(name, "", (label,))
    return {labels[label]: child.value for labels, child in gauge.series()}


def test_merge_and_forget_remote_reclaims_every_label(pkg):
    reg = _fresh(pkg)
    metrics = reg._metrics  # noqa: SLF001 — the exported surface
    reg.wrap("stencil", "k", lambda: None)()

    reg.merge_remote("w1", _cost_frame())
    assert _labels(metrics, "gol_programs_live", "family") == {"stencil": 1, "bitpack": 3}
    assert "w1:cuda:0" in _labels(metrics, "gol_device_bytes_in_use", "device")
    merged = reg.cost_doc()
    assert merged["families"]["bitpack"]["cell_updates_per_s"] == pytest.approx(2.0e9)
    assert merged["storms"] == 2 and "w1:cuda:0" in merged["devices"]
    health = reg.health_summary()
    assert health["members"]["w1"] == {"warm": True, "storms": 2, "programs": 3}
    assert health["programs"] == 4
    assert reg.snapshot()["members"]["w1"]["families"]["bitpack"]["calls"] == 10

    reg.forget_remote("w1")
    assert _labels(metrics, "gol_programs_live", "family") == {"stencil": 1}
    assert "w1:cuda:0" not in _labels(metrics, "gol_device_bytes_in_use", "device")
    assert reg.health_summary()["members"] == {}


def test_refresh_device_gauges_reclaims_stale_devices(pkg):
    reg = _fresh(pkg)
    metrics = reg._metrics  # noqa: SLF001
    reg.refresh_device_gauges({"cuda:0": {"bytes_in_use": 1}, "cuda:1": {"bytes_in_use": 2}})
    assert set(_labels(metrics, "gol_device_bytes_in_use", "device")) == {"cuda:0", "cuda:1"}
    reg.refresh_device_gauges({"cuda:0": {"bytes_in_use": 3}})
    assert set(_labels(metrics, "gol_device_bytes_in_use", "device")) == {"cuda:0"}


def _http(base, method, path, doc=None, raw=None):
    data = raw if raw is not None else (json.dumps(doc).encode() if doc is not None else None)
    req = urllib.request.Request(base + path, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_programs_cost_profile_contract(pkg, tmp_path):
    reg = _fresh(pkg, node="edge")
    reg.wrap("stencil", "k", lambda: None)()
    now = [0.0]
    cap = pkg.profiling.ProfilerCapture(
        str(tmp_path), node="edge", max_seconds=5.0, min_interval_s=60.0,
        clock=lambda: now[0], sleep=lambda s: None,
        start=lambda path: None, stop=lambda *prof: None,
    )
    server = pkg.httpd.MetricsServer(
        pkg.catalog.install(pkg.metrics.MetricsRegistry()), port=0, host="127.0.0.1",
        routes=pkg.programs.http_routes(registry=reg, profile=cap.capture),
    )
    base = f"http://127.0.0.1:{server.port}"
    try:
        status, doc = _http(base, "GET", "/programs")
        assert status == 200 and doc["node"] == "edge"
        assert doc["programs"][0]["family"] == "stencil"
        status, doc = _http(base, "GET", "/cost?window=ignored")
        assert status == 200 and "stencil" in doc["families"]

        assert _http(base, "POST", "/programs", {})[0] == 405
        assert _http(base, "POST", "/cost", {})[0] == 405
        assert _http(base, "GET", "/profile")[0] == 405

        status, doc = _http(base, "POST", "/profile?seconds=2", raw=b"")
        assert status == 200 and doc["seconds"] == 2.0
        status, doc = _http(base, "POST", "/profile?seconds=2", raw=b"")
        assert status == 429 and doc["retry_after_s"] > 0
        now[0] += 61.0
        status, doc = _http(base, "POST", "/profile", {"seconds": 1.5})
        assert status == 200 and doc["seconds"] == 1.5
        now[0] += 61.0
        assert _http(base, "POST", "/profile", raw=b"not json")[0] == 400
        assert _http(base, "POST", "/profile?seconds=bogus", raw=b"")[0] == 400
    finally:
        server.close()


def test_registered_jit_routes_through_global_registry(pkg):
    programs = pkg.programs.get_programs()
    programs.reset()
    programs.configure(node="g", metrics=pkg.catalog.install(pkg.metrics.MetricsRegistry()))
    try:
        assert pkg.programs.registered_jit("ltl", ("r", 7), lambda x: x)(4) == 4
        assert [p["family"] for p in programs.snapshot()["programs"]] == ["ltl"]
    finally:
        programs.reset()


# -- the sites ------------------------------------------------------------------


def _families(package: str) -> set:
    """Every string literal passed as the family of a ``registered_jit(``
    call in the package's sources."""
    found = set()
    for path in (ROOT / package).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (
                isinstance(node, ast.Call)
                and getattr(node.func, "id", getattr(node.func, "attr", None)) == "registered_jit"
                and node.args
                and isinstance(node.args[0], ast.Constant)
            ):
                found.add(node.args[0].value)
    return found


# Families only the port registers: ``digest``, each ``ops/digest.py``
# ``digest_packed`` call, so the digest's device time is on the ledger.
PORT_ONLY_FAMILIES = frozenset({"digest"})


def test_port_registers_the_jax_packages_families():
    want = _families("akka_game_of_life_tpu")
    assert "pallas" in want and "sparse" in want
    assert not want & PORT_ONLY_FAMILIES
    assert _families("akka_game_of_life_tpu_torch") == want | PORT_ONLY_FAMILIES


# -- the same ledger --------------------------------------------------------------

# Every factory that caches a registered program in the JAX package: a
# record bound before a registry reset would take later calls out of view.
_JAX_CACHED = [
    ("ops.pallas_stencil", "packed_multi_step_fn"),
    ("ops.pallas_gen", "gen_pallas_multi_step_fn"),
    ("ops.pallas_ltl", "ltl_pallas_multi_step_fn"),
    ("ops.bitpack", "packed_step_fn"),
    ("ops.bitpack", "packed_multi_step_fn"),
    ("ops.bitpack_gen", "gen_multi_step_fn"),
    ("ops.stencil", "step_fn"),
    ("ops.stencil", "multi_step_fn"),
    ("ops.ltl", "ltl_multi_step_fn"),
    ("ops.matmul_stencil", "matmul_multi_step_fn"),
    ("ops.fastforward", "_jump_pow2_fn"),
    ("ops.fastforward", "jump_matmul_fn"),
]
_PORT_CACHED = [("ops.fastforward", "_jump_pow2_fn"), ("ops.fastforward", "jump_matmul_fn")]


@contextlib.contextmanager
def _ledger(package: str, programs):
    """A clean ledger for one run: the package's program caches emptied
    and its registry reset, before and after."""
    cached = _JAX_CACHED if package == "akka_game_of_life_tpu" else _PORT_CACHED

    def clear():
        for module, name in cached:
            getattr(importlib.import_module(f"{package}.{module}"), name).cache_clear()
        programs.reset()

    clear()
    try:
        yield programs
    finally:
        clear()


def _view(programs, drop=frozenset()) -> tuple:
    keys = sorted((p["family"], p["key"]) for p in programs.snapshot()["programs"]
                  if p["family"] not in drop)
    fams = {
        family: {k: agg[k] for k in ("programs", "calls", "cells", "bytes", "flops")}
        for family, agg in programs.family_summary().items()
        if family not in drop
    }
    return keys, fams


@pytest.fixture
def one_jax_device(monkeypatch):
    """The JAX Simulation meshes over every device it sees (the tests'
    eight virtual ones); the port's single-device runs are held against
    its single-device run."""
    import jax

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:1])


def _both(jax_fn, port_fn) -> tuple:
    with _ledger("akka_game_of_life_tpu", j_programs.get_programs()) as programs:
        jax_fn()
        want = _view(programs)
    with _ledger("akka_game_of_life_tpu_torch", t_programs.get_programs()) as programs:
        port_fn()
        got = _view(programs, PORT_ONLY_FAMILIES)
    return want, got


SIM = dict(height=64, width=64, seed=3, steps_per_call=8)
# (config, epochs, family): rows 1-6 of the ledger's sites through
# Simulation.  The sweeps pin the tile (the port re-measured its default on
# the card) at a depth both packages sweep in one pass.
SIM_CASES = {
    "pallas": (dict(kernel="pallas", pallas_block_rows=16), 16),
    "pallas_gen": (dict(kernel="pallas", pallas_block_rows=16, rule="wireworld",
                        pattern="wireworld-clock"), 16),
    "pallas_ltl": (dict(kernel="pallas", pallas_block_rows=16, rule="bugs", steps_per_call=2), 4),
    "bitpack": (dict(kernel="bitpack"), 16),
    "bitpack_gen": (dict(kernel="bitpack", rule="brians-brain"), 16),
    "stencil": (dict(kernel="dense"), 16),
    "stencil-ltl": (dict(kernel="dense", rule="bugs", steps_per_call=2), 4),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulation_ledgers_match_jax(case, one_jax_device):
    kw, epochs = SIM_CASES[case]
    kw = {**SIM, **kw}

    def jax_run():
        JSimulation(JConfig(**kw), observer=JObserver(out=io.StringIO())).advance(epochs)

    def port_run():
        Simulation(SimulationConfig(**kw), observer=BoardObserver(out=io.StringIO()),
                   device="cpu").advance(epochs)

    want, got = _both(jax_run, port_run)
    assert got == want
    family = case.split("-")[0]
    assert want[1][family]["calls"] == epochs // kw["steps_per_call"]


@pytest.mark.parametrize("layout", ["words", "planes"])
def test_simulation_digest_is_a_program_of_the_port(layout):
    """Each cadence digest of a packed board is one ``digest`` call a
    plane, keyed by the words' shape and the width, priced as one read of
    the words."""
    kw = {**SIM, "metrics_every": 8, "obs_digest": True}
    if layout == "planes":
        kw.update(rule="wireworld", pattern="wireworld-clock")
    with _ledger("akka_game_of_life_tpu_torch", t_programs.get_programs()) as programs:
        Simulation(SimulationConfig(**kw), observer=BoardObserver(out=io.StringIO()),
                   device="cpu").advance(24)
        keys, fams = _view(programs)
    planes = 2 if layout == "planes" else 1
    assert ("digest", repr(("packed", 64, 2, 64))) in keys
    assert fams["digest"]["programs"] == 1
    assert fams["digest"]["calls"] == 3 * planes
    assert fams["digest"]["bytes"] == 3 * planes * 64 * 2 * 4
    assert fams["digest"]["cells"] == 0


def test_the_digest_bills_no_compile_and_raises_no_storm():
    """The digest's eager passes build nothing: its first call is a call,
    not a compile, even for a new shape on a ledger marked warm."""
    from akka_game_of_life_tpu_torch.ops.digest import digest_packed

    metrics = t_catalog.install(t_metrics.MetricsRegistry())
    with _ledger("akka_game_of_life_tpu_torch", t_programs.get_programs()) as programs:
        programs.configure(metrics=metrics)
        words = torch.randint(-2**31, 2**31 - 1, (16, 2), dtype=torch.int32)
        digest_packed(words, 64)
        programs.mark_warm()
        digest_packed(words[:8], 64)
        digest_packed(words[:8], 64)
        recs = {p["key"]: p for p in programs.snapshot()["programs"]}
        rec16, rec8 = recs[repr(("packed", 16, 2, 64))], recs[repr(("packed", 8, 2, 64))]
        assert (rec16["calls"], rec8["calls"]) == (1, 2)
        assert rec16["compile_seconds"] == rec8["compile_seconds"] == 0.0
        assert programs.storms == 0
        assert programs.family_summary()["digest"]["compile_seconds"] == 0.0
    assert "gol_compile_seconds" not in metrics.snapshot()


# Rows 8-10 through the CLI on the runs of test_torch_steppers_run.  `auto`
# takes the packed sweep in the port and bitpack in JAX on the CPU: pinned.
PIN = {"ff-words": ["--kernel", "bitpack"]}
FAMILIES = {"matmul": "matmul", "sparse": "sparse", "ff": "fastforward"}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_cli_run_ledgers_match_jax(name, one_jax_device):
    args = [*RUNS[name], *PIN.get(name, [])]

    def cli(main, *flags):
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(["run", *flags, *args]) == 0

    want, got = _both(lambda: cli(jcli.main, "--platform", "cpu"),
                      lambda: cli(tcli.main, "--device", "cpu"))
    assert got == want
    assert want[1][FAMILIES[name.split("-")[0]]]["calls"] > 0


def _direct_cases():
    """The factories no ``run`` reaches in either package: (JAX call, port
    call) on the same board."""
    import jax.numpy as jnp

    from akka_game_of_life_tpu.models.registry import get_model as jget_model
    from akka_game_of_life_tpu.ops import bitpack as jbitpack
    from akka_game_of_life_tpu.ops import fastforward as jff
    from akka_game_of_life_tpu.ops import ltl as jltl
    from akka_game_of_life_tpu.ops.rules import resolve_rule as jrule
    from akka_game_of_life_tpu_torch.models.registry import get_model
    from akka_game_of_life_tpu_torch.ops import bitpack, fastforward, ltl
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    board = (np.random.default_rng(7).random((40, 64)) < 0.4).astype(np.uint8)
    words = bitpack.pack_np(board)
    return {
        "bitpack-step": (
            lambda: jbitpack.packed_step_fn(jrule("conway"))(jnp.asarray(words)),
            lambda: bitpack.packed_step_fn("conway")(torch.from_numpy(words.view(np.int32))),
        ),
        "stencil-step": (
            lambda: jget_model("highlife").step(jnp.asarray(board)),
            lambda: get_model("highlife").step(torch.from_numpy(board)),
        ),
        "ltl": (
            lambda: jltl.ltl_multi_step_fn(jrule("bugs"), 2)(jnp.asarray(board)),
            lambda: ltl.ltl_multi_step_fn("bugs", 2)(torch.from_numpy(board)),
        ),
        "ltl-matmul": (
            lambda: jltl.ltl_multi_step_fn(jrule("bugs"), 1, "matmul")(jnp.asarray(board)),
            lambda: ltl.ltl_multi_step_fn("bugs", 1, "matmul")(torch.from_numpy(board)),
        ),
        "jump_matmul": (
            lambda: jff.jump_matmul_fn(jrule("fredkin"), 1000, (40, 64), "f32")(jnp.asarray(board)),
            lambda: fastforward.jump_matmul_fn("fredkin", 1000, (40, 64), "f32", "cpu")(
                torch.from_numpy(board)),
        ),
    }


@pytest.mark.parametrize(
    "case", ["bitpack-step", "stencil-step", "ltl", "ltl-matmul", "jump_matmul"]
)
def test_direct_factory_ledgers_match_jax(case):
    jax_call, port_call = _direct_cases()[case]
    want, got = _both(jax_call, port_call)
    assert got == want
    assert sum(f["calls"] for f in want[1].values()) == 1


# -- the port's timing rule ---------------------------------------------------------


class _Card:
    """A stand-in card clock (ms) with events that record on it: a pair is
    finished once the card has run past its stop."""

    def __init__(self):
        self.now = 0.0
        self.done = 0.0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                self.t, self.waits = None, 0

            def record(self, stream=None):
                self.t = card.now

            def query(self):
                return card.done >= self.t

            def synchronize(self):
                self.waits += 1
                card.done = max(card.done, self.t)

            def elapsed_time(self, stop):
                return stop.t - self.t

        self.Event = Event


@pytest.fixture
def card(monkeypatch):
    """The ledger on a stand-in card: every call is taken as a call on
    ``cuda:0``, its entry recorded on the card clock."""
    c = _Card()
    monkeypatch.setattr(torch.cuda, "Event", c.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")

    def start_event(args, kwargs):
        ev = c.Event()
        ev.record()
        return ev, "cuda:0", True

    monkeypatch.setattr(t_programs, "_start_event", start_event)
    ticks = iter(range(100))
    reg = t_programs.ProgramRegistry(node="card", clock=lambda: float(next(ticks)))
    metrics = t_catalog.install(t_metrics.MetricsRegistry())
    reg.configure(metrics=metrics)
    c.reg = reg
    c.counter = metrics.counter("gol_program_device_seconds_total", "", ("family",))
    return c


def test_card_calls_resolve_later_and_never_wait_in_the_call(card):
    """A call whose events are pending adds nothing to seconds; the next
    call adds the finished pair without waiting; a report waits for the
    rest.  The counter moves with seconds; compile_seconds stays the first
    call's host wall time."""
    stops = []

    def work(ms):
        card.now += ms
        return ms

    fn = card.reg.wrap("stencil", "k", work)
    rec = card.reg._programs[("stencil", "k")]  # noqa: SLF001
    real_stop = t_programs._stop_event

    def watch(start, out):
        pair = real_stop(start, out)
        stops.append(pair[1])
        return pair

    t_programs._stop_event, saved = watch, t_programs._stop_event
    try:
        fn(2.0)
        assert rec.calls == 1 and rec.seconds == 0.0 and rec.compile_s == 1.0
        card.done = card.now  # the card finished the first call
        fn(4.0)
        assert rec.seconds == pytest.approx(0.002) and len(rec.pending) == 1
        fn(10.0)  # the second pair is still running: left pending
        assert rec.seconds == pytest.approx(0.002) and len(rec.pending) == 2
        assert [s.waits for s in stops] == [0, 0, 0]
        assert card.counter.labels(family="stencil").value == pytest.approx(0.002)

        doc = card.reg.cost_doc()["families"]["stencil"]
        assert doc["seconds"] == pytest.approx(0.016) and rec.pending == []
        assert [s.waits for s in stops] == [0, 1, 1]  # the report waited for both
        assert card.counter.labels(family="stencil").value == pytest.approx(0.016)
        assert card.reg.snapshot()["programs"][0]["compile_seconds"] == 1.0
    finally:
        t_programs._stop_event = saved


def test_a_call_on_the_card_counts_from_its_entry(card):
    """The card's time of a call runs from its entry to its exit: host
    dispatch before the first kernel, in which the card waits, is counted;
    an enclosing call counts its own work and the inner call's."""

    def sweep(dispatch_ms, kernels_ms):
        card.now += dispatch_ms  # the card waits on the host's Python
        card.now += kernels_ms

    kernel = card.reg.wrap("pallas", "k", sweep)

    def chunk():
        card.now += 3.0  # the enclosing call's own work
        kernel(0.25, 1.0)

    outer = card.reg.wrap("worker_chunk", "k", chunk)
    kernel(0.125, 2.0)
    outer()
    fams = card.reg.family_summary()
    assert fams["pallas"]["seconds"] == pytest.approx(0.003375)  # 2.125 + 1.25 ms
    assert fams["worker_chunk"]["seconds"] == pytest.approx(0.00425)
    assert fams["pallas"]["calls"] == 2 and fams["worker_chunk"]["calls"] == 1


def test_host_calls_keep_wall_time():
    """CPU tensors and numpy arrays never reach the card's clock."""
    assert t_programs._start_event((torch.zeros(2),), {}) is None
    assert t_programs._start_event((np.zeros(2),), {"x": 1}) is None
    assert t_programs._stop_event(None, torch.zeros(2)) is None
    ticks = iter((0.0, 0.25))
    reg = t_programs.ProgramRegistry(clock=lambda: next(ticks))
    reg.configure(metrics=t_catalog.install(t_metrics.MetricsRegistry()))
    reg.wrap("stencil", "k", lambda x: x + 1)(torch.zeros(2))
    assert reg.family_summary()["stencil"]["seconds"] == 0.25
