"""The port's cluster chunk engine (``_torch_engine``) on the CPU.

Against the JAX package's ``_jax_engine(rule, pallas="interpret")`` (the
Mosaic chunk sweep in interpret mode) and the numpy peeling oracle
``_np_chunk``, at the awkward slab shapes of the JAX engine's own tests
(48, 136 and 260 rows, odd widths, ``steps < halo``), plus a Generations
rule, single-step chunks and ``pallas="off"``.  Also: ``interpret`` is
refused by name, and a sweep that raises makes the engine raise — the port
has no demotion to a plain path.
"""

import numpy as np
import pytest

from akka_game_of_life_tpu.ops.rules import resolve_rule as jresolve
from akka_game_of_life_tpu.runtime.backend import _jax_engine, _np_chunk
from akka_game_of_life_tpu_torch.ops import packed_sweep
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
from akka_game_of_life_tpu_torch.runtime.backend import _np_chunk as t_np_chunk
from akka_game_of_life_tpu_torch.runtime.backend import _torch_engine

SLABS = [
    (40, 40, 4, 4),  # 48 rows
    (120, 56, 8, 8),  # 136 rows, width 72: column junk
    (250, 70, 2, 5),  # 260 rows, steps < halo
]


def _slab(h, w, halo, states=2, seed=0):
    rng = np.random.default_rng(h + w + halo + seed)
    return rng.integers(0, states, size=(h + 2 * halo, w + 2 * halo), dtype=np.uint8)


@pytest.mark.parametrize("h,w,steps,halo", SLABS)
@pytest.mark.parametrize("rule", ["conway", "highlife"])
def test_chunk_matches_jax_interpret_and_np(h, w, steps, halo, rule):
    padded = _slab(h, w, halo)
    got = _torch_engine(resolve_rule(rule), device="cpu")(padded, steps, halo)
    jax_run = _jax_engine(jresolve(rule), pallas="interpret")
    assert got.shape == (h, w) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_run(padded, steps, halo))
    np.testing.assert_array_equal(got, _np_chunk(padded, steps, halo, jresolve(rule)))


@pytest.mark.parametrize(
    "rule,states,steps,halo",
    [
        ("brians-brain", 3, 4, 4),  # Generations: the plain plane step
        ("wireworld", 4, 3, 5),
        ("conway", 2, 1, 3),  # single step: the plain dense stencil
        ("brians-brain", 3, 1, 1),
    ],
)
def test_plane_and_single_step_chunks(rule, states, steps, halo):
    padded = _slab(30, 45, halo, states=states, seed=steps)
    got = _torch_engine(resolve_rule(rule), device="cpu")(padded, steps, halo)
    want = _np_chunk(padded, steps, halo, jresolve(rule))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _jax_engine(jresolve(rule), pallas="off")(padded, steps, halo)
    )


def test_pallas_off_keeps_the_plain_packed_loop(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("pallas='off' must not reach the sweep")

    monkeypatch.setattr(packed_sweep, "packed_multi_step_fn", boom)
    padded = _slab(40, 40, 4)
    got = _torch_engine(resolve_rule("conway"), pallas="off", device="cpu")(padded, 4, 4)
    np.testing.assert_array_equal(got, _np_chunk(padded, 4, 4, jresolve("conway")))


def test_engine_caches_and_repeats():
    rule = resolve_rule("conway")
    run = _torch_engine(rule, device="cpu")
    padded = _slab(32, 32, 8)
    for steps in (4, 4, 2, 8):
        np.testing.assert_array_equal(
            run(padded, steps, 8), t_np_chunk(padded, steps, 8, rule)
        )


def test_interpret_and_unknown_modes_refused():
    with pytest.raises(ValueError, match="interpret"):
        _torch_engine(resolve_rule("conway"), pallas="interpret", device="cpu")
    with pytest.raises(ValueError, match="pallas mode"):
        _torch_engine(resolve_rule("conway"), pallas="interperet", device="cpu")


def test_failing_sweep_raises_no_demotion(monkeypatch):
    """The inverse of the JAX engine's demotion test: a sweep that fails
    makes the chunk raise; nothing falls back to a plain path."""

    def broken(rule, n_steps, **kw):
        def run(words):
            raise RuntimeError("packed_sweep_launch failed: CUDA error 700")

        return run

    monkeypatch.setattr(packed_sweep, "packed_multi_step_fn", broken)
    run = _torch_engine(resolve_rule("conway"), device="cpu")
    padded = _slab(40, 40, 4)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        run(padded, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        run(padded, 4, 4)  # still raising: no silent switch after a failure


def test_default_device_raises_without_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _torch_engine(resolve_rule("conway"))


def test_chunk_registers_in_program_ledger():
    """Each chunk is one ``worker_chunk`` call and, for a binary chunk of
    two or more steps, one call of the packed sweep's ``pallas`` program
    inside it: the port counts the inner program on every call, where JAX
    traces it once under its outer jit."""
    from akka_game_of_life_tpu_torch.obs.programs import get_programs

    def calls(family):
        return get_programs().family_summary().get(family, {}).get("calls", 0)

    run = _torch_engine(resolve_rule("conway"), device="cpu")
    before = {f: calls(f) for f in ("worker_chunk", "pallas")}
    padded = _slab(16, 32, 2)  # 20 x 36 cells, padded to 2 words a row
    for n in (1, 2):
        run(padded, 2, 2)
        assert calls("worker_chunk") == before["worker_chunk"] + n
        assert calls("pallas") == before["pallas"] + n
    fam = get_programs().family_summary()["worker_chunk"]
    assert fam["cells"] > 0
    keys = {p["key"] for p in get_programs().snapshot()["programs"] if p["family"] == "pallas"}
    assert repr(("packed_multi_step", "conway", 2, packed_sweep.DEFAULT_TILE_ROWS)) in keys
