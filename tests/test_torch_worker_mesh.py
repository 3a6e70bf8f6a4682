"""The cluster worker's chunk spread over its devices (``_meshed_engine``).

A worker given several devices row-shards each halo-padded slab over an
(n, 1) mesh and steps it with the mesh's steppers.  On ``['cpu'] * n`` for
n = 2 and 3 (3 leaves junk rows below the slab) the meshed engine must equal
the port's single-device engine and the JAX package's ``_jax_engine``, which
takes its own meshed branch on the conftest's 8 virtual CPU devices, for
binary chunks of k >= 2 steps (the sharded packed sweep), Generations and
WireWorld plane chunks (the sharded plane sweep) and one-step dense chunks
(the sharded dense step).  An in-process cluster of meshed workers must
reach the numpy engine's digests.  Every comparison is exact.
"""

import io

import jax
import numpy as np
import pytest

from akka_game_of_life_tpu.ops.rules import resolve_rule as jresolve
from akka_game_of_life_tpu.runtime.backend import _jax_engine
from akka_game_of_life_tpu_torch.obs.programs import get_programs
from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
from akka_game_of_life_tpu_torch.runtime import backend as tbackend
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig
from akka_game_of_life_tpu_torch.runtime.harness import cluster
from akka_game_of_life_tpu_torch.runtime.render import BoardObserver

CHUNKS = [  # (rule, steps, halo, slab (h, w) interior, states)
    ("conway", 4, 4, (20, 24), 2),
    ("highlife", 10, 10, (30, 40), 2),
    ("brians-brain", 4, 5, (19, 24), 3),
    ("wireworld", 3, 3, (22, 30), 4),
    ("conway", 1, 1, (21, 20), 2),
    ("brians-brain", 1, 2, (16, 18), 3),
]


def _slab(h, w, halo, states, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, states, size=(h + 2 * halo, w + 2 * halo), dtype=np.uint8)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case", range(len(CHUNKS)))
def test_meshed_engine_matches_single_and_jax(n, case):
    rule_name, steps, halo, (h, w), states = CHUNKS[case]
    rule = resolve_rule(rule_name)
    slab = _slab(h, w, halo, states, seed=case)
    assert len(jax.local_devices()) == 8  # the JAX engine's meshed branch
    want = np.asarray(_jax_engine(jresolve(rule_name))(slab, steps, halo))
    single = tbackend._torch_engine(rule, device="cpu")(slab, steps, halo)
    meshed = tbackend._torch_engine(rule, device=["cpu"] * n)(slab, steps, halo)
    assert meshed.shape == (h, w)
    np.testing.assert_array_equal(single, want)
    np.testing.assert_array_equal(meshed, want)
    assert tbackend._meshed_engine(rule, ["cpu"] * n, use_sweep=False)(
        slab, steps, halo
    ).tobytes() == want.tobytes()


def test_meshed_chunk_is_registered_under_its_key():
    rule = resolve_rule("conway")
    slab = _slab(20, 24, 4, 2, seed=7)
    tbackend._torch_engine(rule, device=["cpu"] * 3)(slab, 4, 4)
    keys = [str(p["key"]) for p in get_programs().snapshot()["programs"]
            if p["family"] == "worker_chunk"]
    assert any("'meshed', 'conway', 3, (4, 0)" in k for k in keys), keys


def test_single_device_list_keeps_the_single_engine():
    worker = tbackend.BackendWorker("127.0.0.1", 1, engine="torch", device=["cpu"])
    assert str(worker.device) == "cpu"
    worker = tbackend.BackendWorker("127.0.0.1", 1, engine="torch", device=["cpu", "cpu"])
    assert [str(d) for d in worker.device] == ["cpu", "cpu"]


@pytest.mark.parametrize("rule", ["conway", "brians-brain"])
def test_meshed_workers_cluster_reaches_the_numpy_digests(rule):
    cfg = dict(height=48, width=64, rule=rule, seed=5, max_epochs=20, exchange_width=5,
               metrics_every=5, obs_digest=True)
    digests = {}
    for engine, device in (("numpy", None), ("torch", ["cpu", "cpu", "cpu"])):
        with cluster(SimulationConfig(**cfg), 2, engine=engine, device=device,
                     observer=BoardObserver(metrics_every=5, out=io.StringIO())) as h:
            h.run_to_completion()
            digests[engine] = dict(h.frontend.epoch_digests)
    assert sorted(digests["torch"]) == [5, 10, 15, 20]
    assert digests["torch"] == digests["numpy"]
