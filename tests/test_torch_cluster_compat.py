"""Mixed clusters: the port and the JAX package speak one wire protocol.

A JAX ``Frontend`` drives one JAX ``numpy`` worker and one port ``torch``
worker; the port's ``Frontend`` drives a JAX worker beside a port worker.
Both finish with the dense oracle's board.  A cluster checkpoint directory
written by either package's frontend resumes in the other's.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest

from akka_game_of_life_tpu.models import get_model
from akka_game_of_life_tpu.runtime.backend import BackendWorker as JWorker
from akka_game_of_life_tpu.runtime.config import SimulationConfig as JConfig
from akka_game_of_life_tpu.runtime.frontend import Frontend as JFrontend
from akka_game_of_life_tpu.runtime.harness import cluster as jcluster
from akka_game_of_life_tpu_torch.runtime.backend import BackendWorker as TWorker
from akka_game_of_life_tpu_torch.runtime.config import SimulationConfig as TConfig
from akka_game_of_life_tpu_torch.runtime.frontend import Frontend as TFrontend
from akka_game_of_life_tpu_torch.runtime.harness import cluster as tcluster
from akka_game_of_life_tpu_torch.runtime.simulation import initial_board

DONE_TIMEOUT = 60
BOARD = dict(height=48, width=64, seed=21, max_epochs=24, exchange_width=4)


def _oracle(cfg, epochs):
    return np.asarray(get_model(cfg.rule).run(epochs)(jnp.asarray(initial_board(cfg))))


def _mixed_run(frontend, workers):
    """Start ``frontend``, join ``workers`` (factories taking the port),
    run to completion and return the final board."""
    frontend.start()
    started = []
    try:
        for make in workers:
            w = make(frontend.port)
            w.crash_hook = w.stop
            w.connect()
            threading.Thread(target=w.run, daemon=True).start()
            started.append(w)
        assert frontend.wait_for_backends(timeout=5)
        frontend.start_simulation()
        assert frontend.done.wait(DONE_TIMEOUT), "cluster did not finish"
        assert frontend.error is None, frontend.error
        return frontend.final_board
    finally:
        frontend.stop()
        for w in started:
            w.stop()


def _jworker(name):
    return lambda port: JWorker("127.0.0.1", port, name=name, engine="numpy")


def _tworker(name):
    return lambda port: TWorker("127.0.0.1", port, name=name, device="cpu")


@pytest.mark.parametrize("rule", ["conway", "brians-brain"])
def test_jax_frontend_with_port_worker(rule):
    cfg = JConfig(rule=rule, port=0, **BOARD)
    fe = JFrontend(cfg, min_backends=2)
    final = _mixed_run(fe, [_jworker("jax-w"), _tworker("torch-w")])
    np.testing.assert_array_equal(final, _oracle(TConfig(rule=rule, **BOARD), 24))


@pytest.mark.parametrize("rule", ["conway", "brians-brain"])
def test_port_frontend_with_jax_worker(rule):
    cfg = TConfig(rule=rule, port=0, **BOARD)
    fe = TFrontend(cfg, min_backends=2)
    final = _mixed_run(fe, [_tworker("torch-w"), _jworker("jax-w")])
    np.testing.assert_array_equal(final, _oracle(cfg, 24))


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_cluster_checkpoints_resume_across_packages(first, tmp_path):
    """Run to epoch 12 under one package's frontend with per-tile durable
    checkpoints (digest recorded), then resume to 24 under the other's,
    which certifies the stored digest before deploying."""
    kw = dict(BOARD, checkpoint_dir=str(tmp_path), checkpoint_every=4, obs_digest=True)
    kw["max_epochs"] = 12
    if first == "jax":
        with jcluster(JConfig(**kw), 2, engine="numpy") as h:
            h.run_to_completion()
    else:
        with tcluster(TConfig(**kw), 2, device="cpu") as h:
            h.run_to_completion()
    kw["max_epochs"] = 24
    if first == "jax":
        with tcluster(TConfig(**kw), 2, device="cpu") as h:
            final = h.run_to_completion()
            start = h.frontend.start_epoch
            digest = h.frontend.final_digest
    else:
        with jcluster(JConfig(**kw), 2, engine="numpy") as h:
            final = h.run_to_completion()
            start = h.frontend.start_epoch
            digest = h.frontend.final_digest
    assert start == 12
    want = _oracle(TConfig(**kw), 24)
    np.testing.assert_array_equal(final, want)
    from akka_game_of_life_tpu_torch.ops import digest as tdigest

    assert digest == tdigest.value(tdigest.digest_dense_np(want))
