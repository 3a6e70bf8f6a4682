"""The port's ``frontend`` and ``backend`` roles as processes, on the CPU.

A frontend on an ephemeral port and two ``backend --device cpu`` processes
run a paced 64² Conway torus with 4-epoch exchanges and durable per-tile
checkpoints; one backend is killed (SIGKILL) once the first checkpoint is
final.  The frontend redeploys its tile, exits 0, and prints the digests of
the JAX package's dense oracle; the stored final digest agrees.  Every wait
has a timeout and every child is killed in a ``finally``.
"""

import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from akka_game_of_life_tpu.models import get_model
from akka_game_of_life_tpu.ops import digest as jdigest
from akka_game_of_life_tpu_torch.runtime.checkpoint import CheckpointStore
from akka_game_of_life_tpu_torch.runtime.config import load_config
from akka_game_of_life_tpu_torch.runtime.simulation import initial_board

REPO = Path(__file__).resolve().parent.parent
TOML = """\
height = 64
width = 64
seed = 4
max_epochs = 48
exchange_width = 4
metrics_every = 8
checkpoint_every = 8
obs_digest = true
failure_timeout_s = 10
"""


def _cli(*args):
    return [sys.executable, "-m", "akka_game_of_life_tpu_torch", *args]


def _wait_for(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def test_frontend_backend_processes_survive_node_loss(tmp_path):
    toml = tmp_path / "cluster.toml"
    toml.write_text(TOML)
    ckpt, prom = tmp_path / "ckpt", tmp_path / "fe.prom"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    logs = {name: open(tmp_path / f"{name}.log", "w") for name in ("fe", "b0", "b1")}
    procs = []
    try:
        fe = subprocess.Popen(
            _cli("frontend", "--config", str(toml), "--port", "0", "--min-backends", "2",
                 "--wait-for-backends", "60s", "--tick", "40ms", "--checkpoint-dir", str(ckpt),
                 "--metrics-file", str(prom), "--flight-dir", str(tmp_path / "fl")),
            cwd=tmp_path, env=env, stdout=logs["fe"], stderr=subprocess.STDOUT,
        )
        procs.append(fe)
        fe_log = tmp_path / "fe.log"
        _wait_for(lambda: "frontend listening" in fe_log.read_text(), 60, "the frontend")
        port = re.search(r"frontend listening on \S+:(\d+)", fe_log.read_text()).group(1)
        for i in range(2):
            procs.append(subprocess.Popen(
                _cli("backend", "--port", port, "--name", f"b{i}", "--device", "cpu",
                     "--flight-dir", str(tmp_path / "fl")),
                cwd=tmp_path, env=env, stdout=logs[f"b{i}"], stderr=subprocess.STDOUT,
            ))
        marker = ckpt / f"ckpt_{8:012d}.d" / "COMPLETE.json"
        _wait_for(lambda: marker.exists() or fe.poll() is not None, 60, "the first checkpoint")
        procs[1].send_signal(signal.SIGKILL)
        assert fe.wait(timeout=60) == 0, fe_log.read_text()
        assert procs[2].wait(timeout=30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in logs.values():
            f.close()
    text = fe_log.read_text()
    digests = {int(e): d for e, d in re.findall(r"^epoch (\d+): digest=([0-9a-f]{16})$", text, re.M)}
    cfg = load_config(str(toml))
    board = initial_board(cfg)
    for epoch in range(8, 49, 8):
        want = np.asarray(get_model("conway").run(epoch)(jnp.asarray(board)))
        assert digests[epoch] == jdigest.format_digest(jdigest.value(jdigest.digest_dense_np(want)))
    assert any(
        line.startswith("gol_redeploys_total") and float(line.split()[-1]) >= 1
        for line in prom.read_text().splitlines()
    ), "no redeploy recorded"
    store = CheckpointStore(str(ckpt))
    assert store.latest_epoch() == 48
    assert store.tile_meta(48)["digest"] == digests[48]
