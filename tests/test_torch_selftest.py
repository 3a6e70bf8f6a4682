"""The port's ``selftest`` on the CPU: every check passes or skips.

Mirrors ``tests/test_selftest.py``: the seven checks (gun phase, dense
oracle, checkpoint resume, chaos replay, sharded, families, obs-defer) drive
the public ``Simulation`` for each kernel choice; each line names the kernel
the run resolved to.  On one device ``sharded`` skips, as in the JAX
package.  A failing check is counted and reported, never raised.
"""

import json

import pytest

from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.runtime import selftest

RESOLVED = {"auto": "sweep", "dense": "dense", "bitpack": "bitpack"}


@pytest.mark.parametrize("kernel", ["auto", "dense", "bitpack"])
def test_selftest_green_on_cpu(kernel):
    lines = []
    failures = selftest.run_selftest(kernel=kernel, out=lines.append, device="cpu")
    recs = [json.loads(line) for line in lines]
    assert failures == 0, recs
    assert [r["check"] for r in recs] == [name for name, _ in selftest.CHECKS]
    by_name = {r["check"]: r for r in recs}
    assert by_name["sharded"]["status"] == "skip"
    assert all(r["status"] == "pass" for n, r in by_name.items() if n != "sharded")
    assert all(r["kernel"] == kernel and r["backend"] == "cpu" for r in recs)
    for name in ("gun-phase", "oracle", "checkpoint", "chaos", "obs-defer"):
        assert by_name[name]["resolved"] == RESOLVED[kernel]
    assert by_name["families"]["resolved"] == "wireworld=gen_sweep, ltl=dense"


def test_failures_are_counted_not_raised(monkeypatch):
    def broken(kernel, device):
        raise AssertionError("gun out of phase after two periods")

    monkeypatch.setattr(
        selftest, "CHECKS",
        [("gun-phase", broken)] + [c for c in selftest.CHECKS if c[0] == "sharded"],
    )
    lines = []
    assert selftest.run_selftest(out=lines.append, device="cpu") == 1
    first, second = (json.loads(line) for line in lines)
    assert first["status"] == "fail"
    assert first["error"] == "AssertionError: gun out of phase after two periods"
    assert second["status"] == "skip"


def test_matmul_fails_every_check_by_name():
    lines = []
    failures = selftest.run_selftest(kernel="matmul", out=lines.append, device="cpu")
    recs = [json.loads(line) for line in lines]
    failed = [r for r in recs if r["status"] == "fail"]
    assert failures == len(failed) == len(recs) - 2  # sharded skips; families is auto
    assert all("not ported" in r["error"] for r in failed)


def test_cli_selftest(capsys):
    assert tcli.main(["selftest", "--device", "cpu", "--kernel", "bitpack"]) == 0
    out = capsys.readouterr().out.splitlines()
    recs = [json.loads(line) for line in out if line.startswith("{")]
    assert len(recs) == len(selftest.CHECKS)
    with pytest.raises(SystemExit):
        tcli.main(["selftest", "--kernel", "matmul"])
