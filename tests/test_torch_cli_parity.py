"""The port's ``run``, ``frontend`` and ``serve`` take the JAX package's
command lines.

Both parsers are built (each ``main`` is stopped at its ``parse_args``), and
every option string the JAX parser gives ``run``, ``frontend`` or ``serve``
must parse in the port's, with a sample value of the JAX option's own kind
(every choice of a choice option), apart from the refusals listed below.
Then the flags the port added for keys it honours reach the config.
"""

import argparse
import dataclasses

import pytest

from akka_game_of_life_tpu.cli import main as jmain
from akka_game_of_life_tpu.runtime.config import load_config as jload
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.runtime.config import load_config

# Deliberate refusals, by role: option string -> reason.
REFUSED = {
    "run": {
        "--platform": "the JAX backend's platform; the port names its device with --device",
        "--sparse-cluster": "a cluster key, which the standalone run refuses by name",
    },
}
REFUSED["frontend"] = {
    k: v for k, v in REFUSED["run"].items() if k != "--sparse-cluster"
}
REFUSED["serve"] = {"--platform": REFUSED["run"]["--platform"]}
SAMPLES = {"--mesh": "1x1", "--tick": "10ms", "--probe-window": "0:2,0:2"}


class _Parsed(Exception):
    pass


def _parser(main) -> argparse.ArgumentParser:
    def stop(self, args=None, namespace=None):
        raise _Parsed(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = stop
    try:
        main(["run"])
    except _Parsed as parsed:
        return parsed.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("main returned without parsing")


def _subparser(main, role: str) -> argparse.ArgumentParser:
    parser = _parser(main)
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices[role]
    raise AssertionError("no subcommands")


def _refused(role: str, option: str):
    for pattern, reason in REFUSED[role].items():
        if option == pattern or (pattern.endswith("*") and option.startswith(pattern[:-1])):
            return reason
    return None


def _command_lines(action: argparse.Action, option: str):
    if action.nargs == 0 or action.nargs == "?":
        return [[option]]
    if action.choices:
        return [[option, str(choice)] for choice in action.choices]
    if option in SAMPLES:
        return [[option, SAMPLES[option]]]
    if action.type is float:
        return [[option, "0.5"]]
    return [[option, "2"]]


@pytest.mark.parametrize("role", ["run", "frontend", "serve"])
def test_every_jax_option_parses_in_the_port(role):
    jax_role, port_role = _subparser(jmain, role), _subparser(tcli.main, role)
    unparsed, checked = [], 0
    for option, action in jax_role._option_string_actions.items():
        if option in ("-h", "--help") or _refused(role, option):
            continue
        for argv in _command_lines(action, option):
            try:
                port_role.parse_args(argv)
            except SystemExit:
                unparsed.append(argv)
            checked += 1
    assert not unparsed, f"the port's {role} does not parse {unparsed}"
    assert checked > 40


@pytest.mark.parametrize("role", ["run", "frontend", "serve"])
def test_refusals_are_options_of_the_jax_parser(role):
    """Every refusal names a JAX option the port's parser really lacks."""
    jax_role, port_role = _subparser(jmain, role), _subparser(tcli.main, role)
    for pattern in REFUSED[role]:
        matches = [
            o for o in jax_role._option_string_actions
            if o == pattern or (pattern.endswith("*") and o.startswith(pattern[:-1]))
        ]
        assert matches, pattern
        assert not set(matches) & set(port_role._option_string_actions), pattern


@pytest.mark.parametrize(
    "role,overrides",
    [("run", tcli._run_overrides), ("frontend", tcli._frontend_overrides)],
)
def test_new_flags_reach_the_config(role, overrides):
    argv = [
        "--obs-profile-max-s", "5s", "--obs-profile-min-interval-s", "0",
        "--obs-cost-interval-s", "2s", "--checkpoint-format", "npz",
        "--height", "64", "--width", "64", "--max-epochs", "4",
    ]
    args = _subparser(tcli.main, role).parse_args(argv)
    cfg = load_config(None, overrides(args))
    assert (cfg.obs_profile_max_s, cfg.obs_profile_min_interval_s) == (5.0, 0.0)
    assert cfg.obs_cost_interval_s == 2.0
    assert cfg.checkpoint_format == "npz"
    if role == "run":
        # The steppers' flags (the frontend parses and ignores them, below).
        args = _subparser(tcli.main, role).parse_args(argv + [
            "--sparse-kernel", "on", "--sparse-block", "64", "--sparse-threshold", "0.25",
            "--ff-enabled", "off", "--ff-certify-steps", "3",
        ])
        cfg = load_config(None, overrides(args))
        assert (cfg.sparse_kernel, cfg.sparse_block, cfg.sparse_threshold) == (True, 64, 0.25)
        assert (cfg.ff_enabled, cfg.ff_certify_steps) == (False, 3)
    orbax = _subparser(tcli.main, role).parse_args(argv[:6] + ["--checkpoint-format", "orbax"])
    assert load_config(None, overrides(orbax)).checkpoint_format == "orbax"
    dist = ["--distributed", "--coordinator", "127.0.0.1:29512", "--num-processes", "2",
            "--process-id", "1"]
    cfg = load_config(None, overrides(_subparser(tcli.main, role).parse_args(argv + dist)))
    if role == "run":
        assert (cfg.distributed, cfg.coordinator_address, cfg.num_processes,
                cfg.process_id) == (True, "127.0.0.1:29512", 2, 1)
    else:
        # As the JAX frontend: parsed, and no part of its config.
        assert cfg == load_config(None, overrides(_subparser(tcli.main, role).parse_args(argv)))


def test_orbax_format_reaches_the_store(tmp_path):
    """``run --checkpoint-format orbax`` saves through the async per-shard
    store; the frontend refuses it, with the JAX package's text."""
    from akka_game_of_life_tpu_torch.runtime.orbax_store import OrbaxCheckpointStore
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    args = _subparser(tcli.main, "run").parse_args([
        "--height", "32", "--width", "32", "--max-epochs", "4", "--steps-per-call", "2",
        "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2",
        "--checkpoint-format", "orbax",
    ])
    cfg = load_config(None, tcli._run_overrides(args))
    with Simulation(cfg, device="cpu") as sim:
        assert isinstance(sim.store, OrbaxCheckpointStore)
        sim.advance(4)
    assert OrbaxCheckpointStore(str(tmp_path / "ck")).epochs() == [2, 4]
    fe = _subparser(tcli.main, "frontend").parse_args([
        "--checkpoint-dir", str(tmp_path / "fe"), "--checkpoint-format", "orbax",
        "--max-epochs", "4",
    ])
    from akka_game_of_life_tpu_torch.runtime.frontend import Frontend

    with pytest.raises(ValueError, match="cluster frontend requires checkpoint_format='npz'"):
        Frontend(load_config(None, tcli._frontend_overrides(fe)))


def test_the_frontend_ignores_the_run_only_flags():
    """As the JAX frontend does: it parses the stepping flags and steps no
    board, so they change nothing in its config."""
    role = _subparser(tcli.main, "frontend")
    base = ["--height", "64", "--width", "64", "--max-epochs", "4"]
    plain = load_config(None, tcli._frontend_overrides(role.parse_args(base)))
    stepped = load_config(None, tcli._frontend_overrides(role.parse_args(base + [
        "--kernel", "pallas", "--steps-per-call", "8", "--mesh", "2x2",
        "--halo-width", "3", "--pallas-block-rows", "64", "--pallas-vmem-limit-mb", "16",
        "--obs-defer", "--checkpoint-sync", "--sparse-kernel", "on", "--sparse-block", "64",
        "--sparse-threshold", "0.25", "--ff-enabled", "off", "--ff-certify-steps", "3",
    ])))
    assert stepped == plain


def test_every_serve_flag_maps_to_config():
    """Every ``--serve-X`` flag of the port's ``serve`` sets
    ``SimulationConfig.serve_X`` and nothing else, and every ``serve_*``
    field has its flag (the JAX package's bijection)."""
    import dataclasses

    role = _subparser(tcli.main, "serve")
    flags = {o for o in role._option_string_actions if o.startswith("--serve-")}
    fields = {f.name for f in dataclasses.fields(load_config(None))} & {
        "serve_" + f[len("--serve-"):].replace("-", "_") for f in flags
    }
    assert {f.replace("_", "-") for f in fields} == {f[2:] for f in flags}
    assert fields == {
        f.name for f in dataclasses.fields(load_config(None)) if f.name.startswith("serve_")
    }
    base = load_config(None, tcli._serve_overrides(role.parse_args([])))
    samples = {"--serve-size-classes": "16,32", "--serve-slo-log": "a.log",
               "--serve-slo-availability": "0.99", "--serve-memo-block": "32",
               "--serve-memo-hit-floor": "0.5", "--serve-slo-slow-window-s": "900"}
    for flag in sorted(flags):
        action = role._option_string_actions[flag]
        name = "serve_" + flag[len("--serve-"):].replace("-", "_")
        if action.choices:
            value = "off" if getattr(base, name) else "on"
        else:
            value = samples.get(flag, "7")
        cfg = load_config(None, tcli._serve_overrides(role.parse_args([flag, value])))
        changed = [f.name for f in dataclasses.fields(cfg) if getattr(cfg, f.name) != getattr(base, f.name)]
        assert changed == [name], (flag, changed)


def test_serve_refuses_the_cluster_and_federation_by_name():
    """The serving cluster and its federation are ported: ``--serve-cluster
    on`` and the ``--frontend-*`` flags load, from ``serve`` and from
    ``frontend``, to the JAX package's values (the name dates from when
    the port refused them)."""
    role = _subparser(tcli.main, "serve")
    cfg = load_config(None, tcli._serve_overrides(role.parse_args(["--serve-cluster", "on"])))
    assert cfg.serve_cluster and cfg.serve_tiled_resident and cfg.serve_replicate
    fe = _subparser(tcli.main, "frontend").parse_args(
        ["--serve-cluster", "on", "--serve-shards", "8", "--serve-replicate", "off"]
    )
    cfg = load_config(None, tcli._frontend_overrides(fe))
    assert (cfg.serve_cluster, cfg.serve_shards, cfg.serve_replicate) == (True, 8, False)
    argv = [
        "--serve-cluster", "on", "--frontend-seeds", "127.0.0.1:9000,h:9001",
        "--frontend-advertise", "127.0.0.1:9000",
        "--frontend-gossip-interval-s", "200ms", "--frontend-gossip-timeout-s", "2s",
        "--frontend-replicate-every", "4", "--frontend-replicate-interval-s", "0.1",
    ]
    want = jload(None, {
        "frontend_seeds": "127.0.0.1:9000,h:9001", "frontend_advertise": "127.0.0.1:9000",
        "frontend_gossip_interval_s": "200ms", "frontend_gossip_timeout_s": "2s",
        "frontend_replicate_every": 4, "frontend_replicate_interval_s": 0.1,
    })
    for cfg in (
        load_config(None, {**tcli._serve_overrides(role.parse_args(argv)),
                           **tcli._federation_overrides(role.parse_args(argv))}),
        load_config(None, tcli._frontend_overrides(
            _subparser(tcli.main, "frontend").parse_args(argv))),
    ):
        for f in dataclasses.fields(cfg):
            if f.name.startswith("frontend_"):
                assert getattr(cfg, f.name) == getattr(want, f.name), f.name
        assert cfg.frontend_gossip_interval_s == 0.2
    # Without the switch the cluster-only knobs parse, validate and stay
    # inert, as in the JAX package.
    cfg = load_config(None, tcli._serve_overrides(role.parse_args(["--serve-shards", "8"])))
    assert cfg.serve_shards == 8 and not cfg.serve_cluster
    with pytest.raises(ValueError, match="serve_shards=0 must be >= 1"):
        load_config(None, {"serve_shards": 0})


def test_run_backend_and_worker_engines_reach_their_roles():
    args = _subparser(tcli.main, "run").parse_args(["--backend", "actor-native"])
    assert load_config(None, tcli._run_overrides(args)).backend == "actor-native"
    backend = _subparser(tcli.main, "backend")
    for engine in ("torch", "numpy", "swar", "actor", "actor-native"):
        assert backend.parse_args(["--engine", engine]).engine == engine
    jax_engines = set(_subparser(jmain, "backend")._option_string_actions["--engine"].choices)
    port_engines = set(backend._option_string_actions["--engine"].choices)
    assert jax_engines - port_engines == {"jax"}
