"""The port's ``run`` and ``frontend`` take the JAX package's command lines.

Both parsers are built (each ``main`` is stopped at its ``parse_args``), and
every option string the JAX parser gives ``run`` or ``frontend`` must parse
in the port's, with a sample value of the JAX option's own kind (every
choice of a choice option), apart from the refusals listed below.  Then the
flags the port added for keys it honours reach the config.
"""

import argparse

import pytest

from akka_game_of_life_tpu.cli import main as jmain
from akka_game_of_life_tpu_torch import cli as tcli
from akka_game_of_life_tpu_torch.runtime.config import load_config

_NOT_PORTED = "not ported yet (ROADMAP queue 1)"
# Deliberate refusals, by role: option string -> reason.
REFUSED = {
    "run": {
        "--platform": "the JAX backend's platform; the port names its device with --device",
        "--backend": f"the actor engines: {_NOT_PORTED}",
        "--distributed": f"multi-process runs: {_NOT_PORTED}",
        "--coordinator": f"multi-process runs: {_NOT_PORTED}",
        "--num-processes": f"multi-process runs: {_NOT_PORTED}",
        "--process-id": f"multi-process runs: {_NOT_PORTED}",
        "--sparse-cluster": "a cluster key, which the standalone run refuses by name",
    },
}
REFUSED["frontend"] = {
    **{k: v for k, v in REFUSED["run"].items() if k != "--sparse-cluster"},
    "--serve-*": f"the serving plane: {_NOT_PORTED}",
    "--frontend-*": f"the frontends' federation: {_NOT_PORTED}",
}
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


@pytest.mark.parametrize("role", ["run", "frontend"])
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


@pytest.mark.parametrize("role", ["run", "frontend"])
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
    with pytest.raises(ValueError, match="orbax"):
        load_config(None, overrides(orbax))


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
