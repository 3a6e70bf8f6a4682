"""Command line of the PyTorch port: the standalone ``run`` subcommand.

Counterpart of ``akka_game_of_life_tpu/cli.py``'s ``run`` with the flags the
port honours, plus ``--device {cuda,cpu}`` (default ``cuda``; the run raises
when CUDA is absent rather than moving to the CPU):

    python -m akka_game_of_life_tpu_torch run --config examples/headline-65536.toml
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from akka_game_of_life_tpu_torch.runtime.config import KERNEL_CHOICES, load_config


def _parse_window(spec):
    """"Y0:Y1,X0:X1" → (y0, y1, x0, x1); None passes through."""
    if spec is None:
        return None
    try:
        rows, cols = spec.split(",")
        y0, y1 = (int(v) for v in rows.split(":"))
        x0, x1 = (int(v) for v in cols.split(":"))
    except ValueError:
        raise SystemExit(
            f"bad --probe-window {spec!r}; expected Y0:Y1,X0:X1 (e.g. 8:17,8:44)"
        )
    return (y0, y1, x0, x1)


def _run_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("run", help="standalone simulation on one device")
    p.add_argument("--config", help="TOML or JSON config file")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--rule", help="rule name or rulestring (B3/S23, ...)")
    p.add_argument("--height", type=int)
    p.add_argument("--width", type=int)
    p.add_argument("--density", type=float)
    p.add_argument("--seed", type=int)
    p.add_argument(
        "--pattern",
        help="initial board: a built-in pattern name or a Golly/LifeWiki "
        ".rle file",
    )
    p.add_argument("--max-epochs", type=int)
    p.add_argument("--steps-per-call", type=int)
    p.add_argument(
        "--kernel",
        choices=list(KERNEL_CHOICES),
        help="auto/pallas: the CUDA kernels on cuda (packed sweep for binary "
        "rules, plane sweep for Generations/WireWorld, LtL step for "
        "Larger-than-Life boxes; auto runs dense on widths not a multiple "
        "of 32 and for the LtL diamond); bitpack: the plain packed/plane "
        "step; dense: the plain dense stencil; matmul is not ported yet",
    )
    p.add_argument("--checkpoint-dir")
    p.add_argument("--checkpoint-every", type=int)
    p.add_argument("--render-every", type=int)
    p.add_argument(
        "--probe-window",
        default=None,
        help="exact-cell probe window printed at render cadence, as "
        "Y0:Y1,X0:X1",
    )
    p.add_argument("--metrics-every", type=int)
    p.add_argument(
        "--obs-digest",
        action="store_true",
        default=None,
        help="print the 64-bit board digest (digest=<16 hex>) on every "
        "metrics line",
    )
    return p


def _overrides(args: argparse.Namespace) -> dict:
    return {
        "rule": args.rule,
        "height": args.height,
        "width": args.width,
        "density": args.density,
        "seed": args.seed,
        "pattern": args.pattern,
        "max_epochs": args.max_epochs,
        "steps_per_call": args.steps_per_call,
        "kernel": args.kernel,
        "checkpoint_dir": args.checkpoint_dir,
        "checkpoint_every": args.checkpoint_every,
        "render_every": args.render_every,
        "probe_window": _parse_window(args.probe_window),
        "metrics_every": args.metrics_every,
        "obs_digest": args.obs_digest,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="akka_game_of_life_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _run_parser(sub)
    args = parser.parse_args(argv)

    cfg = load_config(args.config, _overrides(args))
    if cfg.max_epochs is None:
        cfg.max_epochs = 100
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    with Simulation(cfg, device=args.device) as sim:
        # --max-epochs is the absolute end epoch: a resumed run advances the
        # remaining max_epochs - E.
        sim.advance(max(0, cfg.max_epochs - sim.epoch))
        stats = sim.observer.summary()
        if stats is not None:
            print(
                "run summary: "
                + json.dumps({"kernel": sim.kernel, "epoch": sim.epoch, **stats}),
                file=sim.observer.out,
                flush=True,
            )
        if cfg.render_every == 0 and cfg.metrics_every == 0:
            from akka_game_of_life_tpu_torch.runtime.render import render_ascii

            print(f"epoch {sim.epoch}:", file=sim.observer.out)
            print(render_ascii(sim.board_host(), 128), file=sim.observer.out)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
