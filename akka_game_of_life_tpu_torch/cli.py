"""Command line of the PyTorch port: ``run``, ``frontend`` and ``backend``.

Counterpart of ``akka_game_of_life_tpu/cli.py``'s subcommands of the same
names, with the flags the port honours.  ``run`` and ``backend`` take
``--device`` (default ``cuda``; they raise when CUDA is absent rather than
moving to the CPU); ``run --device cuda`` uses every visible card, sharding
the board over them, and ``--mesh ROWSxCOLS`` asks for a mesh of exactly
that many devices:

    python -m akka_game_of_life_tpu_torch run --config examples/headline-65536.toml
    python -m akka_game_of_life_tpu_torch frontend --port 2601 --min-backends 2 \\
        --height 4096 --width 4096 --max-epochs 120 --exchange-width 10
    python -m akka_game_of_life_tpu_torch backend --port 2601 --name alpha
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
from typing import Optional, Sequence

from akka_game_of_life_tpu_torch.runtime.config import (
    KERNEL_CHOICES,
    load_config,
    parse_duration,
)

_ON_OFF = {"on": True, "off": False, None: None}


def _duration(value):
    return parse_duration(value) if value is not None else None


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


def _add_board(p: argparse.ArgumentParser) -> None:
    """The flags ``run`` and ``frontend`` share."""
    p.add_argument("--config", help="TOML or JSON config file")
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
        "metrics line; on the frontend, workers digest their tiles and the "
        "frontend merges the lanes",
    )


def _board_overrides(args: argparse.Namespace) -> dict:
    return {
        "rule": args.rule,
        "height": args.height,
        "width": args.width,
        "density": args.density,
        "seed": args.seed,
        "pattern": args.pattern,
        "max_epochs": args.max_epochs,
        "checkpoint_dir": args.checkpoint_dir,
        "checkpoint_every": args.checkpoint_every,
        "render_every": args.render_every,
        "probe_window": _parse_window(args.probe_window),
        "metrics_every": args.metrics_every,
        "obs_digest": args.obs_digest,
    }


def _run_device(value: str) -> str:
    if value in ("cuda", "cpu") or re.fullmatch(r"cuda:\d+", value):
        return value
    raise argparse.ArgumentTypeError(f"expected cuda, cuda:N or cpu, got {value!r}")


def _parse_mesh(spec):
    """"ROWSxCOLS" → (rows, cols); None passes through."""
    if spec is None:
        return None
    try:
        rows, cols = spec.lower().split("x")
        return (int(rows), int(cols))
    except ValueError:
        raise SystemExit(f"bad --mesh {spec!r}; expected ROWSxCOLS (e.g. 4x2)")


def _run_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("run", help="standalone simulation on one device or a mesh")
    _add_board(p)
    p.add_argument(
        "--device", type=_run_device, default="cuda",
        help="cuda (every visible card; a mesh when there are several), "
        "cuda:N (one card) or cpu",
    )
    p.add_argument(
        "--mesh",
        help="ROWSxCOLS device mesh, e.g. 4x2: needs exactly that many of "
        "--device's devices",
    )
    p.add_argument(
        "--halo-width", type=int,
        help="steps per halo exchange of the plain sharded steppers "
        "(the sharded sweeps plan their own)",
    )
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
    return p


def _add_observability(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--metrics-file",
        help="dump this role's Prometheus exposition here every few seconds "
        "and on exit (atomic write)",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        help="serve live /metrics, /healthz and /trace on this port (0 = off)",
    )
    p.add_argument(
        "--log-events", metavar="PATH",
        help="append structured JSONL lifecycle events here",
    )
    p.add_argument(
        "--trace-file", metavar="PATH",
        help="write the span buffer as Chrome trace-event / Perfetto JSON on "
        "exit",
    )
    p.add_argument(
        "--flight-dir", metavar="DIR",
        help="directory for flight-recorder dumps on crashes, redeploys and "
        "SIGTERM (default: artifacts; empty string disables)",
    )


def _add_chaos_net(p: argparse.ArgumentParser) -> None:
    """The network chaos knobs: every ``--chaos-net-X`` flag maps onto
    ``NetworkChaosConfig.X``; any of them arms the plane."""
    g = p.add_argument_group("network chaos")
    g.add_argument("--chaos-net", action="store_true", default=None)
    g.add_argument("--chaos-net-seed", type=int, default=None, metavar="N")
    for name in ("drop", "delay", "duplicate", "reorder"):
        g.add_argument(f"--chaos-net-{name}-p", type=float, default=None, metavar="P")
    for name in ("delay-s", "partition-after-s", "partition-every-s", "partition-heal-s"):
        g.add_argument(f"--chaos-net-{name}", default=None, metavar="DUR")
    g.add_argument("--chaos-net-max-partitions", type=int, default=None, metavar="N")
    g.add_argument("--chaos-net-scope", choices=["peer", "control", "all"], default=None)


def _chaos_net_overrides(args: argparse.Namespace) -> Optional[dict]:
    out = {
        "seed": args.chaos_net_seed,
        "drop_p": args.chaos_net_drop_p,
        "delay_p": args.chaos_net_delay_p,
        "delay_s": _duration(args.chaos_net_delay_s),
        "duplicate_p": args.chaos_net_duplicate_p,
        "reorder_p": args.chaos_net_reorder_p,
        "partition_after_s": _duration(args.chaos_net_partition_after_s),
        "partition_every_s": _duration(args.chaos_net_partition_every_s),
        "partition_heal_s": _duration(args.chaos_net_partition_heal_s),
        "max_partitions": args.chaos_net_max_partitions,
        "scope": args.chaos_net_scope,
    }
    out = {k: v for k, v in out.items() if v is not None}
    if not out and not args.chaos_net:
        return None
    out["enabled"] = True
    return out


def _frontend_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("frontend", help="cluster coordinator")
    _add_board(p)
    _add_observability(p)
    p.add_argument("--port", type=int, default=2551)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--wait-for-backends", default=None, help="e.g. 5s")
    p.add_argument("--min-backends", type=int, default=1)
    p.add_argument("--tick", help="wall-clock pacing per epoch (e.g. 200ms); 0 = free-run")
    p.add_argument(
        "--exchange-width", type=int, default=None,
        help="boundary-ring width k: one peer exchange buys k local epochs "
        "per tile (cadences must be multiples of k)",
    )
    p.add_argument(
        "--tiles-per-worker", type=int, default=None,
        help="tile oversubscription: each worker hosts this many tiles",
    )
    p.add_argument("--render-max-cells", type=int)
    p.add_argument("--log-file")
    p.add_argument("--inject-faults", action="store_true", default=None)
    p.add_argument("--obs-programs", choices=["on", "off"], default=None)
    p.add_argument("--obs-cost-interval-s", default=None, metavar="DUR")
    p.add_argument("--sparse-cluster", choices=["on", "off"], default=None)
    p.add_argument("--ring-pack", choices=["on", "off"], default=None)
    p.add_argument("--ring-batch", choices=["on", "off"], default=None)
    p.add_argument("--ring-queue-depth", type=int, default=None, metavar="N")
    p.add_argument("--rebalance", nargs="?", choices=["on", "off"], const="on", default=None)
    p.add_argument("--rebalance-interval-s", default=None, metavar="DUR")
    p.add_argument("--rebalance-min-gap", type=int, default=None, metavar="N")
    p.add_argument("--rebalance-max-inflight", type=int, default=None, metavar="N")
    p.add_argument("--rebalance-deadline-s", default=None, metavar="DUR")
    _add_chaos_net(p)
    return p


def _frontend_overrides(args: argparse.Namespace) -> dict:
    out = {
        **_board_overrides(args),
        "role": "frontend",
        "host": args.host,
        "port": args.port,
        "wait_for_backends_s": _duration(args.wait_for_backends),
        "tick_s": _duration(args.tick),
        "exchange_width": args.exchange_width,
        "tiles_per_worker": args.tiles_per_worker,
        "render_max_cells": args.render_max_cells,
        "log_file": args.log_file,
        "metrics_file": args.metrics_file,
        "metrics_port": args.metrics_port,
        "log_events": args.log_events,
        "trace_file": args.trace_file,
        "flight_dir": args.flight_dir,
        "obs_programs": _ON_OFF[args.obs_programs],
        "obs_cost_interval_s": _duration(args.obs_cost_interval_s),
        "sparse_cluster": _ON_OFF[args.sparse_cluster],
        "ring_pack": _ON_OFF[args.ring_pack],
        "ring_batch": _ON_OFF[args.ring_batch],
        "ring_queue_depth": args.ring_queue_depth,
        "rebalance_enabled": _ON_OFF[args.rebalance],
        "rebalance_interval_s": _duration(args.rebalance_interval_s),
        "rebalance_min_gap": args.rebalance_min_gap,
        "rebalance_max_inflight": args.rebalance_max_inflight,
        "rebalance_deadline_s": _duration(args.rebalance_deadline_s),
        "net_chaos": _chaos_net_overrides(args),
    }
    if args.inject_faults:
        out["fault_injection"] = {"enabled": True}
    return out


def _backend_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("backend", help="cluster worker")
    p.add_argument(
        "--config",
        help="TOML or JSON config file; the worker reads its [net_chaos] "
        "block (share one file with the frontend) — flags override it",
    )
    p.add_argument("--port", type=int, default=2551, help="frontend port to join")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--name", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument(
        "--engine",
        choices=["torch", "numpy"],
        default="torch",
        help="tile chunk engine: torch = on --device (binary chunks through "
        "the CUDA packed sweep on cuda), numpy = host stepping",
    )
    p.add_argument(
        "--pallas",
        choices=["auto", "off"],
        default=None,
        help="torch-engine sweep pin: auto (default) steps binary chunks "
        "through the packed sweep, off pins the plain packed step loop",
    )
    _add_observability(p)
    _add_chaos_net(p)
    return p


@contextlib.contextmanager
def _sigterm_as_interrupt():
    """Map SIGTERM to KeyboardInterrupt while a role serves, so an
    orchestrator stop takes the ^C graceful-shutdown path (main thread
    only; the previous handler is restored on exit)."""
    import signal as _signal

    def _handler(signum, frame):
        raise KeyboardInterrupt

    prev = None
    try:
        if _signal.getsignal(_signal.SIGTERM) is not None:
            prev = _signal.signal(_signal.SIGTERM, _handler)
    except ValueError:  # not the main thread (embedded use)
        pass
    try:
        yield
    finally:
        if prev is not None:
            _signal.signal(_signal.SIGTERM, prev)


def _run(args: argparse.Namespace) -> int:
    overrides = {
        **_board_overrides(args),
        "steps_per_call": args.steps_per_call,
        "kernel": args.kernel,
        "halo_width": args.halo_width,
        "mesh_shape": _parse_mesh(args.mesh),
    }
    cfg = load_config(args.config, overrides)
    if cfg.max_epochs is None:
        cfg.max_epochs = 100
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    with Simulation(cfg, device=args.device) as sim:
        # --max-epochs is the absolute end epoch: a resumed run advances the
        # remaining max_epochs - E.
        sim.advance(max(0, cfg.max_epochs - sim.epoch))
        stats = sim.observer.summary()
        if stats is not None:
            mesh = {} if sim.mesh is None else {"mesh": list(sim.mesh.shape)}
            print(
                "run summary: "
                + json.dumps({"kernel": sim.kernel, **mesh, "epoch": sim.epoch, **stats}),
                file=sim.observer.out,
                flush=True,
            )
        if cfg.render_every == 0 and cfg.metrics_every == 0:
            from akka_game_of_life_tpu_torch.runtime.render import render_ascii

            print(f"epoch {sim.epoch}:", file=sim.observer.out)
            print(render_ascii(sim.board_host(), 128), file=sim.observer.out)
    return 0


def _frontend(args: argparse.Namespace) -> int:
    cfg = load_config(args.config, _frontend_overrides(args))
    from akka_game_of_life_tpu_torch.obs import get_tracer
    from akka_game_of_life_tpu_torch.runtime.frontend import run_frontend
    from akka_game_of_life_tpu_torch.runtime.signals import flight_dump_on_signals

    with _sigterm_as_interrupt(), flight_dump_on_signals(get_tracer().flight):
        try:
            return run_frontend(cfg, min_backends=args.min_backends)
        except KeyboardInterrupt:
            return 130  # startup window; run_frontend handles the rest


def _backend(args: argparse.Namespace) -> int:
    from akka_game_of_life_tpu_torch.obs import get_tracer
    from akka_game_of_life_tpu_torch.runtime.backend import run_backend
    from akka_game_of_life_tpu_torch.runtime.signals import flight_dump_on_signals

    # The worker's chaos policy layers like the frontend's: the config
    # file's [net_chaos] block < --chaos-net-* flags.
    chaos_kwargs = _chaos_net_overrides(args)
    chaos_cfg = None
    if args.config or chaos_kwargs is not None:
        cfg = load_config(
            args.config, {"net_chaos": chaos_kwargs} if chaos_kwargs else None
        )
        chaos_cfg = cfg.net_chaos if cfg.net_chaos.enabled else None
    with _sigterm_as_interrupt(), flight_dump_on_signals(get_tracer().flight):
        try:
            return run_backend(
                host=args.host,
                port=args.port,
                name=args.name,
                engine=args.engine,
                pallas=args.pallas,
                device=args.device if args.engine == "torch" else None,
                metrics_file=args.metrics_file,
                metrics_port=args.metrics_port or 0,
                log_events=args.log_events,
                trace_file=args.trace_file,
                flight_dir=args.flight_dir if args.flight_dir is not None else "artifacts",
                net_chaos=chaos_cfg,
            )
        except KeyboardInterrupt:
            return 130  # the connect/join window; run_backend handles the rest


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="akka_game_of_life_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _run_parser(sub)
    _frontend_parser(sub)
    _backend_parser(sub)
    args = parser.parse_args(argv)
    return {"run": _run, "frontend": _frontend, "backend": _backend}[args.command](args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
