"""Command line of the PyTorch port: ``run``, ``frontend``, ``backend``,
``tune``, ``selftest``, ``checkpoints`` and ``models``.

Counterpart of ``akka_game_of_life_tpu/cli.py``'s subcommands of the same
names, with the flags the port honours.  ``run``, ``backend``, ``tune`` and
``selftest`` take ``--device`` (default ``cuda``; they raise when CUDA is
absent rather than moving to the CPU); ``run --device cuda`` uses every
visible card, sharding the board over them, and ``--mesh ROWSxCOLS`` asks
for a mesh of exactly that many devices:

    python -m akka_game_of_life_tpu_torch run --config examples/headline-65536.toml
    python -m akka_game_of_life_tpu_torch tune --size 16384 --rule wireworld
    python -m akka_game_of_life_tpu_torch selftest --kernel pallas
    python -m akka_game_of_life_tpu_torch checkpoints ckpt-65536 --validate
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
    p.add_argument(
        "--checkpoint-format", choices=["npz", "orbax"],
        help="npz (the port's store); orbax is refused by name",
    )
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
        "checkpoint_format": args.checkpoint_format,
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


def _add_stepping(p: argparse.ArgumentParser) -> None:
    """How ``run`` steps the board.  The JAX package gives the frontend
    these flags too (its ``_add_common``), which it parses and does not
    use; the port's frontend does the same, so a JAX command line runs
    unchanged."""
    p.add_argument(
        "--pallas-block-rows", type=int,
        help="output rows per block of the CUDA kernels under --kernel "
        "pallas (a tile variant, built at first use; `tune` finds one); "
        "default: the kernel's own tile",
    )
    p.add_argument(
        "--pallas-vmem-limit-mb", type=int,
        help="the JAX package's Mosaic VMEM budget: accepted at 0 only",
    )
    p.add_argument(
        "--checkpoint-sync", action="store_true", default=None,
        help="block at each checkpoint until the save is durable (default: "
        "saves run on a writer thread while stepping continues)",
    )
    p.add_argument(
        "--obs-defer", action="store_true", default=None,
        help="dispatch cadence observations on the device and read them one "
        "chunk later, while the next chunk runs (lines appear one chunk "
        "late; values are identical)",
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
        "step; dense: the plain dense stencil; matmul: neighbour counts as "
        "banded matrix products (any box-neighbourhood rule incl. radius-R "
        "LtL; one device)",
    )
    g = p.add_argument_group(
        "activity-gated sparse stepping",
        "skip the dead parts of the board (run only; the frontend parses "
        "and ignores them, as the JAX frontend does)",
    )
    g.add_argument(
        "--sparse-kernel", choices=["on", "off"], default=None,
        help="a per-block activity bitmap gates which blocks the stepper "
        "advances: a block steps only if it or a neighbour changed last "
        "chunk (radius-1 rules, one device; default off)",
    )
    g.add_argument(
        "--sparse-block", type=int, default=None, metavar="B",
        help="gating block side in cells (default 128; clamped to the "
        "largest common divisor of the board sides)",
    )
    g.add_argument(
        "--sparse-threshold", type=float, default=None, metavar="F",
        help="dense escape: above this active-block fraction the chunk "
        "steps the whole board and only the change bitmap is recomputed "
        "(default 0.5)",
    )
    g = p.add_argument_group(
        "logarithmic fast-forward",
        "jump T epochs of an XOR-linear (odd-rule) board in O(log T) roll "
        "passes instead of O(T) steps (run only; the frontend parses and "
        "ignores them); non-linear rules are refused",
    )
    g.add_argument(
        "--ff-enabled", choices=["on", "off"], default=None,
        help="master switch (default on): off makes Simulation.fast_forward "
        "refuse",
    )
    g.add_argument(
        "--ff-certify-steps", type=int, default=None, metavar="T",
        help="jump-vs-iterate digest certification per jump (default 8): "
        "min(T, jump span) epochs also run through the dense stepper and "
        "the digests must agree; 0 skips",
    )


def _add_obs_programs(p: argparse.ArgumentParser) -> None:
    """The observatory's knobs, as the JAX package gives them to ``run``
    and ``frontend``."""
    p.add_argument("--obs-programs", choices=["on", "off"], default=None)
    p.add_argument(
        "--obs-cost-interval-s", default=None, metavar="DUR",
        help="cadence of worker COST frames (default: 5s)",
    )
    p.add_argument(
        "--obs-profile-max-s", default=None, metavar="DUR",
        help="longest POST /profile capture window; longer requests are "
        "clamped (default: 30s)",
    )
    p.add_argument(
        "--obs-profile-min-interval-s", default=None, metavar="DUR",
        help="minimum gap between POST /profile captures; requests inside "
        "it get HTTP 429 (default: 60s; 0 disables the rate limit)",
    )


def _obs_programs_overrides(args: argparse.Namespace) -> dict:
    return {
        "obs_programs": _ON_OFF[args.obs_programs],
        "obs_cost_interval_s": _duration(args.obs_cost_interval_s),
        "obs_profile_max_s": _duration(args.obs_profile_max_s),
        "obs_profile_min_interval_s": _duration(args.obs_profile_min_interval_s),
    }


def _run_parser(sub) -> argparse.ArgumentParser:
    p = sub.add_parser("run", help="standalone simulation on one device or a mesh")
    _add_board(p)
    _add_observability(p)
    _add_obs_programs(p)
    _add_stepping(p)
    p.add_argument("--tick", help="wall-clock pacing per chunk (e.g. 200ms); 0 = free-run")
    p.add_argument("--render-max-cells", type=int)
    p.add_argument("--log-file")
    p.add_argument(
        "--inject-faults", action="store_true", default=None,
        help="arm the crash injector (schedule from the config file's "
        "[fault_injection]); needs --checkpoint-dir",
    )
    p.add_argument(
        "--trace-dir",
        help="capture a torch.profiler trace of the run into this directory "
        "(trace.json, Chrome trace-event / Perfetto)",
    )
    p.add_argument(
        "--dump-rle", metavar="PATH",
        help="write the final board as a Golly/LifeWiki .rle file (O(board) "
        "host fetch)",
    )
    p.add_argument(
        "--fast-forward", type=int, default=None, metavar="T",
        help="jump to epoch T up front through the O(log T) linear-rule "
        "fast-forward (XOR-linear rules only; refused otherwise), then run "
        "the loop for any remaining --max-epochs.  T is an absolute epoch "
        "like --max-epochs: a resumed run jumps only the remainder; prints "
        "the landed epoch and its digest",
    )
    p.add_argument(
        "--device", type=_run_device, default="cuda",
        help="cuda (every visible card; a mesh when there are several), "
        "cuda:N (one card) or cpu",
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


def _observability_overrides(args: argparse.Namespace) -> dict:
    return {
        "metrics_file": args.metrics_file,
        "metrics_port": args.metrics_port,
        "log_events": args.log_events,
        "trace_file": args.trace_file,
        "flight_dir": args.flight_dir,
    }


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
    _add_obs_programs(p)
    _add_stepping(p)
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
        **_observability_overrides(args),
        **_obs_programs_overrides(args),
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


def _run_overrides(args: argparse.Namespace) -> dict:
    out = {
        **_board_overrides(args),
        "steps_per_call": args.steps_per_call,
        "kernel": args.kernel,
        "pallas_block_rows": args.pallas_block_rows,
        "pallas_vmem_limit_mb": args.pallas_vmem_limit_mb,
        "halo_width": args.halo_width,
        "mesh_shape": _parse_mesh(args.mesh),
        "tick_s": _duration(args.tick),
        "checkpoint_async": False if args.checkpoint_sync else None,
        "render_max_cells": args.render_max_cells,
        **_observability_overrides(args),
        **_obs_programs_overrides(args),
        "obs_defer": args.obs_defer,
        "log_file": args.log_file,
        "sparse_kernel": _ON_OFF[args.sparse_kernel],
        "sparse_block": args.sparse_block,
        "sparse_threshold": args.sparse_threshold,
        "ff_enabled": _ON_OFF[args.ff_enabled],
        "ff_certify_steps": args.ff_certify_steps,
    }
    if args.inject_faults:
        out["fault_injection"] = {"enabled": True}
    return out


def _check_dump_rle(args: argparse.Namespace, cfg) -> None:
    """Fail before the run, not after it: RLE's alphabet stops at state 24,
    and an unwritable path would lose the board at the very end."""
    from akka_game_of_life_tpu_torch.ops.rules import resolve_rule

    states = resolve_rule(cfg.rule).states
    if states - 1 > 24:
        raise SystemExit(
            f"--dump-rle: rule {cfg.rule!r} has {states} states; RLE's "
            f"alphabet stops at 24 (25 states incl. dead)"
        )
    try:
        with open(args.dump_rle, "a", encoding="utf-8"):
            pass
    except OSError as e:
        raise SystemExit(f"--dump-rle: cannot write {args.dump_rle!r}: {e}")


@contextlib.contextmanager
def _metrics_endpoint(cfg, sim):
    """Live /metrics, /healthz, /trace, /programs, /cost and /profile for
    the standalone run while its body executes."""
    if not cfg.metrics_port:
        yield
        return
    from akka_game_of_life_tpu_torch.obs import MetricsServer
    from akka_game_of_life_tpu_torch.obs.programs import get_programs, http_routes
    from akka_game_of_life_tpu_torch.runtime.profiling import ProfilerCapture

    programs = get_programs().configure(
        node="standalone", metrics=sim.metrics, enabled=cfg.obs_programs
    )
    profiler = ProfilerCapture(
        cfg.flight_dir or "artifacts",
        node="standalone",
        max_seconds=cfg.obs_profile_max_s,
        min_interval_s=cfg.obs_profile_min_interval_s,
    )
    server = MetricsServer(
        sim.metrics,
        port=cfg.metrics_port,
        health=lambda: {"ok": True, "epoch": sim.epoch},
        tracer=sim.tracer,
        routes=http_routes(registry=programs, profile=profiler.capture),
    )
    print(
        f"metrics on :{server.port}/metrics "
        f"(+/healthz,/trace,/programs,/cost,/profile)",
        flush=True,
    )
    try:
        yield
    finally:
        server.close()


def _run(args: argparse.Namespace) -> int:
    cfg = load_config(args.config, _run_overrides(args))
    if args.dump_rle:
        _check_dump_rle(args, cfg)
    if cfg.max_epochs is None:
        cfg.max_epochs = 100
    from akka_game_of_life_tpu_torch.runtime.signals import flight_dump_on_signals
    from akka_game_of_life_tpu_torch.runtime.simulation import Simulation

    sim = Simulation(cfg, device=args.device)
    # SIGTERM maps to ^C first; the flight dump wraps it, so an orchestrator
    # stop dumps the span/event ring, then takes the graceful path.
    with _sigterm_as_interrupt(), flight_dump_on_signals(
        sim.tracer.flight
    ), _metrics_endpoint(cfg, sim):
        try:
            return _run_simulation(args, cfg, sim)
        except KeyboardInterrupt:
            # Outside advance()'s graceful window (start-up, summary,
            # epilogue): no save; the cadence checkpoints are durable.
            print(
                f"interrupted outside the run loop at epoch {sim.epoch}",
                file=sys.stderr,
                flush=True,
            )
            return 130


def _run_simulation(args: argparse.Namespace, cfg, sim) -> int:
    """The ``run`` body between the signal handlers' install and restore."""
    from akka_game_of_life_tpu_torch.obs.programs import get_programs
    from akka_game_of_life_tpu_torch.runtime import profiling

    interrupted = False
    with sim, profiling.trace(args.trace_dir):
        try:
            if args.fast_forward:
                from akka_game_of_life_tpu_torch.ops.digest import format_digest

                # An absolute target, like --max-epochs: a resumed run jumps
                # only the remaining fast_forward - E.
                try:
                    ep = sim.fast_forward(max(0, args.fast_forward - sim.epoch))
                except ValueError as e:
                    raise SystemExit(f"--fast-forward: {e}")
                print(
                    f"fast-forwarded to epoch {ep}: "
                    f"digest={format_digest(sim.board_digest())}",
                    file=sim.observer.out,
                    flush=True,
                )
            # --max-epochs is the absolute end epoch: a resumed run advances
            # the remaining max_epochs - E.
            sim.advance(max(0, cfg.max_epochs - sim.epoch))
        except KeyboardInterrupt:
            # Graceful ^C / SIGTERM: the board is consistent at the last
            # completed chunk; make it durable so the run resumes from here.
            # Masked so a second signal cannot abort the promised save.
            interrupted = True
            if sim.store is not None:
                from akka_game_of_life_tpu_torch.runtime.signals import mask_interrupts

                with mask_interrupts():
                    sim.checkpoint()
                    sim.flush()
                print(
                    f"interrupted at epoch {sim.epoch}; checkpoint written",
                    file=sys.stderr,
                    flush=True,
                )
            else:
                print(
                    f"interrupted at epoch {sim.epoch} (no durable save: no "
                    f"checkpoint dir)",
                    file=sys.stderr,
                    flush=True,
                )
        stats = sim.observer.summary()
        if stats is not None:
            mesh = {} if sim.mesh is None else {"mesh": list(sim.mesh.shape)}
            print(
                "run summary: "
                + json.dumps({"kernel": sim.kernel, **mesh, "epoch": sim.epoch, **stats}),
                file=sim.observer.out,
                flush=True,
            )
    # End-of-run device-memory watermarks, as the cataloged gauges and, under
    # --trace-dir, one [profile] line per device.
    try:
        final_dev_stats = get_programs().refresh_device_gauges()
    except Exception:  # noqa: BLE001 — observability must not fail the run
        final_dev_stats = {}
    if args.trace_dir:
        for dev, stats in final_dev_stats.items():
            print(f"[profile] {dev}: {stats}", flush=True)
    if interrupted:
        return 130
    final = None
    if args.dump_rle:
        from akka_game_of_life_tpu_torch.ops.rules import resolve_rule
        from akka_game_of_life_tpu_torch.utils.patterns import encode_rle

        final = sim.board_host()
        with open(args.dump_rle, "w", encoding="utf-8") as f:
            f.write(encode_rle(final, resolve_rule(cfg.rule).rulestring()))
        print(f"wrote {args.dump_rle}", flush=True)
    if cfg.render_every == 0 and cfg.metrics_every == 0:
        from akka_game_of_life_tpu_torch.runtime.render import render_ascii

        if final is None:
            final = sim.board_host()
        print(f"epoch {sim.epoch}:")
        print(render_ascii(final, cfg.render_max_cells))
    return 0


def _tune_parser(sub) -> None:
    p = sub.add_parser(
        "tune",
        help="autotune the CUDA kernels' (tile rows, steps_per_sweep) on this "
        "device: one JSON line per measured point (best first), then the "
        "winning flags",
    )
    p.add_argument("--size", type=int, default=65536)
    p.add_argument("--steps-per-call", type=int, default=64)
    p.add_argument(
        "--blocks", default="64,128,192,256", metavar="B1,B2,...",
        help="tile rows per block (the kernel's -DTILE_ROWS)",
    )
    p.add_argument("--sweeps", default="4,8,16", metavar="K1,K2,...",
                   help="generations per sweep (LtL: always 1)")
    p.add_argument("--timed-calls", type=int, default=2)
    p.add_argument("--vmem-limit-mb", type=int, default=0,
                   help="the JAX package's Mosaic budget: 0 only")
    p.add_argument("--rule", default="conway")
    p.add_argument("--device", type=_run_device, default="cuda",
                   help="cuda (the kernels), cuda:N or cpu (their plain versions)")


def _tune(args: argparse.Namespace) -> int:
    from akka_game_of_life_tpu_torch.runtime.autotune import (
        best_flags,
        best_point,
        sweep,
    )

    results = sweep(
        args.size,
        steps_per_call=args.steps_per_call,
        blocks=[int(v) for v in args.blocks.split(",")],
        sweeps=[int(v) for v in args.sweeps.split(",")],
        timed_calls=args.timed_calls,
        vmem_limit_mb=args.vmem_limit_mb,
        device=args.device,
        rule=args.rule,
    )
    for p in results:
        print(json.dumps(p), flush=True)
    flags = best_flags(results, rule=args.rule)
    if flags is None:
        print("no feasible point succeeded", file=sys.stderr)
        return 1
    # The machine-readable summary: best_point is the selection best_flags
    # rendered, so the two cannot drift apart.
    print(
        json.dumps({
            "tune": {"size": args.size, "rule": args.rule},
            "best": best_point(results),
            "flags": flags,
        }),
        flush=True,
    )
    print(f"best: {flags}")
    return 0


def _selftest_parser(sub) -> None:
    p = sub.add_parser(
        "selftest",
        help="run the product self-checks (gun phase, dense oracle, "
        "checkpoint resume, chaos replay, sharded, families, obs-defer) "
        "through the public Simulation; one JSON line per check",
    )
    p.add_argument(
        "--kernel", choices=list(KERNEL_CHOICES),
        default="auto",
        help="kernel the checks drive (default auto — what `run` would pick)",
    )
    p.add_argument("--device", type=_run_device, default="cuda",
                   help="cuda (every visible card), cuda:N or cpu")


def _selftest(args: argparse.Namespace) -> int:
    from akka_game_of_life_tpu_torch.runtime.selftest import run_selftest

    return 1 if run_selftest(kernel=args.kernel, device=args.device) else 0


def _checkpoints_parser(sub) -> None:
    p = sub.add_parser(
        "checkpoints",
        help="inspect a checkpoint directory: one JSON line per durable "
        "epoch (epoch, layout, rule, shape, bytes on disk)",
    )
    p.add_argument("dir")
    p.add_argument(
        "--validate", action="store_true",
        help="additionally load each epoch in full and report ok/error "
        "(exit 1 if any epoch fails)",
    )


def _checkpoints(args: argparse.Namespace) -> int:
    from akka_game_of_life_tpu_torch.runtime.checkpoint import describe_store

    n = failed = 0
    for info in describe_store(args.dir, validate=args.validate):
        print(json.dumps(info), flush=True)
        n += 1
        # Unreadable metadata fails even without --validate.
        failed += ("error" in info) or (info.get("ok") is False)
    if n == 0:
        print(f"no checkpoints found in {args.dir}", file=sys.stderr)
        return 1
    return 1 if failed else 0


def _models(args: argparse.Namespace) -> int:
    from akka_game_of_life_tpu_torch.ops.rules import NAMED_RULES

    for name in sorted(NAMED_RULES):
        r = NAMED_RULES[name]
        print(json.dumps({
            "name": name,
            "rulestring": r.rulestring(),
            "kind": r.kind,
            "states": r.states,
            "radius": r.radius,
            "neighborhood": r.neighborhood,
        }))
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
    _tune_parser(sub)
    _selftest_parser(sub)
    _checkpoints_parser(sub)
    sub.add_parser(
        "models",
        help="list the registered rule families (name, rulestring, kind, "
        "states, radius) as JSON lines",
    )
    args = parser.parse_args(argv)
    return {
        "run": _run,
        "frontend": _frontend,
        "backend": _backend,
        "tune": _tune,
        "selftest": _selftest,
        "checkpoints": _checkpoints,
        "models": _models,
    }[args.command](args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
