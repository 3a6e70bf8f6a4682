"""Scheduled fault injection — the reference's in-app chaos harness.

The reference ships its chaos testing *inside* the app: a scheduled killer
picks a random cell and crashes it — first after ``error.delay``, then every
``error.every``, bounded by ``max-crashes`` (``BoardCreator.scala:97-102,108``,
``application.conf:41,44-47``).  :class:`CrashInjector` reproduces exactly
that schedule/budget contract.

What a "crash" means is the consumer's choice (the seam between standalone
and cluster modes): the standalone simulation loses its in-memory board and
must restore from checkpoint + deterministic replay; the control-plane
frontend kills a live backend worker process.

This injector faults what the runtime *hosts*; its wire-layer sibling —
:mod:`akka_game_of_life_tpu_torch.runtime.netchaos` — faults what it *says*
(drops, delays, duplicates, reorders, partitions), on the same
schedule/budget contract.  Run both for the full drill.
"""

from __future__ import annotations

import random
import time
from typing import Optional

from akka_game_of_life_tpu_torch.runtime.config import FaultInjectionConfig


class CrashInjector:
    """Wall-clock crash scheduler with a budget.

    ``should_crash(now)`` is True when a scheduled crash is due: the first
    ``first_after_s`` after start, then every ``every_s``, at most
    ``max_crashes`` times.  Deterministic given the clock readings; the
    ``rng`` is exposed for consumers that need to pick a random victim (the
    reference picks a random child cell — ``BoardCreator.scala:99``).
    """

    def __init__(
        self,
        config: FaultInjectionConfig,
        *,
        start_time: Optional[float] = None,
        registry=None,
        flight=None,
    ) -> None:
        self.config = config
        self.crashes = 0
        self.rng = random.Random(config.seed)
        self._start = start_time if start_time is not None else time.monotonic()
        self._next_due: Optional[float] = (
            self._start + config.first_after_s if config.enabled else None
        )
        # Fired crashes count at the source — both schedules, every consumer
        # (standalone replay, cluster node/tile kill) share one counter.
        if registry is None:
            from akka_game_of_life_tpu_torch.obs import get_registry

            registry = get_registry()
        self._crash_counter = registry.counter("gol_chaos_crashes_total")
        # Same at-the-source rule for the flight ring: the schedule firing
        # is on record even if the consumer dies before its own dump.
        if flight is None:
            from akka_game_of_life_tpu_torch.obs.tracing import get_tracer

            flight = get_tracer().flight
        self._flight = flight

    def _fired(self, **fields) -> None:
        self.crashes += 1
        self._crash_counter.inc()
        self._flight.record(
            "chaos_crash_due", n=self.crashes, mode=self.config.mode, **fields
        )

    @property
    def exhausted(self) -> bool:
        return self.crashes >= self.config.max_crashes

    def should_crash(self, now: Optional[float] = None) -> bool:
        if self.config.epoch_indexed:
            return False  # epoch-indexed schedules use should_crash_at_epoch
        if self._next_due is None or self.exhausted:
            return False
        now = now if now is not None else time.monotonic()
        if now < self._next_due:
            return False
        self._fired(schedule="wall_clock")
        self._next_due = now + self.config.every_s
        return True

    def should_crash_at_epoch(self, epoch: int) -> bool:
        """Epoch-indexed twin of :meth:`should_crash`: due once the
        simulation reaches ``first_after_epochs``, then every
        ``every_epochs`` further.  Pure in simulation time — every rank of a
        multi-host run computes the identical schedule, so injected crashes
        are lockstep SPMD events (the distributed-chaos requirement)."""
        if not self.config.epoch_indexed or not self.config.enabled:
            return False
        if self.exhausted:
            return False
        due = self.config.first_after_epochs + self.crashes * self.config.every_epochs
        if epoch < due:
            return False
        self._fired(schedule="epoch_indexed", epoch=epoch)
        return True
