"""Per-cell actor engine — the reference's architecture, preserved as the
CPU parity backend (BASELINE.json config 1).

This is a faithful in-process re-expression of the reference's compute layer
(``CellActor.scala`` + ``NextStateCellGathererActor.scala``), kept because it
*is* the reference's distinctive design and serves as the semantic oracle for
the async/recovery behaviors the device path re-implements densely:

- one :class:`Cell` per grid position holding an epoch-keyed state history
  seeded ``{0: initial}`` (``CellActor.scala:34``);
- cells advance lazily toward the announced epoch, one step at a time, gated
  by a ``waiting`` latch (``scheduleTransitionToNextepochIfNeeded``,
  ``CellActor.scala:41-47``);
- each step spawns a :class:`Gatherer` that asks all 8 neighbors for their
  state at the cell's epoch (``NextStateCellGathererActor.scala:32-36``);
- a neighbor serves the request from history, or **queues** it when asked for
  an epoch it hasn't computed (``CellActor.scala:71-77``), flushing on state
  set (``:82-88``);
- a crashed cell resets to epoch 0 and replays forward out of its neighbors'
  histories (``§3.3`` in SURVEY.md) — the unbounded history *is* the recovery
  log, exactly as in the reference.

Differences from the reference, by design: the transition rule is a correct
parameterized B/S rule (not the ``:44`` bug), the board is toroidal (not
edge-clipped), and message delivery is a deterministic FIFO event loop (akka
delivery order within a pair is FIFO too; there is no network loss in
process, so the gatherer's retry path is unnecessary).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from akka_game_of_life_tpu_torch.ops.rules import Rule, resolve_rule

Position = Tuple[int, int]


class Gatherer:
    """Per-step neighbor-state collector + rule kernel
    (``NextStateCellGathererActor``)."""

    __slots__ = ("cell", "epoch", "neighbors", "want", "got", "current_state")

    def __init__(self, cell: "Cell", epoch: int, neighbors: List[Position]) -> None:
        self.cell = cell
        self.epoch = epoch
        # On toruses smaller than 3 a neighbor position repeats; keep the
        # full offset list so counting uses multiplicity, matching the dense
        # stencil kernels (one reply per *distinct* position still suffices).
        self.neighbors = list(neighbors)
        self.want = set(neighbors)
        self.got: Dict[Position, int] = {}
        self.current_state = cell.history[epoch]

    def offer(self, pos: Position, state: int) -> bool:
        """Accumulate one reply (set semantics: duplicates are no-ops,
        ``GatheredData``'s dedup).  Returns True when complete."""
        if pos in self.want:
            self.got[pos] = state
        return len(self.got) == len(self.want)

    def result(self, rule: Rule) -> int:
        alive = sum(1 for p in self.neighbors if self.got[p] == 1)
        if not rule.is_totalistic:  # wireworld: see ops/stencil.apply_rule
            if self.current_state == 1:
                return 2
            if self.current_state == 2:
                return 3
            if self.current_state == 3 and (rule.birth_mask >> alive) & 1:
                return 1
            return self.current_state
        mask = rule.survive_mask if self.current_state == 1 else rule.birth_mask
        if rule.is_binary:
            return (mask >> alive) & 1
        if self.current_state == 0:
            return (rule.birth_mask >> alive) & 1
        if self.current_state == 1:
            return 1 if (rule.survive_mask >> alive) & 1 else (2 % rule.states)
        return (self.current_state + 1) % rule.states


class Cell:
    """One grid cell: epoch-keyed history + request queue (``CellActor``)."""

    __slots__ = ("pos", "history", "queued_requests", "waiting", "initial")

    def __init__(self, pos: Position, initial: int) -> None:
        self.pos = pos
        self.initial = initial
        self.history: Dict[int, int] = {0: initial}  # the History map
        # requests for epochs not yet computed: epoch -> [gatherer ids]
        self.queued_requests: Dict[int, List[int]] = {}
        self.waiting = False  # waitingForNewState latch

    @property
    def epoch(self) -> int:
        return max(self.history)

    def crash(self) -> None:
        """Supervision restart: vars reinitialized, history lost
        (``CellActor.scala:32-36``)."""
        self.history = {0: self.initial}
        self.queued_requests = {}
        self.waiting = False


class ActorBoard:
    """A toroidal board of per-cell actors with a deterministic FIFO mailbox.

    The coordinator role (epoch announcements, crash injection) is the caller;
    ``advance_to`` is the ``CurrentEpochMsg`` broadcast plus event-loop drain.
    """

    def __init__(self, board: np.ndarray, rule) -> None:
        self.rule = resolve_rule(rule)
        if self.rule.radius != 1:
            raise ValueError(
                "the per-cell actor engine is Moore-8 (radius 1); "
                "radius-R ltl rules run on the dense kernel"
            )
        board = np.asarray(board, dtype=np.uint8)
        self.shape = board.shape
        h, w = self.shape
        self.cells: Dict[Position, Cell] = {
            (y, x): Cell((y, x), int(board[y, x])) for y in range(h) for x in range(w)
        }
        self._neighbors: Dict[Position, List[Position]] = {
            pos: self._moore(pos) for pos in self.cells
        }
        self._gatherers: Dict[int, Gatherer] = {}
        self._next_gid = 0
        self._mailbox: Deque[tuple] = deque()
        self.global_epoch = 0
        self.messages_processed = 0

    def _moore(self, pos: Position) -> List[Position]:
        h, w = self.shape
        y, x = pos
        return [
            ((y + dy) % h, (x + dx) % w)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0)
        ]

    # -- coordinator API -----------------------------------------------------

    def advance_to(self, target_epoch: int) -> None:
        """Announce the epoch and drain the event loop until every cell has
        caught up (cells fast-forward one epoch at a time, as in
        ``CellActor.scala:86``)."""
        self.global_epoch = max(self.global_epoch, target_epoch)
        for pos in self.cells:
            self._mailbox.append(("current_epoch", pos))
        self._drain()

    def crash_cell(self, pos: Position) -> None:
        """DoCrashMsg: the cell loses all state and replays from epoch 0 via
        its neighbors' histories."""
        self.cells[pos].crash()
        # postRestart → re-announce the epoch so it starts catching up
        self._mailbox.append(("current_epoch", pos))
        self._drain()

    def board_at_current(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.uint8)
        for (y, x), cell in self.cells.items():
            out[y, x] = cell.history[cell.epoch]
        return out

    def min_epoch(self) -> int:
        return min(c.epoch for c in self.cells.values())

    def prune_histories_below(self, epoch: int) -> None:
        """Optional bounded-history mode (the reference never prunes —
        SURVEY.md §2 bug 5; pruning trades replay depth for memory)."""
        for cell in self.cells.values():
            keep = {e: s for e, s in cell.history.items() if e >= epoch}
            if not keep:
                keep = {cell.epoch: cell.history[cell.epoch]}
            cell.history = keep

    # -- event loop ----------------------------------------------------------

    def _drain(self) -> None:
        while self._mailbox:
            msg = self._mailbox.popleft()
            self.messages_processed += 1
            kind = msg[0]
            if kind == "current_epoch":
                self._on_current_epoch(msg[1])
            elif kind == "get_to_next_epoch":
                self._on_get_to_next_epoch(msg[1])
            elif kind == "get_state":
                _, requester_gid, pos, epoch = msg
                self._on_get_state(requester_gid, pos, epoch)
            elif kind == "state_reply":
                _, gid, pos, state = msg
                self._on_state_reply(gid, pos, state)
            elif kind == "set_state":
                _, pos, epoch, state = msg
                self._on_set_state(pos, epoch, state)

    def _on_current_epoch(self, pos: Position) -> None:
        # scheduleTransitionToNextepochIfNeeded (CellActor.scala:41-47)
        cell = self.cells[pos]
        if cell.epoch < self.global_epoch and not cell.waiting:
            cell.waiting = True
            self._mailbox.append(("get_to_next_epoch", pos))

    def _on_get_to_next_epoch(self, pos: Position) -> None:
        # spawn a gatherer child (CellActor.scala:67-69)
        cell = self.cells[pos]
        gid = self._next_gid
        self._next_gid += 1
        g = Gatherer(cell, cell.epoch, self._neighbors[pos])
        self._gatherers[gid] = g
        for npos in g.want:
            self._mailbox.append(("get_state", gid, npos, g.epoch))

    def _on_get_state(self, requester_gid: int, pos: Position, epoch: int) -> None:
        # GetStateFromEpoch: serve from history or queue (CellActor.scala:71-77)
        cell = self.cells[pos]
        if epoch in cell.history:
            self._mailbox.append(
                ("state_reply", requester_gid, pos, cell.history[epoch])
            )
        else:
            cell.queued_requests.setdefault(epoch, []).append(requester_gid)

    def _on_state_reply(self, gid: int, pos: Position, state: int) -> None:
        g = self._gatherers.get(gid)
        if g is None:
            return
        if g.offer(pos, state):
            new_state = g.result(self.rule)
            del self._gatherers[gid]
            self._mailbox.append(("set_state", g.cell.pos, g.epoch + 1, new_state))

    def _on_set_state(self, pos: Position, epoch: int, state: int) -> None:
        # SetNewStateMsg guard: previous epoch must exist (CellActor.scala:29-30,79)
        cell = self.cells[pos]
        if epoch - 1 not in cell.history:
            return
        cell.history[epoch] = state
        cell.waiting = False
        # flush queued requests for this epoch (CellActor.scala:82-88)
        for gid in cell.queued_requests.pop(epoch, []):
            self._mailbox.append(("state_reply", gid, pos, state))
        # immediately reschedule if still behind (CellActor.scala:86)
        self._mailbox.append(("current_epoch", pos))


class _TileActorBoard(ActorBoard):
    """An ActorBoard over one tile whose out-of-bounds Moore neighbors are
    *ghost cells* — stand-ins for remote cells, fed per epoch from the halo
    the control plane delivers.  This is how the per-cell-actor architecture
    participates in the tiled cluster: the same pull/queue semantics, with
    the halo as the remote neighbors' served history."""

    def __init__(self, board: np.ndarray, rule) -> None:
        h, w = board.shape
        self.ghost_cells: Dict[Position, Cell] = {}
        for y in range(-1, h + 1):
            for x in range(-1, w + 1):
                if 0 <= y < h and 0 <= x < w:
                    continue
                g = Cell((y, x), 0)
                g.history = {}  # no epoch served until a halo feeds it
                self.ghost_cells[(y, x)] = g
        super().__init__(board, rule)

    def _moore(self, pos: Position) -> List[Position]:
        y, x = pos
        return [
            (y + dy, x + dx)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if (dy, dx) != (0, 0)
        ]

    def _on_get_state(self, requester_gid: int, pos: Position, epoch: int) -> None:
        ghost = self.ghost_cells.get(pos)
        if ghost is None:
            super()._on_get_state(requester_gid, pos, epoch)
            return
        if epoch in ghost.history:
            self._mailbox.append(("state_reply", requester_gid, pos, ghost.history[epoch]))
        else:
            ghost.queued_requests.setdefault(epoch, []).append(requester_gid)

    def feed_halo(self, epoch: int, padded: np.ndarray) -> None:
        """Publish the remote ring's states for ``epoch`` into the ghosts
        (and flush any queued requests waiting on them)."""
        h, w = self.shape
        for (y, x), ghost in self.ghost_cells.items():
            ghost.history[epoch] = int(padded[y + 1, x + 1])
            for gid in ghost.queued_requests.pop(epoch, []):
                self._mailbox.append(("state_reply", gid, (y, x), ghost.history[epoch]))
        self._drain()


class ActorTileEngine:
    """``engine="actor"`` adapter for :class:`BackendWorker`: steps a tile by
    per-cell actor message passing instead of a dense kernel.  Stateful per
    tile; a redeploy constructs a fresh engine (supervision restart)."""

    def __init__(self, rule) -> None:
        self.rule = resolve_rule(rule)
        self._board: Optional[_TileActorBoard] = None
        self._epoch = 0  # internal epoch counter (0 = deploy epoch)

    def step(self, padded: np.ndarray) -> np.ndarray:
        interior = padded[1:-1, 1:-1]
        if self._board is None:
            self._board = _TileActorBoard(interior, self.rule)
        self._board.feed_halo(self._epoch, padded)
        self._epoch += 1
        self._board.advance_to(self._epoch)
        assert self._board.min_epoch() == self._epoch
        # Bounded history: crash recovery goes through redeploy (a fresh
        # engine), never through in-place replay, so only the previous epoch
        # (the set_state guard) is ever read again.
        self._board.prune_histories_below(self._epoch - 1)
        for ghost in self._board.ghost_cells.values():
            ghost.history = {
                e: s for e, s in ghost.history.items() if e >= self._epoch - 1
            }
        return self._board.board_at_current()
