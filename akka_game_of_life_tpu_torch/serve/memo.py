"""Cross-tenant memoized macro-stepping: the Hashlife-grade serve fast path.

The serving plane's boards are small, numerous, and HIGHLY repetitive:
guns, oscillators, still lifes, and dead space dominate real traffic, and
thousands of tenants seed from overlapping pattern libraries.  Hashlife's
macro-cell theorem (``ops/macroblock.py``) turns that repetition into a
fast path that works for EVERY outer-totalistic rule — including the
nonlinear ones the XOR fast-forward plane (``ops/fastforward.py``) cannot
touch: a B-sided block's content determines its T-sided center (T = B/2)
for S = B/4 generations, so

    (rule, canonical block payload)  →  center tile after S epochs

is a pure function, memoizable in a content-addressed cache shared across
ALL sessions of ALL tenants in the process.  One tenant's glider gun
warms the cache for every other tenant running the same rule.

The engine advances memo-eligible step jobs in **macro-rounds** of S
epochs each, lockstep across the tick's tasks:

0. the WHOLE pre-round board is hashed against the board-chain cache
   (:class:`BoardMemo` — Hashlife's top-of-the-quadtree move): a board on
   a periodic orbit, settled ash, or a twin tenant's trajectory advances
   the full S epochs for one packbits+crc of the board, skipping every
   per-block step below;
1. otherwise the board tiles into T-sided result tiles; each tile's
   toroidal B-sided context block is extracted in one gather;
2. all-zero contexts under a no-B0 rule short-circuit to zero centers —
   no hashing, no assembly (dead space is the dominant win on structured
   boards);
3. the rest hash (crc32 bucket + full-payload compare — collisions cost a
   memcmp, never a wrong answer) and hit or miss the shared cache;
4. the round's unique misses — deduplicated ACROSS tasks, so two tenants
   missing the same block pay the device once — batch into ONE batched
   device call (``serve/batch.memo_block_step_fn``, rule masks as traced
   operands, batch dim padded to a power of two);
5. results scatter back into the cache and every task assembles its next
   board from centers; digest lanes fold from per-block contributions
   (``ops/digest.BlockLaneCache``) instead of an O(board) re-mix.

Overhead discipline (the contract: observability/auxiliary planes
stay within ~5% of the work they watch): hashing is the only cost a
hostile board can force.  Per-session warmup probes the cache ungated for
``serve_memo_warmup`` macro-rounds; after that, a round whose hit rate
falls below ``serve_memo_hit_floor`` aborts the task to the dense path
immediately (misses NOT paid), and ``serve_memo_disable_after``
consecutive low rounds disable memoization for the session outright — a
high-entropy random board degrades to one crc32 pass per probe round,
then to zero.

Trust, but verify: memoized trajectories are sampled against direct
iteration through the digest plane.  Every ``serve_memo_certify_every``-th
macro-round of a session (and always its first), the pre-round board is
ALSO advanced S epochs by the dense batched kernel and the two digests
compared — ``gol_memo_certify_total`` / ``gol_memo_certify_mismatches_total``
count the verdicts, and a mismatch raises a loud event + flight dump,
commits the DIRECT board (the trusted one), and drops the session to the
dense path for good.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from akka_game_of_life_tpu_torch.ops import digest as odigest
from akka_game_of_life_tpu_torch.ops import macroblock as mblock
from akka_game_of_life_tpu_torch.serve import batch as sbatch

__all__ = ["MemoCache", "MemoEngine", "MemoTask"]

# Per-entry bookkeeping estimate charged against serve_memo_max_mb beyond
# the payload/center bytes themselves: dict slot, key tuple, two bytes
# objects' headers, the pop int.  An estimate on purpose — the bound
# exists to stop unbounded growth, not to account the allocator.
_ENTRY_OVERHEAD = 160


class _Entry:
    """One memoized macro-step result: context payload → decoded center.

    The center ships decoded (read-only uint8) because hits are the hot
    path — assembly must be a reshape/transpose away, never an unpackbits
    per tile per round.  ``center_payload`` re-encodes the center once at
    insert so whole-board digests can key the block-lane cache by center
    CONTENT (maximal reuse: the same still life at the same origin folds
    identical lanes whatever context produced it)."""

    __slots__ = ("center", "center_payload", "pop", "nbytes")

    def __init__(self, payload: bytes, center: np.ndarray, states: int):
        center = np.ascontiguousarray(center, dtype=np.uint8)
        center.setflags(write=False)
        self.center = center
        self.center_payload = mblock.encode_blocks(
            center[None, :, :], states
        )[0]
        self.pop = int((center == 1).sum())
        self.nbytes = (
            len(payload)
            + center.nbytes
            + len(self.center_payload)
            + _ENTRY_OVERHEAD
        )


class MemoCache:
    """The content-addressed macro-cell store, shared across every session
    and tenant of a router.

    Keys are ``(rule_operands, crc32(payload), payload)``: the crc is the
    cheap bucket hash (``ops/macroblock.block_key``), and the payload
    bytes ride the key so equality — Python's own within-bucket compare —
    resolves crc collisions by full content, never by trusting the hash.
    Byte-bounded LRU: eviction pops the coldest entry until under
    ``max_bytes``; an evicted block just recomputes on next miss, so
    tightness costs device time, never correctness.  Thread-safe (the
    ticker owns the write path, but /cost and metrics read concurrently).
    """

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: tuple) -> Optional[_Entry]:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e

    def insert(self, key: tuple, center: np.ndarray, states: int) -> _Entry:
        e = _Entry(key[2], center, states)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[key] = e
            self.bytes += e.nbytes
            while self.bytes > self.max_bytes and len(self._entries) > 1:
                _, cold = self._entries.popitem(last=False)
                self.bytes -= cold.nbytes
                self.evictions += 1
        return e

    def stats(self) -> dict:
        with self._lock:
            probes = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / probes) if probes else 0.0,
            }


class _BoardEntry:
    """One whole-board macro-step chain link: canonical pre-round board
    payload → (board, lanes, pop) after S epochs."""

    __slots__ = ("board", "lanes", "pop", "nbytes")

    def __init__(self, payload: bytes, board: np.ndarray, lanes, pop: int):
        self.board = board
        self.lanes = lanes
        self.pop = pop
        self.nbytes = len(payload) + board.nbytes + 8 + _ENTRY_OVERHEAD


class BoardMemo:
    """The second memo level: whole-board macro-step chaining.

    Hashlife's superpower is not the leaf blocks — it is memoizing at the
    TOP of the quadtree, so a board on a periodic orbit (a gun, an
    oscillator garden, settled ash) advances a full macro-round per hash
    lookup of the whole board.  Same key discipline as :class:`MemoCache`
    (rule operands + crc bucket + full payload, plus the board shape —
    bit-packing erases geometry, and a 32x64 board must never answer a
    64x32 probe), same byte-bounded LRU, same collision story.  The block
    cache underneath stays the workhorse for boards that share structure
    without repeating exactly; this level turns exact recurrence — the
    steady state of every bounded Life board — into O(bytes) per round.
    """

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _BoardEntry]" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: tuple) -> Optional[_BoardEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e

    def insert(
        self, key: tuple, board: np.ndarray, lanes, pop: int
    ) -> None:
        board = np.ascontiguousarray(board, dtype=np.uint8)
        board.setflags(write=False)
        e = _BoardEntry(key[2], board, lanes, pop)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[key] = e
            self.bytes += e.nbytes
            while self.bytes > self.max_bytes and len(self._entries) > 1:
                _, cold = self._entries.popitem(last=False)
                self.bytes -= cold.nbytes
                self.evictions += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "board_entries": len(self._entries),
                "board_bytes": self.bytes,
                "board_hits": self.hits,
                "board_misses": self.misses,
                "board_evictions": self.evictions,
            }


class _SessionMemo:
    """Per-session adaptive state, stored on the Session object so it dies
    (and its history with it) when the session does."""

    __slots__ = ("rounds", "hits", "misses", "low_streak", "disabled")

    def __init__(self) -> None:
        self.rounds = 0
        self.hits = 0
        self.misses = 0
        self.low_streak = 0
        self.disabled = False


class MemoTask:
    """One step job riding the memo phase: the snapshot it was planned
    against, the working board the rounds evolve, and the commit payload
    (lanes/pop) the router writes back."""

    __slots__ = (
        "job", "sess", "board0", "epoch0", "board", "rounds_total",
        "rounds_done", "state", "fell_back", "lanes", "pop",
    )

    def __init__(self, job, sess, board0, epoch0, rounds_total, state):
        self.job = job
        self.sess = sess
        self.board0 = board0
        self.epoch0 = epoch0
        self.board = board0
        self.rounds_total = rounds_total
        self.rounds_done = 0
        self.state = state
        self.fell_back = False
        self.lanes: Optional[np.ndarray] = None
        self.pop = 0


class MemoEngine:
    """The macro-stepping engine one :class:`SessionRouter` owns.

    Pure compute: ``plan_tasks`` partitions a tick's snapshots into memo
    tasks and dense passthroughs, ``run`` advances the tasks by macro-
    rounds.  Table commits stay in the router (its lock, its optimistic
    write-back discipline) — the engine never touches the session table.
    """

    def __init__(
        self,
        config,
        *,
        registry,
        tracer,
        events=None,
        size_classes: Sequence[int] = sbatch.DEFAULT_SIZE_CLASSES,
        cache: Optional[MemoCache] = None,
        device="cuda",
    ) -> None:
        self.device = device
        self.block = int(config.serve_memo_block)
        self.steps = self.block // 4
        self.hit_floor = float(config.serve_memo_hit_floor)
        self.warmup = int(config.serve_memo_warmup)
        self.disable_after = int(config.serve_memo_disable_after)
        self.certify_every = int(config.serve_memo_certify_every)
        self.size_classes = tuple(size_classes)
        budget = int(config.serve_memo_max_mb) << 20
        self.cache = cache if cache is not None else MemoCache(budget)
        # The whole-board chain level rides an eighth of the byte budget:
        # its entries are fat (a full board each) but an orbit needs only
        # period-many of them, and the block cache stays the workhorse
        # for cross-board sharing.
        self.board_cache = BoardMemo(max(budget >> 3, 1 << 20))
        self.lane_cache = odigest.BlockLaneCache()
        self.tracer = tracer
        self.events = events
        m = registry
        self._m_hits = m.counter(
            "gol_serve_memo_hits_total", labelnames=("tenant",)
        )
        self._m_misses = m.counter(
            "gol_serve_memo_misses_total", labelnames=("tenant",)
        )
        self._m_epochs = m.counter(
            "gol_serve_memo_epochs_total", labelnames=("tenant",)
        )
        self._m_entries = m.gauge("gol_serve_memo_entries")
        self._m_bytes = m.gauge("gol_serve_memo_bytes")
        self._m_evictions = m.counter("gol_serve_memo_evictions_total")
        self._m_hit_rate = m.gauge("gol_serve_memo_hit_rate")
        self._m_disables = m.counter("gol_serve_memo_disables_total")
        self._m_certify = m.counter("gol_memo_certify_total")
        self._m_certify_bad = m.counter("gol_memo_certify_mismatches_total")
        self._evictions_pub = 0  # counter is monotonic; cache stat is too
        # Block-equivalent probe totals across BOTH memo levels (a board
        # hit serves every one of its blocks), matching the per-tenant
        # counters — the global hit-rate gauge derives from these.
        self._hits_eq = 0
        self._misses_eq = 0
        # The cost observatory's /cost doc grows a serve_memo section so
        # cache economics attribute alongside compile/device spend.
        from akka_game_of_life_tpu_torch.obs.programs import register_section

        register_section("serve_memo", self._section_stats)

    def _section_stats(self) -> dict:
        """The /cost ``serve_memo`` section: block-cache economics plus
        the whole-board chain level's, one flat numeric dict so the cost
        observatory can merge it across cluster members."""
        return {**self.cache.stats(), **self.board_cache.stats()}

    # The per-tenant instruments whose children the router must reclaim
    # when a tenant's last session drops (the exposition-growth contract
    # _drop_locked enforces for every tenant-labelled serve metric).
    @property
    def tenant_instruments(self) -> tuple:
        return (self._m_hits, self._m_misses, self._m_epochs)

    # -- planning -------------------------------------------------------------

    def eligible(self, sess) -> bool:
        """Memo-plane eligibility for a session's geometry and state (the
        rule is always totalistic on this plane)."""
        state = sess.memo
        if state is not None and state.disabled:
            return False
        return mblock.plan(sess.height, sess.width, self.block) is not None

    def plan_tasks(
        self, entries: List[tuple]
    ) -> Tuple[List[MemoTask], List[tuple]]:
        """Partition a tick's ``(job, sess, board, epoch0)`` snapshots into
        memo tasks (jobs worth ≥ 1 macro-round on eligible sessions) and
        dense passthroughs."""
        tasks: List[MemoTask] = []
        passthrough: List[tuple] = []
        for entry in entries:
            job, sess, board, epoch0 = entry
            rounds = job.steps // self.steps
            if rounds < 1 or not self.eligible(sess):
                passthrough.append(entry)
                continue
            if sess.memo is None:
                sess.memo = _SessionMemo()
            tasks.append(
                MemoTask(job, sess, board, epoch0, rounds, sess.memo)
            )
        return tasks, passthrough

    # -- the macro-round loop -------------------------------------------------

    def run(self, tasks: List[MemoTask]) -> None:
        """Advance every task as far as memoization carries it (mutating
        tasks in place): lockstep macro-rounds with cross-task miss
        deduplication, one device call per round.  A task that falls back
        (low hit rate, certify mismatch) keeps the rounds it completed —
        the router routes its remainder dense."""
        while True:
            active = [
                t
                for t in tasks
                if not t.fell_back and t.rounds_done < t.rounds_total
            ]
            if not active:
                break
            self._run_round(active)
        probes = self._hits_eq + self._misses_eq
        if probes:
            self._m_hit_rate.set(self._hits_eq / probes)
        self._m_entries.set(len(self.cache))
        self._m_bytes.set(self.cache.bytes)
        ev = self.cache.evictions + self.board_cache.evictions
        if ev > self._evictions_pub:
            self._m_evictions.inc(ev - self._evictions_pub)
            self._evictions_pub = ev

    def _run_round(self, active: List[MemoTask]) -> None:
        # Phase 1: extract + hash + look up, per task.  Misses are only
        # PLANNED here (per-task), committed to the round batch in phase 2
        # after the task passes its hit-rate gate — a gated task must not
        # charge the device for blocks only it wanted.
        plans = []  # (task, plan, rule_ops, slots, board_key)
        for t in active:
            sess = t.sess
            p = mblock.plan(sess.height, sess.width, self.block)
            rule_ops = sbatch.rule_operands(sess.rule)
            # Whole-board chain level first: a board seen before (periodic
            # orbit, settled ash, a twin tenant one round behind) advances
            # the entire macro-round for one hash of the board — no
            # extraction, no per-block probes, no assembly.
            bp = mblock.encode_blocks(t.board[None], rule_ops[2])[0]
            bkey = (rule_ops, mblock.block_key(bp), bp, t.board.shape)
            be = self.board_cache.lookup(bkey)
            if be is not None:
                board_pre = t.board
                t.board = be.board
                t.lanes = be.lanes
                t.pop = be.pop
                st = t.state
                st.hits += p.n_tiles  # one board hit = every block served
                st.low_streak = 0
                self._hits_eq += p.n_tiles
                self._m_hits.labels(tenant=sess.tenant).inc(p.n_tiles)
                t.rounds_done += 1
                st.rounds += 1
                self._m_epochs.labels(tenant=sess.tenant).inc(self.steps)
                if self.certify_every > 0 and (
                    st.rounds % self.certify_every == 1
                    or self.certify_every == 1
                ):
                    self._certify(t, board_pre, rule_ops)
                continue
            ctx = mblock.extract_contexts(t.board, p)
            live = ctx.reshape(p.n_tiles, -1).any(axis=1)
            if rule_ops[0] & 1:
                # B0 rules birth from dead space: no zero shortcut.
                live[:] = True
            idx = np.flatnonzero(live)
            payloads = (
                mblock.encode_blocks(ctx[idx], rule_ops[2])
                if idx.size
                else []
            )
            # slots[j] is tile j's resolution: None → zero center,
            # _Entry → hit, (key, block) → miss pending device compute.
            slots: List[object] = [None] * p.n_tiles
            n_hit = int(p.n_tiles - idx.size)  # zero tiles are free hits
            n_miss = 0
            for j, payload in zip(idx, payloads):
                key = (rule_ops, mblock.block_key(payload), payload)
                e = self.cache.lookup(key)
                if e is None:
                    slots[j] = (key, np.ascontiguousarray(ctx[j]))
                    n_miss += 1
                else:
                    slots[j] = e
                    n_hit += 1
            st = t.state
            st.hits += n_hit
            st.misses += n_miss
            self._hits_eq += n_hit
            self._misses_eq += n_miss
            self._m_hits.labels(tenant=sess.tenant).inc(n_hit)
            self._m_misses.labels(tenant=sess.tenant).inc(n_miss)
            rate = n_hit / p.n_tiles
            if st.rounds >= self.warmup and rate < self.hit_floor:
                # Post-warmup gate, BEFORE misses are paid: the round cost
                # on a hostile board is the crc pass above, nothing more.
                st.low_streak += 1
                t.fell_back = True
                if st.low_streak >= self.disable_after and not st.disabled:
                    st.disabled = True
                    self._m_disables.inc()
                    if self.events is not None:
                        self.events.emit(
                            "memo_disabled",
                            sid=sess.sid,
                            tenant=sess.tenant,
                            rounds=st.rounds,
                            hit_rate=round(rate, 4),
                        )
                continue
            st.low_streak = 0
            plans.append((t, p, rule_ops, slots, bkey))
        if not plans:
            return

        # Phase 2: ONE device call for the round's unique misses.
        misses: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        for _, _, _, slots, _ in plans:
            for s in slots:
                if type(s) is tuple:
                    misses.setdefault(s[0], s[1])
        computed: Dict[tuple, _Entry] = {}
        if misses:
            keys = list(misses)
            n = len(keys)
            n_pad = sbatch.next_pow2(n)
            blocks = np.zeros(
                (n_pad, self.block, self.block), dtype=np.uint8
            )
            birth = np.zeros(n_pad, dtype=np.uint32)
            survive = np.zeros(n_pad, dtype=np.uint32)
            states = np.full(n_pad, 2, dtype=np.int32)
            for i, key in enumerate(keys):
                blocks[i] = misses[key]
                birth[i], survive[i], states[i] = key[0]
            centers = (
                sbatch.memo_block_step_fn(self.block, self.device)(
                    blocks, birth, survive, states
                )
                .cpu()
                .numpy()
            )
            for i, key in enumerate(keys):
                computed[key] = self.cache.insert(
                    key, centers[i], key[0][2]
                )

        # Phase 3: assemble each surviving task's next board; lanes fold
        # from per-center contributions, population from entry pops.
        for t, p, rule_ops, slots, bkey in plans:
            sess = t.sess
            tile = p.tile
            board_pre = t.board
            stack = np.zeros(
                (p.n_tiles, tile, tile), dtype=np.uint8
            )
            parts = []
            pop = 0
            origins = p.origins()
            for j, s in enumerate(slots):
                if s is None:
                    continue  # zero center: zero lanes, zero pop
                e = s if isinstance(s, _Entry) else computed[s[0]]
                stack[j] = e.center
                pop += e.pop
                parts.append(
                    self.lane_cache.block_lanes(
                        e.center_payload, e.center, origins[j], p.width
                    )
                )
            t.board = p.assemble(stack)
            t.lanes = odigest.merge_lanes(parts)
            t.pop = pop
            t.rounds_done += 1
            t.state.rounds += 1
            self._m_epochs.labels(tenant=sess.tenant).inc(self.steps)
            if self.certify_every > 0 and (
                t.state.rounds % self.certify_every == 1
                or self.certify_every == 1
            ):
                self._certify(t, board_pre, rule_ops)
            if not t.fell_back:
                # Chain the round at the board level — but never a result
                # certification just rejected (the block path was wrong;
                # caching its output would launder the corruption).
                self.board_cache.insert(bkey, t.board, t.lanes, t.pop)

    # -- sampled certification ------------------------------------------------

    def _certify(self, t: MemoTask, board_pre: np.ndarray, rule_ops) -> None:
        """Advance the pre-round board S epochs on the DENSE batched kernel
        (batch of one) and compare digests with the memoized result.  A
        mismatch is a kernel/cache bug signal: loud event + flight dump,
        the direct board wins the commit, and the session leaves the memo
        plane for good."""
        sess = t.sess
        cls = sbatch.size_class(sess.height, sess.width, self.size_classes)
        if cls is None:  # unreachable on this plane; never certify-skip silently
            cls = sbatch.next_pow2(max(sess.height, sess.width))
        length = sbatch.next_pow2(self.steps)
        boards = np.zeros((1, cls, cls), dtype=np.uint8)
        boards[0, : sess.height, : sess.width] = board_pre
        out, lanes = sbatch.batch_step_fn(cls, length, self.device)(
            boards,
            np.asarray([rule_ops[0]], dtype=np.uint32),
            np.asarray([rule_ops[1]], dtype=np.uint32),
            np.asarray([rule_ops[2]], dtype=np.int32),
            np.asarray([sess.height], dtype=np.int32),
            np.asarray([sess.width], dtype=np.int32),
            np.asarray([self.steps], dtype=np.int32),
        )
        direct_lanes = lanes.cpu().numpy().astype(np.uint32)[0]
        self._m_certify.inc()
        if odigest.value(direct_lanes) == odigest.value(t.lanes):
            return
        self._m_certify_bad.inc()
        direct = out[0, : sess.height, : sess.width].cpu().numpy()
        if self.events is not None:
            self.events.emit(
                "memo_certify_mismatch",
                sid=sess.sid,
                tenant=sess.tenant,
                rule=sess.rule.rulestring(),
                epoch=t.epoch0 + t.rounds_done * self.steps,
                memo=odigest.format_digest(odigest.value(t.lanes)),
                direct=odigest.format_digest(odigest.value(direct_lanes)),
            )
        flight = getattr(self.tracer, "flight", None)
        if flight is not None:
            flight.dump("memo_certify_mismatch", node="serve")
        # The direct board is the trusted one: commit it, keep the round
        # (it DID advance S epochs), and retire the session from memo.
        t.board = direct
        t.lanes = direct_lanes
        t.pop = int((direct == 1).sum())
        t.fell_back = True
        if not t.state.disabled:
            t.state.disabled = True
            self._m_disables.inc()
