"""The standard metric catalog — every metric the runtime exports, declared
in one place.

This is the single source of truth three consumers share:

- :func:`install` pre-registers every family into a registry, so a scrape
  (or a ``--metrics-file`` dump) shows the full metric surface even for
  paths that never fired in this process — a standalone run still exposes
  ``gol_peer_retries_total 0``;
- ``docs/OPERATIONS.md`` documents the same names (the "Metrics & events"
  table);
- ``tools/check_metrics_doc.py`` (driven by a tier-1 test) asserts the two
  cannot drift: every name here AND every ``gol_*`` literal in the source
  must appear in the doc.

Naming follows Prometheus conventions: ``_total`` counters, ``_seconds``
histograms, bare gauges; everything is prefixed ``gol_``.
"""

from __future__ import annotations

from akka_game_of_life_tpu_torch.obs.metrics import DEFAULT_BUCKETS, MetricsRegistry

# Rings-per-frame buckets for gol_ring_batch_size: batch sizes are small
# integer counts, not latencies, so the shared latency buckets would bin
# everything into one bucket.
RING_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

# First-call (compile) seconds for gol_compile_seconds: XLA compiles run
# milliseconds to minutes, far past the request-latency buckets.
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                   60.0, 120.0)

# (name, kind, help, labelnames[, buckets]) — histograms use DEFAULT_BUCKETS
# unless an entry carries its own.
CATALOG = (
    # -- simulation hot path (L3) --------------------------------------------
    ("gol_epochs_advanced_total", "counter",
     "Generations advanced by the local simulation loop", ()),
    ("gol_chunks_total", "counter",
     "Stepper chunks dispatched (one device round-trip each)", ()),
    ("gol_step_seconds", "histogram",
     "Wall seconds per stepper chunk (dispatch to board swap)", ()),
    ("gol_obs_seconds", "histogram",
     "Wall seconds per cadence observation (device dispatch + host fetch)",
     ()),
    ("gol_epoch", "gauge", "Current simulation epoch", ()),
    ("gol_population", "gauge", "Last observed live-cell population", ()),
    ("gol_steps_per_second", "gauge",
     "Epochs per wall second over the last observed interval", ()),
    ("gol_halo_bytes_total", "counter",
     "Halo bytes exchanged over the device mesh (analytic, per chunk)", ()),
    # -- cluster data/control plane (L1/L2) ----------------------------------
    ("gol_peer_sends_total", "counter",
     "Peer data-plane messages sent (rings, pulls, hellos)", ()),
    ("gol_peer_receives_total", "counter",
     "PEER_RING messages received from peer workers", ()),
    ("gol_peer_retries_total", "counter",
     "Stale-halo re-pulls fired by the retry loop (one per stale tile "
     "per round; rounds are gol_retry_wakeups_total)", ()),
    ("gol_retry_wakeups_total", "counter",
     "Retry-loop passes that found at least one stale tile", ()),
    ("gol_peer_drops_total", "counter",
     "Peer channels dropped (dead or stale-address peers)", ()),
    ("gol_heartbeats_total", "counter", "Heartbeats sent to the frontend", ()),
    ("gol_gather_failures_total", "counter",
     "GATHER_FAILED escalations sent after the retry budget", ()),
    ("gol_ring_bytes_total", "counter",
     "Boundary-ring payload bytes pushed to remote peers (dense cell "
     "bytes, whatever the wire encoding)", ()),
    ("gol_ring_packed_bytes_total", "counter",
     "Boundary-ring bytes actually put on the wire (bit-packed for binary "
     "rules when ring_pack is on; ratio to gol_ring_bytes_total is the "
     "packing win)", ()),
    ("gol_ring_batch_size", "histogram",
     "Rings coalesced into each PEER_RING_BATCH frame (count = frames "
     "sent)", (), RING_BATCH_BUCKETS),
    ("gol_peer_send_queue_depth", "gauge",
     "Entries queued in a peer's async send lane", ("peer",)),
    ("gol_peer_send_queue_drops_total", "counter",
     "Ring/ask entries dropped oldest-first by a full peer send queue "
     "(recovered via halo re-pulls)", ()),
    ("gol_members_alive", "gauge", "Cluster members currently alive", ()),
    ("gol_members_joined_total", "counter", "Workers that ever joined", ()),
    ("gol_members_lost_total", "counter",
     "Workers lost (EOF, stale heartbeat, or GOODBYE)", ()),
    ("gol_redeploys_total", "counter",
     "Tile redeployments (crash recovery, stuck escalation, node loss)", ()),
    # -- elastic plane: live migration, scale-out, drain ----------------------
    ("gol_member_heartbeat_age_seconds", "gauge",
     "Seconds since each member's last control-plane traffic (staleness "
     "early warning; auto-down fires at failure_timeout_s)", ("member",)),
    ("gol_members_draining", "gauge",
     "Members currently draining (graceful scale-in in progress)", ()),
    ("gol_migrations_total", "counter",
     "Live tile migrations committed (digest-certified ownership moves)", ()),
    ("gol_migration_aborts_total", "counter",
     "Live tile migrations rolled back (digest mismatch, deadline, or "
     "member loss — the source kept the tile, no epoch lost)", ()),
    ("gol_migration_seconds", "histogram",
     "Wall seconds per committed migration (PREPARE to COMMIT)", ()),
    ("gol_drains_total", "counter",
     "Graceful worker drains completed (every tile migrated off before "
     "the member left)", ()),
    # -- multi-tenant serving plane (serve/) ----------------------------------
    ("gol_serve_sessions", "gauge",
     "Live board sessions, per tenant", ("tenant",)),
    ("gol_serve_cells", "gauge",
     "Aggregate live-session cells (the serve_max_cells admission "
     "resource)", ()),
    ("gol_serve_session_creates_total", "counter",
     "Board sessions admitted, per tenant", ("tenant",)),
    ("gol_serve_session_evictions_total", "counter",
     "Sessions evicted by the idle TTL sweep", ()),
    ("gol_serve_steps_total", "counter",
     "Board generations served, per tenant", ("tenant",)),
    ("gol_serve_rejects_total", "counter",
     "Requests refused by admission control (HTTP 429), by reason",
     ("reason",)),
    ("gol_serve_queue_depth", "gauge",
     "Step jobs pending in the engine queue", ()),
    ("gol_serve_batch_boards", "histogram",
     "Boards advanced per batched device program (count = programs run)",
     (), RING_BATCH_BUCKETS),
    ("gol_serve_tick_seconds", "histogram",
     "Wall seconds per engine tick (batch assembly + device programs + "
     "scatter-back)", ()),
    ("gol_serve_step_seconds", "histogram",
     "Wall seconds per step request, enqueue to result (queue wait + "
     "batch run)", ()),
    ("gol_serve_ff_jumps_total", "counter",
     "Serve fast-path jumps committed (linear-rule sessions stepping "
     "past serve_max_steps via O(log T) fast-forward)", ()),
    ("gol_serve_ff_jump_retries_total", "counter",
     "Fast-path optimistic commits that lost the race to a batched "
     "write-back and recomputed (bounded, observable)",
     ()),
    # -- cluster-sharded serving (serve/cluster.py + serve/worker.py) ---------
    ("gol_serve_shards", "gauge",
     "Session shards owned, per serve worker (reclaimed to 0 on loss)",
     ("member",)),
    ("gol_serve_shard_sessions", "gauge",
     "Sessions resident, per serve worker (reclaimed to 0 on loss)",
     ("member",)),
    ("gol_serve_worker_queue_depth", "gauge",
     "Serve ops in flight toward each worker (unsent + unanswered; "
     "reclaimed to 0 on loss)", ("member",)),
    ("gol_serve_ops_total", "counter",
     "Session ops forwarded to workers by the cluster frontend", ()),
    ("gol_serve_op_frames_total", "counter",
     "SERVE_OPS frames sent (ops_total / op_frames_total = the op-plane "
     "coalescing ratio)", ()),
    ("gol_serve_shard_migrations_total", "counter",
     "Session-shard migrations committed (freeze → certify → commit)", ()),
    ("gol_serve_shard_migration_aborts_total", "counter",
     "Session-shard migrations rolled back (source unfroze, no loss)", ()),
    ("gol_serve_tiled_sessions", "gauge",
     "Mega-board sessions admitted as tiled (above the largest size "
     "class, fanned across workers per chunk)", ()),
    # -- worker-resident tiled sessions (serve/cluster.py + serve/worker.py) --
    ("gol_serve_tiled_bytes_round", "histogram",
     "Cell-state bytes moved per tiled-session step round (resident "
     "mode: peer halo strips, O(perimeter); ship mode: full chunk "
     "payloads through the frontend, O(area))", (),
     (2**10, 2**12, 2**14, 2**16, 2**18, 2**20, 2**22, 2**24)),
    ("gol_serve_tiled_halo_bytes_total", "counter",
     "Peer-to-peer TILED_HALO strip payload bytes sent by this worker", ()),
    ("gol_serve_tiled_halo_retx_total", "counter",
     "TILED_HALO strips retransmitted after an ack timeout", ()),
    ("gol_serve_tiled_resident_chunks", "gauge",
     "Resident tiled-session chunks hosted by this worker", ()),
    ("gol_serve_tiled_chunk_migrations_total", "counter",
     "Resident tiled chunks re-homed digest-certified (drain/load "
     "rebalancing)", ()),
    # -- session replication & failover (serve/cluster.py) --------------------
    ("gol_serve_replication_lag_seconds", "gauge",
     "Age of the oldest session update the shard's replica has not yet "
     "acked, per shard (0 = caught up; defined only while a replica "
     "exists, reclaimed when caught up/lost)", ("shard",)),
    ("gol_serve_replica_bytes_total", "counter",
     "Bit-packed session snapshot bytes relayed to replicas", ()),
    ("gol_serve_promotions_total", "counter",
     "Shard replicas promoted to primary after a worker loss "
     "(digest-certified; sessions resumed at their replicated epoch)",
     ()),
    ("gol_serve_single_copy_shards", "gauge",
     "Owned shards with NO placeable replica — the honest single-copy "
     "degradation level (0 when replication is healthy)", ()),
    ("gol_serve_sessions_lost_total", "counter",
     "Sessions lost to worker failure (no replica, never-acked, or a "
     "double failure) — each one is a tenant-visible 404", ()),
    # -- frontend federation (serve/federation.py) ----------------------------
    ("gol_frontend_peers", "gauge",
     "Live federation peer frontends (connected AND gossip-fresh)", ()),
    ("gol_frontend_gossip_age_seconds", "gauge",
     "Seconds since the last frame from each peer frontend (label "
     "reclaimed when the peer is confirmed dead)", ("peer",)),
    ("gol_frontend_forwarded_ops_total", "counter",
     "Serve ops forwarded to the owning peer frontend over the peer "
     "link (P_FWD_OPS)", ()),
    ("gol_frontend_forward_redirects_total", "counter",
     "Fat-payload requests answered with a 307 to the owning frontend "
     "instead of proxied (GET /boards/<id>)", ()),
    ("gol_frontend_slice_promotions_total", "counter",
     "Slices adopted from a confirmed-dead peer frontend by its "
     "rendezvous standby", ()),
    ("gol_frontend_slices_owned", "gauge",
     "Serve-keyspace slices this frontend currently owns", ()),
    ("gol_frontend_parked_ops_total", "counter",
     "Ops parked with retryable 429 'partitioned' because the owning "
     "frontend is suspect but not provably dead (the split-brain guard)",
     ()),
    ("gol_frontend_replicated_rows_total", "counter",
     "Control-state rows streamed to this frontend's standby peer "
     "(P_REPLICATE)", ()),
    # -- per-tenant SLO plane (obs/slo.py, served at /slo) --------------------
    ("gol_serve_slo_requests_total", "counter",
     "HTTP requests against the serve surface, per tenant/route/outcome "
     "(ok | rejected | client_error | error) — the SLO plane's R+E",
     ("tenant", "route", "outcome")),
    ("gol_serve_slo_latency_seconds", "histogram",
     "End-to-end request latency per tenant (trace-id exemplars ride the "
     "buckets: a p99 spike clicks through to a concrete trace via /slo)",
     ("tenant",)),
    ("gol_serve_slo_queue_wait_seconds", "histogram",
     "Worker-side queue wait per step request (relayed to the edge; "
     "latency minus this is compute + wire)", ()),
    ("gol_serve_slo_burn_rate", "gauge",
     "Error-budget burn rate per objective (availability | latency) and "
     "window (fast | slow); 1.0 = burning exactly the budget",
     ("objective", "window")),
    ("gol_serve_slo_burn_alert", "gauge",
     "1 while the multi-window burn alert is firing for an objective "
     "(both windows past threshold), else 0", ("objective",)),
    ("gol_serve_slo_alerts_total", "counter",
     "Burn-alert firing edges per objective (transition-edged: one per "
     "incident, not per scrape)", ("objective",)),
    ("gol_serve_slo_tenants", "gauge",
     "Tenants currently tracked by the SLO plane (LRU-bounded by "
     "serve_slo_max_tenants; evictees fold into the ~overflow tenant)",
     ()),
    # -- digest-certified canary prober (serve/canary.py) ---------------------
    ("gol_canary_probes_total", "counter",
     "Canary probes by outcome (ok | mismatch | rejected | lost | error "
     "| pin_failed) — the black-box availability numerator/denominator",
     ("outcome",)),
    ("gol_canary_failures_total", "counter",
     "Canary probes that PAGED: digest mismatch against the numpy "
     "oracle, or a wedged/errored worker (flight dump reason="
     "canary_fail carries the failing trace)", ()),
    ("gol_canary_latency_seconds", "histogram",
     "Canary probe latency through the real HTTP surface (black-box; "
     "compare with gol_serve_slo_latency_seconds{tenant=\"canary\"})",
     ()),
    ("gol_canary_staleness_seconds", "gauge",
     "Seconds since the LEAST-recently-certified pinned session last "
     "certified ok (grows past the cadence = a worker is wedged or the "
     "surface is down)", ()),
    ("gol_canary_sessions", "gauge",
     "Canary sessions currently pinned (one per serving worker on the "
     "cluster plane)", ()),
    # -- cross-tenant memoized macro-stepping (serve/memo.py) -----------------
    ("gol_serve_memo_hits_total", "counter",
     "Macro-cell cache hits per tenant (zero-block shortcuts included: "
     "a dead tile is a free hit)", ("tenant",)),
    ("gol_serve_memo_misses_total", "counter",
     "Macro-cell cache misses per tenant (each unique miss costs one "
     "slot in the round's batched device call)", ("tenant",)),
    ("gol_serve_memo_epochs_total", "counter",
     "Epochs advanced through memoized macro-rounds per tenant (the "
     "fast-path share of gol_serve_steps_total)", ("tenant",)),
    ("gol_serve_memo_entries", "gauge",
     "Macro-cell cache entries resident (shared across all tenants)",
     ()),
    ("gol_serve_memo_bytes", "gauge",
     "Macro-cell cache bytes resident (bounded by serve_memo_max_mb)",
     ()),
    ("gol_serve_memo_evictions_total", "counter",
     "Macro-cell cache LRU evictions (byte budget pressure; an evicted "
     "block recomputes on next miss)", ()),
    ("gol_serve_memo_hit_rate", "gauge",
     "Global macro-cell cache hit rate since start (hits / probes); the "
     "cross-tenant sharing signal the runbook watches", ()),
    ("gol_serve_memo_disables_total", "counter",
     "Sessions adaptively retired from the memo plane (hit rate below "
     "serve_memo_hit_floor for serve_memo_disable_after rounds, or a "
     "certification mismatch)", ()),
    ("gol_memo_certify_total", "counter",
     "Sampled memo-vs-direct certifications run (every "
     "serve_memo_certify_every-th macro-round per session)", ()),
    ("gol_memo_certify_mismatches_total", "counter",
     "Memo-vs-direct digest mismatches — a kernel/cache bug signal: "
     "event + flight dump reason=memo_certify_mismatch, the direct "
     "board wins, the session leaves the memo plane", ()),
    # -- logarithmic fast-forward (ops/fastforward.py) ------------------------
    ("gol_ff_jumps_total", "counter",
     "Fast-forward jumps committed by Simulation.fast_forward", ()),
    ("gol_ff_epochs_total", "counter",
     "Epochs advanced via O(log T) fast-forward jumps", ()),
    ("gol_ff_seconds", "histogram",
     "Wall seconds per fast-forward jump (certify + jump + board swap)",
     ()),
    # -- activity-gated sparse stepping --------------------------------------
    ("gol_tiles_skipped_total", "counter",
     "Tile chunks skipped by quiescent cluster tiles (frontend-merged "
     "worker deltas — the cluster tier's O(activity) win)", ()),
    ("gol_tiles_quiescent", "gauge",
     "Tiles currently self-reporting quiescent (period 1 or 2)", ()),
    ("gol_tile_chunks_skipped_total", "counter",
     "Tile chunks this worker skipped as provably quiescent", ()),
    ("gol_ring_same_markers_total", "counter",
     "O(1)-byte same-ring markers published in place of ring payloads", ()),
    ("gol_ring_same_miss_total", "counter",
     "Same-ring markers whose referenced epoch was not in the local store "
     "(recovered by the dependent pull's re-ask — latency, never "
     "corruption)", ()),
    ("gol_sparse_active_blocks", "gauge",
     "Blocks the intra-tile activity gate considers live this chunk", ()),
    ("gol_sparse_blocks_stepped_total", "counter",
     "Block-chunks actually advanced by the gated kernel", ()),
    ("gol_sparse_blocks_skipped_total", "counter",
     "Block-chunks skipped as provably unchanged by the activity gate", ()),
    ("gol_sparse_dense_chunks_total", "counter",
     "Chunks the gate handed to the dense kernel (active fraction over "
     "sparse_threshold, or a board of unknown provenance)", ()),
    # -- network chaos plane / hardened comms ----------------------------------
    ("gol_net_chaos_dropped_total", "counter",
     "Messages dropped by the network chaos policy (random drops + "
     "partition blocks, send and recv side)", ()),
    ("gol_net_chaos_delayed_total", "counter",
     "Messages delayed by the network chaos policy", ()),
    ("gol_net_chaos_duplicated_total", "counter",
     "Messages duplicated by the network chaos policy", ()),
    ("gol_net_chaos_reordered_total", "counter",
     "Messages held so the next send overtakes them", ()),
    ("gol_net_partitions_total", "counter",
     "Network partitions opened (scheduled or manual)", ()),
    ("gol_net_partition_heals_total", "counter",
     "Network partitions healed", ()),
    ("gol_breaker_state", "gauge",
     "Per-peer circuit breaker state (0=closed, 1=open, 2=half-open)",
     ("peer",)),
    ("gol_breaker_open_total", "counter",
     "Circuit breaker closed-to-open transitions", ()),
    ("gol_breaker_skipped_sends_total", "counter",
     "Peer sends refused by an open circuit breaker", ()),
    ("gol_retry_backoff_seconds", "histogram",
     "Backoff delay chosen per halo re-pull retry (decorrelated jitter)",
     ()),
    ("gol_degraded_mode", "gauge",
     "1 while the frontend is in partition-degraded mode", ()),
    ("gol_degraded_entries_total", "counter",
     "Times the frontend entered degraded mode", ()),
    # -- chaos / failure paths -----------------------------------------------
    ("gol_chaos_crashes_total", "counter",
     "Crashes fired by the chaos injector (any mode)", ()),
    ("gol_chaos_recovered_total", "counter",
     "Injected crashes recovered by checkpoint restore + replay "
     "(standalone runtime; cluster recovery surfaces as "
     "gol_redeploys_total)", ()),
    ("gol_chaos_replay_epochs_total", "counter",
     "Epochs recomputed during standalone crash-recovery replay", ()),
    # -- digest certification plane ------------------------------------------
    ("gol_digest_checks_total", "counter",
     "Board digests computed/merged (standalone cadence observation, "
     "frontend tile-digest merges, recovery-source certification)", ()),
    ("gol_digest_mismatches_total", "counter",
     "Digest comparisons that disagreed (corrupt recovery source / "
     "diverged state — always a fault, never expected)", ()),
    ("gol_digest_seconds", "histogram",
     "Wall seconds per digest compute+fetch (device) or merge (frontend)",
     ()),
    # -- checkpoint / durability ---------------------------------------------
    ("gol_checkpoint_saves_total", "counter",
     "Checkpoint saves made durable (full-board or finalized per-tile)", ()),
    ("gol_checkpoint_restores_total", "counter",
     "Checkpoint loads (resume, recovery, or inspection)", ()),
    ("gol_checkpoint_seconds", "histogram",
     "Checkpoint IO wall seconds", ("op",)),
    # -- profiling spans -----------------------------------------------------
    ("gol_span_seconds", "histogram",
     "profiling.timed() span wall seconds", ("span",)),
    # -- compile & device-cost observatory (obs/programs.py) ------------------
    ("gol_compile_seconds", "histogram",
     "First-call (compile) wall seconds per registered jitted program, "
     "per kernel family", ("family",), COMPILE_BUCKETS),
    ("gol_programs_live", "gauge",
     "Jitted programs on the ledger, per family (cluster-merged on the "
     "frontend; reclaimed with their last contributing member)",
     ("family",)),
    ("gol_program_invocations_total", "counter",
     "Invocations of registered jitted programs, per family", ("family",)),
    ("gol_program_device_seconds_total", "counter",
     "Host-observed seconds inside registered jitted programs, per "
     "family (async dispatch makes this a throughput lower bound)",
     ("family",)),
    ("gol_compile_storms_total", "counter",
     "Compile storms: NEW programs that compiled after warmup (each one "
     "stalled a live batch; an event + flight dump marks each)", ()),
    ("gol_device_bytes_in_use", "gauge",
     "Device memory currently allocated, per device (cluster members "
     "namespaced member:device; reclaimed on loss)", ("device",)),
    ("gol_device_peak_bytes_in_use", "gauge",
     "Device memory high-water mark since process start, per device",
     ("device",)),
    ("gol_profile_captures_total", "counter",
     "On-demand profiler captures taken (POST /profile)", ()),
)


def install(registry: MetricsRegistry) -> MetricsRegistry:
    """Pre-register every cataloged family into ``registry`` (idempotent)."""
    for entry in CATALOG:
        name, kind, help, labelnames = entry[:4]
        if kind == "counter":
            registry.counter(name, help, labelnames)
        elif kind == "gauge":
            registry.gauge(name, help, labelnames)
        else:
            buckets = entry[4] if len(entry) > 4 else DEFAULT_BUCKETS
            registry.histogram(name, help, labelnames, buckets=buckets)
    return registry


def names() -> tuple:
    return tuple(entry[0] for entry in CATALOG)
