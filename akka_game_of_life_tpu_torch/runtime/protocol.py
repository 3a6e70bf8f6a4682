"""Control-plane message protocol — the reference's actor messages, as data.

This is the plugin boundary SURVEY.md §2 calls out: the ``Tick``/``CellState``
message contract between coordinator and compute backends, preserved so the
CPU per-cell backend and the TPU stencil backend are swappable by role
config.  Mapping to the reference protocol:

==========================  ====================================================
This protocol               Reference message (file:line)
==========================  ====================================================
REGISTER / WELCOME          cluster join + MemberUp (BoardCreator.scala:125-126)
HEARTBEAT                   cluster gossip liveness (application.conf:23)
DEPLOY                      remote CellActor deployment (BoardCreator.scala:65-70)
OWNERS                      NeighboursRefs wiring + re-wiring — who serves each
                            tile, with peer addresses
                            (BoardCreator.scala:86-88,149-151)
TICK                        CurrentEpochMsg broadcast (BoardCreator.scala:113-116)
PROGRESS                    a cell's state landing in History, as a control
                            ping only — the data rides peer-to-peer
                            (CellActor.scala:81)
PEER_RING (worker↔worker)   neighbor state push between cells — direct, no
                            coordinator relay (NextStateCellGathererActor:32-36)
PEER_RING_BATCH             (new) every ring bound for one peer in an
                            epoch/chunk, coalesced into a single frame
                            (bit-packed entries for binary rules); PEER_PULL
                            replies ride the same frame kind
PEER_PULL (worker↔worker)   GetStateFromEpoch re-ask to a specific neighbor
                            (NextStateCellGathererActor.scala:49-53); carries
                            every missing tile of that owner in one frame
PRUNE                       (new) bounded-history floor broadcast
TILE_STATE                  CellStateMsg to the logger (BoardCreator.scala:159)
CRASH / CRASH_TILE          DoCrashMsg fault injection (CellActor.scala:53-55)
REDEPLOY_REQUEST            postRestart → SendMeMyNeighbours (CellActor.scala:21-25)
GATHER_FAILED               FailedToGatherInfoMsg — gatherer gives up, parent
                            repairs the neighborhood
                            (NextStateCellGathererActor.scala:49-58)
PAUSE / RESUME              PauseSimulation/ResumeSimulation — *dead code* in
                            the reference (BoardCreator.scala:109-112); reachable here
SHUTDOWN                    (new) orderly termination
GOODBYE                     graceful leave (cluster down)
MIGRATE_PREPARE /           (new) the elastic plane: live tile migration —
MIGRATE_STATE /             freeze a tile at its chunk boundary, ship its
MIGRATE_ABORT               packed state + digest lanes to the frontend,
                            certify on arrival, commit via an OWNERS
                            rewiring (or roll back loudly); the reference
                            can only *react* to failure, never move load
DRAIN_REQUEST /             (new) graceful scale-in: a worker asks to leave,
DRAIN_COMPLETE              its tiles migrate off live, and only then is it
                            released — planned departure never trips the
                            node-loss redeploy path
SERVE_OPS / SERVE_RESULT    (new) cluster-sharded serving: coalesced session
                            ops (create/step/delete/get/adopt/step_raw) from
                            the frontend's tenant surface to one worker's
                            batch engine, and the coalesced results back
SHARD_PREPARE /             (new) session-shard migration: freeze a shard's
SHARD_STATE /               sessions on the source, ship them digest-
SHARD_COMMIT / SHARD_ABORT  certified, commit ownership (or roll back) —
                            the tile-migration protocol, session-shaped
SHARD_REPLICATE /           (new) session replication: a shard primary
SHARD_REPLICATE_ACK         streams dirty session snapshots (bit-packed +
                            digest lanes) to the frontend, which relays
                            them to the shard's replica worker through its
                            op FIFO and acks the primary with the per-
                            session epoch watermark (or parks/resets the
                            stream) — promotion on worker loss resumes
                            from the last acked state
COST                        (new) compile & device-cost observatory: a
                            worker's low-cadence ledger frame — per-
                            family program counts/compile bill/priced
                            throughput plus device-memory watermarks —
                            merged by the frontend into /programs,
                            /cost, and /healthz (obs/programs.py)
PROFILE                     (new) on-demand profiler fan-out: the
                            frontend relays one POST /profile capture
                            request to every worker so a single call
                            profiles the whole cluster window
TILED_HALO /                (new) worker-resident tiled sessions: one
TILED_HALO_ACK              chunk's O(perimeter) edge strip for a
                            neighbor chunk at an epoch barrier, shipped
                            worker-to-worker over the peer data plane and
                            enqueued onto the receiver's serve op FIFO —
                            the frontend never touches per-round cell
                            state; the ack clears the sender's
                            retransmit buffer
P_HELLO                     (new) frontend federation: first frame on a
                            freshly dialed peer link — name, advertised
                            addresses, incarnation — answered with the
                            receiver's own hello (the Akka Cluster seed
                            handshake, application.conf:7-12)
P_GOSSIP                    (new) frontend federation: heartbeat-aged
                            membership + slice-table deltas (LWW by
                            version) + cluster-budget shares, the
                            convergence vehicle (application.conf:23-26)
P_FWD_OPS /                 (new) frontend federation: serve ops for a
P_FWD_RESULT                foreign slice forwarded to the owning
                            frontend over the peer link (per-peer FIFO,
                            executed in arrival order on the owner) and
                            the coalesced results back
P_REPLICATE /               (new) frontend federation: a frontend's
P_REPLICATE_ACK             slice of control state — session index
                            rows, replication watermarks, certified
                            floors — streamed to its standby peer with
                            the seq/ack watermark discipline, so
                            a SIGKILLed frontend's slice promotes from
                            the last acked row set
SHARD_HOME                  (new) worker → frontend after a control-
                            channel re-home: the shards + session truth
                            this worker hosts, so the adopting frontend
                            replaces promoted placeholder rows with
                            worker truth and clears the failover window
FED_PEERS                   (new) frontend → worker whenever the
                            federation peer set changes: the live peer
                            frontends' cluster addresses, the fallback
                            list a worker re-homes its control channel
                            to after a frontend loss
==========================  ====================================================

Every message constant below must appear in docs/OPERATIONS.md's
"Protocol messages" table — ``tools/check_protocol_msgs.py`` (tier-1, via
``tests/test_rebalance.py``) lint-enforces it, so new messages cannot ship
undocumented.

Wire form: each message is a JSON object with a ``type`` field from the
constants below; numpy arrays ride as base64 (see :mod:`wire`).

Trace propagation: frontend→backend envelopes (TICK, DEPLOY, CRASH,
CRASH_TILE) may carry the sender's span context under
:data:`akka_game_of_life_tpu_torch.obs.tracing.TRACE_KEY` (attached by
``wire.attach_trace``), so a worker's step/halo/recovery spans become
children of the frontend epoch span that caused them.  The key is
underscored — it can never collide with a payload field — and decoders
that ignore it lose nothing but causality.

The serve plane extends the same discipline to its protocol
(``serve_trace``, on by default): each op inside a ``SERVE_OPS`` frame
carries the ``serve.request`` ctx of the HTTP request that caused it
(the frame itself carries the first traced op's ctx — one frame
coalesces many requests), the worker opens its ``serve.batch`` span as
that ctx's child and echoes the ctx on the matching ``serve_result``
entry, and ``shard_*``/``replicate`` control frames join whatever span
is active at enqueue time (a promotion, a migration) so failover
machinery traces under the event that triggered it.
"""

from __future__ import annotations

# backend → frontend
REGISTER = "register"
HEARTBEAT = "heartbeat"
PROGRESS = "progress"
TILE_STATE = "tile_state"
REDEPLOY_REQUEST = "redeploy_request"
GATHER_FAILED = "gather_failed"
GOODBYE = "goodbye"
# (new) batched finished trace spans, so the frontend's --trace-file /
# /trace holds the whole cluster's causal timeline in one document (the
# multi-process CLI roles forward; the in-process harness shares a tracer
# and never needs to)
SPANS = "spans"
# (new) compile & device-cost observatory: the worker's low-cadence
# program-ledger + device-watermark frame (obs/programs.py summary())
COST = "cost"

# frontend → backend
WELCOME = "welcome"
DEPLOY = "deploy"
OWNERS = "owners"
TICK = "tick"
PRUNE = "prune"
CRASH = "crash"
CRASH_TILE = "crash_tile"
PAUSE = "pause"
RESUME = "resume"
SHUTDOWN = "shutdown"
# (new) on-demand cluster profiler capture fan-out (POST /profile)
PROFILE = "profile"

# elastic plane: live tile migration + graceful drain
# frontend → backend
MIGRATE_PREPARE = "migrate_prepare"
MIGRATE_ABORT = "migrate_abort"
DRAIN_COMPLETE = "drain_complete"
# backend → frontend
MIGRATE_STATE = "migrate_state"
DRAIN_REQUEST = "drain_request"

# cluster-sharded serving plane: the session router as the frontend's
# tenant-facing surface, with per-worker vmapped batch engines behind it
# frontend → worker
SERVE_OPS = "serve_ops"
SHARD_PREPARE = "shard_prepare"
SHARD_COMMIT = "shard_commit"
SHARD_ABORT = "shard_abort"
# session replication: ack-watermark half (frontend → primary, on the
# per-worker op FIFO so it can never reorder against shard control)
SHARD_REPLICATE_ACK = "shard_replicate_ack"
# worker → frontend
SERVE_RESULT = "serve_result"
SHARD_STATE = "shard_state"
# session replication: data half (primary → frontend, relayed to the
# shard's replica as a ``replicate`` op on the replica's op FIFO)
SHARD_REPLICATE = "shard_replicate"

# worker ↔ worker (the peer-to-peer data plane)
PEER_HELLO = "peer_hello"
PEER_RING = "peer_ring"
PEER_RING_BATCH = "peer_ring_batch"
PEER_PULL = "peer_pull"
# worker ↔ worker: resident tiled-session halo exchange (received frames
# ride the serve plane's per-worker op FIFO, so halo installs order
# against chunk installs/steps/migrations like every other serve op)
TILED_HALO = "tiled_halo"
TILED_HALO_ACK = "tiled_halo_ack"

# frontend ↔ frontend (the federation peer plane): gossip-converged
# membership, slice-table deltas, forwarded serve ops, and control-state
# replication between frontends — all on one per-peer FIFO link so
# forwarded ops can never reorder against the slice-ownership control
# frames that route them
P_HELLO = "p_hello"
P_GOSSIP = "p_gossip"
P_FWD_OPS = "p_fwd_ops"
P_FWD_RESULT = "p_fwd_result"
P_REPLICATE = "p_replicate"
P_REPLICATE_ACK = "p_replicate_ack"

# worker → frontend: control-channel re-home announcement — after a
# frontend loss the worker reconnects to a surviving peer and declares
# the shards/sessions it hosts, which closes that slice's failover window
SHARD_HOME = "shard_home"

# frontend → worker: the live federation peers' cluster addresses (sent
# in WELCOME and re-pushed whenever the peer set changes), the fallback
# list the worker's control channel re-homes to after a frontend loss
FED_PEERS = "fed_peers"
